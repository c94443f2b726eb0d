"""K2's and K3's plain versions over the Pallas kernels' whole domain, on
the CPU: any state size N and any width C (the EfficientViM classifier's
mixers run N = 49/25/9 and 64/32/16 at C = 128-512, where the CUDA kernels
take their wide path).

``hsmssd_compress_plain`` against ``hsmssd_compress_op`` (the Pallas
kernel, interpreted off the TPU) within 1e-4 (tests/test_kernels.py's
bound) and ``hsmssd_mix_plain`` against ``hsmssd_mix(..., interpret=True)``
within 1e-5 relative and absolute (tests/test_ssd_mix.py's), at N of 1, 9,
25 and 49 and C of 96 and 224, B=1 and L=49 (the classifier's second
stage), with the inputs of tests/test_torch_hsmssd.py. The kernels' own
arithmetic at a padded odd N and at more than one 64-channel chunk is
modelled in tests/test_torch_k3_tiles.py; the kernels themselves are held
to the plain versions on the card (chip_smoke.py, tests/test_torch_gpu.py).
"""

import jax
import numpy as np
import pytest

from kmunet_tpu.kernels.ssd_mix_pallas import hsmssd_mix as hsmssd_mix_jax
from kmunet_tpu.kernels.ssd_pallas import hsmssd_compress_op
from kmunet_tpu_torch.kernels import ssd
from tests.test_torch_hsmssd import _inputs, _port_args
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse: one torch thread)

L = 49


@pytest.mark.parametrize("C", [96, 224])
@pytest.mark.parametrize("N", [1, 9, 25, 49])
def test_plain_versions_match_jax_kernels_at_any_n_and_c(N, C):
    kw = _inputs((1, C, L, N, 1.0), seed=N + C)
    x, dt, Bm, Cm, A, w_hz, w_out, D = _port_args(kw)
    want_h = jax.jit(hsmssd_compress_op)(kw["xt"].transpose(0, 2, 1), kw["dt"], kw["Bm"], kw["A"])
    got_h = ssd.hsmssd_compress_plain(x, dt, Bm, A)
    assert got_h.shape == (1, N, C)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=0, atol=1e-4)
    want_y, want_h2 = jax.jit(hsmssd_mix_jax, static_argnums=8)(*kw.values(), True)
    got_y, got_h2 = ssd.hsmssd_mix_plain(x, dt, Bm, Cm, A, w_hz, w_out, D)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_h2.numpy(), np.asarray(want_h2).transpose(0, 2, 1),
                               rtol=1e-5, atol=1e-5)
