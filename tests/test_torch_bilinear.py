"""K5 bilinear gather of the port against the JAX package.

The plain version (what the port runs on a CPU tensor) is held to
``bilinear_gather_xla`` and to the Pallas kernel in interpret mode, in fp32,
within 1e-6 abs: both compute the same 4-tap blend in fp32, so only the
order of a few roundings differs. The CUDA kernel is held to the plain
version on the card in tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmunet_tpu.kernels.bilinear_pallas import gather_bilinear_border, gather_bilinear_zeros
from kmunet_tpu.ops.sample import bilinear_gather_xla
from kmunet_tpu_torch.kernels import bilinear
from tests.torch_cases import GATHER_CASES as CASES
from tests.torch_cases import GATHER_SHAPES as SHAPES
from tests.torch_cases import gather_inputs as _inputs
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse: one torch thread)

MODES = ("zeros", "border")
PALLAS = {"zeros": gather_bilinear_zeros, "border": gather_bilinear_border}


def _plain(img, x, y, mode):
    t = bilinear.bilinear_gather_plain(torch.from_numpy(img), torch.from_numpy(x),
                                       torch.from_numpy(y), mode)
    return t.numpy()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_xla(mode, shape, case):
    img, x, y = _inputs(SHAPES[shape], case)
    want = bilinear_gather_xla(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y), mode)
    np.testing.assert_allclose(_plain(img, x, y, mode), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_pallas_interpret(mode, case):
    img, x, y = _inputs(SHAPES["ragged"], case, seed=1)
    want = PALLAS[mode](jnp.asarray(img), jnp.asarray(x), jnp.asarray(y), True)
    np.testing.assert_allclose(_plain(img, x, y, mode), np.asarray(want), rtol=0, atol=1e-6)


def test_cpu_tensor_takes_plain_version_without_launch():
    img, x, y = _inputs(SHAPES["ragged"], "spread")
    before = bilinear.bilinear_gather.launches
    got = bilinear.bilinear_gather(torch.from_numpy(img), torch.from_numpy(x),
                                   torch.from_numpy(y), "zeros")
    np.testing.assert_array_equal(got.numpy(), _plain(img, x, y, "zeros"))
    assert bilinear.bilinear_gather.launches == before


def test_bad_padding_mode_raises():
    img, x, y = _inputs(SHAPES["ragged"], "spread")
    with pytest.raises(ValueError, match="padding_mode"):
        bilinear.bilinear_gather(torch.from_numpy(img), torch.from_numpy(x),
                                 torch.from_numpy(y), "reflect")
