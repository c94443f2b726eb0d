"""K3a, the HSM-SSD mixer ablation, in the port against the TPU kernel, on
the CPU.

The same numpy inputs (bf16, A drawn from [1, 16] as the TPU script draws
it) go to the TPU kernel itself, a ``pl.pallas_call`` of
``scripts/ablate_mix_kernel.py::make_kernel`` with ``run``'s grid and block
specs in interpret mode, and to ``ablate_mix_plain``, in all five modes, at
one tile, several tiles, C != N and N = 64. The two must agree within one
bf16 ulp of the output's scale (2^(floor(log2 max|y|) - 7)): the plain
version keeps the kernel's tiles and casts, so only the order of fp32 sums
differs (on these inputs they agree bit for bit). Also: ``chained_time_ms``
on the CPU, the wrapper's dispatch and its refusals.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from kmunet_tpu_torch.kernels import ablate_mix as k3a
from kmunet_tpu_torch.utils import chained_time_ms
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("ablate_mix_kernel",
                                               REPO / "scripts" / "ablate_mix_kernel.py")
tpu_script = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tpu_script)

# (B, C, L, N, tile)
SHAPES = {
    "one_tile": (2, 16, 64, 8, 64),
    "tiles": (2, 16, 256, 16, 32),
    "c6_n16": (3, 6, 192, 16, 64),
    "n64": (1, 8, 512, 64, 128),
}


def tpu_kernel(mode, xt, dt, Bm, Cm, A, tile):
    """The TPU kernel of ``run`` (``scripts/ablate_mix_kernel.py:98-122``) at
    these inputs' shapes, in interpret mode: yt (B, C, L) as float32."""
    B, C, L = xt.shape
    N = dt.shape[2]
    n_tiles = L // tile
    last = n_tiles - 1
    vmem = dict(memory_space=pltpu.VMEM)
    f = pl.pallas_call(
        tpu_script.make_kernel(mode, n_tiles, C, N, tile),
        grid=(B, 2, n_tiles),
        in_specs=[
            pl.BlockSpec((1, C, tile), lambda b, p, i: (b, 0, i * (1 - p) + last * p), **vmem),
            pl.BlockSpec((1, tile, N), lambda b, p, i: (b, i * (1 - p) + last * p, 0), **vmem),
            pl.BlockSpec((1, tile, N), lambda b, p, i: (b, i * (1 - p) + last * p, 0), **vmem),
            pl.BlockSpec((1, tile, N), lambda b, p, i: (b, i * p, 0), **vmem),
            pl.BlockSpec((1, N), lambda b, p, i: (0, 0), **vmem),
        ],
        out_specs=pl.BlockSpec((1, C, tile), lambda b, p, i: (b, 0, i * p), **vmem),
        out_shape=jax.ShapeDtypeStruct((B, C, L), jnp.bfloat16),
        scratch_shapes=[pltpu.VMEM((1, N), jnp.float32), pltpu.VMEM((1, N), jnp.float32),
                        pltpu.VMEM((C, N), jnp.float32)],
        interpret=True,
    )
    return np.asarray(jax.jit(f)(xt, dt, Bm, Cm, A[None, :]).astype(jnp.float32))


def inputs(shape, seed=0):
    """xt, dt, Bm, Cm N(0, 1) and A U(1, 16), as bf16 numpy-born arrays: the
    JAX ones and their torch copies."""
    B, C, L, N, _ = shape
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=s) for s in ((B, C, L), (B, L, N), (B, L, N), (B, L, N))]
    arrays.append(rng.uniform(1.0, 16.0, N))
    jx = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16) for a in jx]
    return jx, tx


@pytest.mark.parametrize("mode", k3a.MODES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_matches_tpu_kernel(shape, mode):
    tile = SHAPES[shape][4]
    jx, tx = inputs(SHAPES[shape], seed=list(SHAPES).index(shape))
    want = tpu_kernel(mode, *jx, tile)
    got = k3a.ablate_mix_plain(mode, *tx, tile)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    assert np.isfinite(want).all() and np.abs(want).max() > 0.1
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=ulp)


def test_bf16_e_depends_on_the_tile():
    """bf16_e never stores its running max, so the same inputs give another
    answer under another tile (the TPU kernel's as well as the port's), far
    beyond the one ulp by which full's answers move (where w rounds)."""
    jx, tx = inputs((2, 8, 256, 8, 0), seed=5)
    for tile in (64, 256):
        np.testing.assert_array_equal(k3a.ablate_mix_plain("bf16_e", *tx, tile).float().numpy(),
                                      tpu_kernel("bf16_e", *jx, tile))
    moved = {}
    for mode in ("full", "bf16_e"):
        a, b = (k3a.ablate_mix_plain(mode, *tx, tile).float() for tile in (64, 256))
        ulp = 2.0 ** (np.floor(np.log2(float(b.abs().max()))) - 7)
        moved[mode] = float((a - b).abs().max()) / ulp
    assert moved["full"] <= 1.0 and moved["bf16_e"] > 10.0, moved


def test_wrapper_takes_the_plain_version_on_the_cpu():
    _, tx = inputs(SHAPES["tiles"], seed=1)
    before = k3a.ablate_mix.launches
    for mode in k3a.MODES:
        assert torch.equal(k3a.ablate_mix(mode, *tx, 32), k3a.ablate_mix_plain(mode, *tx, 32))
    assert k3a.ablate_mix.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        k3a.ablate_mix_forward("full", *tx, 64)


def test_refuses_what_it_does_not_take():
    _, (xt, dt, Bm, Cm, A) = inputs(SHAPES["c6_n16"], seed=2)  # L = 192
    with pytest.raises(ValueError, match="not a multiple of tile"):
        k3a.ablate_mix("full", xt, dt, Bm, Cm, A, 128)
    with pytest.raises(ValueError, match="mode"):
        k3a.ablate_mix("no_softmax", xt, dt, Bm, Cm, A, 64)
    with pytest.raises(TypeError, match="bfloat16"):
        k3a.ablate_mix("full", xt.float(), dt, Bm, Cm, A, 64)
    with pytest.raises(ValueError, match="Cm"):
        k3a.ablate_mix("full", xt, dt, Bm, Cm[:, :, :8], A, 64)


def test_chained_time_ms_on_the_cpu():
    _, tx = inputs(SHAPES["tiles"], seed=3)
    calls = []

    def fn(*args):
        calls.append(args[0])
        return k3a.ablate_mix("full", *args, 32)

    ms = chained_time_ms(fn, *tx, iters=4, warmup=1)
    assert ms > 0 and len(calls) == 5
    # The first floating input is the one perturbed; by 1e-20, nothing in bf16.
    assert all(a is not tx[0] and torch.equal(a, tx[0]) for a in calls)
    with pytest.raises(ValueError, match="floating"):
        chained_time_ms(lambda n: n, 3)


def test_timing_script_runs_on_the_cpu():
    """``scripts/torch_ablate_mix_kernel.py``'s ``run`` at a small shape on
    the CPU (the plain versions): a reading per mode and for K2, each with
    the byte bound of its shape; on the card it is the script's path."""
    spec = importlib.util.spec_from_file_location("torch_ablate_mix_kernel",
                                                  REPO / "scripts" / "torch_ablate_mix_kernel.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    out = script.run(("full", "dma_only"), tile=64, batch=1, hw=16, iters=1, device="cpu")
    assert set(out) == {"full", "dma_only", "K2"}
    assert all(ms > 0 and bound > 0 for ms, bound, _ in out.values())
    assert out["full"][1] == script.byte_bound_ms(1, script.C, 256, script.N)
