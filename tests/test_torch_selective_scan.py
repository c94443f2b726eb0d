"""K8, the selective scan, and its backward: the port's plain versions
against the JAX package, on the CPU.

The forward within 1e-5 abs of ``_selective_scan_xla`` and of
``selective_scan_pallas(..., interpret=True)``; all six gradients within
1e-4 of each one's largest |value| of ``jax.vjp`` through both, including
the Pallas kernel's multi-chunk carry forward and backward (its chunk sizes
monkeypatched, as tests/test_scan_pallas.py does); bf16 inputs with an fp32
state; a float64 ``gradcheck``; the autograd function's path on the CPU; and
the scan's counters, which only the CUDA launchers move. Every input is
drawn from this file's own seeded generators. Each JAX function is jitted,
so that it compiles once per shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmunet_tpu.kernels.scan_pallas as scan_pallas_jax
from kmunet_tpu.ops.scan import _selective_scan_xla
from kmunet_tpu_torch.kernels import scan
from kmunet_tpu_torch.ops import scan as scan_ops
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse: one torch thread)

NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD")


def _inputs(shape, seed, dt_scale=1.0):
    """(x, dt, A, B, C, D) and an upstream gradient, numpy fp32: dt the
    softplus of N(0, 1) times ``dt_scale``, A negative."""
    B, L, D, N = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, D))
    dt = dt_scale * np.logaddexp(0.0, rng.normal(size=(B, L, D)))
    A = -rng.uniform(0.5, 4.0, (D, N))
    Bm, Cm = rng.normal(size=(B, L, N)), rng.normal(size=(B, L, N))
    Dp = rng.uniform(0.5, 1.5, D)
    g = rng.normal(size=(B, L, D))
    return [a.astype(np.float32) for a in (x, dt, A, Bm, Cm, Dp)], g.astype(np.float32)


def _jax_vjp(fn):
    """jit of (y, the six gradients) of ``fn`` for the upstream gradient."""
    def run(args, g):
        y, vjp = jax.vjp(fn, *args)
        return y, vjp(g)

    return jax.jit(run)


def _port(args, g):
    t = [torch.from_numpy(a) for a in args]
    return (scan.selective_scan_plain(*t).numpy(),
            [d.numpy() for d in scan.selective_scan_backward_plain(*t, torch.from_numpy(g))])


def _assert_matches(port, want):
    (y, grads), (y_want, grads_want) = port, want
    np.testing.assert_allclose(y, np.asarray(y_want), rtol=0, atol=1e-5)
    for name, a, b in zip(NAMES, grads, grads_want):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max(), err_msg=name)


@pytest.mark.parametrize("shape,dt_scale", [
    ((2, 150, 6, 4), 1.0),      # three plain chunks, the last ragged
    ((2, 64, 24, 16), 0.01),    # decay near 1: memory over the whole sequence
    ((1, 33, 8, 8), 8.0),       # decay near 0
])
def test_plain_matches_xla(shape, dt_scale):
    args, g = _inputs(shape, seed=sum(shape))
    want = _jax_vjp(_selective_scan_xla)([jnp.asarray(a) for a in args], jnp.asarray(g))
    _assert_matches(_port(args, g), want)


@pytest.mark.parametrize("chunk", [None, 16])
def test_plain_matches_pallas_interpret(chunk, monkeypatch):
    """The Pallas kernel in interpret mode, at L=64, D=8, N=4 in one chunk
    and (``chunk`` 16) in four, forward and backward: the carry across
    chunks, the checkpoints and the cotangent message all run."""
    if chunk is not None:
        monkeypatch.setattr(scan_pallas_jax, "_pick_chunk", lambda L, DN: chunk)
        monkeypatch.setattr(scan_pallas_jax, "_pick_chunk_bwd", lambda L, DN: chunk)
    args, g = _inputs((2, 64, 8, 4), seed=3)

    def kernel(x, dt, A, Bm, Cm, Dp):
        return scan_pallas_jax.selective_scan_pallas(x, dt, A, Bm, Cm, Dp, True)

    want = _jax_vjp(kernel)([jnp.asarray(a) for a in args], jnp.asarray(g))
    _assert_matches(_port(args, g), want)


def test_bf16_inputs_fp32_state_match_xla():
    """bf16 x, dt, B, C (A and D fp32): the output in bf16, from an fp32
    state, within one bf16 ulp of XLA's (both round the same fp32 sum once),
    and within 2e-2 of the fp32 result on the same rounded inputs."""
    args, _ = _inputs((2, 96, 16, 8), seed=4)
    bf = [a if i in (2, 5) else jnp.asarray(a, jnp.bfloat16) for i, a in enumerate(args)]
    want = np.asarray(jax.jit(_selective_scan_xla)(*bf).astype(jnp.float32))
    t = [torch.from_numpy(a) if i in (2, 5) else torch.from_numpy(a).bfloat16()
         for i, a in enumerate(args)]
    got = scan.selective_scan_plain(*t)
    assert got.dtype == torch.bfloat16
    ulp = np.ldexp(1.0, np.frexp(np.abs(want))[1] - 8)
    assert (np.abs(got.float().numpy() - want) <= ulp).all()
    exact = scan.selective_scan_plain(*[a.float() for a in t])
    np.testing.assert_allclose(got.float().numpy(), exact.numpy(), rtol=2e-2, atol=2e-2)
    grads = scan.selective_scan_backward_plain(*t, torch.ones(2, 96, 16, dtype=torch.bfloat16))
    assert [d.dtype for d in grads] == [torch.bfloat16, torch.bfloat16, torch.float32,
                                        torch.bfloat16, torch.bfloat16, torch.float32]


def test_gradcheck_float64():
    """The autograd function's plain backward against finite differences of
    its plain forward, in float64, over two plain chunks."""
    args, _ = _inputs((1, 68, 2, 2), seed=5)
    leaves = [torch.from_numpy(a).double().requires_grad_() for a in args]
    assert torch.autograd.gradcheck(scan.selective_scan, leaves, eps=1e-6, atol=1e-7,
                                    rtol=1e-5)


def test_autograd_function_takes_the_plain_versions_on_the_cpu():
    """``selective_scan`` (re-exported by ``ops/scan.py``) on CPU tensors: the
    plain forward and backward, bit for bit, on non-contiguous B and C as
    MambaBlock's split gives them; no kernel counter moves."""
    args, g = _inputs((2, 40, 6, 4), seed=6)
    t = [torch.from_numpy(a) for a in args]
    proj = torch.cat([t[3], t[4]], -1).requires_grad_()
    Bm, Cm = proj.split([4, 4], -1)
    leaves = [a.clone().requires_grad_() for a in (t[0], t[1], t[2], t[5])]
    before = (scan.selective_scan.launches, scan.selective_scan_backward.launches)
    y = scan_ops.selective_scan(leaves[0], leaves[1], leaves[2], Bm, Cm, leaves[3])
    y.backward(torch.from_numpy(g))
    assert (scan.selective_scan.launches, scan.selective_scan_backward.launches) == before
    assert torch.equal(y.detach(), scan.selective_scan_plain(*t))
    dx, ddt, dA, dB, dC, dD = scan.selective_scan_backward_plain(*t, torch.from_numpy(g))
    for got, want in ((leaves[0].grad, dx), (leaves[1].grad, ddt), (leaves[2].grad, dA),
                      (proj.grad, torch.cat([dB, dC], -1)), (leaves[3].grad, dD)):
        assert torch.equal(got, want)


def test_plain_versions_refuse_mismatched_shapes():
    args, _ = _inputs((1, 8, 4, 4), seed=7)
    t = [torch.from_numpy(a) for a in args]
    with pytest.raises(ValueError, match="want A"):
        scan.selective_scan_plain(t[0], t[1], t[2][:3], t[3], t[4], t[5])
    with pytest.raises(ValueError, match="want B"):
        scan.selective_scan_plain(t[0], t[1], t[2], t[3][:, :4], t[4], t[5])
    with pytest.raises(ValueError, match="want D"):
        scan.selective_scan_plain(t[0], t[1], t[2], t[3], t[4], t[5][:2])
