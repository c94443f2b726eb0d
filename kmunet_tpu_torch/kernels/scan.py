"""K8, the selective scan (Mamba's S6 recurrence), and its backward.

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t      # h: (D, N) per sequence
    y_t = C_t . h_t + D * x_t

The port's counterpart of ``kmunet_tpu/kernels/scan_pallas.py``'s
``selective_scan_pallas`` (the ``pl.pallas_call`` in ``_forward``) and of
its custom VJP's backward ``_backward`` (the ``pl.pallas_call`` of
``_bwd_kernel``), which compute what ``kmunet_tpu/ops/scan.py::
_selective_scan_xla`` computes. Both CUDA kernels are in
``csrc/selective_scan.cu``; its source note says what bounds them and how
they are laid out: L cut into chunks that run in parallel, with a carry
pass between them (three device launches per call of either, one where L
fits one chunk; the backward's launcher adds two sums), and fp32 scratch per
(b, chunk) that the launchers allocate.

``selective_scan`` is what callers use: an autograd function
(``SelectiveScan``) whose forward is K8 and whose backward is K8's backward
on a CUDA tensor, and the plain versions of both on a CPU tensor. It
dispatches on the device of ``x`` alone; on a CUDA tensor it launches the
kernels or raises. The launchers count their launches on
``selective_scan.launches`` and ``selective_scan_backward.launches``; it
records K8's useful FLOPs (``utils.flops.custom_call``) as
``scan_pallas.py:350-358`` does, on either device.

The plain versions are a chunked sequential loop, not the JAX package's
log-depth ``associative_scan``: they walk the recurrence one token at a
time inside chunks of ``PLAIN_CHUNK`` tokens, computing the decays and
increments of a chunk at once, and the backward stores only each chunk's
entry state and rebuilds the chunk's states from it, as the kernels do.
Memory stays at a few (B, PLAIN_CHUNK, D, N) tensors, where the log-depth
form keeps log2(L) pairs of (B, L, D, N) tensors for autograd (about 2.8 GB
in fp32 for one scan of Mamba-UNet's refine3 at B=2, L=16384). The state
is at least fp32 (float64 for float64 inputs).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from kmunet_tpu_torch.kernels import build
from kmunet_tpu_torch.utils.flops import custom_call

SOURCE = "selective_scan.cu"
PLAIN_CHUNK = 64  # tokens per chunk of the plain versions
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_STATE_SIZES = (1, 2, 4, 8, 16, 32)  # N: the lanes of one channel sit in one warp


def _state_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def _check_shapes(x, dt, A, Bm, Cm, Dp) -> None:
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"want x, dt (B, L, D); got {tuple(x.shape)}, {tuple(dt.shape)}")
    Bsz, L, D = x.shape
    if A.dim() != 2 or A.shape[0] != D:
        raise ValueError(f"want A ({D}, N); got {tuple(A.shape)}")
    N = A.shape[1]
    for name, t in (("B", Bm), ("C", Cm)):
        if tuple(t.shape) != (Bsz, L, N):
            raise ValueError(f"want {name} ({Bsz}, {L}, {N}); got {tuple(t.shape)}")
    if tuple(Dp.shape) != (D,):
        raise ValueError(f"want D ({D},); got {tuple(Dp.shape)}")


def _chunk_terms(x, dt, A, Bm):
    """The decays exp(dt*A) and increments dt*x*B of a chunk, (B, Q, D, N)."""
    a = torch.exp(dt[..., None] * A)
    inc = (dt * x)[..., None] * Bm[:, :, None, :]
    return a, inc


def _walk(a, inc, h):
    """The states h_t = a_t * h_{t-1} + inc_t of a chunk from its entry
    state ``h`` (B, D, N): (states (B, Q, D, N), the last state)."""
    states = torch.empty_like(inc)
    for t in range(inc.shape[1]):
        h = torch.addcmul(inc[:, t], a[:, t], h)
        states[:, t] = h
    return states, h


@torch.no_grad()
def selective_scan_plain(x, dt, A, Bm, Cm, Dp) -> torch.Tensor:
    """Plain PyTorch version of K8: x, dt (B, L, D); A (D, N); B, C
    (B, L, N); D (D,) -> y (B, L, D) in x's dtype, with the state and every
    product in (at least) fp32, as ``_selective_scan_xla`` computes it."""
    _check_shapes(x, dt, A, Bm, Cm, Dp)
    out_dtype, st = x.dtype, _state_dtype(x)
    x, dt, A, Bm, Cm, Dp = (t.to(st) for t in (x, dt, A, Bm, Cm, Dp))
    Bsz, L, D = x.shape
    h = x.new_zeros(Bsz, D, A.shape[1])
    y = torch.empty_like(x)
    for s in range(0, L, PLAIN_CHUNK):
        e = min(s + PLAIN_CHUNK, L)
        states, h = _walk(*_chunk_terms(x[:, s:e], dt[:, s:e], A, Bm[:, s:e]), h)
        y[:, s:e] = torch.einsum("bldn,bln->bld", states, Cm[:, s:e])
    return (y + x * Dp).to(out_dtype)


@torch.no_grad()
def selective_scan_backward_plain(x, dt, A, Bm, Cm, Dp, g):
    """Plain PyTorch version of K8's backward: the VJP of
    ``selective_scan_plain`` for the upstream gradient ``g`` (B, L, D);
    returns (dx, ddt, dA, dB, dC, dD), each in its input's dtype.

    What ``scan_pallas.py::_backward`` computes, in its two phases: a
    forward walk that keeps each chunk's entry state, then the chunks in
    reverse, each rebuilding its states from its entry state and walking
    the cotangent of the state back, hh_t = g_t (x) C_t + a_{t+1} * hh_{t+1}
    (the carry into the chunk before is a_t * hh_t at its first token):

        dx  = sum_n hh * dt * B + g * D        ddt = sum_n hh * (x * B + h_{t-1} * a * A)
        dB  = sum_d hh * dt * x                dC  = sum_d g * h
        dA  = sum_{b,t} hh * h_{t-1} * a * dt  dD  = sum_{b,t} g * x
    """
    _check_shapes(x, dt, A, Bm, Cm, Dp)
    dtypes = [t.dtype for t in (x, dt, A, Bm, Cm, Dp)]
    st = _state_dtype(x)
    x, dt, A, Bm, Cm, Dp, g = (t.to(st) for t in (x, dt, A, Bm, Cm, Dp, g))
    Bsz, L, D = x.shape
    starts = list(range(0, L, PLAIN_CHUNK))
    entries = []
    h = x.new_zeros(Bsz, D, A.shape[1])
    for s in starts:
        entries.append(h)
        _, h = _walk(*_chunk_terms(x[:, s:s + PLAIN_CHUNK], dt[:, s:s + PLAIN_CHUNK], A,
                                   Bm[:, s:s + PLAIN_CHUNK]), h)
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    dA = torch.zeros_like(A)
    m = torch.zeros_like(h)
    for s, h_in in zip(reversed(starts), reversed(entries)):
        e = min(s + PLAIN_CHUNK, L)
        xs, dts, Bs, gs = x[:, s:e], dt[:, s:e], Bm[:, s:e], g[:, s:e]
        a, inc = _chunk_terms(xs, dts, A, Bs)
        states, _ = _walk(a, inc, h_in)
        h_prev = torch.cat([h_in[:, None], states[:, :-1]], 1)
        G = gs[..., None] * Cm[:, s:e, None, :]
        hh = torch.empty_like(G)
        for t in reversed(range(e - s)):
            hh[:, t] = G[:, t] + m
            m = a[:, t] * hh[:, t]
        P = hh * h_prev * a
        dx[:, s:e] = (hh * Bs[:, :, None, :]).sum(-1) * dts + gs * Dp
        ddt[:, s:e] = (hh * xs[..., None] * Bs[:, :, None, :] + P * A).sum(-1)
        dB[:, s:e] = torch.einsum("bldn,bld->bln", hh, dts * xs)
        dC[:, s:e] = torch.einsum("bld,bldn->bln", gs, states)
        dA += (P * dts[..., None]).sum((0, 1))
    dD = (g * x).sum((0, 1))
    return tuple(t.to(d) for t, d in zip((dx, ddt, dA, dB, dC, dD), dtypes))


@functools.cache
def _entry(name: str, argtypes: tuple) -> ctypes._CFuncPtr:
    """The C entry ``name`` of the library built from ``csrc/selective_scan.cu``."""
    fn = getattr(ctypes.CDLL(str(build.build(SOURCE).path)), name)
    fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
    return fn


def _launcher(name: str, n_pointers: int) -> ctypes._CFuncPtr:
    """A kernel entry: ``n_pointers`` tensor pointers, B, L, D, N and the
    dtype code, then the stream."""
    return _entry(name, (ctypes.c_void_p,) * n_pointers + (ctypes.c_int,) * 5
                  + (ctypes.c_void_p,))


def forward_kernel() -> ctypes._CFuncPtr:
    """K8's entry point, built on first use."""
    return _launcher("kmunet_selective_scan", 9)


def backward_kernel() -> ctypes._CFuncPtr:
    """K8's backward entry point, built on first use (from the same source)."""
    return _launcher("kmunet_selective_scan_backward", 16)


@functools.cache
def _chunks(Bsz: int, L: int, D: int, N: int, backward: bool) -> int:
    """The kernels' chunks at this shape, the scratch's second dimension;
    -1 for a shape whose tensors or scratch they cannot index in int32."""
    return _entry("kmunet_selective_scan_chunks", (ctypes.c_int,) * 5)(Bsz, L, D, N,
                                                                      int(backward))


def _check(x, dt, A, Bm, Cm, Dp) -> None:
    _check_shapes(x, dt, A, Bm, Cm, Dp)
    if not x.is_cuda:
        raise ValueError(f"the CUDA scan needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x dtype {x.dtype} not in {list(_DTYPE_CODES)}")
    for name, t in (("dt", dt), ("B", Bm), ("C", Cm), ("A", A), ("D", Dp)):
        want = torch.float32 if name in ("A", "D") else x.dtype
        if t.dtype != want or t.device != x.device:
            raise TypeError(f"{name} must be {want} on {x.device}, got {t.dtype} on {t.device}")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", Bm), ("C", Cm), ("D", Dp)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    Bsz, L, D = x.shape
    N = A.shape[1]
    if N not in _STATE_SIZES:
        raise ValueError(f"the kernel takes a state size N in {_STATE_SIZES}, got {N}")
    if min(Bsz, L, D) < 1:
        raise ValueError(f"the kernel takes B, L, D >= 1, got {tuple(x.shape)}")
    if Bsz > 65535:
        raise ValueError(f"the kernel takes a batch of at most 65535, got {Bsz}")
    # The kernels index in int32, their scratch too.
    if max(Bsz * L * D, Bsz * L * N) >= 2**31 or _chunks(Bsz, L, D, N, backward=False) < 0:
        raise ValueError("the kernel takes tensors and scratch of fewer than 2**31 elements")


def _scratch(x, N: int, backward: bool):
    """The kernels' fp32 scratch per (b, chunk): E (B, chunks, D, N), S (B,
    chunks, D) and, for the backward, M0 like E (csrc's source note); None
    where L fits one chunk, which needs none."""
    Bsz, L, D = x.shape
    chunks = _chunks(Bsz, L, D, N, backward)
    if chunks == 1:
        return (None, None, None) if backward else (None, None)
    f32 = dict(dtype=torch.float32, device=x.device)
    E = torch.empty((Bsz, chunks, D, N), **f32)
    S = torch.empty((Bsz, chunks, D), **f32)
    return (E, torch.empty_like(E), S) if backward else (E, S)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(fn, x, *args) -> None:
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: error {err}")


def selective_scan_forward(x, dt, A, Bm, Cm, Dp) -> torch.Tensor:
    """The scan without its gradient: y (B, L, D) in x's dtype. A CPU ``x``
    takes the plain version; a CUDA ``x`` launches K8, which takes fp32,
    bf16 and fp16 x, dt, B and C (one dtype) with A and D cast to fp32. Its
    launches count on ``selective_scan.launches``."""
    if x.device.type in ("cpu", "meta"):  # meta: the plain version's shapes
        return selective_scan_plain(x, dt, A, Bm, Cm, Dp)
    A, Dp = A.float().contiguous(), Dp.float().contiguous()
    _check(x, dt, A, Bm, Cm, Dp)
    Bsz, L, D = x.shape
    y = torch.empty_like(x)
    E, S = _scratch(x, A.shape[1], backward=False)
    _launch(forward_kernel(), x, x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), Dp.data_ptr(), y.data_ptr(), _ptr(E), _ptr(S), Bsz, L, D, A.shape[1],
            _DTYPE_CODES[x.dtype])
    selective_scan.launches += 1
    return y


def selective_scan_backward(x, dt, A, Bm, Cm, Dp, g):
    """(dx, ddt, dA, dB, dC, dD) of the scan for the upstream gradient ``g``
    (B, L, D), each in its input's dtype. A CPU ``x`` takes the plain
    version; a CUDA ``x`` launches K8's backward, which writes dx, ddt, dB
    and dC, and fp32 partial sums of dA and dD per (batch, chunk), summed
    here in a fixed order: no atomics, so the gradients are the same from
    run to run. Its launches count on ``selective_scan_backward.launches``."""
    if x.device.type in ("cpu", "meta"):  # meta: the plain version's shapes
        return selective_scan_backward_plain(x, dt, A, Bm, Cm, Dp, g)
    a_dtype, d_dtype = A.dtype, Dp.dtype
    A, Dp = A.float().contiguous(), Dp.float().contiguous()
    _check(x, dt, A, Bm, Cm, Dp)
    if g.dtype != x.dtype or g.device != x.device or g.shape != x.shape:
        raise ValueError(f"g must be {x.dtype} {tuple(x.shape)} on {x.device}; got "
                         f"{g.dtype} {tuple(g.shape)} on {g.device}")
    if not g.is_contiguous():
        raise ValueError("g must be contiguous")
    Bsz, L, D = x.shape
    N = A.shape[1]
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    E, M0, S = _scratch(x, N, backward=True)
    chunks = _chunks(Bsz, L, D, N, backward=True)
    dA_part = torch.empty((Bsz, chunks, D, N), dtype=torch.float32, device=x.device)
    dD_part = torch.empty((Bsz, chunks, D), dtype=torch.float32, device=x.device)
    _launch(backward_kernel(), x, x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), Dp.data_ptr(), g.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
            dB.data_ptr(), dC.data_ptr(), dA_part.data_ptr(), dD_part.data_ptr(), _ptr(E),
            _ptr(M0), _ptr(S), Bsz, L, D, N, _DTYPE_CODES[x.dtype])
    selective_scan_backward.launches += 1
    return (dx, ddt, dA_part.sum((0, 1)).to(a_dtype), dB, dC,
            dD_part.sum((0, 1)).to(d_dtype))


class SelectiveScan(torch.autograd.Function):
    """The scan with its gradient to all six inputs: K8 forward and K8's
    backward on a CUDA tensor, the plain versions of both on a CPU tensor.
    Never runs a plain version on a CUDA tensor."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, Dp):
        ctx.save_for_backward(x, dt, A, Bm, Cm, Dp)
        return selective_scan_forward(x, dt, A, Bm, Cm, Dp)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        grads = selective_scan_backward(*ctx.saved_tensors, g.contiguous())
        return tuple(gr if need else None for gr, need in zip(grads, ctx.needs_input_grad))


def selective_scan(x, dt, A, Bm, Cm, Dp) -> torch.Tensor:
    """The selective scan of ``kmunet_tpu/ops/scan.py::selective_scan``:
    x, dt (B, L, D); A (D, N); B, C (B, L, N); D (D,) -> y (B, L, D) in x's
    dtype, the state in fp32, with its gradient to all six inputs.

    A CPU ``x`` takes the plain versions; a CUDA ``x`` launches K8 (and its
    backward), which take fp32, bf16 and fp16 x, dt, B and C of one dtype,
    and A and D of any float dtype, cast to fp32.
    """
    B, L, D = x.shape
    # per (b, l, d, n): decay 2, dt*B*x 2, the state update 2, C.h 2; the D*x skip 2
    with custom_call(8.0 * B * L * D * A.shape[-1] + 2.0 * B * L * D):
        return SelectiveScan.apply(*(t.contiguous() for t in (x, dt, A, Bm, Cm, Dp)))


selective_scan.launches = 0
selective_scan_backward.launches = 0
