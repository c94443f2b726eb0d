"""K2 and K3, the HSM-SSD mixer's online-softmax compress and the fused
mixer, in the port's layout: tokens ``x`` (B, C, L) as ``nn/ssd.py`` holds
them, ``dt``, ``B`` and ``C`` (B, N, L), which may be the strided slices of
the mixer's one (B, 3N, L) ``bcdt`` tensor.

    K2  h  = x (softmax_L(dt + A) * B)^T                      -> (B, N, C)
    K3  h_, z = split(h W_hz^T);  h2 = (h_ silu(z) + h_ D) W_out^T
        y  = h2^T C                                           -> (B, C, L), (B, N, C)

The port's counterparts of ``kmunet_tpu/kernels/ssd_pallas.py::
hsmssd_compress`` and ``kmunet_tpu/kernels/ssd_mix_pallas.py::hsmssd_mix``;
both CUDA kernels are in ``csrc/hsmssd.cu``, whose source note says what
bounds them and how they are laid out. ``w_hz`` (2C, C) and ``w_out`` (C, C)
are the ``nn.Linear`` weights as ``HSMSSD`` stores them.

``hsmssd_compress`` and ``hsmssd_mix`` are what callers use: on a CPU tensor
they run the plain versions (autograd differentiates them); on a CUDA tensor
they apply ``HSMSSDCompress`` and ``HSMSSDMix``, autograd functions whose
forward launches the kernel and whose backward recomputes through the plain
version and returns its autograd gradients, as the JAX package's custom VJPs
return those of their XLA references. Nothing falls back: the launchers
(``hsmssd_compress_forward``, ``hsmssd_mix_forward``) raise on anything they
do not take, a CPU tensor included. Each counts its calls, one per mixer
forward, on ``hsmssd_compress.launches`` and ``hsmssd_mix.launches`` (a call
of K2 is two device launches, compress and merge, one of K3 three, with the
scatter; on the wide path, past 64 channels or states, five: compress,
merge, the MLP's two products and the scatter; see the source note). The
kernels take any N and C; ``plan`` raises where a pass's shared memory
would not fit a block.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from kmunet_tpu_torch.kernels import build, sm_count

SOURCE = "hsmssd.cu"
TILE = 64  # tokens per tile of the compress and scatter passes (csrc's kT)
# The kernels take any N >= 1 (16 states per warp, the last group padded)
# and any C >= 1: up to NARROW channels and states the compress holds a
# batch element's every state and channel in one block and the merge runs
# the MLP; past it (the wide path: the EfficientViM classifier) the compress
# splits its warps over 16-state groups and 64-channel chunks and the MLP
# runs as two tiled products (see the source note).
NARROW = 64
# The compress pass splits each batch element's tiles into slices, one block
# each, until B * slices reaches BLOCKS_PER_SM blocks per SM (a small batch
# must still fill the card), but of at least MIN_TILES tiles, so that the
# partials and the merge over them stay small against the tokens read.
BLOCKS_PER_SM = 16
MIN_TILES = 8
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _work_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def _check_shapes(x, dt, Bm, A, Cm=None, w_hz=None, w_out=None, D=None) -> None:
    if x.dim() != 3:
        raise ValueError(f"want x (B, C, L); got {tuple(x.shape)}")
    Bsz, C, L = x.shape
    if dt.dim() != 3 or dt.shape[0] != Bsz or dt.shape[2] != L:
        raise ValueError(f"want dt ({Bsz}, N, {L}); got {tuple(dt.shape)}")
    N = dt.shape[1]
    for name, t in (("B", Bm), ("C", Cm)):
        if t is not None and tuple(t.shape) != (Bsz, N, L):
            raise ValueError(f"want {name} ({Bsz}, {N}, {L}); got {tuple(t.shape)}")
    if tuple(A.shape) != (N,):
        raise ValueError(f"want A ({N},); got {tuple(A.shape)}")
    if w_hz is not None and tuple(w_hz.shape) != (2 * C, C):
        raise ValueError(f"want w_hz ({2 * C}, {C}); got {tuple(w_hz.shape)}")
    if w_out is not None and tuple(w_out.shape) != (C, C):
        raise ValueError(f"want w_out ({C}, {C}); got {tuple(w_out.shape)}")
    if D is not None and D.numel() != 1:
        raise ValueError(f"want one D; got {tuple(D.shape)}")


def hsmssd_compress_plain(x, dt, Bm, A) -> torch.Tensor:
    """Plain PyTorch version of K2, the port of ``hsmssd_compress_reference``
    (``ssd_pallas.py:99``): x (B, C, L); dt, B (B, N, L); A (N,) -> h (B, N, C)
    in x's dtype, computed in (at least) fp32."""
    _check_shapes(x, dt, Bm, A)
    wd = _work_dtype(x)
    att = torch.softmax(dt.to(wd) + A.to(wd)[None, :, None], dim=2)
    return torch.einsum("bcl,bnl->bnc", x.to(wd), att * Bm.to(wd)).to(x.dtype)


def hsmssd_mix_plain(x, dt, Bm, Cm, A, w_hz, w_out, D):
    """Plain PyTorch version of K3, the port of ``hsmssd_mix_reference``
    (``ssd_mix_pallas.py:193``): (y (B, C, L), h2 (B, N, C)) in x's dtype,
    computed in (at least) fp32, with h2 rounded to x's dtype before the
    scatter, as the TPU kernel rounds it."""
    _check_shapes(x, dt, Bm, A, Cm, w_hz, w_out, D)
    wd = _work_dtype(x)
    att = torch.softmax(dt.to(wd) + A.to(wd)[None, :, None], dim=2)
    h = torch.einsum("bcl,bnl->bnc", x.to(wd), att * Bm.to(wd))
    h_, z = (h @ w_hz.to(wd).T).chunk(2, dim=-1)
    h2 = ((h_ * F.silu(z) + h_ * D.to(wd).reshape(())) @ w_out.to(wd).T).to(x.dtype)
    y = torch.einsum("bnc,bnl->bcl", h2.to(wd), Cm.to(wd))
    return y.to(x.dtype), h2


@functools.cache
def _kernel(name: str, n_pointers: int, n_ints: int, n_longs: int) -> ctypes._CFuncPtr:
    """The C entry ``name`` of the library built from ``csrc/hsmssd.cu``:
    ``n_pointers`` tensor pointers, ``n_ints`` ints, ``n_longs`` 64-bit
    batch strides, the dtype code, then the stream."""
    fn = getattr(ctypes.CDLL(str(build.build(SOURCE).path)), name)
    fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints
                   + [ctypes.c_longlong] * n_longs + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def compress_kernel() -> ctypes._CFuncPtr:
    """K2's entry point, built on first use."""
    return _kernel("kmunet_hsmssd_compress", 8, 7, 2)


def mix_kernel() -> ctypes._CFuncPtr:
    """K3's entry point, built on first use (from the same source)."""
    return _kernel("kmunet_hsmssd_mix", 15, 7, 3)


@functools.cache
def _plan_entry() -> ctypes._CFuncPtr:
    fn = getattr(ctypes.CDLL(str(build.build(SOURCE).path)), "kmunet_hsmssd_plan")
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    return fn


def plan(C: int, N: int, dtype: torch.dtype, device: torch.device) -> tuple[int, bool]:
    """(cpt, wide) of a call at (C, N) in ``dtype`` on ``device``: the
    channels of a compress partial's row and whether the wide path runs.
    Raises ValueError where a pass's shared memory would exceed the
    device's block limit: N in the thousands, which no model of the repo
    comes near (the largest N is 64)."""
    cpt, wide = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        err = _plan_entry()(C, N, _DTYPE_CODES[dtype], ctypes.byref(cpt), ctypes.byref(wide))
    if err == -2:
        raise ValueError(f"the mixer kernels at C={C}, N={N} in {dtype} need more shared "
                         "memory a block than the device has (the scatter stages N rows of "
                         "C per tile): no model of the repo comes near (largest N: 64)")
    if err != 0:
        raise ValueError(f"the mixer kernels do not take C={C}, N={N}")
    return cpt.value, bool(wide.value)


def _check(x, dt, Bm, Cm=None) -> None:
    """What the kernels take: CUDA tensors of one dtype, x contiguous, dt,
    B and C with contiguous tokens and rows of L (any batch stride)."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x dtype {x.dtype} not in {list(_DTYPE_CODES)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    Bsz, C, L = x.shape
    N = dt.shape[1]
    for name, t in (("dt", dt), ("B", Bm), ("C", Cm)):
        if t is None:
            continue
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f"{name} must be {x.dtype} on {x.device}, got {t.dtype} on {t.device}")
        if t.stride(2) != 1 or t.stride(1) != L:
            raise ValueError(f"{name} must have contiguous rows of L tokens, strides "
                             f"{t.stride()}")
    if min(Bsz, C, L, N) < 1 or Bsz > 65535:
        raise ValueError(f"the kernels take 1 <= B <= 65535 and C, L, N >= 1, got x "
                         f"{tuple(x.shape)}, N={N}")
    if not x.is_cuda:
        raise ValueError(f"the CUDA mixer kernels need a CUDA tensor, got {x.device}")


def _slices(x) -> tuple[int, int]:
    """(S, tps): the compress pass splits each batch element's tiles into S
    slices of tps tiles (the module's BLOCKS_PER_SM and MIN_TILES)."""
    Bsz, _, L = x.shape
    tiles = -(-L // TILE)
    want = max(1, -(-BLOCKS_PER_SM * sm_count(x.device.index) // Bsz))
    tps = max(MIN_TILES, -(-tiles // want))
    return -(-tiles // tps), tps


def _scratch(x, N, S, cpt):
    """The compress pass's fp32 partials per (b, slice): max and
    denominator (B, S, N), unnormalised h (B, S, N, cpt)."""
    Bsz = x.shape[0]
    f32 = dict(dtype=torch.float32, device=x.device)
    return (torch.empty(Bsz, S, N, **f32), torch.empty(Bsz, S, N, **f32),
            torch.empty(Bsz, S, N, cpt, **f32))


def _aligned(*tensors) -> int:
    """1 where the tiles can move by 16-byte copies: every base address,
    batch stride and row of L tokens a multiple of 16 bytes (the kernels
    then fill their tiles by cp.async, else by plain loads)."""
    for t in tensors:
        esz = t.element_size()
        if t.data_ptr() % 16 or (t.stride(0) * esz) % 16 or (t.stride(1) * esz) % 16:
            return 0
    return 1


def _launch(fn, x, *args) -> None:
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*args, _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: error {err}")


def hsmssd_compress_forward(x, dt, Bm, A) -> torch.Tensor:
    """K2 on CUDA tensors: h (B, N, C) in x's dtype; A of any float dtype,
    cast to fp32. Raises on what the kernel does not take. Counts one call on
    ``hsmssd_compress.launches``."""
    _check_shapes(x, dt, Bm, A)
    _check(x, dt, Bm)
    Bsz, C, L = x.shape
    N = dt.shape[1]
    S, tps = _slices(x)
    cpt, _ = plan(C, N, x.dtype, x.device)
    A32 = A.float().contiguous()
    part_m, part_d, part_h = _scratch(x, N, S, cpt)
    h = torch.empty(Bsz, N, C, dtype=x.dtype, device=x.device)
    _launch(compress_kernel(), x, x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), A32.data_ptr(),
            part_m.data_ptr(), part_d.data_ptr(), part_h.data_ptr(), h.data_ptr(),
            Bsz, C, L, N, S, tps, _aligned(x, dt, Bm), dt.stride(0), Bm.stride(0))
    hsmssd_compress.launches += 1
    return h


def hsmssd_mix_forward(x, dt, Bm, Cm, A, w_hz, w_out, D):
    """K3 on CUDA tensors: (y (B, C, L), h2 (B, N, C)) in x's dtype; A,
    w_hz, w_out and D of any float dtype, cast to fp32. Raises on what the
    kernel does not take. Counts one call on ``hsmssd_mix.launches``."""
    _check_shapes(x, dt, Bm, A, Cm, w_hz, w_out, D)
    _check(x, dt, Bm, Cm)
    Bsz, C, L = x.shape
    N = dt.shape[1]
    S, tps = _slices(x)
    cpt, wide = plan(C, N, x.dtype, x.device)
    A32, whz32, wout32, D32 = (t.float().contiguous() for t in (A, w_hz, w_out, D))
    part_m, part_d, part_h = _scratch(x, N, S, cpt)
    # The wide path's merged h and h W_hz^T, fp32, for the MLP's products.
    h32, hz32 = ((torch.empty(Bsz, N, k * C, dtype=torch.float32, device=x.device)
                  for k in (1, 2)) if wide else (None, None))
    y = torch.empty_like(x)
    h2 = torch.empty(Bsz, N, C, dtype=x.dtype, device=x.device)
    _launch(mix_kernel(), x, x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            A32.data_ptr(), whz32.data_ptr(), wout32.data_ptr(), D32.data_ptr(),
            part_m.data_ptr(), part_d.data_ptr(), part_h.data_ptr(),
            h32.data_ptr() if wide else None, hz32.data_ptr() if wide else None, y.data_ptr(),
            h2.data_ptr(), Bsz, C, L, N, S, tps, _aligned(x, dt, Bm, Cm, y), dt.stride(0),
            Bm.stride(0), Cm.stride(0))
    hsmssd_mix.launches += 1
    return y, h2


def plain_gradients(plain, inputs, needs, grads):
    """The gradients of ``plain(*inputs)`` for the output gradients
    ``grads``, by autograd of the plain version: the backward of K1-K3, as
    the JAX package's custom VJPs are the autodiff of its references. None
    for an input whose ``needs`` entry is false."""
    leaves = [t.detach().requires_grad_(need) for t, need in zip(inputs, needs)]
    with torch.enable_grad():
        out = plain(*leaves)
    out = out if isinstance(out, tuple) else (out,)
    wrt = [t for t in leaves if t.requires_grad]
    got = iter(torch.autograd.grad(out, wrt, grads, allow_unused=True))
    return tuple(next(got) if t.requires_grad else None for t in leaves)


class HSMSSDCompress(torch.autograd.Function):
    """K2 forward, the plain version's gradient backward."""

    @staticmethod
    def forward(ctx, x, dt, Bm, A):
        ctx.save_for_backward(x, dt, Bm, A)
        return hsmssd_compress_forward(x, dt, Bm, A)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return plain_gradients(hsmssd_compress_plain, ctx.saved_tensors, ctx.needs_input_grad,
                                (g,))


class HSMSSDMix(torch.autograd.Function):
    """K3 forward, the plain version's gradient backward."""

    @staticmethod
    def forward(ctx, x, dt, Bm, Cm, A, w_hz, w_out, D):
        ctx.save_for_backward(x, dt, Bm, Cm, A, w_hz, w_out, D)
        return hsmssd_mix_forward(x, dt, Bm, Cm, A, w_hz, w_out, D)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gy, gh2):
        return plain_gradients(hsmssd_mix_plain, ctx.saved_tensors, ctx.needs_input_grad,
                                (gy, gh2))


def _token_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` (B, N, L) as the kernels read it: rows of L contiguous tokens,
    any batch stride (a slice of (B, 3N, L) already is)."""
    return t if t.stride(2) == 1 and t.stride(1) == t.shape[2] else t.contiguous()


def hsmssd_compress(x, dt, Bm, A) -> torch.Tensor:
    """h = x (softmax_L(dt + A) * B)^T, (B, N, C) in x's dtype, with its
    gradient: the plain version on a CPU ``x``, K2 on a CUDA ``x``."""
    if x.device.type == "cpu":
        return hsmssd_compress_plain(x, dt, Bm, A)
    return HSMSSDCompress.apply(x.contiguous(), _token_rows(dt), _token_rows(Bm), A)


def hsmssd_mix(x, dt, Bm, Cm, A, w_hz, w_out, D):
    """The mixer after the ``bcdt`` conv: (y (B, C, L), h2 (B, N, C)) in x's
    dtype, with their gradients: the plain version on a CPU ``x``, K3 on a
    CUDA ``x``."""
    if x.device.type == "cpu":
        return hsmssd_mix_plain(x, dt, Bm, Cm, A, w_hz, w_out, D)
    return HSMSSDMix.apply(x.contiguous(), _token_rows(dt), _token_rows(Bm), _token_rows(Cm), A,
                           w_hz, w_out, D)


hsmssd_compress.launches = 0
hsmssd_mix.launches = 0

