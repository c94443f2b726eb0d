"""K3a, the HSM-SSD mixer ablation: K3's compress phase and scatter without
the gated MLP, in five modes, in the TPU script's layout: tokens ``xt`` (B,
C, L), ``dt``, ``Bm``, ``Cm`` (B, L, N), ``A`` (N,), all bf16.

    h  = sum over the tiles of xt . w        w = e * Bm, e by the mode  -> (B, C, N)
    yt = bf16(bf16(h / (den + 1)) . Cm^T)                               -> (B, C, L)

The port's counterpart of ``scripts/ablate_mix_kernel.py::run`` (its
``pl.pallas_call`` and ``make_kernel``), a diagnostic of what each piece of
K3's first phase costs. The modes (``MODES``), as the TPU kernel computes
them tile by tile over ``tile`` tokens, every sum in fp32:

- ``full``: the online softmax, its running max starting at 0 (not -inf):
  s = dt + A, e = exp(s - m), w = bf16(e * Bm), den the sum of e;
- ``bf16_e``: the running max is never stored, so each tile takes m =
  max(0, its own max of s) and scales the h and den before it by exp(-m);
  e = bf16(exp(s - m)), w = bf16(e * Bm): the result depends on ``tile``.
  s = dt + A stays fp32 here too: the TPU kernel writes it as a bf16 sum,
  which XLA computes in fp32 and does not round (its excess precision), as
  the kernel in interpret mode shows;
- ``no_max``: e = exp(s), w = bf16(e * Bm);
- ``no_exp``: den sums s itself, w = bf16(s * Bm);
- ``dma_only``: output tile i is bf16(sum of Cm's first 8 tokens of tile i)
  broadcast; the kernel still reads every byte of xt, dt, Bm and Cm.

``ablate_mix`` is what callers use: on CPU tensors it runs the plain version
(``ablate_mix_plain``); on CUDA tensors it launches the CUDA kernel
(``csrc/hsmssd_ablate.cu``, whose source note says what bounds it and how it
is laid out) through ``ablate_mix_forward``, which raises on what the kernel
does not take and counts its calls on ``ablate_mix.launches``. A call is
three or four device launches (two for ``dma_only``). Both refuse ``L %
tile != 0``: the TPU kernel leaves those outputs unwritten.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from kmunet_tpu_torch.kernels import build, sm_count

SOURCE = "hsmssd_ablate.cu"
MODES = ("full", "bf16_e", "no_max", "no_exp", "dma_only")
KTILE = 64  # tokens per tile of the kernel's compress pass (csrc's kTile)
MAX_C = 64
STATE_SIZES = (8, 16, 32, 64)  # N: rows of 16-byte vectors, a divisor of the block
DMA_TOKENS = 8  # dma_only: the tokens of each tile whose Cm it sums
# As K2's and K3's compress pass (kernels/ssd.py): each TPU tile's kernel
# tiles are split into slices, one block each, until B * tiles * slices
# reaches BLOCKS_PER_SM blocks per SM, but of at least MIN_TILES tiles.
BLOCKS_PER_SM = 16
MIN_TILES = 8
MAX_MERGE_SMEM = 200 * 1024  # the merge pass holds a weight per (slice, n)


def _check_shapes(mode, xt, dt, Bm, Cm, A, tile) -> None:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    if xt.dim() != 3:
        raise ValueError(f"want xt (B, C, L); got {tuple(xt.shape)}")
    Bsz, C, L = xt.shape
    if dt.dim() != 3 or dt.shape[:2] != (Bsz, L):
        raise ValueError(f"want dt ({Bsz}, {L}, N); got {tuple(dt.shape)}")
    N = dt.shape[2]
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        if tuple(t.shape) != (Bsz, L, N):
            raise ValueError(f"want {name} ({Bsz}, {L}, {N}); got {tuple(t.shape)}")
    if A.numel() != N:
        raise ValueError(f"want A of {N} values; got {tuple(A.shape)}")
    for name, t in (("xt", xt), ("dt", dt), ("Bm", Bm), ("Cm", Cm), ("A", A)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, as the TPU kernel takes it; got {t.dtype}")
    if tile < 1 or L % tile:
        raise ValueError(f"L = {L} is not a multiple of tile = {tile}: the TPU kernel "
                         "leaves the outputs past its last whole tile unwritten")


def ablate_mix_plain(mode, xt, dt, Bm, Cm, A, tile) -> torch.Tensor:
    """Plain PyTorch version of K3a: yt (B, C, L) bf16, computed tile by tile
    as ``make_kernel`` computes it (``scripts/ablate_mix_kernel.py:17-81``),
    with its casts: w rounded to bf16 before the fp32 products with xt,
    h / (den + 1) rounded to bf16 before the product with Cm, yt rounded
    once."""
    _check_shapes(mode, xt, dt, Bm, Cm, A, tile)
    Bsz, C, L = xt.shape
    N = dt.shape[2]
    n_tiles = L // tile
    f32, bf16 = torch.float32, torch.bfloat16
    if mode == "dma_only":
        sums = Cm.view(Bsz, n_tiles, tile, N)[:, :, :DMA_TOKENS].to(f32).sum((2, 3))
        return sums.to(bf16)[:, None, :, None].expand(Bsz, C, n_tiles, tile).reshape(Bsz, C, L)
    a = A.reshape(1, 1, N)
    m = torch.zeros(Bsz, N, dtype=f32, device=xt.device)
    den = torch.zeros(Bsz, N, dtype=f32, device=xt.device)
    h = torch.zeros(Bsz, C, N, dtype=f32, device=xt.device)
    for i in range(n_tiles):
        tokens = slice(i * tile, (i + 1) * tile)
        s = dt[:, tokens].to(f32) + a.to(f32)
        if mode in ("full", "bf16_e"):
            # bf16_e never stores its max: each tile's is taken against 0.
            m_new = torch.maximum(m, s.amax(1)) if mode == "full" else s.amax(1).clamp_min(0.0)
            scale = torch.exp(m - m_new)
            e = torch.exp(s - m_new[:, None])
            if mode == "bf16_e":
                e = e.to(bf16).to(f32)
            else:
                m = m_new
            den = den * scale + e.sum(1)
            h = h * scale[:, None]
        else:
            e = torch.exp(s) if mode == "no_max" else s
            den = den + e.sum(1)
        w = (e * Bm[:, tokens].to(f32)).to(bf16)
        h = h + torch.einsum("bct,btn->bcn", xt[:, :, tokens].to(f32), w.to(f32))
    hn = (h / (den[:, None] + 1.0)).to(bf16)
    return torch.einsum("bcn,bln->bcl", hn.to(f32), Cm.to(f32)).to(bf16)


@functools.cache
def kernel() -> ctypes._CFuncPtr:
    """K3a's entry point, built from ``csrc/hsmssd_ablate.cu`` on first use:
    the mode, 12 pointers, 7 ints, then the stream."""
    fn = ctypes.CDLL(str(build.build(SOURCE).path)).kmunet_hsmssd_ablate
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(xt, dt, Bm, Cm, tile) -> None:
    """What the kernel takes: contiguous CUDA tensors on one device, N a
    power of two in STATE_SIZES, 1 <= C <= MAX_C, tiles of whole KTILE-token
    kernel tiles."""
    Bsz, C, L = xt.shape
    N = dt.shape[2]
    for name, t in (("xt", xt), ("dt", dt), ("Bm", Bm), ("Cm", Cm)):
        if not t.is_cuda or t.device != xt.device:
            raise ValueError(f"the CUDA K3a kernel needs CUDA tensors on one device; "
                             f"{name} is on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if N not in STATE_SIZES:
        raise ValueError(f"the kernel takes a state size N in {STATE_SIZES}, got {N}")
    if not 1 <= C <= MAX_C:
        raise ValueError(f"the kernel takes 1 <= C <= {MAX_C}, got {C}")
    if tile % KTILE:
        raise ValueError(f"the kernel takes a tile of whole {KTILE}-token tiles, got {tile}")
    if not 1 <= Bsz <= 65535:
        raise ValueError(f"the kernel takes 1 <= B <= 65535, got {Bsz}")


def _slices(Bsz, L, tile, sm_count) -> tuple[int, int]:
    """(spt, tps): each TPU tile's ``tile // KTILE`` kernel tiles go to spt
    slices of tps tiles, one block each (BLOCKS_PER_SM, MIN_TILES)."""
    per_tile = tile // KTILE
    want = max(1, -(-BLOCKS_PER_SM * sm_count // (Bsz * (L // tile))))
    tps = min(per_tile, max(MIN_TILES, -(-per_tile // want)))
    return -(-per_tile // tps), tps


def ablate_mix_forward(mode, xt, dt, Bm, Cm, A, tile) -> torch.Tensor:
    """K3a on CUDA tensors: yt (B, C, L) bf16. Raises on what the kernel
    does not take. Counts one call on ``ablate_mix.launches``."""
    _check_shapes(mode, xt, dt, Bm, Cm, A, tile)
    _check(xt, dt, Bm, Cm, tile)
    Bsz, C, L = xt.shape
    N = dt.shape[2]
    n_tiles = L // tile
    spt, tps = _slices(Bsz, L, tile, sm_count(xt.device.index))
    S = n_tiles * spt
    if 4 * (S * N + N) > MAX_MERGE_SMEM:
        raise ValueError(f"{S} slices of {N} states: the merge pass's weights exceed "
                         f"{MAX_MERGE_SMEM} bytes of shared memory; take a larger tile")
    f32 = dict(dtype=torch.float32, device=xt.device)
    A32 = A.reshape(N).float().contiguous()
    # full's and bf16_e's per-tile maxima, max(0, .), gathered by atomics from 0.
    tmax = torch.zeros(Bsz, n_tiles, N, **f32) if mode in ("full", "bf16_e") else None
    part_m, part_d = torch.empty(Bsz, S, N, **f32), torch.empty(Bsz, S, N, **f32)
    part_h = torch.empty(Bsz, S, N, C, **f32)
    hn = torch.empty(Bsz, N, C, **f32)
    sink = torch.empty(Bsz, L // KTILE, **f32)  # dma_only's checksums of what it loads
    yt = torch.empty_like(xt)
    with torch.cuda.device(xt.device):
        stream = torch.cuda.current_stream(xt.device).cuda_stream
        err = kernel()(MODES.index(mode), xt.data_ptr(), dt.data_ptr(), Bm.data_ptr(),
                       Cm.data_ptr(), A32.data_ptr(), None if tmax is None else tmax.data_ptr(),
                       part_m.data_ptr(), part_d.data_ptr(), part_h.data_ptr(), hn.data_ptr(),
                       sink.data_ptr(), yt.data_ptr(), Bsz, C, L, N, tile, spt, tps, stream)
    if err != 0:
        raise RuntimeError(f"kmunet_hsmssd_ablate ({mode}) launch failed: error {err}")
    ablate_mix.launches += 1
    return yt


def ablate_mix(mode, xt, dt, Bm, Cm, A, tile) -> torch.Tensor:
    """yt (B, C, L) bf16 of ``mode``: the plain version on a CPU ``xt``,
    the CUDA kernel on a CUDA ``xt``."""
    if xt.device.type == "cpu":
        return ablate_mix_plain(mode, xt, dt, Bm, Cm, A, tile)
    return ablate_mix_forward(mode, xt, dt, Bm, Cm, A, tile)


ablate_mix.launches = 0
