"""A model of the CUDA K7's decomposition (``csrc/multiview_gather.cu``) in
torch on the CPU, held to the plain version ``bilinear_gather_multiview_plain``
in both padding modes, and at TrajGRU's and the bridge's shapes within 1e-5
abs to the JAX package's ``bilinear_gather_multiview_xla`` (the plain
version is held to it at every shape in
tests/test_torch_multiview_gather.py; a jitted JAX function compiles once
per shape and mode, which sets this file's time).

The model follows the kernel: the (output pixel, view) entries in output
order, each reckoned once by one lane of its warp's chunk (the entry's
view, pixel and batch element from its index, its coordinates clamped and
floored, its fractions and its four taps' element offsets in the source, or
-1 for a masked tap); then every channel of the entry blended from those,
the entry's numbers shared by all of them. Two checks come of it. The
check on the entries, the taps, the masks and the output's layout: those
blended with the plain version's lerps equal the plain version bit for bit
in fp32. The model of the kernel's output: the kernel blends with one
weight per tap, the products of the fractions reckoned with the entry,
which rounds otherwise than the lerps, so that blend is held within 1e-5
abs, the card tests' bound of the kernel (and its fused multiply-adds)
against the plain version; the kernel's output is not the plain version's
bit for bit in fp32. The lanes' walk over a chunk's
(entry, channel vector) pairs, a fixed first pair and a fixed step with no
division, is simulated for every chunk size and lane count the kernel can
get: each pair once, 32 consecutive pairs a round (chunk 0, a thread per
pair, maps thread i to pair i). The inputs: every ``MULTIVIEW_SHAPES``
entry and TrajGRU's five K7 shapes and the deformable conv's nine taps at
B=1, on every coordinate case of tests/torch_cases.py.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from kmunet_tpu.ops.sample import bilinear_gather_multiview_xla
from kmunet_tpu_torch.kernels import bilinear
from tests.torch_cases import GATHER_CASES as CASES
from tests.torch_cases import MULTIVIEW_SHAPES, multiview_inputs

MODES = ("zeros", "border")
SMS = 132  # the H100's SMs
# TrajGRU's K7 shapes (B, H, W, C, G, Ho, Wo) at B=1 (128^2 input), and the
# deformable conv at DAGEM's bridge (16^2, C=64, 9 taps).
K7_SHAPES = {
    "enc_rnn1": (1, 32, 32, 64, 13, 32, 32),
    "fore_rnn1": (1, 32, 32, 64, 9, 32, 32),
    "rnn2": (1, 8, 8, 192, 13, 8, 8),
    "enc_rnn3": (1, 4, 4, 192, 9, 4, 4),
    "fore_rnn3": (1, 4, 4, 192, 13, 4, 4),
    "bridge": (1, 16, 16, 64, 9, 16, 16),
}
SHAPES = {**MULTIVIEW_SHAPES, **K7_SHAPES}
# The shapes also held to JAX: C=64 at 32^2, C=192 at 8^2, 9 taps at 16^2.
XLA_SHAPES = ("enc_rnn1", "rnn2", "bridge")


def k7_model(img, x, y, mode):
    """(the CUDA K7's output on ``img`` (B, H, W, C) at ``x``, ``y``
    (B, G, Ho, Wo), blended as the kernel does, with one weight per tap;
    the same entries, taps and masks blended as the plain version does,
    lerps of lerps: the check on those)."""
    B, H, W, C = img.shape
    G, Ho, Wo = x.shape[1:]
    HoWo = Ho * Wo
    # Each entry reckoned once: entry = (b * HoWo + pixel) * G + view.
    entry = torch.arange(B * HoWo * G)
    bp, g = entry // G, entry % G
    b, pixel = bp // HoWo, bp % HoWo
    q = (b * G + g) * HoWo + pixel  # its coordinates' index in x, y
    xs, ys = x.reshape(-1)[q], y.reshape(-1)[q]
    if mode == "zeros":
        xs, ys = xs.clamp(-2.0, W + 1.0), ys.clamp(-2.0, H + 1.0)
    else:
        xs, ys = xs.clamp(0.0, W - 1), ys.clamp(0.0, H - 1)
    x0f, y0f = torch.floor(xs), torch.floor(ys)
    wx, wy = xs - x0f, ys - y0f
    x0, y0 = x0f.long(), y0f.long()
    x1, y1 = x0 + 1, y0 + 1
    if mode == "zeros":
        vx = ((x0 >= 0) & (x0 <= W - 1), (x1 >= 0) & (x1 <= W - 1))
        vy = ((y0 >= 0) & (y0 <= H - 1), (y1 >= 0) & (y1 <= H - 1))
    else:
        x1, y1 = x1.clamp(max=W - 1), y1.clamp(max=H - 1)
        vx = vy = (torch.ones_like(x0, dtype=torch.bool),) * 2
    taps = [torch.where(vy[i] & vx[j], ((b * H + ry) * W + cx) * C, -1)
            for i, ry in enumerate((y0, y1)) for j, cx in enumerate((x0, x1))]
    # Every channel of an entry from its taps and fractions.
    flat = img.reshape(-1, C)
    a = [torch.where((t >= 0)[:, None], flat[t.clamp(min=0) // C], 0.0) for t in taps]
    w = [((1.0 - wx) * (1.0 - wy))[:, None], (wx * (1.0 - wy))[:, None],
         ((1.0 - wx) * wy)[:, None], (wx * wy)[:, None]]
    weights = a[0] * w[0] + a[1] * w[1] + a[2] * w[2] + a[3] * w[3]
    wx, wy = wx[:, None], wy[:, None]
    top = a[0] * (1.0 - wx) + a[1] * wx
    bot = a[2] * (1.0 - wx) + a[3] * wx
    lerps = top * (1.0 - wy) + bot * wy
    return weights.reshape(B, Ho, Wo, G * C), lerps.reshape(B, Ho, Wo, G * C)


def lane_walk(K, nvec):
    """The (entry, vector) pairs each lane of a warp blends in a chunk of K
    entries with nvec channel vectors each, round by round, as the kernel
    steps them: the first pair (lane / nvec, lane % nvec), then 32 pairs on
    by (32 / nvec, 32 % nvec) and a carry."""
    e, v = np.divmod(np.arange(32), nvec)
    de, dv = divmod(32, nvec)
    rounds = []
    for p in range(0, K * nvec, 32):
        live = np.arange(p, p + 32) < K * nvec
        rounds.append([(int(a), int(c)) for a, c, ok in zip(e, v, live) if ok])
        e, v = e + de, v + dv
        carry = v >= nvec
        e, v = e + carry, v - nvec * carry
    return rounds


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The model's tensors are small: one intra-op thread runs it as fast
    alone and does not contend with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.cache
def _xla(mode):
    return jax.jit(lambda i, a, b: bilinear_gather_multiview_xla(i, a, b, mode))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("mode", MODES)
def test_model_matches_plain_and_xla(mode, shape, case):
    img, x, y, _ = multiview_inputs(SHAPES[shape], case)
    args = [torch.from_numpy(a) for a in (img, x, y)]
    want = bilinear.bilinear_gather_multiview_plain(*args, mode)
    got, entries_check = k7_model(*args, mode)
    # The entries, taps, masks and layout: bit for bit.
    torch.testing.assert_close(entries_check, want, rtol=0, atol=0)
    # The kernel's blend: within the card tests' bound.
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    if shape in XLA_SHAPES:
        np.testing.assert_allclose(got.numpy(), np.asarray(_xla(mode)(img, x, y)), rtol=0,
                                   atol=1e-5)


# Channel vectors per entry: C = 3 and 6 (one channel a lane), 64 in bf16
# (8) and fp32 (16), 192 in bf16 (24) and fp32 (48), 16 in fp32 (4).
@pytest.mark.parametrize("nvec", [1, 3, 4, 6, 8, 16, 24, 48])
@pytest.mark.parametrize("K", [1, 2, 3, 7, 32])
def test_lanes_blend_each_pair_once_in_output_order(K, nvec):
    """Every (entry, vector) pair of a chunk once, and each round 32
    consecutive pairs (the output is written in consecutive 16-byte
    vectors), whatever the chunk and the lanes an entry takes."""
    rounds = lane_walk(K, nvec)
    pairs = [pair for r in rounds for pair in r]
    assert pairs == [(e, v) for e in range(K) for v in range(nvec)]
    assert all(len(r) == 32 for r in rounds[:-1])


def test_chunks_fill_the_card():
    """32 entries a warp at TrajGRU's 32^2 levels (B=16) and the bridge
    (B=128); fewer at its 8^2 levels, where 32 would leave most warps of the
    card idle; a thread per pair (0) at its 4^2 levels; 0 or 2 to 32."""
    for shape, want in (("enc_rnn1", 32), ("fore_rnn1", 32), ("bridge", 32), ("rnn2", 6),
                        ("enc_rnn3", 0), ("fore_rnn3", 0)):
        B = 128 if shape == "bridge" else 16
        _, _, _, _, G, Ho, Wo = K7_SHAPES[shape]
        assert bilinear.multiview_chunk(B, G, Ho, Wo, SMS) == want
    assert bilinear.multiview_chunk(1, 1, 1, 1, SMS) == 0
    assert bilinear.multiview_chunk(4096, 16, 64, 64, SMS) == 32
