"""K8's chunk-parallel formulation, as csrc/selective_scan.cu computes it,
modelled in numpy and held to the JAX package's ``_selective_scan_xla`` and
``jax.vjp`` of it on the CPU.

The model runs the kernels' passes on their own arithmetic, in fp32: L cut
into chunks of T tokens (the last one ragged, padded with zeros: dt = 0
leaves a state as it is, g = 0 a message), each token's decay
2^(dt * f32(A * log2 e)); the forward summaries of every chunk at once (the
local end state E from a zero state and S = sum dt, the chunk's decay
exp(A S) taken as 2^(f32(A log2 e) * S)) and the reverse summary (the
message m0 = sum_t P_t g_t C_t the chunk sends out of its first token, P_t
the running product of its decays); the carry pass both ways in chunk
order, h_in(c) = decay(c-1) h_in(c-1) + E(c-1) and m_in(c) = m0(c+1) +
decay(c+1) m_in(c+1), composed over 16 runs of chunks as the kernel's
warps compose them; the rebuild, y = sum_n C h + D x with the sum over n
in the kernel's order (a chain of fmas over each thread's 4 states, then a
butterfly over the channel's threads); the backward's rebuild and reverse walk per
chunk from h_in and m_in, dx and ddt summed over n, dB and dC over d, and
dA and dD as fp32 partials per (b, chunk), summed over each backward
sub-chunk's tokens from the last, then over the sub-chunks, then over
(b, chunk).

The chunks are shrunk (8 tokens in the backward, 4 in the forward; the
kernels' are 64 and 32, or 16 for a short L) so that the shapes stay small:
L a multiple of T, k T + 1, T - 1 and 1, ragged D, N of 1, 4 and 16, with
the ``mamba``, ``small`` and ``large`` dt of ``chip_smoke.scan_inputs``;
one case runs the kernels' own chunks. Tolerance: y within 1e-5 and each gradient within 1e-4 of its
largest |value| of XLA's, as tests/test_torch_selective_scan.py holds the
plain version (fp32 sums over up to L = 65 tokens and D = 24 channels, in
another order than XLA's log-depth scan). Against the float64 plain
version, the model lies no farther than ``selective_scan_plain`` over a
long memory, where the carries replace a chain of L rounded products by
L / T short ones, and within ``chip_smoke.scan_reference``'s bound over a
short one, where the two differ by rounding only. The kernels themselves
are held to the plain versions on the card (chip_smoke.py,
tests/test_torch_gpu.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from kmunet_tpu.ops.scan import _selective_scan_xla
from kmunet_tpu_torch.kernels import scan
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse: one torch thread)

f32 = np.float32
LOG2E = f32(1.4426950408889634)
T_MODEL, Q_MODEL, T_FWD_MODEL = 8, 4, 4  # the model's backward chunk, sub-chunk, forward chunk
KERNEL_T, KERNEL_Q = 64, 8  # the kernels' (csrc's kT and kQ)
CARRY_RUNS = 16  # runs of chunks in the carry pass (csrc's kCarryWarps)
WALK_STATES = 4  # states per thread of the walks (csrc's kNSMax)
NAMES = ("y", "dx", "ddt", "dA", "dB", "dC", "dD")


def _sum_c_h(c, h):
    """sum_n c h over the last axis as the output pass takes it: each part of
    WALK_STATES states by a chain of fmas (emulated: the product exact in
    float64, one rounding per step), then the parts by a butterfly, the
    partner at distance P/2 first."""
    N = c.shape[-1]
    ns = min(N, WALK_STATES)
    parts = []
    for k in range(N // ns):
        acc = np.zeros(c.shape[:-1], f32)
        for n in range(k * ns, (k + 1) * ns):
            acc = (c[..., n].astype(np.float64) * h[..., n] + acc).astype(f32)
        parts.append(acc)
    off = len(parts) // 2
    while off > 0:
        parts = [parts[i] + parts[i ^ off] for i in range(len(parts))]
        off //= 2
    return parts[0]


def _carry(decay, V, forward):
    """The carry pass over the chunks (axis 1) as the kernel runs it: the
    chunks split into CARRY_RUNS runs in order; each run's transfer
    v -> P v + e composed over its chunks in the direction of the walk; a
    run's entry value the transfers of the runs before it applied in order
    to zero; then the run walked again, each chunk's entry value kept:
    h_in(c) = decay(c-1) h_in(c-1) + E(c-1) forward, m_in(c) = decay(c+1)
    m_in(c+1) + M0(c+1) in reverse."""
    C = V.shape[1]
    run = -(-C // CARRY_RUNS)
    runs = [(min(C, w * run), min(C, w * run + run)) for w in range(CARRY_RUNS)]

    def chunks(c0, c1):
        return range(c0, c1) if forward else range(c1 - 1, c0 - 1, -1)

    P, e = [], []
    for c0, c1 in runs:
        p, v = np.ones_like(V[:, 0]), np.zeros_like(V[:, 0])
        for c in chunks(c0, c1):
            v = decay[:, c] * v + V[:, c]
            p = p * decay[:, c]
        P.append(p)
        e.append(v)
    out = np.empty_like(V)
    for w, (c0, c1) in enumerate(runs):
        h = np.zeros_like(V[:, 0])
        for k in (range(w) if forward else range(CARRY_RUNS - 1, w, -1)):
            h = P[k] * h + e[k]
        for c in chunks(c0, c1):
            out[:, c] = h
            h = decay[:, c] * h + V[:, c]
    return out


def chunked_model(x, dt, A, Bm, Cm, Dp, g, T, Q, T_fwd):
    """(y, dx, ddt, dA, dB, dC, dD) by the kernels' passes, in fp32: y with
    forward chunks of T_fwd tokens, the gradients with chunks of T tokens
    and backward sub-chunks of Q."""
    y = _passes(x, dt, A, Bm, Cm, Dp, g, T_fwd, Q)[0]
    return (y, *_passes(x, dt, A, Bm, Cm, Dp, g, T, Q)[1:])


def _passes(x, dt, A, Bm, Cm, Dp, g, T, Q):
    Bsz, L, D = x.shape
    N = A.shape[1]
    C = -(-L // T)

    def chunked(v):  # (B, L, ...) -> (B, C, T, ...), zeros past the last token
        pad = np.zeros((Bsz, C * T - L) + v.shape[2:], f32)
        return np.concatenate([v, pad], 1).reshape((Bsz, C, T) + v.shape[2:])

    xc, dtc, Bc, Cc, gc = (chunked(v) for v in (x, dt, Bm, Cm, g))
    a2 = (A * LOG2E).astype(f32)
    a = np.exp2(dtc[..., None] * a2).astype(f32)  # (B, C, T, D, N)
    inc = ((dtc * xc)[..., None] * Bc[:, :, :, None, :]).astype(f32)
    gC = (gc[..., None] * Cc[:, :, :, None, :]).astype(f32)

    # Summaries of every chunk at once: E, S and the reverse message m0.
    E = np.zeros((Bsz, C, D, N), f32)
    P = np.ones((Bsz, C, D, N), f32)
    M0 = np.zeros((Bsz, C, D, N), f32)
    S = np.zeros((Bsz, C, D), f32)
    for t in range(T):
        E = a[:, :, t] * E + inc[:, :, t]
        S = S + dtc[:, :, t]
        P = P * a[:, :, t]
        M0 = P * gC[:, :, t] + M0
    decay = np.exp2(a2 * S[..., None]).astype(f32)

    # The carry pass, forward and in reverse.
    h_in = _carry(decay, E, forward=True)
    m_in = _carry(decay, M0, forward=False)

    # The rebuild: every chunk's states from its entry state.
    states = np.empty_like(a)
    h = h_in
    for t in range(T):
        h = a[:, :, t] * h + inc[:, :, t]
        states[:, :, t] = h
    y = _sum_c_h(np.broadcast_to(Cc[:, :, :, None, :], states.shape), states) + xc * Dp
    h_prev = np.concatenate([h_in[:, :, None], states[:, :, :-1]], 2)

    # The backward's reverse walk per chunk from its incoming message.
    hh = np.empty_like(a)
    m = m_in
    for t in range(T - 1, -1, -1):
        hh[:, :, t] = gC[:, :, t] + m
        m = a[:, :, t] * hh[:, :, t]
    p = hh * h_prev * a
    dx = (hh * Bc[:, :, :, None, :]).sum(-1, dtype=f32) * dtc + gc * Dp
    ddt = ((hh * xc[..., None]) * Bc[:, :, :, None, :] + p * A).sum(-1, dtype=f32)
    dB = (hh * (dtc * xc)[..., None]).sum(3, dtype=f32)
    dC = (gc[..., None] * states).sum(3, dtype=f32)
    dA_part = np.zeros((Bsz, C, D, N), f32)
    dD_part = np.zeros((Bsz, C, D), f32)
    for k in range(T // Q - 1, -1, -1):  # a lane's sums: the sub-chunks from the last
        da = np.zeros_like(dA_part)
        dd = np.zeros_like(dD_part)
        for t in range(k * Q + Q - 1, k * Q - 1, -1):
            da = p[:, :, t] * dtc[:, :, t, :, None] + da
            dd = gc[:, :, t] * xc[:, :, t] + dd
        dA_part = dA_part + da
        dD_part = dD_part + dd
    dA = dA_part.sum((0, 1), dtype=f32)
    dD = dD_part.sum((0, 1), dtype=f32)

    def unchunked(v):
        return v.reshape((Bsz, C * T) + v.shape[3:])[:, :L]

    return (unchunked(y), unchunked(dx), unchunked(ddt), dA, unchunked(dB), unchunked(dC), dD)


def kernel_forward_chunk(Bsz, L, D, N):
    """The forward kernels' chunk at a shape (csrc's forward_chunk): 32
    tokens, halved down to 16 while the walks would have fewer than 64 K
    threads (N / min(N, 4) per channel)."""
    T, parts = 32, N // min(N, 4)
    while T > 16 and Bsz * -(-L // T) * D * parts < 65536:
        T //= 2
    return T


@functools.cache
def _xla_vjp():
    def run(args, g):
        y, vjp = jax.vjp(_selective_scan_xla, *args)
        return (y, *vjp(g))

    return jax.jit(run)


def _inputs(shape, dt_case):
    args, g = chip_smoke.scan_inputs(np, np.random.default_rng(sum(shape)), shape, dt_case)
    return args, g


CASES = {  # (B, L, D, N) with the model's T = 8
    "l_4t": (2, 32, 6, 4),
    "l_4t_plus_1": (2, 33, 5, 16),
    "l_8t_plus_1_n1": (1, 65, 24, 1),
    "l_t_minus_1": (2, 7, 6, 16),
    "l1": (2, 1, 6, 4),
    "d5_n1": (2, 20, 5, 1),
}


@pytest.mark.parametrize("dt_case", chip_smoke.SCAN_DT_CASES)
@pytest.mark.parametrize("case", list(CASES))
def test_chunked_model_matches_xla_vjp(case, dt_case):
    args, g = _inputs(CASES[case], dt_case)
    got = chunked_model(*args, g, T_MODEL, Q_MODEL, T_FWD_MODEL)
    want = [np.asarray(v) for v in _xla_vjp()([jnp.asarray(a) for a in args], jnp.asarray(g))]
    for name, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape and a.dtype == b.dtype == f32, name
        rel = 1e-5 if name == "y" else 1e-4
        np.testing.assert_allclose(a, b, rtol=0, atol=rel * np.abs(b).max(), err_msg=name)


def test_chunked_model_at_the_kernels_chunk():
    """The kernels' chunks: the backward's T = 64 over three whole chunks
    and one token, the forward's 16 at this shape."""
    shape = (2, 3 * KERNEL_T + 1, 6, 4)
    args, g = _inputs(shape, "mamba")
    got = chunked_model(*args, g, KERNEL_T, KERNEL_Q, kernel_forward_chunk(*shape))
    want = [np.asarray(v) for v in _xla_vjp()([jnp.asarray(a) for a in args], jnp.asarray(g))]
    for name, a, b in zip(NAMES, got, want):
        rel = 1e-5 if name == "y" else 1e-4
        np.testing.assert_allclose(a, b, rtol=0, atol=rel * np.abs(b).max(), err_msg=name)


def _plain(args, g, dtype):
    t = [torch.from_numpy(a).to(dtype) for a in args]
    gt = torch.from_numpy(g).to(dtype)
    out = (scan.selective_scan_plain(*t), *scan.selective_scan_backward_plain(*t, gt))
    return [o.double().numpy() for o in out]


def _distances(shape, dt_case):
    """Per output: the model's (the kernels' chunks) and the fp32 plain version's largest
    distance from the float64 plain version, and that one's largest |value|."""
    args, g = _inputs(shape, dt_case)
    exact = _plain(args, g, torch.float64)
    plain = _plain(args, g, torch.float32)
    model = chunked_model(*args, g, KERNEL_T, KERNEL_Q, kernel_forward_chunk(*shape))
    return [(name, np.abs(m.astype(np.float64) - e).max(), np.abs(p - e).max(), np.abs(e).max())
            for name, m, p, e in zip(NAMES, model, plain, exact)]


def test_chunked_model_is_no_farther_from_float64_over_a_long_memory():
    """dt "small" (decays near 1, memory over the whole sequence) at L =
    2000, 32 chunks: per output, the model lies no farther from float64 than
    the plain version, whose states are chains of up to 2000 rounded
    products where the model's are chains of at most 64 plus 31 carries."""
    for name, err_model, err_plain, _ in _distances((2, 2000, 4, 16), "small"):
        assert err_model <= err_plain, (name, err_model, err_plain)


@pytest.mark.parametrize("dt_case", chip_smoke.SCAN_DT_CASES)
@pytest.mark.parametrize("shape", [(2, 600, 6, 16), (1, 257, 24, 4)])
def test_chunked_model_lies_within_the_kernels_bound_over_a_short_memory(shape, dt_case):
    """Over a short memory the two differ by rounding only, and the model may
    lie farther from float64 than the plain version (measured: its largest
    distance 0.3-2.5 times the plain version's, per output; ``pytest -s``
    prints the ratios): it lies inside the bound that
    ``chip_smoke.scan_reference`` gives the kernels, 4 times the plain
    version's distance plus 1e-6 of the largest |value|."""
    distances = _distances(shape, dt_case)
    print(shape, dt_case, {name: round(float(em / ep), 2) if ep > 0 else None
                           for name, em, ep, _ in distances})
    for name, err_model, err_plain, top in distances:
        assert err_model <= 4.0 * err_plain + 1e-6 * top, (name, err_model, err_plain)
