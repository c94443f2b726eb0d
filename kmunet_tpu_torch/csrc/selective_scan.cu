// K8: the selective scan (Mamba's S6 recurrence) and its backward.
//
//   h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t      h: (D, N) per sequence
//   y_t = C_t . h_t + D * x_t
//
// x, dt, y (B, L, D); A (D, N) fp32; B, C (B, L, N); D (D,) fp32; x, dt, B, C
// and y in one dtype (fp32, bf16 or fp16); the state and all arithmetic fp32.
//
// Replaces the TPU kernels of kmunet_tpu/kernels/scan_pallas.py:
//   forward   selective_scan_pallas (pl.pallas_call in _forward), what
//             ops/scan.py::_selective_scan_xla computes;
//   backward  its custom VJP's _backward (pl.pallas_call of _bwd_kernel): the
//             six gradients dx, ddt, dA, dB, dC, dD.
//
// Design. The TPU kernel walks the chunks of L in order on one core and runs
// a log-depth scan inside each chunk in VMEM. Here the chunks run in
// parallel, with a carry pass between them. L is cut into chunks (the last
// one ragged): kTf = 32 tokens in the forward (halved down to 16 while the
// walks would have fewer than 64 K threads, for a short L), kT = 64 in the
// backward. A chunk's transfer over its tokens is its local end state (the
// walk from a zero state) and its decay exp(A * sum dt): the exponential of
// the summed dt, not the product of the tokens' exps.
//   Forward, three launches (one where L fits a chunk):
//   1. walk_kernel<kSummary>: a block per (chunk, b, tile of up to 128
//      channels) stages the chunk's x, dt and B in shared memory as fp32 (all
//      loads in flight at once); a thread per (d, part) holds kNS = 4 of the
//      channel's N states in registers and walks the chunk from zero: the
//      local end state E (B, chunks, D, N) and S = sum dt (B, chunks, D).
//   2. carry_kernel: h_in(c) = exp(A S(c-1)) h_in(c-1) + E(c-1), in place
//      over E. A block per (32 (d, n) lanes, b); its 16 warps take the chunks
//      in 16 runs: each composes its run's transfer h -> P h + e, each run's
//      entry is the transfers before it applied in order, and each walks its
//      run again from there.
//   3. walk_kernel<kOutput>: each (b, chunk, d, part) walks its chunk again
//      from h_in; y_t = sum_n C h over the part's states by a chain of fmas
//      and over the channel's N / kNS parts by shuffles, + D x, written once.
//   Backward, three launches (one where L fits a chunk):
//   A. walk_kernel<kSummaryGrad>: the same walk, over x, dt, g, B and C, also
//      gives the chunk's reverse summary: the message m0 = sum_t P_t g_t C_t
//      (P_t the product of the chunk's decays up to t) that the cotangent walk
//        hh_t = g_t C_t + a_{t+1} hh_{t+1}      (a_t = exp(dt_t A))
//      carries out of the chunk's first token from a zero message; its
//      transfer factor is the same decay.
//   B. carry_kernel: the entry states forward and the incoming messages in
//      reverse, m_in(c) = m0(c+1) + exp(A S(c+1)) m_in(c+1), in place over E
//      and M0.
//   C. backward_kernel: a block per (chunk, b), a lane per (d, n) for a group
//      of channels at a time, all D channels of the chunk in one block. The
//      chunk's x, dt, g, B and C are staged in shared memory as fp32, zeros
//      past the last token (dt = 0 leaves h as it is and g = 0 leaves the
//      message as it is). A lane walks the chunk from h_in and keeps the
//      state at each kQ = 8-token sub-chunk's entry (sub-chunks past the
//      last token change nothing and are skipped: a short L walks only its
//      own tokens); then, sub-chunk by sub-chunk from the last, it rebuilds
//      the kQ states with their decays a_t in registers (one exp per token
//      per walk) and walks the message back through them. dx and ddt are sums over n, taken by a butterfly
//      over the N lanes of a channel (each step halves the tokens a lane
//      keeps: about one shuffle per value), staged, and written once in the
//      dtype. dB and dC are sums over d: a butterfly over a warp's channels,
//      then the warps in order, then the channel groups in order, in shared
//      memory, written once per chunk as (B, L, N) in the dtype. dA and dD
//      are summed over each sub-chunk's tokens, then over the sub-chunks,
//      into fp32 partials per (b, chunk), (B, chunks, D, N) and (B, chunks,
//      D), which the caller sums in a fixed order.
//   Every sum is taken in a fixed order and there are no float atomics: two
//   calls give the same bits. Scratch, all fp32 and per (b, chunk), at
//   refine3 (B=16, L=16384, D=48, N=16): the forward's E 25.2 MB and S 1.6
//   MB (512 chunks); the backward's E and M0 12.6 MB each, S 0.8 MB, and its
//   dA and dD partials 12.6 and 0.8 MB (256 chunks). No (B, tiles, L, N)
//   partials: dB and dC are final when written.
//   kT, kTf, kQ, kNSMax and pass C's blocks per SM are compile-time
//   constants, chosen on an H100.
//
// Bound. Bytes: x, dt read and y written once (B*L*D each), B and C once
// (B*L*N each). At Mamba-UNet's refine3 (bf16) that is 92 MB, 27.6 us at
// 3.35 TB/s; the backward reads x, dt, B, C, g and writes dx, ddt, dB, dC,
// about 160 MB, 47.6 us. The recurrence's fp32 work (8 operations per (b,
// l, d, n) and 2 per (b, l, d), as scan_pallas.py counts it) is 1.6 GFLOP
// there, 24 us at 67 TFLOP/s. Below both lies the exp unit: every walk
// takes B*L*D*N exps (201 M at refine3), about 48 us at 16 per clock per SM;
// the forward walks twice, the backward three times (summary, checkpoints,
// rebuild). On the card neither bounds these kernels: with the exps replaced
// by an add the forward took as long, and fewer states per thread (more
// warps) made the walks faster, so each walk waits on its tokens' dependent
// chains (load, exp, the state's fma, the sum over n) with too few warps to
// hide them; pass C also issues about 40 instructions per (b, l, d, n)
// (three walks, the message, four butterflies). PERF.md has the times.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace {

// Chosen on an H100 (PERF.md has the sweep).
constexpr int kT = 64;         // tokens of a backward chunk
constexpr int kTf = 32;        // tokens of a forward chunk, at most
constexpr int kQ = 8;          // tokens of a backward sub-chunk, held in registers
constexpr int kNSMax = 4;      // states per thread of the walks
constexpr int kBwdBlocks = 3;  // pass C's blocks per SM: its registers are capped to fit
constexpr int kTP = kT + 4;    // a staged column's row in pass C's shared memory, padded
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kT % kQ == 0 && kQ % 4 == 0, "a chunk is whole sub-chunks of whole float4s");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half(v);
}

// 2^v on the exp unit; callers pass v = dt * A * log2(e). Results below
// 2^-126 flush to 0, which leaves a state or message unchanged to fp32. On
// the card the kernels built on it land nearer the float64 scan than the
// plain version does, and a build on expf(dt * A) ran slower and landed no
// nearer (PERF.md).
__device__ __forceinline__ float exp2_fast(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

template <int N>
__device__ __forceinline__ void store_floats(float* __restrict__ p, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k)
      reinterpret_cast<float4*>(p)[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2],
                                                    v[4 * k + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) p[j] = v[j];
  }
}

template <int N>
__device__ __forceinline__ void load_floats(const float* __restrict__ p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N / 4; ++k) {
      const float4 f = reinterpret_cast<const float4*>(p)[k];
      v[4 * k] = f.x;
      v[4 * k + 1] = f.y;
      v[4 * k + 2] = f.z;
      v[4 * k + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = p[j];
  }
}

// The summary and output passes: a block per (chunk, b, tile of up to kDW
// channels) stages the chunk's tokens in shared memory as fp32 (x, dt and g
// [Tc][DW], B and C [Tc][N]: all loads in flight at once, each value
// converted once) and a thread per (d, part) walks them, each part kNS of
// the channel's N states in registers, the kParts parts of a channel in
// adjacent lanes.
template <int N>
struct Walk {
  static constexpr int kNS = N < kNSMax ? N : kNSMax;
  static constexpr int kParts = N / kNS;
  static constexpr int kDW = 128;
};

enum WalkMode { kSummary = 0, kSummaryGrad = 1, kOutput = 2 };

// Floats of shared memory a walk block stages.
int walk_smem_floats(int mode, int Tc, int DW, int N) {
  return Tc * ((mode == kSummaryGrad ? 3 : 2) * DW + (mode == kSummary ? 1 : 2) * N);
}

// kSummary (pass 1) and kSummaryGrad (pass A): each (b, chunk, d, part)
// walks the chunk's tokens from a zero state: its kNS states of E and S =
// sum dt (part 0); kSummaryGrad also the reverse summary M0. kOutput (pass
// 3): the walk from the entry state hin (zero without it), y = sum_n C h,
// over the part's states by a chain of fmas and over the channel's parts by
// shuffles, + D x.
template <typename T, int N, int kMode>
__global__ void __launch_bounds__(Walk<N>::kDW * Walk<N>::kParts)
walk_kernel(const T* __restrict__ x, const T* __restrict__ dt, const float* __restrict__ A,
            const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ Dp,
            const T* __restrict__ g, const float* __restrict__ hin, float* __restrict__ E,
            float* __restrict__ M0, float* __restrict__ S, T* __restrict__ y, int L, int D,
            int C, int Tc, int DW) {
  constexpr int NS = Walk<N>::kNS, P = Walk<N>::kParts;
  constexpr bool kGrad = kMode == kSummaryGrad, kOut = kMode == kOutput;
  constexpr bool kStageC = kMode != kSummary;
  extern __shared__ __align__(16) float smem[];
  const int c = blockIdx.x, b = blockIdx.y, d0 = blockIdx.z * DW;
  const int nt = blockDim.x, tid = threadIdx.x;
  const int dw = min(DW, D - d0), t0 = c * Tc, len = min(Tc, L - t0);
  float* bs = smem;                              // [Tc][N]
  float* cs = bs + Tc * N;                       // [Tc][N]
  float* xs = bs + (kStageC ? 2 : 1) * Tc * N;   // [Tc][DW]
  float* dts = xs + Tc * DW;                     // [Tc][DW]
  float* gs = dts + Tc * DW;                     // [Tc][DW]
  {  // B and C: a lane per n, nt / N rows at a time
    const int rows = nt / N, r0 = tid / N, j = tid % N;
    if (r0 < rows)
#pragma unroll 8
      for (int t = r0; t < len; t += rows) {
        const int o = (b * L + t0 + t) * N + j;
        bs[t * N + j] = to_f32(Bm[o]);
        if constexpr (kStageC) cs[t * N + j] = to_f32(Cm[o]);
      }
  }
  {  // x, dt, g: a lane per channel, nt / DW rows at a time; zeros past D
    const int rows = nt / DW, r0 = tid / DW, j = tid % DW;
    if (r0 < rows)
#pragma unroll 8
      for (int t = r0; t < len; t += rows) {
        const int o = (b * L + t0 + t) * D + d0 + j;
        const bool in = j < dw;
        xs[t * DW + j] = in ? to_f32(x[o]) : 0.f;
        dts[t * DW + j] = in ? to_f32(dt[o]) : 0.f;
        if constexpr (kGrad) gs[t * DW + j] = in ? to_f32(g[o]) : 0.f;
      }
  }
  __syncthreads();
  const int dl = tid / P, part = tid % P, n0 = part * NS;
  const bool active = dl < dw;
  const int dr = active ? dl : 0;  // the staged column a padding thread reads
  const int d = d0 + dr, ch = (b * C + c) * D + d;
  float a2[NS], h[NS], Pc[NS], m[NS];
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    a2[n] = A[d * N + n0 + n] * kLog2e;
    h[n] = 0.f;
    Pc[n] = 1.f;
    m[n] = 0.f;
  }
  if (kOut && hin != nullptr) load_floats<NS>(hin + ch * N + n0, h);
  const float dp = kOut ? Dp[d] : 0.f;
  float s = 0.f;
#pragma unroll 4
  for (int t = 0; t < len; ++t) {
    const float xv = xs[t * DW + dr], dtv = dts[t * DW + dr], u = dtv * xv;
    float bv[NS], cv[NS];
    load_floats<NS>(bs + t * N + n0, bv);
    if constexpr (kStageC) load_floats<NS>(cs + t * N + n0, cv);
    if constexpr (kOut) {
      float p = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        h[n] = fmaf(exp2_fast(dtv * a2[n]), h[n], u * bv[n]);
        p = fmaf(cv[n], h[n], p);
      }
#pragma unroll
      for (int off = P / 2; off > 0; off /= 2) p += __shfl_xor_sync(0xffffffffu, p, off);
      if (active && part == 0) y[(b * L + t0 + t) * D + d] = from_f32<T>(p + xv * dp);
    } else {
      s += dtv;
      const float gv = kGrad ? gs[t * DW + dr] : 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float a = exp2_fast(dtv * a2[n]);
        h[n] = fmaf(a, h[n], u * bv[n]);
        if constexpr (kGrad) {
          Pc[n] *= a;
          m[n] = fmaf(Pc[n], gv * cv[n], m[n]);
        }
      }
    }
  }
  if constexpr (!kOut) {
    if (active) {
      store_floats<NS>(E + ch * N + n0, h);
      if constexpr (kGrad) store_floats<NS>(M0 + ch * N + n0, m);
      if (part == 0) S[ch] = s;
    }
  }
}

// Pass 2 / B: the carries over the C chunks of each (b, d, n), in place: E
// becomes each chunk's entry state and, given M0, M0 each chunk's incoming
// message. A block per (tile of 32 (d, n) lanes, b); its kCarryWarps warps
// split the chunks into as many runs in order. Each warp composes its run's
// transfer h -> P h + e (P the product of the chunks' decays exp(A S)),
// from the first chunk, into shared memory; each then takes its run's entry
// state as the transfers of the runs before it applied in order to zero, and
// walks its run again, writing the entry states. The messages go the same
// way from the last chunk.
constexpr int kCarryWarps = 16;
constexpr int kCarryBatch = 8;  // chunks whose loads are issued together

// One run's walk over chunks c0 .. c1 - 1 (forward) or c1 - 1 .. c0 (in
// reverse) from the value h: h = dec(c) h + v(c) per chunk; with kWrite each
// chunk's v is replaced by its entry value h. Returns h after the run and,
// in P, the product of the run's decays.
template <bool kWrite>
__device__ __forceinline__ float carry_run(float* __restrict__ v0, const float* __restrict__ s0,
                                           int stride, int D, float a2, int c0, int c1,
                                           bool forward, bool active, float h, float& P) {
  P = 1.f;
  const int n = c1 - c0;
  const auto chunk = [&](int k) { return forward ? c0 + k : c1 - 1 - k; };  // the k-th of the walk
  for (int k0 = 0; k0 < n; k0 += kCarryBatch) {
    float v[kCarryBatch], dec[kCarryBatch];
#pragma unroll
    for (int k = 0; k < kCarryBatch; ++k) {
      const bool in = k0 + k < n;
      v[k] = (in && active) ? v0[chunk(k0 + k) * stride] : 0.f;
      dec[k] = in ? exp2_fast(a2 * s0[chunk(k0 + k) * D]) : 1.f;
    }
#pragma unroll
    for (int k = 0; k < kCarryBatch; ++k) {
      if (kWrite && k0 + k < n && active) v0[chunk(k0 + k) * stride] = h;
      h = fmaf(dec[k], h, v[k]);
      P *= dec[k];
    }
  }
  return h;
}

__global__ void __launch_bounds__(32 * kCarryWarps)
carry_kernel(const float* __restrict__ A, float* __restrict__ E, float* __restrict__ M0,
             const float* __restrict__ S, int D, int N, int C) {
  __shared__ float tp[kCarryWarps][32], te[kCarryWarps][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane, b = blockIdx.y;  // j = d * N + n
  const bool active = j < D * N;
  const int jr = active ? j : 0;
  const float a2 = A[jr] * kLog2e;
  const int run = (C + kCarryWarps - 1) / kCarryWarps;
  const int c0 = min(C, w * run), c1 = min(C, c0 + run);
  const long long base = (long long)b * C * D * N + jr;  // chunk c at base + c * D * N
  const float* s0 = S + (long long)b * C * D + jr / N;   // chunk c at s0[c * D]
  for (int dir = 0; dir < (M0 != nullptr ? 2 : 1); ++dir) {
    const bool forward = dir == 0;
    float* v0 = (forward ? E : M0) + base;
    float P;
    const float e = carry_run<false>(v0, s0, D * N, D, a2, c0, c1, forward, active, 0.f, P);
    tp[w][lane] = P;
    te[w][lane] = e;
    __syncthreads();
    float h = 0.f;  // the runs before this one, in the direction of the walk
    if (forward) {
      for (int k = 0; k < w; ++k) h = fmaf(tp[k][lane], h, te[k][lane]);
    } else {
      for (int k = kCarryWarps - 1; k > w; --k) h = fmaf(tp[k][lane], h, te[k][lane]);
    }
    carry_run<true>(v0, s0, D * N, D, a2, c0, c1, forward, active, h, P);
    __syncthreads();  // tp and te are read before the next direction writes them
  }
}

// Pass C's block: kCG channels of N lanes each, 256 lanes where N >= 8.
template <int N>
struct Bwd {
  static constexpr int kCG = N >= 8 ? 256 / N : 32;
  static constexpr int kThreads = kCG * N;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kSub = kT / kQ;
  // floats of shared memory: B, C [N][kTP]; x, dt, g [kCG][kTP]; the
  // sub-chunk checkpoints [kSub][kThreads]; dx, ddt [kQ][kCG]; the warps'
  // dB, dC [kWarps][kQ][N]; the chunk's dB, dC [kT][N].
  static constexpr int kSmem = 2 * N * kTP + 3 * kCG * kTP + kSub * kThreads + 2 * kQ * kCG +
                               2 * kWarps * kQ * N + 2 * kT * N;
};

// Sums v[0 .. W) over the lanes whose ids differ in the bits O, O/2, ...,
// OLO, by a butterfly: while a lane holds more than one value, each step
// keeps one half of them (the upper half where the lane's bit is set) and
// adds the partner's copy of that half; after that, steps add the partner's
// value. kept_tokens<...> gives which of the kQ tokens a lane then holds.
template <int W, int O, int OLO>
__device__ __forceinline__ void butterfly(float (&v)[kQ], int lane) {
  if constexpr (O >= OLO && O > 0) {
    if constexpr (W > 1) {
      const bool up = lane & O;
#pragma unroll
      for (int i = 0; i < W / 2; ++i) {
        const float send = up ? v[i] : v[i + W / 2];
        const float keep = up ? v[i + W / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      butterfly<W / 2, O / 2, OLO>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      butterfly<1, O / 2, OLO>(v, lane);
    }
  }
}

// After butterfly<kQ, O, OLO>: the number of tokens each lane holds.
__host__ __device__ constexpr int kept_width(int O, int OLO) {
  int w = kQ;
  for (int o = O; o >= OLO && o > 0; o /= 2)
    if (w > 1) w /= 2;
  return w;
}

// After butterfly<kQ, O, OLO>: the lane holds the sums of tokens first ..
// first + kept_width - 1; writer is false for all but one lane of those that
// hold the same sums.
template <int O, int OLO>
__device__ __forceinline__ void kept_tokens(int lane, int& first, bool& writer) {
  int w = kQ;
  first = 0;
  writer = true;
  for (int o = O; o >= OLO && o > 0; o /= 2) {
    if (w > 1) {
      if (lane & o) first += w / 2;
      w /= 2;
    } else if (lane & o) {
      writer = false;
    }
  }
}

// Pass C: a block per (chunk c, b); see the source note.
template <typename T, int N>
__global__ void __launch_bounds__(Bwd<N>::kThreads, kBwdBlocks)
backward_kernel(const T* __restrict__ x, const T* __restrict__ dt, const float* __restrict__ A,
                const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ Dp,
                const T* __restrict__ g, const float* __restrict__ hin,
                const float* __restrict__ min_, T* __restrict__ dx, T* __restrict__ ddt,
                T* __restrict__ dB, T* __restrict__ dC, float* __restrict__ dA_part,
                float* __restrict__ dD_part, int L, int D, int C) {
  using K = Bwd<N>;
  constexpr int CG = K::kCG, NT = K::kThreads, W = K::kWarps;
  constexpr int WN = kept_width(N / 2, 1), WC = kept_width(16, N);
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;                 // [N][kTP]
  float* cs = bs + N * kTP;         // [N][kTP]
  float* xs = cs + N * kTP;         // [CG][kTP]
  float* dts = xs + CG * kTP;       // [CG][kTP]
  float* gs = dts + CG * kTP;       // [CG][kTP]
  float* cks = gs + CG * kTP;       // [kSub][NT]: each lane's sub-chunk entry states
  float* dxq = cks + K::kSub * NT;  // [kQ][CG]: sum_n hh B
  float* ddtq = dxq + kQ * CG;      // [kQ][CG]
  float* pb = ddtq + kQ * CG;       // [W][kQ][N]: dB over each warp's channels
  float* pc = pb + W * kQ * N;      // [W][kQ][N]
  float* accb = pc + W * kQ * N;    // [kT][N]: dB over the groups so far
  float* accc = accb + kT * N;      // [kT][N]

  const int c = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, n = tid % N, dl = tid / N;
  const int t0 = c * kT, len = min(kT, L - t0);
  const int subs = (len + kQ - 1) / kQ;  // sub-chunks that hold a token: the rest change nothing
#pragma unroll
  for (int i = tid; i < kT * N; i += NT) {
    const int t = i / N, k = i % N, o = (b * L + t0 + t) * N + k;
    bs[k * kTP + t] = t < len ? to_f32(Bm[o]) : 0.f;
    cs[k * kTP + t] = t < len ? to_f32(Cm[o]) : 0.f;
    accb[i] = 0.f;
    accc[i] = 0.f;
  }
  int first_n, first_c;
  bool writes_n, writes_c;
  kept_tokens<N / 2, 1>(lane, first_n, writes_n);
  kept_tokens<16, N>(lane, first_c, writes_c);
  const float* br = bs + n * kTP;
  const float* cr = cs + n * kTP;
  const float* xr = xs + dl * kTP;
  const float* dr = dts + dl * kTP;
  const float* gr = gs + dl * kTP;

  for (int d0 = 0; d0 < D; d0 += CG) {
#pragma unroll
    for (int i = tid; i < kT * CG; i += NT) {
      const int t = i / CG, j = i % CG, o = (b * L + t0 + t) * D + d0 + j;
      const bool in = t < len && d0 + j < D;
      xs[j * kTP + t] = in ? to_f32(x[o]) : 0.f;
      dts[j * kTP + t] = in ? to_f32(dt[o]) : 0.f;
      gs[j * kTP + t] = in ? to_f32(g[o]) : 0.f;
    }
    __syncthreads();
    const int d = d0 + dl;
    const bool active = d < D;
    const float an = active ? A[d * N + n] : 0.f, a2 = an * kLog2e;
    const int sidx = ((b * C + c) * D + d) * N + n;  // (b, c, d, n) of the scratch

    // The chunk from its entry state: each sub-chunk's entry state.
    float h = (active && hin != nullptr) ? hin[sidx] : 0.f;
#pragma unroll 1
    for (int k = 0; k < subs; ++k) {
      cks[k * NT + tid] = h;
#pragma unroll
      for (int t = k * kQ, e = t + kQ; t < e; t += 4) {
        const float4 d4 = *reinterpret_cast<const float4*>(dr + t);
        const float4 x4 = *reinterpret_cast<const float4*>(xr + t);
        const float4 b4 = *reinterpret_cast<const float4*>(br + t);
        h = fmaf(exp2_fast(d4.x * a2), h, (d4.x * x4.x) * b4.x);
        h = fmaf(exp2_fast(d4.y * a2), h, (d4.y * x4.y) * b4.y);
        h = fmaf(exp2_fast(d4.z * a2), h, (d4.z * x4.z) * b4.z);
        h = fmaf(exp2_fast(d4.w * a2), h, (d4.w * x4.w) * b4.w);
      }
    }

    // The sub-chunks from the last: rebuild, walk the message back, reduce.
    float m = (active && min_ != nullptr) ? min_[sidx] : 0.f;
    float da = 0.f, dd = 0.f;
#pragma unroll 1
    for (int k = subs - 1; k >= 0; --k) {
      const int base = k * kQ;
      const float hk = cks[k * NT + tid];
      float hr[kQ], ar[kQ];
      h = hk;
#pragma unroll
      for (int t = 0; t < kQ; t += 4) {
        const float4 d4 = *reinterpret_cast<const float4*>(dr + base + t);
        const float4 x4 = *reinterpret_cast<const float4*>(xr + base + t);
        const float4 b4 = *reinterpret_cast<const float4*>(br + base + t);
        const float dv[4] = {d4.x, d4.y, d4.z, d4.w}, xv[4] = {x4.x, x4.y, x4.z, x4.w};
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ar[t + j] = exp2_fast(dv[j] * a2);
          h = fmaf(ar[t + j], h, (dv[j] * xv[j]) * bv[j]);
          hr[t + j] = h;
        }
      }
      float qx[kQ], qdt[kQ], qb[kQ], qc[kQ];
      float da_k = 0.f, dd_k = 0.f;  // the sub-chunk's terms, then added to the chunk's
#pragma unroll
      for (int t = kQ - 4; t >= 0; t -= 4) {
        const float4 d4 = *reinterpret_cast<const float4*>(dr + base + t);
        const float4 x4 = *reinterpret_cast<const float4*>(xr + base + t);
        const float4 b4 = *reinterpret_cast<const float4*>(br + base + t);
        const float4 g4 = *reinterpret_cast<const float4*>(gr + base + t);
        const float4 c4 = *reinterpret_cast<const float4*>(cr + base + t);
        const float dv[4] = {d4.x, d4.y, d4.z, d4.w}, xv[4] = {x4.x, x4.y, x4.z, x4.w};
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w}, gv[4] = {g4.x, g4.y, g4.z, g4.w};
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int j = 3; j >= 0; --j) {
          const int tt = t + j;
          const float hh = fmaf(gv[j], cv[j], m);
          const float p = hh * (tt > 0 ? hr[tt - 1] : hk) * ar[tt];
          qx[tt] = hh * bv[j];
          qdt[tt] = fmaf(hh * xv[j], bv[j], p * an);
          qb[tt] = hh * (dv[j] * xv[j]);
          qc[tt] = gv[j] * hr[tt];
          da_k = fmaf(p, dv[j], da_k);
          dd_k = fmaf(gv[j], xv[j], dd_k);
          m = ar[tt] * hh;
        }
      }
      da += da_k;
      dd += dd_k;
      butterfly<kQ, N / 2, 1>(qx, lane);
      butterfly<kQ, N / 2, 1>(qdt, lane);
      if (writes_n) {
#pragma unroll
        for (int j = 0; j < WN; ++j) {
          dxq[(first_n + j) * CG + dl] = qx[j];
          ddtq[(first_n + j) * CG + dl] = qdt[j];
        }
      }
      butterfly<kQ, 16, N>(qb, lane);
      butterfly<kQ, 16, N>(qc, lane);
      if (writes_c) {
#pragma unroll
        for (int j = 0; j < WC; ++j) {
          pb[(warp * kQ + first_c + j) * N + n] = qb[j];
          pc[(warp * kQ + first_c + j) * N + n] = qc[j];
        }
      }
      __syncthreads();
      for (int i = tid; i < kQ * CG; i += NT) {
        const int t = i / CG, j = i % CG, tok = base + t;
        if (tok < len && d0 + j < D) {
          const int o = (b * L + t0 + tok) * D + d0 + j;
          dx[o] = from_f32<T>(dxq[i] * dts[j * kTP + tok] + gs[j * kTP + tok] * Dp[d0 + j]);
          ddt[o] = from_f32<T>(ddtq[i]);
        }
      }
      for (int i = tid; i < kQ * N; i += NT) {
        const int t = i / N, kk = i % N;
        float sb = 0.f, sc = 0.f;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          sb += pb[(w * kQ + t) * N + kk];
          sc += pc[(w * kQ + t) * N + kk];
        }
        accb[(base + t) * N + kk] += sb;
        accc[(base + t) * N + kk] += sc;
      }
      __syncthreads();
    }
    if (active) {
      dA_part[sidx] = da;
      if (n == 0) dD_part[(b * C + c) * D + d] = dd;
    }
  }
  for (int i = tid; i < len * N; i += NT) {
    const int o = (b * L + t0) * N + i;
    dB[o] = from_f32<T>(accb[i]);
    dC[o] = from_f32<T>(accc[i]);
  }
}

int chunks(int L, int T) { return (L + T - 1) / T; }

constexpr int kMinForwardChunk = 16;

// The forward's chunk: kTf tokens, halved down to kMinForwardChunk while the
// flat passes would have fewer than 64 K threads (a short L gets more,
// shorter chunks, which ran faster than kTf at encoder4 and encoder5; so
// there a sequence's chunks, and the last bits of its y, depend on B). The
// backward's is always kT (its pass C stages kT tokens).
int forward_chunk(int B, int L, int D, int N) {
  const long long parts = N / (N < kNSMax ? N : kNSMax);
  int T = kTf;
  while (T > kMinForwardChunk && (long long)B * chunks(L, T) * D * parts < 65536) T /= 2;
  return T;
}

bool valid(int B, int L, int D, int N) {
  if (B < 1 || B > 65535 || L < 1 || D < 1 || N < 1 || N > 32 || (N & (N - 1)) != 0)
    return false;
  const long long limit = 1LL << 31;  // every index fits in int
  return (long long)B * L * D < limit &&
         (long long)B * chunks(L, kMinForwardChunk) * D * N < limit &&
         (long long)B * L * N < limit;
}

// A kernel's shared memory: the dynamic size above 48 KB must be asked for,
// and the SM's split between L1 and shared memory is set to the most shared
// memory, so that as many blocks fit as the registers allow.
template <typename K>
int smem_attributes(K kernel, size_t smem) {
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != 0) return err;
  }
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   (int)cudaSharedmemCarveoutMaxShared);
}

// Launches walk_kernel<T, N, kMode> over (chunks, B, channel tiles).
template <typename T, int N, int kMode>
int launch_walk(const T* x, const T* dt, const float* A, const T* Bm, const T* Cm,
                const float* Dp, const T* g, const float* hin, float* E, float* M0, float* S,
                T* y, int B, int L, int D, int C, int Tc, cudaStream_t stream) {
  const int DW = D < Walk<N>::kDW ? D : Walk<N>::kDW;
  const int threads = (DW * Walk<N>::kParts + 31) / 32 * 32;
  const size_t smem = sizeof(float) * walk_smem_floats(kMode, Tc, DW, N);
  const int err = smem_attributes(walk_kernel<T, N, kMode>, smem);
  if (err != 0) return err;
  const dim3 grid(C, B, (D + DW - 1) / DW);
  walk_kernel<T, N, kMode><<<grid, threads, smem, stream>>>(x, dt, A, Bm, Cm, Dp, g, hin, E,
                                                            M0, S, y, L, D, C, Tc, DW);
  return (int)cudaGetLastError();
}

template <typename T, int N>
int forward_n(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
              const void* Dp, void* y, void* E, void* S, int B, int L, int D,
              cudaStream_t stream) {
  const int Tc = forward_chunk(B, L, D, N), C = chunks(L, Tc);
  const T* xt = static_cast<const T*>(x);
  const T* dtt = static_cast<const T*>(dt);
  const float* Af = static_cast<const float*>(A);
  const T* Bt = static_cast<const T*>(Bm);
  const T* Ct = static_cast<const T*>(Cm);
  const float* Df = static_cast<const float*>(Dp);
  float* Ef = static_cast<float*>(E);
  float* Sf = static_cast<float*>(S);
  if (C > 1) {
    int err = launch_walk<T, N, kSummary>(xt, dtt, Af, Bt, Ct, Df, nullptr, nullptr, Ef,
                                          nullptr, Sf, nullptr, B, L, D, C, Tc, stream);
    if (err != 0) return err;
    carry_kernel<<<dim3((D * N + 31) / 32, B), 32 * kCarryWarps, 0, stream>>>(Af, Ef, nullptr,
                                                                             Sf, D, N, C);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return launch_walk<T, N, kOutput>(xt, dtt, Af, Bt, Ct, Df, nullptr, C > 1 ? Ef : nullptr,
                                    nullptr, nullptr, nullptr, static_cast<T*>(y), B, L, D, C,
                                    Tc, stream);
}

template <typename T, int N>
int backward_n(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
               const void* Dp, const void* g, void* dx, void* ddt, void* dB, void* dC,
               void* dA_part, void* dD_part, void* E, void* M0, void* S, int B, int L, int D,
               cudaStream_t stream) {
  const int C = chunks(L, kT);
  const T* xt = static_cast<const T*>(x);
  const T* dtt = static_cast<const T*>(dt);
  const float* Af = static_cast<const float*>(A);
  const T* Bt = static_cast<const T*>(Bm);
  const T* Ct = static_cast<const T*>(Cm);
  const T* gt = static_cast<const T*>(g);
  float* Ef = static_cast<float*>(E);
  float* Mf = static_cast<float*>(M0);
  if (C > 1) {
    int err = launch_walk<T, N, kSummaryGrad>(xt, dtt, Af, Bt, Ct, nullptr, gt, nullptr, Ef,
                                              Mf, static_cast<float*>(S), nullptr, B, L, D, C,
                                              kT, stream);
    if (err != 0) return err;
    carry_kernel<<<dim3((D * N + 31) / 32, B), 32 * kCarryWarps, 0, stream>>>(
        Af, Ef, Mf, static_cast<const float*>(S), D, N, C);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const size_t smem = sizeof(float) * Bwd<N>::kSmem;
  const int err = smem_attributes(backward_kernel<T, N>, smem);
  if (err != 0) return err;
  backward_kernel<T, N><<<dim3(C, B), Bwd<N>::kThreads, smem, stream>>>(
      xt, dtt, Af, Bt, Ct, static_cast<const float*>(Dp), gt, C > 1 ? Ef : nullptr,
      C > 1 ? Mf : nullptr, static_cast<T*>(dx), static_cast<T*>(ddt), static_cast<T*>(dB),
      static_cast<T*>(dC), static_cast<float*>(dA_part), static_cast<float*>(dD_part), L, D, C);
  return (int)cudaGetLastError();
}

// One instantiation per state size: N sets the registers of a channel's
// states, the lanes of a channel and every loop bound of the kernels.
#define KMUNET_SCAN_BY_N(fn, T, ...)                 \
  switch (N) {                                       \
    case 1: return fn<T, 1>(__VA_ARGS__);            \
    case 2: return fn<T, 2>(__VA_ARGS__);            \
    case 4: return fn<T, 4>(__VA_ARGS__);            \
    case 8: return fn<T, 8>(__VA_ARGS__);            \
    case 16: return fn<T, 16>(__VA_ARGS__);          \
    case 32: return fn<T, 32>(__VA_ARGS__);          \
    default: return -1;                              \
  }

template <typename T>
int forward(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
            const void* Dp, void* y, void* E, void* S, int B, int L, int D, int N,
            cudaStream_t stream) {
  KMUNET_SCAN_BY_N(forward_n, T, x, dt, A, Bm, Cm, Dp, y, E, S, B, L, D, stream)
}

template <typename T>
int backward(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
             const void* Dp, const void* g, void* dx, void* ddt, void* dB, void* dC,
             void* dA_part, void* dD_part, void* E, void* M0, void* S, int B, int L, int D,
             int N, cudaStream_t stream) {
  KMUNET_SCAN_BY_N(backward_n, T, x, dt, A, Bm, Cm, Dp, g, dx, ddt, dB, dC, dA_part, dD_part,
                   E, M0, S, B, L, D, stream)
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16, 2 = fp16, of x, dt, B, C, y (and g, dx, ddt, dB,
// dC); A and D fp32. N a power of two up to 32. The scratch is per (b, chunk)
// with chunks = kmunet_selective_scan_chunks(...), all fp32: E (B, chunks,
// D, N), S (B, chunks, D), and for the backward M0 like E; unused when L
// fits one chunk. Returns cudaGetLastError() after the launches, or -1 for
// an argument the kernels do not take.

// Chunks of the forward (backward = 0) or the backward (1) at this shape:
// the scratch's second dimension; -1 for a shape the kernels do not take.
extern "C" int kmunet_selective_scan_chunks(int B, int L, int D, int N, int backward) {
  if (!valid(B, L, D, N)) return -1;
  return backward ? chunks(L, kT) : chunks(L, forward_chunk(B, L, D, N));
}

// K8: y (B, L, D).
extern "C" int kmunet_selective_scan(const void* x, const void* dt, const void* A,
                                     const void* Bm, const void* Cm, const void* Dp, void* y,
                                     void* E, void* S, int B, int L, int D, int N, int dtype,
                                     void* stream) {
  if (!valid(B, L, D, N)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return forward<float>(x, dt, A, Bm, Cm, Dp, y, E, S, B, L, D, N, s);
    case 1: return forward<__nv_bfloat16>(x, dt, A, Bm, Cm, Dp, y, E, S, B, L, D, N, s);
    case 2: return forward<__half>(x, dt, A, Bm, Cm, Dp, y, E, S, B, L, D, N, s);
    default: return -1;
  }
}

// K8's backward for the upstream gradient g (B, L, D): dx, ddt (B, L, D) and
// dB, dC (B, L, N) in the dtype; fp32 partial sums per (b, chunk): dA_part
// (B, chunks, D, N) and dD_part (B, chunks, D).
extern "C" int kmunet_selective_scan_backward(
    const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
    const void* Dp, const void* g, void* dx, void* ddt, void* dB, void* dC, void* dA_part,
    void* dD_part, void* E, void* M0, void* S, int B, int L, int D, int N, int dtype,
    void* stream) {
  if (!valid(B, L, D, N)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return backward<float>(x, dt, A, Bm, Cm, Dp, g, dx, ddt, dB, dC, dA_part, dD_part, E,
                             M0, S, B, L, D, N, s);
    case 1:
      return backward<__nv_bfloat16>(x, dt, A, Bm, Cm, Dp, g, dx, ddt, dB, dC, dA_part,
                                     dD_part, E, M0, S, B, L, D, N, s);
    case 2:
      return backward<__half>(x, dt, A, Bm, Cm, Dp, g, dx, ddt, dB, dC, dA_part, dD_part, E,
                              M0, S, B, L, D, N, s);
    default: return -1;
  }
}
