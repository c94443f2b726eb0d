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
// Design. The TPU kernel expands each chunk of tokens to lane-packed
// (Q, D*N) arrays with one-hot MXU matmuls and runs a Hillis-Steele scan in
// VMEM, because a TPU has wide vector units and a matrix unit but no cheap
// gather or shuffle. Here the recurrence is walked as written: one thread
// (lane) per (b, d, n), holding h[b, d, n] in a register, a block of 128
// lanes per (b, tile of 128 / N channels), the N lanes of a channel in one
// warp. A block walks all L tokens in order, in chunks (kChunk tokens
// forward, kChunkB backward) whose x, dt, B, C (and g) it stages in shared
// memory as fp32, zeros past the last token (dt = 0 leaves h as it is, so
// every chunk is walked whole). The loads go through registers and those of
// the next chunk are issued before this chunk's walk: with one warp per
// scheduler nothing else hides a memory latency, and a latency per load per
// chunk is what a plain staging loop costs. The walk over a chunk is
// unrolled and stores nothing: each lane keeps C_t * h_t in registers, so
// that the loads and exps of later tokens can be issued while the state's
// fma chain runs. A second pass over the chunk, whose tokens are
// independent, reduces y_t = sum_n C h over the N lanes of a channel by warp
// shuffles. N is a template argument: one instantiation per state size.
//   The backward runs two phases in one block, as the TPU kernel does:
// phase 0 walks the tokens forward and writes the state at each chunk's
// entry to an fp32 scratch (B, chunks, D, N); phase 1 takes the chunks in
// reverse, rebuilds the chunk's states from its entry state into registers,
// and walks the cotangent of the state back,
//   hh_t = g_t * C_t + a_{t+1} * hh_{t+1}     (a_t = exp(dt_t * A)),
// carrying a_t * hh_t into the chunk before; each lane keeps its terms of
// dx, ddt and dB in registers, and a second pass over the chunk reduces
// them: dx and ddt are sums over n (warp shuffles); dB and dC are sums over
// d, reduced by shuffles over a warp's channels, then over the block's warps
// in a fixed order, and written per (b, channel tile) as fp32 partial sums;
// dA per (b, d, n) and dD per (b, d) are summed over the tokens in
// registers, with Kahan's compensation. The caller sums the partials over
// tiles and batches. No atomics: the gradients are the same from run to run.
//
// Bound. Bytes: x, dt read and y written once (B*L*D each), B and C once
// (B*L*N each). At Mamba-UNet's refine3 (B=16, L=16384, D=48, N=16, bf16)
// that is 92 MB, 27.6 us at 3.35 TB/s; the backward reads x, dt, B, C, g and
// writes dx, ddt, dB, dC, about 160 MB, 47.6 us. The recurrence's fp32 work
// (8 operations per (b, l, d, n) and 2 per (b, l, d), as scan_pallas.py
// counts it) is 1.6 GFLOP there, 24 us at 67 TFLOP/s. This kernel is bound
// by neither: each lane walks the L tokens one after another, so its time is
// L times the issue time of one step (an exp and the fma of the state, about
// 30 instructions) for the one or two warps each scheduler holds, and
// refine1 at B=16 has only B*D*N = 4,096 lanes, about one warp per SM.
// Splitting L into chunks scanned in parallel, with a second pass for the
// carries, is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // lanes per block; a block covers kThreads / N channels
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;     // tokens of a forward chunk
constexpr int kChunkB = 16;    // tokens of a backward chunk: one checkpoint each

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

// Sum over the N lanes of one channel (xor offsets below N).
template <int N>
__device__ __forceinline__ float sum_over_n(float v) {
#pragma unroll
  for (int off = N / 2; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the channels of a warp, per n (xor offsets N .. 16).
template <int N>
__device__ __forceinline__ float sum_over_warp_channels(float v) {
#pragma unroll
  for (int off = N; off < 32; off *= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// sum += v, with the rounding error carried in comp (Kahan): dA and dD sum
// L terms per lane, which a plain fp32 sum would round L times.
__device__ __forceinline__ void kahan_add(float& sum, float& comp, float v) {
  const float y = v - comp;
  const float t = sum + y;
  comp = (t - sum) - y;
  sum = t;
}

// A chunk of Q tokens of one (B, L, width) tensor, columns [c0, c0 + COLS),
// in registers: this thread's elements i = threadIdx.x + k * kThreads of the
// chunk's [Q][COLS] tile, as fp32, zeros past the last token or column. All
// loads are issued before any is used, so the chunk costs one memory latency.
template <int Q, int COLS>
struct Chunk {
  static constexpr int kPer = (Q * COLS + kThreads - 1) / kThreads;
  float v[kPer];

  template <typename T>
  __device__ __forceinline__ void load(const T* __restrict__ src, int b, int L, int width,
                                       int t0, int c0) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int t = t0 + i / COLS, c = c0 + i % COLS;
      v[k] = (i < Q * COLS && t < L && c < width) ? to_f32(src[(b * L + t) * width + c]) : 0.f;
    }
  }

  __device__ __forceinline__ void store(float* dst) const {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < Q * COLS) dst[i] = v[k];
    }
  }
};

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
scan_forward_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Bm,
                    const T* __restrict__ Cm, const float* __restrict__ Dp,
                    T* __restrict__ y, int L, int D) {
  constexpr int DT = kThreads / N, Q = kChunk;
  extern __shared__ float smem[];
  float* xs = smem;           // [Q][DT]
  float* dts = xs + Q * DT;   // [Q][DT]
  float* bs = dts + Q * DT;   // [Q][N]
  float* cs = bs + Q * N;     // [Q][N]
  float* ys = cs + Q * N;     // [Q][DT]: sum_n C h

  const int b = blockIdx.y, d0 = blockIdx.x * DT;
  const int n = threadIdx.x % N, dl = threadIdx.x / N, d = d0 + dl;
  const float a_dn = d < D ? A[d * N + n] : 0.f;
  const int chunks = (L + Q - 1) / Q;
  Chunk<Q, DT> rx, rdt;
  Chunk<Q, N> rb, rc;
  rx.load(x, b, L, D, 0, d0);
  rdt.load(dt, b, L, D, 0, d0);
  rb.load(Bm, b, L, N, 0, 0);
  rc.load(Cm, b, L, N, 0, 0);
  float h = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const int t0 = c * Q, len = min(Q, L - t0);
    __syncthreads();  // the previous chunk's shared memory is read
    rx.store(xs);
    rdt.store(dts);
    rb.store(bs);
    rc.store(cs);
    __syncthreads();
    if (c + 1 < chunks) {  // the next chunk's loads fly during this chunk's walk
      rx.load(x, b, L, D, t0 + Q, d0);
      rdt.load(dt, b, L, D, t0 + Q, d0);
      rb.load(Bm, b, L, N, t0 + Q, 0);
      rc.load(Cm, b, L, N, t0 + Q, 0);
    }
    float p[Q];  // C_t * h_t; past the last token dt = 0 leaves h as it is
#pragma unroll
    for (int t = 0; t < Q; ++t) {
      const float dtv = dts[t * DT + dl];
      h = fmaf(expf(dtv * a_dn), h, dtv * xs[t * DT + dl] * bs[t * N + n]);
      p[t] = cs[t * N + n] * h;
    }
#pragma unroll
    for (int t = 0; t < Q; ++t) {
      const float yv = sum_over_n<N>(p[t]);
      if (n == 0) ys[t * DT + dl] = yv;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < len * DT; i += kThreads) {
      const int t = i / DT, col = d0 + i % DT;
      if (col < D) y[(b * L + t0 + t) * D + col] = from_f32<T>(ys[i] + xs[i] * Dp[col]);
    }
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
scan_backward_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ Bm,
                     const T* __restrict__ Cm, const float* __restrict__ Dp,
                     const T* __restrict__ g, T* __restrict__ dx, T* __restrict__ ddt,
                     float* __restrict__ dA_part, float* __restrict__ dB_part,
                     float* __restrict__ dC_part, float* __restrict__ dD_part,
                     float* __restrict__ ckpt, int L, int D) {
  constexpr int DT = kThreads / N, Q = kChunkB;
  extern __shared__ float smem[];
  float* xs = smem;                  // [Q][DT]
  float* dts = xs + Q * DT;          // [Q][DT]
  float* gs = dts + Q * DT;          // [Q][DT]
  float* bs = gs + Q * DT;           // [Q][N]
  float* cs = bs + Q * N;            // [Q][N]
  float* dxs = cs + Q * N;           // [Q][DT]: sum_n hh * B
  float* ddts = dxs + Q * DT;        // [Q][DT]
  float* dbw = ddts + Q * DT;        // [Q][kWarps][N]: dB over each warp's channels
  float* dcw = dbw + Q * kWarps * N; // [Q][kWarps][N]

  const int b = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x, d0 = tile * DT;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n = threadIdx.x % N, dl = threadIdx.x / N, d = d0 + dl;
  const bool active = d < D;
  const float a_dn = active ? A[d * N + n] : 0.f;
  const int chunks = (L + Q - 1) / Q;
  Chunk<Q, DT> rx, rdt, rg;
  Chunk<Q, N> rb, rc;

  // Phase 0: the forward walk; each chunk's entry state to the scratch.
  rx.load(x, b, L, D, 0, d0);
  rdt.load(dt, b, L, D, 0, d0);
  rb.load(Bm, b, L, N, 0, 0);
  float h = 0.f;
  for (int c = 0; c < chunks; ++c) {
    if (active) ckpt[((b * chunks + c) * D + d) * N + n] = h;
    __syncthreads();
    rx.store(xs);
    rdt.store(dts);
    rb.store(bs);
    __syncthreads();
    if (c + 1 < chunks) {
      rx.load(x, b, L, D, (c + 1) * Q, d0);
      rdt.load(dt, b, L, D, (c + 1) * Q, d0);
      rb.load(Bm, b, L, N, (c + 1) * Q, 0);
    }
#pragma unroll
    for (int t = 0; t < Q; ++t) {
      const float dtv = dts[t * DT + dl];
      h = fmaf(expf(dtv * a_dn), h, dtv * xs[t * DT + dl] * bs[t * N + n]);
    }
  }

  // Phase 1: the chunks in reverse.
  const int last = (chunks - 1) * Q;
  rx.load(x, b, L, D, last, d0);
  rdt.load(dt, b, L, D, last, d0);
  rg.load(g, b, L, D, last, d0);
  rb.load(Bm, b, L, N, last, 0);
  rc.load(Cm, b, L, N, last, 0);
  float h_next = active ? ckpt[((b * chunks + chunks - 1) * D + d) * N + n] : 0.f;
  float m = 0.f;  // a_{t+1} * hh_{t+1}, carried back
  float da = 0.f, da_comp = 0.f, dd = 0.f, dd_comp = 0.f;
  for (int c = chunks - 1; c >= 0; --c) {
    const int t0 = c * Q, len = min(Q, L - t0);
    __syncthreads();  // the previous chunk's shared memory is read
    rx.store(xs);
    rdt.store(dts);
    rg.store(gs);
    rb.store(bs);
    rc.store(cs);
    __syncthreads();
    const float h_in = h_next;  // this chunk's entry state
    if (c > 0) {
      rx.load(x, b, L, D, t0 - Q, d0);
      rdt.load(dt, b, L, D, t0 - Q, d0);
      rg.load(g, b, L, D, t0 - Q, d0);
      rb.load(Bm, b, L, N, t0 - Q, 0);
      rc.load(Cm, b, L, N, t0 - Q, 0);
      h_next = active ? ckpt[((b * chunks + c - 1) * D + d) * N + n] : 0.f;
    }
    float hr[Q];  // the chunk's states
    h = h_in;
#pragma unroll
    for (int t = 0; t < Q; ++t) {
      const float dtv = dts[t * DT + dl];
      h = fmaf(expf(dtv * a_dn), h, dtv * xs[t * DT + dl] * bs[t * N + n]);
      hr[t] = h;
    }
    // Past the last token g = C = dt = 0: hh stays m and m stays as it is.
    float qx[Q], qdt[Q], qb[Q];  // this lane's terms of dx, ddt, dB
#pragma unroll
    for (int t = Q - 1; t >= 0; --t) {
      const float dtv = dts[t * DT + dl], xv = xs[t * DT + dl];
      const float gv = gs[t * DT + dl], bv = bs[t * N + n];
      const float a = expf(dtv * a_dn);
      const float hh = fmaf(gv, cs[t * N + n], m);
      const float p = hh * (t > 0 ? hr[t - 1] : h_in) * a;
      qx[t] = hh * bv;
      qdt[t] = hh * xv * bv + p * a_dn;
      qb[t] = hh * (dtv * xv);
      kahan_add(da, da_comp, p * dtv);
      kahan_add(dd, dd_comp, gv * xv);
      m = a * hh;
    }
#pragma unroll
    for (int t = 0; t < Q; ++t) {
      const float sx = sum_over_n<N>(qx[t]);
      const float sdt = sum_over_n<N>(qdt[t]);
      const float sb = sum_over_warp_channels<N>(qb[t]);
      const float sc = sum_over_warp_channels<N>(gs[t * DT + dl] * hr[t]);
      if (n == 0) {
        dxs[t * DT + dl] = sx;
        ddts[t * DT + dl] = sdt;
      }
      if (lane < N) {
        dbw[(t * kWarps + warp) * N + n] = sb;
        dcw[(t * kWarps + warp) * N + n] = sc;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < len * DT; i += kThreads) {
      const int t = i / DT, col = d0 + i % DT;
      if (col < D) {
        const int o = (b * L + t0 + t) * D + col;
        dx[o] = from_f32<T>(dxs[i] * dts[i] + gs[i] * Dp[col]);
        ddt[o] = from_f32<T>(ddts[i]);
      }
    }
    for (int i = threadIdx.x; i < len * N; i += kThreads) {
      const int t = i / N, k = i % N;
      float sb = 0.f, sc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        sb += dbw[(t * kWarps + w) * N + k];
        sc += dcw[(t * kWarps + w) * N + k];
      }
      const int o = ((b * tiles + tile) * L + t0 + t) * N + k;
      dB_part[o] = sb;
      dC_part[o] = sc;
    }
  }
  if (active) {
    dA_part[(b * D + d) * N + n] = da;
    if (n == 0) dD_part[b * D + d] = dd;
  }
}

bool valid(int B, int L, int D, int N) {
  if (B < 1 || B > 65535 || L < 1 || D < 1 || N < 1 || N > 32 || (N & (N - 1)) != 0)
    return false;
  const long long limit = 1LL << 31;  // every index fits in int
  const long long chunks = (L + kChunkB - 1) / kChunkB;
  const long long tiles = (D + kThreads / N - 1) / (kThreads / N);
  return (long long)B * L * D < limit && (long long)B * chunks * D * N < limit &&
         (long long)B * tiles * L * N < limit;
}

// Dynamic shared memory above 48 KB must be asked for (N = 1).
template <typename K>
int launch_with_smem(K kernel, size_t smem) {
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
  return 0;
}

template <typename T, int N>
int forward_n(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
              const void* Dp, void* y, int B, int L, int D, cudaStream_t stream) {
  constexpr int DT = kThreads / N;
  const dim3 grid((D + DT - 1) / DT, B);
  const size_t smem = sizeof(float) * kChunk * (3 * DT + 2 * N);
  int err = launch_with_smem(scan_forward_kernel<T, N>, smem);
  if (err != 0) return err;
  scan_forward_kernel<T, N><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<const float*>(Dp),
      static_cast<T*>(y), L, D);
  return (int)cudaGetLastError();
}

template <typename T, int N>
int backward_n(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
               const void* Dp, const void* g, void* dx, void* ddt, void* dA_part,
               void* dB_part, void* dC_part, void* dD_part, void* ckpt, int B, int L, int D,
               cudaStream_t stream) {
  constexpr int DT = kThreads / N;
  const dim3 grid((D + DT - 1) / DT, B);
  const size_t smem = sizeof(float) * kChunkB * (5 * DT + 2 * N + 2 * kWarps * N);
  int err = launch_with_smem(scan_backward_kernel<T, N>, smem);
  if (err != 0) return err;
  scan_backward_kernel<T, N><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<const float*>(Dp),
      static_cast<const T*>(g), static_cast<T*>(dx), static_cast<T*>(ddt),
      static_cast<float*>(dA_part), static_cast<float*>(dB_part), static_cast<float*>(dC_part),
      static_cast<float*>(dD_part), static_cast<float*>(ckpt), L, D);
  return (int)cudaGetLastError();
}

// One instantiation per state size: N sets the lanes of a channel, the
// channels of a block and every loop bound of the kernels.
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
            const void* Dp, void* y, int B, int L, int D, int N, cudaStream_t stream) {
  KMUNET_SCAN_BY_N(forward_n, T, x, dt, A, Bm, Cm, Dp, y, B, L, D, stream)
}

template <typename T>
int backward(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
             const void* Dp, const void* g, void* dx, void* ddt, void* dA_part, void* dB_part,
             void* dC_part, void* dD_part, void* ckpt, int B, int L, int D, int N,
             cudaStream_t stream) {
  KMUNET_SCAN_BY_N(backward_n, T, x, dt, A, Bm, Cm, Dp, g, dx, ddt, dA_part, dB_part, dC_part,
                   dD_part, ckpt, B, L, D, stream)
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16, 2 = fp16, of x, dt, B, C, y (and g, dx, ddt);
// A and D fp32. N a power of two up to 32. Returns cudaGetLastError() after
// the launch, or -1 for an argument the kernel does not take.

// K8: y (B, L, D).
extern "C" int kmunet_selective_scan(const void* x, const void* dt, const void* A,
                                     const void* Bm, const void* Cm, const void* Dp, void* y,
                                     int B, int L, int D, int N, int dtype, void* stream) {
  if (!valid(B, L, D, N)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return forward<float>(x, dt, A, Bm, Cm, Dp, y, B, L, D, N, s);
    case 1: return forward<__nv_bfloat16>(x, dt, A, Bm, Cm, Dp, y, B, L, D, N, s);
    case 2: return forward<__half>(x, dt, A, Bm, Cm, Dp, y, B, L, D, N, s);
    default: return -1;
  }
}

// K8's backward for the upstream gradient g (B, L, D): dx, ddt (B, L, D) in
// the dtype; fp32 partial sums dA_part (B, D, N), dB_part and dC_part
// (B, tiles, L, N) with tiles = ceil(D / (128 / N)), dD_part (B, D); ckpt an
// fp32 scratch (B, ceil(L / 16), D, N).
extern "C" int kmunet_selective_scan_backward(
    const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
    const void* Dp, const void* g, void* dx, void* ddt, void* dA_part, void* dB_part,
    void* dC_part, void* dD_part, void* ckpt, int B, int L, int D, int N, int dtype,
    void* stream) {
  if (!valid(B, L, D, N)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return backward<float>(x, dt, A, Bm, Cm, Dp, g, dx, ddt, dA_part, dB_part, dC_part,
                             dD_part, ckpt, B, L, D, N, s);
    case 1:
      return backward<__nv_bfloat16>(x, dt, A, Bm, Cm, Dp, g, dx, ddt, dA_part, dB_part,
                                     dC_part, dD_part, ckpt, B, L, D, N, s);
    case 2:
      return backward<__half>(x, dt, A, Bm, Cm, Dp, g, dx, ddt, dA_part, dB_part, dC_part,
                              dD_part, ckpt, B, L, D, N, s);
    default: return -1;
  }
}
