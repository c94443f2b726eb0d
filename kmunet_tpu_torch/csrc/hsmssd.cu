// K2 and K3: the HSM-SSD mixer's online-softmax compress (K2) and the whole
// mixer fused (K3).
//
//   h[b,n,c]  = sum_l softmax_L(dt + A)[b,n,l] * B[b,n,l] * x[b,c,l]        (K2)
//   h_, z     = split(h . W_hz^T)                  W_hz (2C, C)
//   h2[b,n,c] = (h_ * silu(z) + h_ * D) . W_out^T   W_out (C, C), h2 in x's dtype
//   y[b,c,l]  = sum_n h2[b,n,c] * C[b,n,l]                                  (K3: y, h2)
//
// x (B, C, L) contiguous; dt, B and C (B, N, L) with tokens contiguous and any
// batch stride, so that they may be the slices of one (B, 3N, L) tensor;
// A (N,), W_hz, W_out and D fp32; x, dt, B, C and the outputs in one dtype
// (fp32, bf16 or fp16); every sum and product in fp32.
//
// Replaces the TPU kernels kmunet_tpu/kernels/ssd_pallas.py::hsmssd_compress
// (K2, the pl.pallas_call at :79) and kmunet_tpu/kernels/ssd_mix_pallas.py::
// hsmssd_mix (K3, the pl.pallas_call at :150). K3's gradient is the autodiff
// of its plain version (kernels/ssd.py), as the TPU kernel's custom VJP is the
// autodiff of hsmssd_mix_reference; so is K2's.
//
// Design. The TPU kernels walk the L tiles of a batch element in order on one
// core, carrying the running max, denominator and unnormalised h in VMEM. A
// GPU has 132 SMs and nothing carries between blocks, and at B = 2 one block
// per batch element would use two of them. So the carry becomes two passes:
//   compress  one block per (slice of L, b) walks its tiles of kTile tokens
//             with an online softmax for all N: per tile it stages x (C, T)
//             and e*B (T, N) in shared memory, e = exp(dt + A - m_new), with
//             the tile's max and sum per n by warp shuffles, rescales its h
//             (N, C) by exp(m_old - m_new) and adds x^T (e*B); it writes its
//             max m_i (N), denominator d_i (N) and h_i (N, C), fp32.
//   merge     one block per b: m = max_i m_i, d = sum_i d_i e^(m_i - m),
//             h = sum_i h_i e^(m_i - m) / d; K2 writes h; K3 computes the
//             gated MLP on the (N, C) states in the same block and writes h2
//             rounded to x's dtype (the TPU kernel rounds it so before its
//             scatter, ssd_mix_pallas.py:106,111).
//   scatter   (K3) one thread per token: y[:, l] = h2^T C[:, l], h2 staged in
//             shared memory, all C channels in registers.
// So K2 is two device launches and K3 three. dt, B and x are read once, C
// once; neither the softmax nor e*B is ever written. The MLP and the scatter
// are written out here, as the TPU kernel computes them in its own body.
//
// Bound. At KM_UNetV3-SH's enc1 mixer (B = 128, C = 16, L = 16384, N = 64,
// bf16) K3 moves x 67.1 MB, dt, B and C 268.4 MB each and y 67.1 MB: 939 MB,
// 280 us at 3.35 TB/s; its 8.6 GFLOP of products take 128 us at the 67
// TFLOP/s of fp32 outside the tensor cores (8.7 us on them): bytes bound it.
// K2 moves 604 MB, 180 us. The compress does 2 shared loads per 4 FMAs, the
// scatter one broadcast float4 per 4 FMAs and one global load per C FMAs;
// the merge's MLP is (4C + 2) C N operations per batch element. Tensor cores
// (the products are (N x T) . (T x C) and (C x N) . (N x T)) are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;         // compress and merge blocks
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;             // tokens per compress tile: two per lane
constexpr int kMaxN = 64;             // N a power of two in [4, kMaxN]
constexpr int kMaxC = 64;
constexpr int kNPerWarp = kMaxN / kWarps;
constexpr int kPairs = kMaxN / 4 * kMaxC / kThreads;  // (n quad, c) pairs per thread
constexpr int kScatterThreads = 128;  // tokens per scatter block

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Index of e*B[t][n] in the compress tile: quads of n, XOR-swizzled by the
// token so that the 32 lanes of a warp (32 tokens of one n) write 16 banks,
// while a thread reads the 4 n of its quad at one token as one float4.
__device__ __forceinline__ int ws_index(int t, int n, int nq_mask) {
  return t * (nq_mask + 1) * 4 + ((((n >> 2) ^ (t & nq_mask))) << 2) + (n & 3);
}

// The compress pass: block (s, b) walks tiles [s * tps, min((s + 1) * tps,
// tiles)) of batch element b and writes its partial max, denominator and
// unnormalised h at (b, s).
template <typename T>
__global__ void __launch_bounds__(kThreads) compress_kernel(
    const T* __restrict__ x, const T* __restrict__ dt, const T* __restrict__ Bm,
    const float* __restrict__ A, float* __restrict__ part_m, float* __restrict__ part_d,
    float* __restrict__ part_h, int C, int L, int N, int tps, long long dt_bstride,
    long long bm_bstride) {
  __shared__ __align__(16) float ws[kTile * kMaxN];  // e*B, [t][n] swizzled
  __shared__ float xs[kMaxC * (kTile + 1)];          // x, [c][t], rows padded
  __shared__ float m_s[kMaxN], d_s[kMaxN], sc_s[kMaxN];

  const int b = blockIdx.y, s = blockIdx.x, S = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nq_mask = N / 4 - 1;
  const int tiles = (L + kTile - 1) / kTile;
  const int tile_end = min(tiles, (s + 1) * tps);
  const T* xb = x + (long long)b * C * L;
  const T* dtb = dt + b * dt_bstride;
  const T* bmb = Bm + b * bm_bstride;

  if (tid < N) {
    m_s[tid] = -INFINITY;
    d_s[tid] = 0.f;
  }
  __syncthreads();
  // This thread's (n quad, c) pairs of h and their accumulators.
  const int pairs = N / 4 * C;
  float acc[kPairs][4];
#pragma unroll
  for (int k = 0; k < kPairs; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[k][q] = 0.f;

  for (int tile = s * tps; tile < tile_end; ++tile) {
    const int l0 = tile * kTile;
    for (int i = tid; i < C * kTile; i += kThreads) {
      const int c = i / kTile, t = i % kTile, l = l0 + t;
      xs[c * (kTile + 1) + t] = l < L ? to_f32(xb[(long long)c * L + l]) : 0.f;
    }
    // Warp w takes n = w, w + kWarps, ...; lane takes tokens lane, lane + 32.
    float dv[kNPerWarp][2], bv[kNPerWarp][2];
#pragma unroll
    for (int k = 0; k < kNPerWarp; ++k) {
      const int n = warp + k * kWarps;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int l = l0 + lane + 32 * h;
        const bool ok = n < N && l < L;
        dv[k][h] = ok ? to_f32(dtb[(long long)n * L + l]) : -INFINITY;
        bv[k][h] = ok ? to_f32(bmb[(long long)n * L + l]) : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < kNPerWarp; ++k) {
      const int n = warp + k * kWarps;
      if (n >= N) break;  // warp-uniform
      const float a = A[n];
      const float s0 = dv[k][0] + a, s1 = dv[k][1] + a;  // -inf past the last token
      const float m_old = m_s[n];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));  // finite: token l0 exists
      const float e0 = expf(s0 - m_new), e1 = expf(s1 - m_new);
      const float e_sum = warp_sum(e0 + e1);
      ws[ws_index(lane, n, nq_mask)] = e0 * bv[k][0];
      ws[ws_index(lane + 32, n, nq_mask)] = e1 * bv[k][1];
      __syncwarp();
      if (lane == 0) {
        const float scale = expf(m_old - m_new);  // 0 on the first tile (m_old = -inf)
        sc_s[n] = scale;
        d_s[n] = d_s[n] * scale + e_sum;
        m_s[n] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int p = tid + k * kThreads;
      if (p < pairs) {
        const int c = p % C, nq = p / C;
        const float* xr = xs + c * (kTile + 1);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[k][q] *= sc_s[nq * 4 + q];
#pragma unroll 8
        for (int t = 0; t < kTile; ++t) {
          const float4 w = *reinterpret_cast<const float4*>(
              ws + t * N + ((nq ^ (t & nq_mask)) << 2));
          const float xval = xr[t];
          acc[k][0] = fmaf(w.x, xval, acc[k][0]);
          acc[k][1] = fmaf(w.y, xval, acc[k][1]);
          acc[k][2] = fmaf(w.z, xval, acc[k][2]);
          acc[k][3] = fmaf(w.w, xval, acc[k][3]);
        }
      }
    }
    __syncthreads();
  }

  const long long part = (long long)b * S + s;
  if (tid < N) {
    part_m[part * N + tid] = m_s[tid];
    part_d[part * N + tid] = d_s[tid];
  }
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int p = tid + k * kThreads;
    if (p < pairs) {
      const int c = p % C, nq = p / C;
#pragma unroll
      for (int q = 0; q < 4; ++q) part_h[(part * N + nq * 4 + q) * C + c] = acc[k][q];
    }
  }
}

// The merge pass: one block per b. MIX = false writes h (B, N, C) (K2);
// MIX = true computes the gated MLP and writes h2 (B, N, C) (K3). Dynamic
// shared memory: S * N + N + 2 * N * (C + 1) floats.
template <typename T, bool MIX>
__global__ void __launch_bounds__(kThreads) merge_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_d,
    const float* __restrict__ part_h, const float* __restrict__ w_hz,
    const float* __restrict__ w_out, const float* __restrict__ Dp, T* __restrict__ out,
    int S, int N, int C) {
  extern __shared__ float smem[];
  float* wgt = smem;            // [S][N]: e^(m_i - m)
  float* dsum = wgt + S * N;    // [N]
  float* hs = dsum + N;         // [N][C + 1]: h, then the gated states
  float* gs = hs + N * (C + 1);
  const int b = blockIdx.x, tid = threadIdx.x;
  const float* pm = part_m + (long long)b * S * N;
  const float* pd = part_d + (long long)b * S * N;
  const float* ph = part_h + (long long)b * S * N * C;

  for (int n = tid; n < N; n += kThreads) {
    float m = -INFINITY;
    for (int i = 0; i < S; ++i) m = fmaxf(m, pm[i * N + n]);
    float d = 0.f;
    for (int i = 0; i < S; ++i) {
      const float e = expf(pm[i * N + n] - m);
      wgt[i * N + n] = e;
      d = fmaf(pd[i * N + n], e, d);
    }
    dsum[n] = d;
  }
  __syncthreads();
  // Lanes run over n, so that W_hz and W_out reads below are warp-uniform.
  for (int p = tid; p < N * C; p += kThreads) {
    const int n = p % N, c = p / N;
    float acc = 0.f;
    for (int i = 0; i < S; ++i) acc = fmaf(wgt[i * N + n], ph[((long long)i * N + n) * C + c], acc);
    const float h = acc / dsum[n];
    if (MIX)
      hs[n * (C + 1) + c] = h;
    else
      out[((long long)b * N + n) * C + c] = from_f32<T>(h);
  }
  if (!MIX) return;
  __syncthreads();
  const float D = Dp[0];
  for (int p = tid; p < N * C; p += kThreads) {
    const int n = p % N, c = p / N;
    const float* hr = hs + n * (C + 1);
    const float* wh = w_hz + (long long)c * C;
    const float* wz = w_hz + (long long)(C + c) * C;
    float hv = 0.f, z = 0.f;
    for (int k = 0; k < C; ++k) {
      hv = fmaf(hr[k], wh[k], hv);
      z = fmaf(hr[k], wz[k], z);
    }
    gs[n * (C + 1) + c] = hv * (z / (1.f + expf(-z))) + hv * D;
  }
  __syncthreads();
  for (int p = tid; p < N * C; p += kThreads) {
    const int n = p % N, c = p / N;
    const float* gr = gs + n * (C + 1);
    const float* wo = w_out + (long long)c * C;
    float h2 = 0.f;
    for (int k = 0; k < C; ++k) h2 = fmaf(gr[k], wo[k], h2);
    out[((long long)b * N + n) * C + c] = from_f32<T>(h2);
  }
}

// The scatter pass of K3: thread l of block (tile, b) computes y[b, :, l] =
// h2[b]^T C[b, :, l] for all C channels, CM >= C of them in registers.
template <typename T, int CM>
__global__ void __launch_bounds__(kScatterThreads) scatter_kernel(
    const T* __restrict__ h2, const T* __restrict__ Cm, T* __restrict__ y, int C, int L, int N,
    long long cm_bstride) {
  __shared__ __align__(16) float hs[kMaxN * CM];  // h2[b], [n][CM], zeros past C
  const int b = blockIdx.y, tid = threadIdx.x;
  const int l = blockIdx.x * kScatterThreads + tid;
#pragma unroll 8
  for (int i = tid; i < N * CM; i += kScatterThreads) {
    const int n = i / CM, c = i % CM;
    hs[i] = c < C ? to_f32(h2[((long long)b * N + n) * C + c]) : 0.f;
  }
  __syncthreads();
  if (l >= L) return;
  float acc[CM];
#pragma unroll
  for (int c = 0; c < CM; ++c) acc[c] = 0.f;
  const T* cb = Cm + b * cm_bstride + l;
#pragma unroll 8
  for (int n = 0; n < N; ++n) {
    const float cv = to_f32(cb[(long long)n * L]);
    const float4* hr = reinterpret_cast<const float4*>(hs + n * CM);
#pragma unroll
    for (int q = 0; q < CM / 4; ++q) {
      const float4 w = hr[q];
      acc[4 * q] = fmaf(w.x, cv, acc[4 * q]);
      acc[4 * q + 1] = fmaf(w.y, cv, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(w.z, cv, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(w.w, cv, acc[4 * q + 3]);
    }
  }
  T* yb = y + (long long)b * C * L + l;
#pragma unroll
  for (int c = 0; c < CM; ++c)
    if (c < C) yb[(long long)c * L] = from_f32<T>(acc[c]);
}

// Dynamic shared memory above 48 KB must be asked for.
template <typename K>
int allow_smem(K kernel, size_t smem) {
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
  return 0;
}

bool valid(int B, int C, int L, int N, int S, int tps) {
  if (B < 1 || B > 65535 || C < 1 || C > kMaxC || L < 1 || N < 4 || N > kMaxN ||
      (N & (N - 1)) != 0 || S < 1 || tps < 1)
    return false;
  const int tiles = (L + kTile - 1) / kTile;
  return (long long)S * tps >= tiles && (long long)(S - 1) * tps < tiles && S <= 65535;
}

template <typename T>
int compress(const void* x, const void* dt, const void* Bm, const void* A, void* part_m,
             void* part_d, void* part_h, int B, int C, int L, int N, int S, int tps,
             long long dt_bstride, long long bm_bstride, cudaStream_t stream) {
  compress_kernel<T><<<dim3(S, B), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const T*>(Bm),
      static_cast<const float*>(A), static_cast<float*>(part_m), static_cast<float*>(part_d),
      static_cast<float*>(part_h), C, L, N, tps, dt_bstride, bm_bstride);
  return (int)cudaGetLastError();
}

template <typename T, bool MIX>
int merge(const void* part_m, const void* part_d, const void* part_h, const void* w_hz,
          const void* w_out, const void* Dp, void* out, int B, int C, int N, int S,
          cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)S * N + N + 2 * (size_t)N * (C + 1));
  int err = allow_smem(merge_kernel<T, MIX>, smem);
  if (err != 0) return err;
  merge_kernel<T, MIX><<<B, kThreads, smem, stream>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_d),
      static_cast<const float*>(part_h), static_cast<const float*>(w_hz),
      static_cast<const float*>(w_out), static_cast<const float*>(Dp), static_cast<T*>(out), S,
      N, C);
  return (int)cudaGetLastError();
}

template <typename T, int CM>
int scatter_cm(const void* h2, const void* Cm, void* y, int B, int C, int L, int N,
               long long cm_bstride, cudaStream_t stream) {
  const dim3 grid((L + kScatterThreads - 1) / kScatterThreads, B);
  scatter_kernel<T, CM><<<grid, kScatterThreads, 0, stream>>>(
      static_cast<const T*>(h2), static_cast<const T*>(Cm), static_cast<T*>(y), C, L, N,
      cm_bstride);
  return (int)cudaGetLastError();
}

// One instantiation per power of two of channels in registers.
template <typename T>
int scatter(const void* h2, const void* Cm, void* y, int B, int C, int L, int N,
            long long cm_bstride, cudaStream_t stream) {
  if (C <= 4) return scatter_cm<T, 4>(h2, Cm, y, B, C, L, N, cm_bstride, stream);
  if (C <= 8) return scatter_cm<T, 8>(h2, Cm, y, B, C, L, N, cm_bstride, stream);
  if (C <= 16) return scatter_cm<T, 16>(h2, Cm, y, B, C, L, N, cm_bstride, stream);
  if (C <= 32) return scatter_cm<T, 32>(h2, Cm, y, B, C, L, N, cm_bstride, stream);
  return scatter_cm<T, 64>(h2, Cm, y, B, C, L, N, cm_bstride, stream);
}

template <typename T>
int run_compress(const void* x, const void* dt, const void* Bm, const void* A, void* part_m,
                 void* part_d, void* part_h, void* h, int B, int C, int L, int N, int S,
                 int tps, long long sdt, long long sbm, cudaStream_t stream) {
  int err = compress<T>(x, dt, Bm, A, part_m, part_d, part_h, B, C, L, N, S, tps, sdt, sbm,
                        stream);
  if (err != 0) return err;
  return merge<T, false>(part_m, part_d, part_h, nullptr, nullptr, nullptr, h, B, C, N, S,
                         stream);
}

template <typename T>
int run_mix(const void* x, const void* dt, const void* Bm, const void* Cm, const void* A,
            const void* w_hz, const void* w_out, const void* Dp, void* part_m, void* part_d,
            void* part_h, void* y, void* h2, int B, int C, int L, int N, int S, int tps,
            long long sdt, long long sbm, long long scm, cudaStream_t stream) {
  int err = compress<T>(x, dt, Bm, A, part_m, part_d, part_h, B, C, L, N, S, tps, sdt, sbm,
                        stream);
  if (err != 0) return err;
  err = merge<T, true>(part_m, part_d, part_h, w_hz, w_out, Dp, h2, B, C, N, S, stream);
  if (err != 0) return err;
  return scatter<T>(h2, Cm, y, B, C, L, N, scm, stream);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16, 2 = fp16, of x, dt, B, C and the outputs; A,
// W_hz, W_out and D fp32. The compress pass splits the ceil(L / 64) tiles of
// each batch element into S slices of tps tiles (S = ceil(tiles / tps));
// part_m, part_d (B, S, N) and part_h (B, S, N, C) are its fp32 scratch. The
// batch strides are in elements. Returns cudaGetLastError() after the first
// launch that fails or after the last, or -1 for an argument the kernels do
// not take (C in [1, 64], N a power of two in [4, 64]).

// K2: h (B, N, C).
extern "C" int kmunet_hsmssd_compress(const void* x, const void* dt, const void* Bm,
                                      const void* A, void* part_m, void* part_d, void* part_h,
                                      void* h, int B, int C, int L, int N, int S, int tps,
                                      long long dt_bstride, long long bm_bstride, int dtype,
                                      void* stream) {
  if (!valid(B, C, L, N, S, tps)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return run_compress<float>(x, dt, Bm, A, part_m, part_d, part_h, h, B, C, L, N, S,
                                       tps, dt_bstride, bm_bstride, s);
    case 1: return run_compress<__nv_bfloat16>(x, dt, Bm, A, part_m, part_d, part_h, h, B, C,
                                               L, N, S, tps, dt_bstride, bm_bstride, s);
    case 2: return run_compress<__half>(x, dt, Bm, A, part_m, part_d, part_h, h, B, C, L, N, S,
                                        tps, dt_bstride, bm_bstride, s);
    default: return -1;
  }
}

// K3: y (B, C, L) and h2 (B, N, C).
extern "C" int kmunet_hsmssd_mix(const void* x, const void* dt, const void* Bm, const void* Cm,
                                 const void* A, const void* w_hz, const void* w_out,
                                 const void* Dp, void* part_m, void* part_d, void* part_h,
                                 void* y, void* h2, int B, int C, int L, int N, int S, int tps,
                                 long long dt_bstride, long long bm_bstride,
                                 long long cm_bstride, int dtype, void* stream) {
  if (!valid(B, C, L, N, S, tps)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return run_mix<float>(x, dt, Bm, Cm, A, w_hz, w_out, Dp, part_m, part_d, part_h, y,
                                  h2, B, C, L, N, S, tps, dt_bstride, bm_bstride, cm_bstride, s);
    case 1: return run_mix<__nv_bfloat16>(x, dt, Bm, Cm, A, w_hz, w_out, Dp, part_m, part_d,
                                          part_h, y, h2, B, C, L, N, S, tps, dt_bstride,
                                          bm_bstride, cm_bstride, s);
    case 2: return run_mix<__half>(x, dt, Bm, Cm, A, w_hz, w_out, Dp, part_m, part_d, part_h, y,
                                   h2, B, C, L, N, S, tps, dt_bstride, bm_bstride, cm_bstride,
                                   s);
    default: return -1;
  }
}
