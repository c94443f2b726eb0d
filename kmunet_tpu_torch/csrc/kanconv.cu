// K1: the fused KAN convolution, stride 1, 3x3, over a pre-padded input.
//
//   out[b,f,i,j] = sum_{c,kh,kw} silu(xp[b,c,i+kh,j+kw]) * base[f,c,kh,kw]
//                + sum_{c,kh,kw,q} B_q(xp[b,c,i+kh,j+kw]) * spline[f,c*8+q,kh,kw]
//
// B_q is basis q of the cubic B-spline on the uniform grid of 5 intervals
// over [-1, 1] (8 bases, each a shift of the cardinal spline M4 on [0, 4)):
// B_q(x) = M4(u - q), u = (x + 1) / 0.4 + 3. xp (B, C, H+2, W+2) NCHW, zero
// padded by the caller (a padded pixel adds silu(0) = 0 to the base branch
// but B_q(0) != 0 to the spline branch, so the padding must be zeros of x);
// the weights fp32, reordered by the wrapper to (C, 9, Fp) and (C, 9, 8, Fp),
// F padded to Fp = a multiple of 16 with zeros; xp and out (B, F, H, W) in one
// dtype (fp32, bf16 or fp16); every basis, product and sum in fp32.
//
// Replaces the TPU kernel kmunet_tpu/kernels/kanconv_pallas.py::fused_kanconv
// (the pl.pallas_call in _forward, :151). Its gradient is the autodiff of the
// plain version (kernels/kanconv.py), as the TPU kernel's custom VJP is the
// autodiff of kanconv_reference.
//
// Design. The TPU kernel evaluates all 8 bases of a tile in VMEM and
// contracts them with 9 shifted MXU matmuls, dense. Here each block computes
// a 16 x 32 tile of output pixels for 16 output channels, a thread two
// pixels of one column, its 2 x 16 sums in registers. It stages the tile's
// 18 x 34 halo of xp, 4 channels at a time, in shared memory as 9 terms per
// value, silu(x) and the 8 bases, each value's loads all in flight before
// its terms are computed: the interval j = floor(u) gives the at most 4
// nonzero bases (j-3 .. j; none outside [-2.2, 2.2)), evaluated once each,
// on the piece the plain version chooses (t = u - q is exact, so t < 1, < 2,
// < 3 select the same piece), the other bases 0. The basis never reaches
// device memory. The products are dense, 9 MACs per (pixel, f, c, tap), as
// the TPU kernel's: every weight is then a broadcast from shared memory (a
// float4 feeds 8 MACs of the thread's two pixels), where skipping the zero
// bases made each pixel gather its own 4 spline rows; that sparse first
// version was shared-memory bound and took twice the time.
//
// Bound. At KM_UNetV3-SH's enc1 (B = 128, 16 -> 16 channels at 128^2, bf16)
// xp is 69.2 MB and the output 67.1 MB: 136 MB, 40.7 us at 3.35 TB/s. The
// nonzero contraction is (4 + 1) MACs per (pixel, f, c, tap) inside [-1, 1]:
// 48.3 GFLOP, 48.9 us on the tensor cores (the dense one, (8 + 1) MACs, 87.0
// GFLOP, 88 us). So operations bound it. This kernel does the dense count on
// the CUDA cores at fp32's 67 TFLOP/s, 1.3 ms at best; a dense basis fed to
// the tensor cores is the later step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>

namespace {

constexpr int kTH = 16, kTW = 32;        // output pixels per block
constexpr int kRows = 2;                 // output rows per thread (same column)
constexpr int kThreads = kTH / kRows * kTW;
constexpr int kFT = 16;                  // output channels per block
constexpr int kCC = 4;                   // input channels staged at a time
constexpr int kHW = kTW + 2;             // halo width
constexpr int kHalo = (kTH + 2) * kHW;
constexpr int kStage = (kCC * kHalo + kThreads - 1) / kThreads;  // halo values per thread
constexpr int kTaps = 9;
constexpr int kBases = 8;
constexpr int kTerms = 1 + kBases;       // silu, then the 8 bases
constexpr int kWeights = kCC * kTaps * kTerms * kFT;  // staged weights per channel chunk
constexpr size_t kSmem = sizeof(float) * ((size_t)kCC * kTerms * kHalo + kWeights);
constexpr float kLo = -1.f;
constexpr float kKnot = 0.4f;            // (1 - (-1)) / 5
constexpr float kSixth = 1.f / 6.f;

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

// The pieces of M4 on [0, 1), [1, 2), [2, 3), [3, 4), as the plain version
// writes them.
__device__ __forceinline__ float piece0(float t) { return t * t * t * kSixth; }
__device__ __forceinline__ float piece1(float t) {
  const float t2 = t * t, t3 = t2 * t;
  return (-3.f * t3 + 12.f * t2 - 12.f * t + 4.f) * kSixth;
}
__device__ __forceinline__ float piece2(float t) {
  const float t2 = t * t, t3 = t2 * t;
  return (3.f * t3 - 24.f * t2 + 60.f * t - 44.f) * kSixth;
}
__device__ __forceinline__ float piece3(float t) {
  const float r = 4.f - t;
  return r * r * r * kSixth;
}

// The 8 bases at x, of which at most 4 (j-3 .. j, j = floor(u)) are
// nonzero: each of those is evaluated once, on the piece the plain version
// selects for it.
__device__ __forceinline__ void bases_at(float x, float (&basis)[kBases]) {
  const float u = (x - kLo) / kKnot + 3.f;  // a division, as the plain version
  float v[4] = {0.f, 0.f, 0.f, 0.f};        // of bases j-3, j-2, j-1, j
  int lo = -8;                               // no basis of 0..7 when u is outside [0, 11)
  if (u >= 0.f && u < 11.f) {
    const int j = (int)floorf(u);
    lo = j - 3;
    v[0] = piece3(u - (float)(j - 3));
    v[1] = piece2(u - (float)(j - 2));
    v[2] = piece1(u - (float)(j - 1));
    v[3] = piece0(u - (float)j);
  }
#pragma unroll
  for (int b = 0; b < kBases; ++b) {
    const int k = b - lo;
    basis[b] = k == 0 ? v[0] : k == 1 ? v[1] : k == 2 ? v[2] : k == 3 ? v[3] : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) kanconv_kernel(
    const T* __restrict__ xp, const float* __restrict__ wk, T* __restrict__ out, int C, int F,
    int Fp, int H, int W, int tiles_w) {
  extern __shared__ __align__(16) float smem[];
  float* s_a = smem;                           // [c][term][halo position]
  float* s_w = smem + kCC * kTerms * kHalo;    // [c][tap][term][f]

  const int tid = threadIdx.x, ty = tid / kTW, tx = tid % kTW;
  const int i0 = (blockIdx.x / tiles_w) * kTH, j0 = (blockIdx.x % tiles_w) * kTW;
  const int f0 = blockIdx.y * kFT, b = blockIdx.z;
  const int Hp = H + 2, Wp = W + 2;
  const T* xb = xp + (long long)b * C * Hp * Wp;

  float acc[kRows][kFT];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int f = 0; f < kFT; ++f) acc[r][f] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kCC) {
    // The halo's loads first, all in flight, then the terms of each value.
    float xv[kStage];
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int idx = tid + k * kThreads;
      const int c = c0 + idx / kHalo, pos = idx % kHalo;
      const int gi = i0 + pos / kHW, gj = j0 + pos % kHW;
      xv[k] = (idx < kCC * kHalo && c < C && gi < Hp && gj < Wp)
                  ? to_f32(xb[((long long)c * Hp + gi) * Wp + gj]) : 0.f;
    }
#pragma unroll 4
    for (int k = 0; k < (kWeights + kThreads - 1) / kThreads; ++k) {
      const int idx = tid + k * kThreads, row = idx / kFT;  // row = (c - c0) * 81 + tap * 9 + term
      if (idx < kWeights)
        s_w[idx] = c0 + row / (kTaps * kTerms) < C
                       ? wk[((long long)c0 * kTaps * kTerms + row) * Fp + f0 + idx % kFT] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int idx = tid + k * kThreads;
      if (idx < kCC * kHalo) {
        const int cc = idx / kHalo, pos = idx % kHalo;
        float basis[kBases];
        bases_at(xv[k], basis);
        float* a = s_a + cc * kTerms * kHalo + pos;
        a[0] = xv[k] / (1.f + expf(-xv[k]));
#pragma unroll
        for (int q = 0; q < kBases; ++q) a[(1 + q) * kHalo] = basis[q];
      }
    }
    __syncthreads();
    const int cc_end = min(kCC, C - c0);
    for (int cc = 0; cc < cc_end; ++cc) {
#pragma unroll 1  // unrolled, the taps' loads are hoisted into too many registers
      for (int tap = 0; tap < kTaps; ++tap) {
        const float* a = s_a + cc * kTerms * kHalo + (kRows * ty + tap / 3) * kHW + tx + tap % 3;
        float av[kRows][kTerms];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int t = 0; t < kTerms; ++t) av[r][t] = a[t * kHalo + r * kHW];
        const float4* w4 = reinterpret_cast<const float4*>(s_w + (cc * kTaps + tap) * kTerms * kFT);
#pragma unroll
        for (int t = 0; t < kTerms; ++t) {
#pragma unroll
          for (int f4 = 0; f4 < kFT / 4; ++f4) {
            const float4 w = w4[t * (kFT / 4) + f4];
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              acc[r][4 * f4] = fmaf(av[r][t], w.x, acc[r][4 * f4]);
              acc[r][4 * f4 + 1] = fmaf(av[r][t], w.y, acc[r][4 * f4 + 1]);
              acc[r][4 * f4 + 2] = fmaf(av[r][t], w.z, acc[r][4 * f4 + 2]);
              acc[r][4 * f4 + 3] = fmaf(av[r][t], w.w, acc[r][4 * f4 + 3]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  const int j = j0 + tx;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + kRows * ty + r;
    if (i < H && j < W) {
#pragma unroll
      for (int f = 0; f < kFT; ++f)
        if (f0 + f < F)
          out[(((long long)b * F + f0 + f) * H + i) * W + j] = from_f32<T>(acc[r][f]);
    }
  }
}

template <typename T>
int run(const void* xp, const void* wk, void* out, int B, int C, int F, int H, int W,
        cudaStream_t stream) {
  const int Fp = (F + kFT - 1) / kFT * kFT;
  const int tiles_w = (W + kTW - 1) / kTW, tiles_h = (H + kTH - 1) / kTH;
  const dim3 grid(tiles_h * tiles_w, Fp / kFT, B);
  int err = (int)cudaFuncSetAttribute(kanconv_kernel<T>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != 0) return err;
  kanconv_kernel<T><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(xp), static_cast<const float*>(wk), static_cast<T*>(out), C, F, Fp,
      H, W, tiles_w);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16, 2 = fp16, of xp (B, C, H+2, W+2) and out
// (B, F, H, W); wk (C, 9, 9, Fp) fp32: per input channel and tap, the base
// weight (term 0) and the 8 spline weights (terms 1-8), F padded to Fp, a
// multiple of 16, with zeros. Returns cudaGetLastError() after the launch,
// or -1 for an argument the kernel does not take.
extern "C" int kmunet_kanconv(const void* xp, const void* wk, void* out, int B, int C, int F,
                              int H, int W, int dtype, void* stream) {
  if (B < 1 || B > 65535 || C < 1 || F < 1 || H < 1 || W < 1 || (F + kFT - 1) / kFT > 65535)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return run<float>(xp, wk, out, B, C, F, H, W, s);
    case 1: return run<__nv_bfloat16>(xp, wk, out, B, C, F, H, W, s);
    case 2: return run<__half>(xp, wk, out, B, C, F, H, W, s);
    default: return -1;
  }
}
