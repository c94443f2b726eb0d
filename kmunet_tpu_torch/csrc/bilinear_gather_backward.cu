// Backward of the bilinear gather (K5) at pixel coordinates, NHWC, border or
// zeros padding: d_img, d_x and d_y from the upstream gradient g.
//
// Replaces the TPU kernel K6 of the JAX package for one coordinate set per
// image (G = 1), the backward of K5:
// kmunet_tpu/kernels/bilinear_pallas.py::_backward_impl (pl.pallas_call of
// _kernel_bwd), reached from the custom VJP of _make_gather_op. It computes
// the VJP of kmunet_tpu/ops/sample.py::bilinear_gather_xla with that custom
// VJP's conventions:
//   d_img[b, tap, c] += g[b, o, c] * w_tap   (4 taps, zeros mode masks them)
//   d_x[b, o] = sum_c g * [(v01 - v00)(1 - wy) + (v11 - v10) wy]
//   d_y[b, o] = sum_c g * [(v10 - v00)(1 - wx) + (v11 - v01) wx]
// with the taps and weights of the forward (coordinates clamped as K5 does).
// Border mode: the coordinate gradients are 0 where x0 (y0) sits on the last
// pixel, because the far tap duplicates the edge pixel there as in the XLA
// reference (the Pallas kernel has to mask them), then chained through the
// border clamp as jnp.clip's VJP does: jnp.clip is minimum(maximum(v, lo),
// hi), and each of maximum and minimum passes half the cotangent at a tie,
// so a coordinate exactly on 0 or dim-1 gets 0.5 of it.
// Zeros mode has no clamp to chain: beyond [-2, dim+1] every tap is masked.
//
// Design. The TPU kernel transposes its matmul formulation (0/1 tap rows) so
// that it needs no scatter. Hopper has fast atomics in L2, so this is a
// direct scatter: one thread per (output pixel, vector of VEC channels),
// the same layout as K5, reading 16 bytes along C per tap and of g.
//   d_img: atomicAdd of g * w_tap into an fp32 scratch that the caller
//          zeroes; a second small pass rounds it to the image dtype (the TPU
//          kernel also accumulates d_src in fp32 and casts at the end). For
//          an fp32 image the scratch is d_img and the pass is skipped.
//   d_x, d_y: each thread sums its channels' terms in fp32; the threads of a
//          pixel are an aligned group of LANES (a power of 2 <= 32) lanes of
//          one warp, reduced with __shfl_xor_sync. A pixel with more than 32
//          channel vectors loops over them.
// The order of the atomic additions varies from run to run, so d_img is
// reproducible only up to fp32 rounding.
//
// Bound. Bytes: img, g and the coordinates read once, d_img, d_x and d_y
// written once. At the DAGEM bridge shape (B=128, 16x16, C=64, bf16) that is
// 4.19 + 4.19 + 0.26 MB read and 4.19 + 0.26 MB written, about 13.1 MB, or
// about 3.9 us at 3.35 TB/s; the operations (about 20 fp32 per element) are
// far below the card's rate. What this simple kernel adds to that: 4 fp32
// atomics per (pixel, channel) and the fp32 scratch's zeroing, write and
// read. Making it fast -- a tap-owner pass with no atomics, shared-memory
// staging, all 9 taps of the deformable conv in one launch -- is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

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

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

// Loads p[0:VEC] as fp32 into v, or zeros where valid is false.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, bool valid, float (&v)[VEC]) {
  if (!valid) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = 0.f;
    return;
  }
  const Vec<T, VEC> t = *reinterpret_cast<const Vec<T, VEC>*>(p);
#pragma unroll
  for (int k = 0; k < VEC; ++k) v[k] = to_f32(t.v[k]);
}

template <int VEC>
__device__ __forceinline__ void scatter(float* __restrict__ d_img, bool valid, float w,
                                        const float (&gv)[VEC]) {
  if (!valid) return;
#pragma unroll
  for (int k = 0; k < VEC; ++k) atomicAdd(d_img + k, gv[k] * w);
}

// d/dv of jnp.clip(v, lo, hi) = minimum(maximum(v, lo), hi), ties at half.
__device__ __forceinline__ float clip_vjp(float v, float lo, float hi) {
  float f = v > lo ? 1.f : (v == lo ? 0.5f : 0.f);
  const float m = fmaxf(v, lo);
  return f * (m < hi ? 1.f : (m == hi ? 0.5f : 0.f));
}

template <typename T, int VEC, bool ZEROS>
__global__ void __launch_bounds__(256)
bilinear_gather_backward_kernel(const T* __restrict__ img, const float* __restrict__ xs,
                                const float* __restrict__ ys, const T* __restrict__ g,
                                float* __restrict__ d_img, float* __restrict__ d_x,
                                float* __restrict__ d_y, int B, int H, int W, int C,
                                int HoWo, int lanes_log2) {
  // 32-bit indices: the entry point takes fewer than 2^30 elements per tensor.
  const int lanes = 1 << lanes_log2;  // threads per output pixel
  const int cv = C / VEC;             // channel vectors per pixel
  const int npix = B * HoWo;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (lanes - 1);  // this thread's place in its pixel's group
  const int pix_per_warp = 32 >> lanes_log2;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int nwarps = (gridDim.x * blockDim.x) >> 5;
  // The loop bound depends on the warp alone, so every lane of a warp takes
  // the same trips and reaches the shuffles below together.
  for (int base = warp * pix_per_warp; base < npix; base += nwarps * pix_per_warp) {
    const int p = base + (lane >> lanes_log2);  // b * HoWo + output pixel
    const bool active = p < npix;
    float gx = 0.f, gy = 0.f;
    float xr = 0.f, yr = 0.f;
    if (active) {
      const int b = p / HoWo;
      xr = xs[p];
      yr = ys[p];
      float x, y;
      if (ZEROS) {
        x = fminf(fmaxf(xr, -2.f), (float)W + 1.f);
        y = fminf(fmaxf(yr, -2.f), (float)H + 1.f);
      } else {
        x = fminf(fmaxf(xr, 0.f), (float)(W - 1));
        y = fminf(fmaxf(yr, 0.f), (float)(H - 1));
      }
      const float x0f = floorf(x);
      const float y0f = floorf(y);
      const float wx = x - x0f;
      const float wy = y - y0f;
      const int x0 = (int)x0f, y0 = (int)y0f;
      int x1 = x0 + 1, y1 = y0 + 1;
      bool vx0 = true, vx1 = true, vy0 = true, vy1 = true;
      if (ZEROS) {
        vx0 = x0 >= 0 && x0 <= W - 1;
        vx1 = x1 >= 0 && x1 <= W - 1;
        vy0 = y0 >= 0 && y0 <= H - 1;
        vy1 = y1 >= 0 && y1 <= H - 1;
      } else {
        x1 = min(x1, W - 1);
        y1 = min(y1, H - 1);
      }
      const bool v00 = vy0 && vx0, v01 = vy0 && vx1, v10 = vy1 && vx0, v11 = vy1 && vx1;
      // Masked taps never form an address: their pixel index may be out of range.
      const int pix00 = v00 ? (b * H + y0) * W + x0 : 0;
      const int pix01 = v01 ? (b * H + y0) * W + x1 : 0;
      const int pix10 = v10 ? (b * H + y1) * W + x0 : 0;
      const int pix11 = v11 ? (b * H + y1) * W + x1 : 0;
      const float w00 = (1.f - wx) * (1.f - wy), w01 = wx * (1.f - wy);
      const float w10 = (1.f - wx) * wy, w11 = wx * wy;
      for (int j = sub; j < cv; j += lanes) {
        const int c0 = j * VEC;
        float a00[VEC], a01[VEC], a10[VEC], a11[VEC], gv[VEC];
        load_vec<T, VEC>(g + (size_t)p * C + c0, true, gv);
        load_vec<T, VEC>(img + pix00 * C + c0, v00, a00);
        load_vec<T, VEC>(img + pix01 * C + c0, v01, a01);
        load_vec<T, VEC>(img + pix10 * C + c0, v10, a10);
        load_vec<T, VEC>(img + pix11 * C + c0, v11, a11);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          gx += gv[k] * ((a01[k] - a00[k]) * (1.f - wy) + (a11[k] - a10[k]) * wy);
          gy += gv[k] * ((a10[k] - a00[k]) * (1.f - wx) + (a11[k] - a01[k]) * wx);
        }
        scatter<VEC>(d_img + pix00 * C + c0, v00, w00, gv);
        scatter<VEC>(d_img + pix01 * C + c0, v01, w01, gv);
        scatter<VEC>(d_img + pix10 * C + c0, v10, w10, gv);
        scatter<VEC>(d_img + pix11 * C + c0, v11, w11, gv);
      }
    }
    for (int off = lanes >> 1; off > 0; off >>= 1) {
      gx += __shfl_xor_sync(0xffffffffu, gx, off);
      gy += __shfl_xor_sync(0xffffffffu, gy, off);
    }
    if (active && sub == 0) {
      if (!ZEROS) {
        gx *= clip_vjp(xr, 0.f, (float)(W - 1));
        gy *= clip_vjp(yr, 0.f, (float)(H - 1));
      }
      d_x[p] = gx;
      d_y[p] = gy;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
round_kernel(const float* __restrict__ src, T* __restrict__ dst, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    dst[i] = from_f32<T>(src[i]);
}

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 32;  // then grid-stride

template <typename T, int VEC>
int launch(const void* img, const void* x, const void* y, const void* g, float* d_img32,
           void* d_img, float* d_x, float* d_y, int B, int H, int W, int C, int Ho, int Wo,
           int zeros, cudaStream_t stream) {
  const int HoWo = Ho * Wo;
  const int npix = B * HoWo;
  const int cv = C / VEC;
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < cv && lanes_log2 < 5) ++lanes_log2;
  if (npix > 0) {
    const long long wanted = (((long long)npix << lanes_log2) + kThreads - 1) / kThreads;
    const int blocks = wanted < kMaxBlocks ? (int)wanted : kMaxBlocks;
    const T* src = static_cast<const T*>(img);
    const float* xs = static_cast<const float*>(x);
    const float* ys = static_cast<const float*>(y);
    const T* gs = static_cast<const T*>(g);
    if (zeros) {
      bilinear_gather_backward_kernel<T, VEC, true><<<blocks, kThreads, 0, stream>>>(
          src, xs, ys, gs, d_img32, d_x, d_y, B, H, W, C, HoWo, lanes_log2);
    } else {
      bilinear_gather_backward_kernel<T, VEC, false><<<blocks, kThreads, 0, stream>>>(
          src, xs, ys, gs, d_img32, d_x, d_y, B, H, W, C, HoWo, lanes_log2);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int n = B * H * W * C;
  if (static_cast<void*>(d_img32) != d_img && n > 0) {
    const int wanted = (n + kThreads - 1) / kThreads;
    const int blocks = wanted < kMaxBlocks ? wanted : kMaxBlocks;
    round_kernel<T><<<blocks, kThreads, 0, stream>>>(d_img32, static_cast<T*>(d_img), n);
    return (int)cudaGetLastError();
  }
  return 0;
}

template <typename T>
int dispatch_vec(int vec, const void* img, const void* x, const void* y, const void* g,
                 float* d_img32, void* d_img, float* d_x, float* d_y, int B, int H, int W,
                 int C, int Ho, int Wo, int zeros, cudaStream_t stream) {
  constexpr int kWide = 16 / sizeof(T);
  if (vec == kWide)
    return launch<T, kWide>(img, x, y, g, d_img32, d_img, d_x, d_y, B, H, W, C, Ho, Wo, zeros,
                            stream);
  if (vec == 1)
    return launch<T, 1>(img, x, y, g, d_img32, d_img, d_x, d_y, B, H, W, C, Ho, Wo, zeros,
                        stream);
  return -1;
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16, 2 = fp16, of img, g and d_img; x, y, d_x, d_y
// and d_img32 are fp32. d_img32 is a zeroed fp32 scratch of img's shape; for
// an fp32 image pass d_img == d_img32. vec: channels per thread, either
// 16 / sizeof(dtype) (C divisible by it, img and g 16-byte aligned) or 1.
// Returns cudaGetLastError() after the launches, or -1 for an argument the
// kernel does not take.
extern "C" int kmunet_bilinear_gather_backward(const void* img, const void* x, const void* y,
                                               const void* g, void* d_img32, void* d_img,
                                               void* d_x, void* d_y, int B, int H, int W,
                                               int C, int Ho, int Wo, int dtype, int zeros,
                                               int vec, void* stream) {
  if (vec < 1 || B < 0 || H < 1 || W < 1 || C < 1 || Ho < 0 || Wo < 0 || C % vec != 0)
    return -1;
  const long long limit = 1LL << 30;  // keeps every index and the grid stride in int
  if ((long long)B * H * W * C >= limit || (long long)B * Ho * Wo * C >= limit) return -1;
  if (dtype == 0 && d_img != d_img32) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* acc = static_cast<float*>(d_img32);
  float* dx = static_cast<float*>(d_x);
  float* dy = static_cast<float*>(d_y);
  switch (dtype) {
    case 0:
      return dispatch_vec<float>(vec, img, x, y, g, acc, d_img, dx, dy, B, H, W, C, Ho, Wo,
                                 zeros, s);
    case 1:
      return dispatch_vec<__nv_bfloat16>(vec, img, x, y, g, acc, d_img, dx, dy, B, H, W, C, Ho,
                                         Wo, zeros, s);
    case 2:
      return dispatch_vec<__half>(vec, img, x, y, g, acc, d_img, dx, dy, B, H, W, C, Ho, Wo,
                                  zeros, s);
    default:
      return -1;
  }
}
