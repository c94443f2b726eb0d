// Backward of the bilinear gather at pixel coordinates, NHWC, border or
// zeros padding: d_img, d_x and d_y from the upstream gradient g, for one
// coordinate set per image (the backward of K5), one per channel group
// (the backward of K4), or one source sampled at G coordinate sets (the
// backward of K7).
//
// Replaces the TPU kernel K6 of the JAX package:
// kmunet_tpu/kernels/bilinear_pallas.py::_backward_impl (pl.pallas_call of
// _kernel_bwd), reached from the custom VJP of _make_gather_op. With
// shared=False for gather_bilinear_{zeros,border} (G = 1) and
// gather_bilinear_grouped (G > 1), it computes the VJP of
// kmunet_tpu/ops/sample.py::bilinear_gather_xla (G = 1) and
// bilinear_gather_grouped_xla (G > 1) with that custom VJP's conventions.
// With Cg = C / G and g(c) = c / Cg:
//   d_img[b, tap, c] += g[b, o, c] * w_tap   (4 taps, zeros mode masks them)
//   d_x[b, k, o] = sum_{c: g(c) = k} g * [(v01 - v00)(1 - wy) + (v11 - v10) wy]
//   d_y[b, k, o] = sum_{c: g(c) = k} g * [(v10 - v00)(1 - wx) + (v11 - v01) wx]
// with the taps and weights of the forward at group k's coordinates
// (clamped as the forward does). With shared=True, for
// gather_bilinear_multiview (its _kernel_bwd's shared_src branch), the VJP
// of bilinear_gather_multiview_xla: g has G * C channels, view k's block
// [k C, (k + 1) C) taken from all C channels of the one source, so
//   d_img[b, tap, c] += sum_k g[b, o, k C + c] * w_tap(k)
//   d_x[b, k, o] = sum_c g[b, o, k C + c] * [(v01 - v00)(1 - wy) + ...]
// every view scattering into the same d_img.
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
// direct scatter. A unit of work is one (output pixel, channel group), or
// with shared=True one (output pixel, view) with Cg = C; its
// Cg / VEC channel vectors are read 16 bytes at a time along C (VEC = 4 fp32
// or 8 bf16/fp16, else 1 where Cg is no multiple of it, so that a vector
// never straddles two groups), by a group of LANES threads.
//   d_img: atomicAdd of g * w_tap into an fp32 scratch that the caller
//          zeroes; a second small pass rounds it to the image dtype (the TPU
//          kernel also accumulates d_src in fp32 and casts at the end). For
//          an fp32 image the scratch is d_img and the pass is skipped.
//   d_x, d_y: each thread sums its channels' terms in fp32; the threads of a
//          unit are an aligned group of LANES lanes of one warp, LANES the
//          power of 2 at or above Cg / VEC (at most 32), so that a group
//          never straddles a warp; lanes past Cg / VEC hold 0 (Cg = 6 in
//          fp32: 6 channel vectors on 8 lanes). The group is reduced with
//          __shfl_xor_sync. A unit of more than 32 channel vectors loops over
//          them. Consecutive units are consecutive groups of one pixel, then
//          the next pixel, so a warp reads contiguous memory of g.
// The order of the atomic additions varies from run to run, so d_img is
// reproducible only up to fp32 rounding. With shared=True every view adds
// into the one d_img: at TrajGRU's enc_rnn1 shape (B=16, 32x32, C=64, G=13)
// that is 16 * 13 * 1024 * 64 * 4 = 54.5 M fp32 atomics, about 52 on each
// d_img element.
//
// Bound. Bytes: img, g and the coordinates read once, d_img, d_x and d_y
// written once. At the DAGEM bridge shape (B=128, 16x16, C=64, G=1, bf16)
// that is 4.19 + 4.19 + 0.26 MB read and 4.19 + 0.26 MB written, about
// 13.1 MB, or about 3.9 us at 3.35 TB/s; at DySample's dec3 shape (B=128,
// 64x64 -> 128x128, C=64, G=4, bf16) 67 + 268 + 67 MB read and 67 + 67 MB
// written, about 540 MB or 160 us; shared=True at TrajGRU's enc_rnn1 shape
// (B=16, 32x32, C=64, G=13, bf16) 2.1 + 27.3 + 1.7 MB read and 2.1 + 1.7 MB
// written, about 35 MB or 10.4 us. The operations (about 20 fp32 per
// element) are far below the card's rate. What this simple kernel adds to
// that: 4 fp32 atomics per (pixel, channel), about 16 landing on each
// source element at dec3 (4 subpixels x 4 taps), and the fp32 scratch's
// zeroing, write and read. Making it fast -- a tap-owner pass with no
// atomics, shared-memory staging, all 9 taps of the deformable conv in one
// launch -- is later work.

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

// C is img's channel count; g has C (shared=False) or G * C (SHARED) channels.
template <typename T, int VEC, bool ZEROS, bool SHARED>
__global__ void __launch_bounds__(256)
bilinear_gather_backward_kernel(const T* __restrict__ img, const float* __restrict__ xs,
                                const float* __restrict__ ys, const T* __restrict__ g,
                                float* __restrict__ d_img, float* __restrict__ d_x,
                                float* __restrict__ d_y, int B, int H, int W, int C, int G,
                                int HoWo, int lanes_log2) {
  // 32-bit indices: the entry point takes fewer than 2^30 elements per tensor.
  const int lanes = 1 << lanes_log2;  // threads per unit (output pixel, group)
  const int Cg = SHARED ? C : C / G;  // source channels per group (view)
  const int Cout = Cg * G;            // channels of g
  const int cvg = Cg / VEC;           // channel vectors per unit
  const int nunits = B * HoWo * G;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (lanes - 1);  // this thread's place in its unit's lanes
  const int units_per_warp = 32 >> lanes_log2;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int nwarps = (gridDim.x * blockDim.x) >> 5;
  // The loop bound depends on the warp alone, so every lane of a warp takes
  // the same trips and reaches the shuffles below together.
  for (int base = warp * units_per_warp; base < nunits; base += nwarps * units_per_warp) {
    const int u = base + (lane >> lanes_log2);  // (b * HoWo + output pixel) * G + group
    const bool active = u < nunits;
    float gx = 0.f, gy = 0.f;
    float xr = 0.f, yr = 0.f;
    int q = 0;  // index of the unit's coordinates, [b, group, pixel]
    if (active) {
      const int p = u / G;  // b * HoWo + output pixel
      const int grp = u - p * G;
      const int b = p / HoWo;
      q = (b * G + grp) * HoWo + (p - b * HoWo);
      xr = xs[q];
      yr = ys[q];
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
      for (int j = sub; j < cvg; j += lanes) {
        const int cout0 = grp * Cg + j * VEC;         // channel of g
        const int c0 = SHARED ? j * VEC : cout0;      // channel of img and d_img
        float a00[VEC], a01[VEC], a10[VEC], a11[VEC], gv[VEC];
        load_vec<T, VEC>(g + (size_t)p * Cout + cout0, true, gv);
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
      d_x[q] = gx;
      d_y[q] = gy;
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

template <typename T, int VEC, bool SHARED>
int launch(const void* img, const void* x, const void* y, const void* g, float* d_img32,
           void* d_img, float* d_x, float* d_y, int B, int H, int W, int C, int G, int Ho,
           int Wo, int zeros, cudaStream_t stream) {
  const int HoWo = Ho * Wo;
  const int nunits = B * HoWo * G;
  const int cvg = (SHARED ? C : C / G) / VEC;
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < cvg && lanes_log2 < 5) ++lanes_log2;
  if (nunits > 0) {
    const long long wanted = (((long long)nunits << lanes_log2) + kThreads - 1) / kThreads;
    const int blocks = wanted < kMaxBlocks ? (int)wanted : kMaxBlocks;
    const T* src = static_cast<const T*>(img);
    const float* xs = static_cast<const float*>(x);
    const float* ys = static_cast<const float*>(y);
    const T* gs = static_cast<const T*>(g);
    if (zeros) {
      bilinear_gather_backward_kernel<T, VEC, true, SHARED><<<blocks, kThreads, 0, stream>>>(
          src, xs, ys, gs, d_img32, d_x, d_y, B, H, W, C, G, HoWo, lanes_log2);
    } else {
      bilinear_gather_backward_kernel<T, VEC, false, SHARED><<<blocks, kThreads, 0, stream>>>(
          src, xs, ys, gs, d_img32, d_x, d_y, B, H, W, C, G, HoWo, lanes_log2);
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

template <typename T, bool SHARED>
int dispatch_vec(int vec, const void* img, const void* x, const void* y, const void* g,
                 float* d_img32, void* d_img, float* d_x, float* d_y, int B, int H, int W,
                 int C, int G, int Ho, int Wo, int zeros, cudaStream_t stream) {
  constexpr int kWide = 16 / sizeof(T);
  if (vec == kWide)
    return launch<T, kWide, SHARED>(img, x, y, g, d_img32, d_img, d_x, d_y, B, H, W, C, G,
                                    Ho, Wo, zeros, stream);
  if (vec == 1)
    return launch<T, 1, SHARED>(img, x, y, g, d_img32, d_img, d_x, d_y, B, H, W, C, G, Ho, Wo,
                                zeros, stream);
  return -1;
}

template <bool SHARED>
int backward(const void* img, const void* x, const void* y, const void* g, void* d_img32,
             void* d_img, void* d_x, void* d_y, int B, int H, int W, int C, int G, int Ho,
             int Wo, int dtype, int zeros, int vec, void* stream) {
  const int cg = SHARED ? C : C / G;  // source channels per group (view)
  if (vec < 1 || G < 1 || B < 0 || H < 1 || W < 1 || C < 1 || Ho < 0 || Wo < 0 ||
      (!SHARED && C % G != 0) || cg % vec != 0)
    return -1;
  const long long limit = 1LL << 30;  // keeps every index and the grid stride in int
  const long long cout = SHARED ? (long long)G * C : C;
  if ((long long)B * H * W * C >= limit || (long long)B * Ho * Wo * cout >= limit) return -1;
  if (dtype == 0 && d_img != d_img32) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* acc = static_cast<float*>(d_img32);
  float* dx = static_cast<float*>(d_x);
  float* dy = static_cast<float*>(d_y);
  switch (dtype) {
    case 0:
      return dispatch_vec<float, SHARED>(vec, img, x, y, g, acc, d_img, dx, dy, B, H, W, C, G,
                                         Ho, Wo, zeros, s);
    case 1:
      return dispatch_vec<__nv_bfloat16, SHARED>(vec, img, x, y, g, acc, d_img, dx, dy, B, H, W,
                                                 C, G, Ho, Wo, zeros, s);
    case 2:
      return dispatch_vec<__half, SHARED>(vec, img, x, y, g, acc, d_img, dx, dy, B, H, W, C, G,
                                          Ho, Wo, zeros, s);
    default:
      return -1;
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16, 2 = fp16, of img, g and d_img; x, y, d_x, d_y
// and d_img32 are fp32. d_img32 is a zeroed fp32 scratch of img's shape; for
// an fp32 image pass d_img == d_img32. vec: channels per thread, either
// 16 / sizeof(dtype) (C / G, for K7's backward C, divisible by it, img and g
// 16-byte aligned) or 1.
// Returns cudaGetLastError() after the launches, or -1 for an argument the
// kernel does not take.

// The backward of K5: x, y, d_x, d_y (B, Ho, Wo).
extern "C" int kmunet_bilinear_gather_backward(const void* img, const void* x, const void* y,
                                               const void* g, void* d_img32, void* d_img,
                                               void* d_x, void* d_y, int B, int H, int W,
                                               int C, int Ho, int Wo, int dtype, int zeros,
                                               int vec, void* stream) {
  return backward<false>(img, x, y, g, d_img32, d_img, d_x, d_y, B, H, W, C, 1, Ho, Wo, dtype,
                         zeros, vec, stream);
}

// The backward of K4: x, y, d_x, d_y (B, G, Ho, Wo).
extern "C" int kmunet_bilinear_gather_grouped_backward(
    const void* img, const void* x, const void* y, const void* g, void* d_img32, void* d_img,
    void* d_x, void* d_y, int B, int H, int W, int C, int G, int Ho, int Wo, int dtype,
    int zeros, int vec, void* stream) {
  return backward<false>(img, x, y, g, d_img32, d_img, d_x, d_y, B, H, W, C, G, Ho, Wo, dtype,
                         zeros, vec, stream);
}

// The backward of K7 (shared=True): x, y, d_x, d_y (B, G, Ho, Wo); g (B, Ho, Wo, G * C);
// d_img (B, H, W, C) summed over the views.
extern "C" int kmunet_bilinear_gather_multiview_backward(
    const void* img, const void* x, const void* y, const void* g, void* d_img32, void* d_img,
    void* d_x, void* d_y, int B, int H, int W, int C, int G, int Ho, int Wo, int dtype,
    int zeros, int vec, void* stream) {
  return backward<true>(img, x, y, g, d_img32, d_img, d_x, d_y, B, H, W, C, G, Ho, Wo, dtype,
                        zeros, vec, stream);
}
