// Bilinear gather at pixel coordinates, NHWC, border or zeros padding.
//
// Replaces the TPU kernel K5 of the JAX package:
// kmunet_tpu/kernels/bilinear_pallas.py::gather_bilinear_zeros and
// ::gather_bilinear_border (pl.pallas_call in _forward). It computes what
// kmunet_tpu/ops/sample.py::bilinear_gather_xla computes:
//   out[b, o, c] = bilinear sample of img[b, :, :, c] at (x[b, o], y[b, o])
// with x along W and y along H, integer coordinates on pixel centres.
//   border: x, y clamped to [0, W-1] x [0, H-1] first; a tap one past the
//           last pixel reads the last pixel (its weight is 0 there anyway).
//   zeros:  a tap outside [0, H-1] x [0, W-1] reads 0. The coordinates are
//           clamped to [-2, W+1] x [-2, H+1] before the int conversion, as
//           the TPU kernel does: beyond that both taps of an axis are out
//           of range, so the clamp changes nothing but cannot overflow.
//
// Design. The TPU kernel writes the gather as MXU matmuls against 0/1 tap
// rows, because a TPU cannot gather rows fast. Hopper can, so this is a
// direct gather: one thread per (output pixel, vector of VEC channels),
// reading 16 bytes along C per tap (VEC = 4 fp32 or 8 bf16/fp16), with
// neighbouring threads on neighbouring channel vectors of one pixel, then
// neighbouring pixels. Coordinate and weight arithmetic and the blend are
// fp32; the output is rounded once to the input's dtype.
//
// Bound. Bytes: each output element reads 4 taps that mostly hit L2/L1
// (neighbouring outputs share taps), so the least traffic is img read once,
// the coordinates read once and out written once. At the DAGEM bridge shape
// (B=128, 16x16, C=64, bf16) that is 4.19 MB + 0.26 MB + 4.19 MB, about
// 8.6 MB, or about 2.6 us at 3.35 TB/s; the ops (about 8 per output element)
// are far below the card's rate. At B <= 8 the launch overhead (a few us)
// dominates, and one call at a time from Python the wrapper's host time
// exceeds the kernel's device time at these shapes (chip_smoke.py reports
// both). Making it fast -- cp.async/TMA staging of the source tile, all 9
// taps of a deformable conv in one launch -- is later work.

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

// Loads img[pix, c0:c0+VEC] as fp32 into v, or zeros for a masked tap.
template <typename T, int VEC>
__device__ __forceinline__ void load_tap(const T* __restrict__ img, int pix, int C,
                                         int c0, bool valid, float (&v)[VEC]) {
  if (!valid) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = 0.f;
    return;
  }
  const Vec<T, VEC> t = *reinterpret_cast<const Vec<T, VEC>*>(img + pix * C + c0);
#pragma unroll
  for (int k = 0; k < VEC; ++k) v[k] = to_f32(t.v[k]);
}

template <typename T, int VEC, bool ZEROS>
__global__ void __launch_bounds__(256)
bilinear_gather_kernel(const T* __restrict__ img, const float* __restrict__ xs,
                       const float* __restrict__ ys, T* __restrict__ out,
                       int B, int H, int W, int C, int HoWo) {
  // 32-bit indices: the entry point takes fewer than 2^30 elements per tensor.
  const int cv = C / VEC;  // channel vectors per pixel
  const int total = B * HoWo * cv;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    const int c0 = (i % cv) * VEC;
    const int p = i / cv;  // b * HoWo + output pixel
    const int b = p / HoWo;
    float x = xs[p];
    float y = ys[p];
    if (ZEROS) {
      x = fminf(fmaxf(x, -2.f), (float)W + 1.f);
      y = fminf(fmaxf(y, -2.f), (float)H + 1.f);
    } else {
      x = fminf(fmaxf(x, 0.f), (float)(W - 1));
      y = fminf(fmaxf(y, 0.f), (float)(H - 1));
    }
    const float x0f = floorf(x);
    const float y0f = floorf(y);
    const float wx = x - x0f;
    const float wy = y - y0f;
    int x0 = (int)x0f, y0 = (int)y0f;
    int x1 = x0 + 1, y1 = y0 + 1;
    bool vx0 = true, vx1 = true, vy0 = true, vy1 = true;
    if (ZEROS) {
      vx0 = x0 >= 0 && x0 <= W - 1;
      vx1 = x1 >= 0 && x1 <= W - 1;
      vy0 = y0 >= 0 && y0 <= H - 1;
      vy1 = y1 >= 0 && y1 <= H - 1;
    } else {
      // Border: x0, y0 already lie in range; the far tap duplicates the edge.
      x1 = min(x1, W - 1);
      y1 = min(y1, H - 1);
    }
    const int row0 = b * H + y0;
    const int row1 = b * H + y1;
    float v00[VEC], v01[VEC], v10[VEC], v11[VEC];
    load_tap<T, VEC>(img, row0 * W + x0, C, c0, vy0 && vx0, v00);
    load_tap<T, VEC>(img, row0 * W + x1, C, c0, vy0 && vx1, v01);
    load_tap<T, VEC>(img, row1 * W + x0, C, c0, vy1 && vx0, v10);
    load_tap<T, VEC>(img, row1 * W + x1, C, c0, vy1 && vx1, v11);
    Vec<T, VEC> r;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float top = v00[k] * (1.f - wx) + v01[k] * wx;
      const float bot = v10[k] * (1.f - wx) + v11[k] * wx;
      r.v[k] = from_f32<T>(top * (1.f - wy) + bot * wy);
    }
    *reinterpret_cast<Vec<T, VEC>*>(out + p * C + c0) = r;
  }
}

template <typename T, int VEC>
int launch(const void* img, const void* x, const void* y, void* out, int B, int H,
           int W, int C, int Ho, int Wo, int zeros, cudaStream_t stream) {
  const int HoWo = Ho * Wo;
  const int total = B * HoWo * (C / VEC);
  if (total == 0) return 0;
  const int threads = 256;
  const int blocks = min((total + threads - 1) / threads, 132 * 64);  // then grid-stride
  const T* src = static_cast<const T*>(img);
  const float* xs = static_cast<const float*>(x);
  const float* ys = static_cast<const float*>(y);
  T* dst = static_cast<T*>(out);
  if (zeros) {
    bilinear_gather_kernel<T, VEC, true><<<blocks, threads, 0, stream>>>(
        src, xs, ys, dst, B, H, W, C, HoWo);
  } else {
    bilinear_gather_kernel<T, VEC, false><<<blocks, threads, 0, stream>>>(
        src, xs, ys, dst, B, H, W, C, HoWo);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_vec(int vec, const void* img, const void* x, const void* y, void* out,
                 int B, int H, int W, int C, int Ho, int Wo, int zeros,
                 cudaStream_t stream) {
  constexpr int kWide = 16 / sizeof(T);
  if (vec == kWide) return launch<T, kWide>(img, x, y, out, B, H, W, C, Ho, Wo, zeros, stream);
  if (vec == 1) return launch<T, 1>(img, x, y, out, B, H, W, C, Ho, Wo, zeros, stream);
  return -1;
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16, 2 = fp16. vec: channels per thread, either
// 16 / sizeof(dtype) (C divisible by it, img 16-byte aligned) or 1.
// Returns cudaGetLastError() after the launch, or -1 for an argument the
// kernel does not take.
extern "C" int kmunet_bilinear_gather(const void* img, const void* x, const void* y,
                                      void* out, int B, int H, int W, int C, int Ho,
                                      int Wo, int dtype, int zeros, int vec,
                                      void* stream) {
  if (vec < 1 || B < 0 || H < 1 || W < 1 || C < 1 || Ho < 0 || Wo < 0 || C % vec != 0)
    return -1;
  const long long limit = 1LL << 30;  // keeps every index and the grid stride in int
  if ((long long)B * H * W * C >= limit || (long long)B * Ho * Wo * C >= limit) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_vec<float>(vec, img, x, y, out, B, H, W, C, Ho, Wo, zeros, s);
    case 1: return dispatch_vec<__nv_bfloat16>(vec, img, x, y, out, B, H, W, C, Ho, Wo, zeros, s);
    case 2: return dispatch_vec<__half>(vec, img, x, y, out, B, H, W, C, Ho, Wo, zeros, s);
    default: return -1;
  }
}
