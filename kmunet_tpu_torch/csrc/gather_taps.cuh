// Device helpers of the bilinear gathers, included by bilinear_gather.cu
// (K4), multiview_gather.cu (K7 and K5) and bilinear_gather_backward.cu (K6): the
// dtype conversions, the vector type of a 16-byte channel load and one
// coordinate pair's taps, so that the forwards and the backward take the
// same padding rules and the same fractions, bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

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

// The taps of one coordinate pair (x along W, y along H, integers on pixel
// centres): its columns x0, x1 and rows y0, y1, the fractions wx = x - x0,
// wy = y - y0, and whether each column and row lies in the image.
//   border: x, y clamped to [0, W-1] x [0, H-1] first; x1 = min(x0 + 1,
//           W - 1) and y1 likewise (a tap one past the last pixel reads the
//           last pixel; its weight is 0 there anyway); every tap valid.
//   zeros:  x, y clamped to [-2, W+1] x [-2, H+1] before the int
//           conversion (beyond that both taps of an axis are out of range,
//           so the clamp changes nothing but cannot overflow); x1 = x0 + 1,
//           y1 = y0 + 1; a tap outside [0, H-1] x [0, W-1] reads 0.
struct Taps {
  int x0, y0, x1, y1;
  float wx, wy;
  bool vx0, vx1, vy0, vy1;
};

template <bool ZEROS>
__device__ __forceinline__ Taps taps(float xr, float yr, int H, int W) {
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
  Taps t;
  t.wx = x - x0f;
  t.wy = y - y0f;
  t.x0 = (int)x0f;
  t.y0 = (int)y0f;
  t.x1 = ZEROS ? t.x0 + 1 : min(t.x0 + 1, W - 1);
  t.y1 = ZEROS ? t.y0 + 1 : min(t.y0 + 1, H - 1);
  t.vx0 = !ZEROS || (t.x0 >= 0 && t.x0 <= W - 1);
  t.vx1 = !ZEROS || (t.x1 >= 0 && t.x1 <= W - 1);
  t.vy0 = !ZEROS || (t.y0 >= 0 && t.y0 <= H - 1);
  t.vy1 = !ZEROS || (t.y1 >= 0 && t.y1 <= H - 1);
  return t;
}

}  // namespace
