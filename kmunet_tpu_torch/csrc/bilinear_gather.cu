// K4: the bilinear gather at pixel coordinates, NHWC, border or zeros
// padding, one coordinate set per channel group. K7, one source sampled at G
// coordinate sets, is csrc/multiview_gather.cu; K5, one coordinate set per
// image, is K7's kernel at G = 1 (below).
//
// Replaces the TPU kernel kmunet_tpu/kernels/bilinear_pallas.py::
// gather_bilinear_grouped (pl.pallas_call in _forward_grouped), what
// ops/sample.py::bilinear_gather_grouped_xla computes: channel block g
// (C / G channels) is sampled at its own coordinates,
//   out[b, o, c] = bilinear sample of img[b, :, :, c] at
//                  (x[b, c / Cg, o], y[b, c / Cg, o]),  Cg = C / G.
// x runs along W and y along H, integer coordinates on pixel centres.
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
// neighbouring pixels. A vector never straddles two channel groups: the
// caller takes 16-byte vectors only where Cg is a multiple of VEC, else one
// channel per thread. Each thread reads its group's coordinate plane.
// Coordinate and weight arithmetic and the blend are fp32; the output is
// rounded once to the input's dtype.
//
// Bound. Bytes: each output element reads 4 taps that mostly hit L2/L1
// (neighbouring outputs share taps), so the least traffic is img read once,
// the coordinates read once and out written once. At DySample's dec3 shape
// (B=128, 64x64 -> 128x128, C=64, G=4, bf16): 67 MB + 67 MB of fp32
// coordinates + 268 MB, about 120 us at 3.35 TB/s; the ops (about 8 per
// output element) are far below the card's rate.
//
// K5. This kernel was K5's too, at G = 1, until K7's warp-chunk kernel
// replaced it there (kernels/bilinear.py::bilinear_gather_forward launches
// kmunet_bilinear_gather_multiview with one view): at DAGEM's bridge shape
// (B=128, 16x16, C=64, bf16, zeros; bound 2.58 us) K7's kernel takes
// 5.27-5.33 us of device time queued behind a spin (4.23-4.30 by the
// profiler) against this kernel's 5.72-5.73 (4.77-4.82), and writing its
// output alone (zero_) 3.26-3.28, on an NVIDIA H100 80GB HBM3 at a 700.00 W
// power limit (scripts/torch_kernel_timing.py gather, in turns). K7's chunk
// rule gives 15 entries a warp there, the fastest of 0, 2, 4, 8, 15 and
// 32 (5.28 at 15, 5.73-5.78 at 0, 6.46 at 32: scripts/
// torch_ablate_variants.py --k5-chunks).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "gather_taps.cuh"  // to_f32, from_f32, Vec, taps: shared with K7 and K6

namespace {

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

// C is img's and the output's channel count.
template <typename T, int VEC, bool ZEROS>
__global__ void __launch_bounds__(256)
bilinear_gather_kernel(const T* __restrict__ img, const float* __restrict__ xs,
                       const float* __restrict__ ys, T* __restrict__ out,
                       int B, int H, int W, int C, int G, int HoWo) {
  // 32-bit indices: the entry point takes fewer than 2^30 elements per tensor.
  const int cv = C / VEC;   // channel vectors per output pixel
  const int cvg = cv / G;   // channel vectors per group
  const int total = B * HoWo * cv;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    const int j = i % cv;
    const int c0 = j * VEC;  // source channel
    const int p = i / cv;  // b * HoWo + output pixel
    const int b = p / HoWo;
    const int q = (b * G + j / cvg) * HoWo + (p - b * HoWo);  // [b, group, pixel]
    const Taps t = taps<ZEROS>(xs[q], ys[q], H, W);
    const int row0 = b * H + t.y0;
    const int row1 = b * H + t.y1;
    float v00[VEC], v01[VEC], v10[VEC], v11[VEC];
    load_tap<T, VEC>(img, row0 * W + t.x0, C, c0, t.vy0 && t.vx0, v00);
    load_tap<T, VEC>(img, row0 * W + t.x1, C, c0, t.vy0 && t.vx1, v01);
    load_tap<T, VEC>(img, row1 * W + t.x0, C, c0, t.vy1 && t.vx0, v10);
    load_tap<T, VEC>(img, row1 * W + t.x1, C, c0, t.vy1 && t.vx1, v11);
    Vec<T, VEC> r;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float top = v00[k] * (1.f - t.wx) + v01[k] * t.wx;
      const float bot = v10[k] * (1.f - t.wx) + v11[k] * t.wx;
      r.v[k] = from_f32<T>(top * (1.f - t.wy) + bot * t.wy);
    }
    *reinterpret_cast<Vec<T, VEC>*>(out + p * C + j * VEC) = r;
  }
}

template <typename T, int VEC>
int launch(const void* img, const void* x, const void* y, void* out, int B, int H,
           int W, int C, int G, int Ho, int Wo, int zeros, cudaStream_t stream) {
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
        src, xs, ys, dst, B, H, W, C, G, HoWo);
  } else {
    bilinear_gather_kernel<T, VEC, false><<<blocks, threads, 0, stream>>>(
        src, xs, ys, dst, B, H, W, C, G, HoWo);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_vec(int vec, const void* img, const void* x, const void* y, void* out,
                 int B, int H, int W, int C, int G, int Ho, int Wo, int zeros,
                 cudaStream_t stream) {
  constexpr int kWide = 16 / sizeof(T);
  if (vec == kWide)
    return launch<T, kWide>(img, x, y, out, B, H, W, C, G, Ho, Wo, zeros, stream);
  if (vec == 1)
    return launch<T, 1>(img, x, y, out, B, H, W, C, G, Ho, Wo, zeros, stream);
  return -1;
}

int gather(const void* img, const void* x, const void* y, void* out, int B, int H, int W,
           int C, int G, int Ho, int Wo, int dtype, int zeros, int vec, void* stream) {
  if (vec < 1 || G < 1 || B < 0 || H < 1 || W < 1 || C < 1 || Ho < 0 || Wo < 0 ||
      C % G != 0 || (C / G) % vec != 0)
    return -1;
  const long long limit = 1LL << 30;  // keeps every index and the grid stride in int
  if ((long long)B * H * W * C >= limit || (long long)B * Ho * Wo * C >= limit) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_vec<float>(vec, img, x, y, out, B, H, W, C, G, Ho, Wo, zeros, s);
    case 1:
      return dispatch_vec<__nv_bfloat16>(vec, img, x, y, out, B, H, W, C, G, Ho, Wo, zeros, s);
    case 2:
      return dispatch_vec<__half>(vec, img, x, y, out, B, H, W, C, G, Ho, Wo, zeros, s);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16, 2 = fp16. vec: channels per thread, either
// 16 / sizeof(dtype) (C / G divisible by it, img 16-byte aligned) or 1.
// Returns cudaGetLastError() after the launch, or -1 for an argument the
// kernel does not take.

// K4: x, y (B, G, Ho, Wo) fp32; channel block g of img and out takes x[:, g], y[:, g].
extern "C" int kmunet_bilinear_gather_grouped(const void* img, const void* x, const void* y,
                                              void* out, int B, int H, int W, int C, int G,
                                              int Ho, int Wo, int dtype, int zeros, int vec,
                                              void* stream) {
  return gather(img, x, y, out, B, H, W, C, G, Ho, Wo, dtype, zeros, vec, stream);
}
