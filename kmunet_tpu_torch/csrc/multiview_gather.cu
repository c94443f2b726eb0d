// K7, the multiview bilinear gather: one NHWC source sampled at G coordinate
// sets, view g written to output channel block g.
//
// Replaces kmunet_tpu/kernels/bilinear_pallas.py::gather_bilinear_multiview
// (the pl.pallas_call in _forward_grouped with shared=True), what
// ops/sample.py::bilinear_gather_multiview_xla computes:
//   out[b, o, g * C + c] = bilinear sample of img[b, :, :, c] at (x[b, g, o], y[b, g, o]),
// img (B, H, W, C), x, y (B, G, Ho, Wo) fp32 pixel coordinates (x along W,
// y along H, integers on pixel centres), out (B, Ho, Wo, G * C).
//   border: x, y clamped to [0, W-1] x [0, H-1] first; a tap one past the
//           last pixel reads the last pixel (its weight is 0 there anyway).
//   zeros:  a tap outside [0, H-1] x [0, W-1] reads 0. The coordinates are
//           clamped to [-2, W+1] x [-2, H+1] before the int conversion, as
//           the TPU kernel does: beyond that both taps of an axis are out
//           of range, so the clamp changes nothing but cannot overflow.
// The weights and the blend are fp32; the output is rounded once to img's
// dtype (fp32, bf16 or fp16).
// At G = 1 it is K5 and replaces kmunet_tpu/kernels/bilinear_pallas.py::
// gather_bilinear_zeros / gather_bilinear_border too (the pl.pallas_call in
// _forward; kernels/bilinear.py::bilinear_gather_forward launches it so).
//
// Bound. Each input read once and the output written once: at TrajGRU's
// enc_rnn1 (B=16, 32x32, C=64, G=13, bf16) 2.1 MB of source, 1.7 MB of
// fp32 coordinates and 27.3 MB of output, 31.1 MB or 9.3 us at 3.35 TB/s;
// the blend's few fp32 operations per output element are far below the
// card's rate. The output sets the bound: on an H100 writing those 27.3 MB
// alone (torch's zero_) takes 10.0 us. The first port (one thread per
// output pixel, view and 16-byte channel vector) read 4 taps x 16 bytes
// per 16 bytes written from L2, about 109 MB at enc_rnn1, redid each
// view's coordinate arithmetic in every channel lane, and found its pixel,
// view and lane by five runtime divisions per thread: 24.5 us there.
//
// Design. Warps work alone, on chunks of K consecutive (output pixel,
// view) entries in output order (K = 32 where the entries fill the card
// with warps, fewer where they do not: kernels/bilinear.py::
// multiview_chunk):
//   1. each entry is reckoned once, by one lane: its view, pixel and batch
//      element from its index, its coordinates clamped and floored, the
//      weights of its four taps (the products of the fractions) and the
//      taps' element offsets in img (-1 for a masked tap), kept in the
//      warp's slice of shared memory;
//   2. the warp's lanes then blend the chunk's (entry, 16-byte channel
//      vector) pairs, 32 consecutive pairs a round (VEC = 4 fp32 or 8
//      bf16/fp16 channels a lane; one channel where C is not a multiple of
//      VEC): a lane reads its entry from shared memory (a broadcast), the 4
//      taps through the read-only path, where neighbouring outputs' taps
//      meet in L1, blends them with one fp32 multiply and three fused
//      multiply-adds a channel, rounds once to the dtype, and writes 16
//      contiguous bytes with a streaming store; a round writes 512
//      contiguous bytes. A lane's first pair and its step are fixed, with
//      no division per pair.
// No block-wide barrier: one warp's reckoning overlaps other warps' blends
// and stores. Where a chunk would hold a single entry (TrajGRU's 4x4
// levels: a few thousand entries, latency-bound), K = 0 takes one (entry,
// vector) pair a thread instead, each thread reckoning its entry.
// Tried and dropped on the card (PERF.md, PR 15): staging a block's source
// rows in shared memory (a block's min and max tap row, a cp.async or TMA
// band, tap codes into it), which serialised a block's phases and bought
// nothing against L1; the lerps of lerps per channel in place of the
// weights (6 operations a channel, not 4).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

#include "gather_taps.cuh"  // to_f32, Vec, taps: shared with K4 and K6

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// Channels c0 .. c0+VEC of the tap at element offset `tap` of img, as fp32,
// by the read-only data path (the taps of neighbouring outputs meet in L1);
// zeros for a masked tap (tap < 0).
template <typename T, int VEC>
__device__ __forceinline__ void load_tap(const T* __restrict__ img, int tap, int c0,
                                         float (&a)[VEC]) {
  if constexpr (sizeof(Vec<T, VEC>) == 16) {
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (tap >= 0) u = __ldg(reinterpret_cast<const uint4*>(img + tap + c0));
    const Vec<T, VEC> t = *reinterpret_cast<const Vec<T, VEC>*>(&u);
#pragma unroll
    for (int i = 0; i < VEC; ++i) a[i] = to_f32(t.v[i]);
  } else {
    a[0] = tap >= 0 ? to_f32(__ldg(img + tap + c0)) : 0.f;
  }
}

// r rounded once to T, two channels per conversion where T is 16-bit.
template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> round_to(const float (&r)[VEC]) {
  Vec<T, VEC> o;
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) o.v[i] = r[i];
  } else if constexpr (VEC == 1) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      o.v[0] = __float2bfloat16(r[0]);
    else
      o.v[0] = __float2half(r[0]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 2) {
      if constexpr (std::is_same<T, __nv_bfloat16>::value)
        *reinterpret_cast<__nv_bfloat162*>(&o.v[i]) = __floats2bfloat162_rn(r[i], r[i + 1]);
      else
        *reinterpret_cast<__half2*>(&o.v[i]) = __floats2half2_rn(r[i], r[i + 1]);
    }
  }
  return o;
}

// Entry `entry` (b, output pixel, view in output order) reckoned: the
// weights of its taps (y0, x0), (y0, x1), (y1, x0), (y1, x1), the products
// of the fractions (1 - wx)(1 - wy), wx(1 - wy), (1 - wx)wy, wx wy, and the
// taps' element offsets in img, -1 for a masked tap.
template <bool ZEROS>
__device__ __forceinline__ void reckon(const float* __restrict__ xs, const float* __restrict__ ys,
                                       int entry, int H, int W, int C, int G, int HoWo,
                                       float4& weight, int4& tap) {
  const int bp = entry / G;
  const int g = entry - bp * G;
  const int b = bp / HoWo;
  const int q = (b * G + g) * HoWo + (bp - b * HoWo);  // [b, g, pixel]
  const Taps t = taps<ZEROS>(xs[q], ys[q], H, W);
  const float wx = t.wx, wy = t.wy;
  const int row0 = (b * H + t.y0) * W, row1 = (b * H + t.y1) * W;
  weight = make_float4((1.f - wx) * (1.f - wy), wx * (1.f - wy), (1.f - wx) * wy, wx * wy);
  tap = make_int4(t.vy0 && t.vx0 ? (row0 + t.x0) * C : -1,
                  t.vy0 && t.vx1 ? (row0 + t.x1) * C : -1,
                  t.vy1 && t.vx0 ? (row1 + t.x0) * C : -1,
                  t.vy1 && t.vx1 ? (row1 + t.x1) * C : -1);
}

// Writes channels c0 .. c0+VEC of an entry's output from its weights and taps.
template <typename T, int VEC>
__device__ __forceinline__ void blend(const T* __restrict__ img, const float4& w, const int4& tap,
                                      int c0, T* __restrict__ dst) {
  float a[4][VEC];  // the taps as fp32, 0 where masked
  load_tap<T, VEC>(img, tap.x, c0, a[0]);
  load_tap<T, VEC>(img, tap.y, c0, a[1]);
  load_tap<T, VEC>(img, tap.z, c0, a[2]);
  load_tap<T, VEC>(img, tap.w, c0, a[3]);
  float r[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) r[i] = a[0][i] * w.x + a[1][i] * w.y + a[2][i] * w.z + a[3][i] * w.w;
  const Vec<T, VEC> res = round_to<T, VEC>(r);
  if constexpr (sizeof(res) == 16)  // a streaming store: the output is read once, later
    __stcs(reinterpret_cast<int4*>(dst), *reinterpret_cast<const int4*>(&res));
  else
    *reinterpret_cast<Vec<T, VEC>*>(dst) = res;
}

template <typename T, int VEC, bool ZEROS>
__global__ void __launch_bounds__(kThreads)
multiview_kernel(const T* __restrict__ img, const float* __restrict__ xs,
                 const float* __restrict__ ys, T* __restrict__ out, int H, int W, int C, int G,
                 int HoWo, int entries, int K, int chunks) {
  // 32-bit indices: the entry point takes fewer than 2^30 elements per tensor.
  const int nvec = C / VEC;  // channel vectors of an entry
  if (K == 0) {  // one (entry, vector) pair a thread, its entry reckoned by each of its lanes
    const int pair = blockIdx.x * kThreads + threadIdx.x;
    if (pair >= entries * nvec) return;
    const int entry = pair / nvec, c0 = (pair - entry * nvec) * VEC;
    float4 w;
    int4 tap;
    reckon<ZEROS>(xs, ys, entry, H, W, C, G, HoWo, w, tap);
    blend<T, VEC>(img, w, tap, c0, out + entry * C + c0);
    return;
  }
  // A chunk's entries, each reckoned once by one lane.
  __shared__ float4 s_weight[kWarps][32];
  __shared__ int4 s_tap[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pairs = K * nvec;  // (entry, vector) pairs of a chunk, 32 a round
  const int e0 = lane / nvec, v0 = lane - e0 * nvec;  // this lane's first pair
  const int de = 32 / nvec, dv = 32 - de * nvec;      // and its step
  for (int chunk = blockIdx.x * kWarps + warp; chunk < chunks; chunk += gridDim.x * kWarps) {
    const int first = chunk * K;  // entry index (b, output pixel, view), output order
    const int n = min(K, entries - first);
    if (lane < n)
      reckon<ZEROS>(xs, ys, first + lane, H, W, C, G, HoWo, s_weight[warp][lane],
                    s_tap[warp][lane]);
    __syncwarp();
    int e = e0, v = v0;
#pragma unroll 1  // a round at a time: two unrolled ran slower on the card
    for (int p = lane; p < pairs; p += 32) {
      if (e < n)
        blend<T, VEC>(img, s_weight[warp][e], s_tap[warp][e], v * VEC,
                      out + (first + e) * C + v * VEC);
      e += de;
      v += dv;
      if (v >= nvec) {
        v -= nvec;
        ++e;
      }
    }
    __syncwarp();
  }
}

template <typename T, int VEC>
int launch(const void* img, const void* x, const void* y, void* out, int B, int H, int W,
           int C, int G, int Ho, int Wo, int zeros, int K, cudaStream_t stream) {
  const long long entries = (long long)B * Ho * Wo * G;
  if (entries == 0) return 0;
  // K = 0: a thread a pair; else a warp a chunk of K entries.
  const long long chunks = K == 0 ? 0 : (entries + K - 1) / K;
  const long long blocks = K == 0 ? (entries * (C / VEC) + kThreads - 1) / kThreads
                                  : (chunks + kWarps - 1) / kWarps;
  auto kernel = zeros ? multiview_kernel<T, VEC, true> : multiview_kernel<T, VEC, false>;
  kernel<<<(int)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(img), static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<T*>(out), H, W, C, G, Ho * Wo, (int)entries, K, (int)chunks);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_vec(int vec, const void* img, const void* x, const void* y, void* out, int B,
                 int H, int W, int C, int G, int Ho, int Wo, int zeros, int K,
                 cudaStream_t stream) {
  constexpr int kWide = 16 / sizeof(T);
  if (vec == kWide)
    return launch<T, kWide>(img, x, y, out, B, H, W, C, G, Ho, Wo, zeros, K, stream);
  if (vec == 1) return launch<T, 1>(img, x, y, out, B, H, W, C, G, Ho, Wo, zeros, K, stream);
  return -1;
}

}  // namespace

// img (B, H, W, C) NHWC, x, y (B, G, Ho, Wo) fp32, out (B, Ho, Wo, G * C),
// channel block g sampled at x[:, g], y[:, g] from all C channels of img.
// dtype: 0 = fp32, 1 = bf16, 2 = fp16. vec: channels per lane, either
// 16 / sizeof(dtype) (C divisible by it, img 16-byte aligned) or 1. K: the
// (output pixel, view) entries a warp reckons and blends at a time, 1 to 32
// (kernels/bilinear.py::multiview_chunk).
// Returns cudaGetLastError() after the launch, or -1 for an argument the
// kernel does not take.
extern "C" int kmunet_bilinear_gather_multiview(const void* img, const void* x, const void* y,
                                                void* out, int B, int H, int W, int C, int G,
                                                int Ho, int Wo, int dtype, int zeros, int vec,
                                                int K, void* stream) {
  if (vec < 1 || G < 1 || B < 0 || H < 1 || W < 1 || C < 1 || Ho < 0 || Wo < 0 ||
      C % vec != 0 || K < 0 || K > 32)
    return -1;
  const long long limit = 1LL << 30;  // keeps every index in int
  if ((long long)B * H * W * C >= limit || (long long)B * Ho * Wo * G * C >= limit) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_vec<float>(vec, img, x, y, out, B, H, W, C, G, Ho, Wo, zeros, K, s);
    case 1:
      return dispatch_vec<__nv_bfloat16>(vec, img, x, y, out, B, H, W, C, G, Ho, Wo, zeros, K,
                                         s);
    case 2:
      return dispatch_vec<__half>(vec, img, x, y, out, B, H, W, C, G, Ho, Wo, zeros, K, s);
    default: return -1;
  }
}
