// Native host-side data-loader core of the port: its own copy of the JAX
// package's, built with g++ by kmunet_tpu_torch/data/native.py into
// kmunet_tpu_torch/_build/ and driven from kmunet_tpu_torch/data/resize.py
// through ctypes (the reference's analogue is the native torchvision/PIL
// resample loop of its DataLoader workers, Shanghai.py:45-49).
//
// The hot op is the fused uint8 -> antialiased-bilinear-resize. The numpy
// path evaluates it as two *dense* matmuls: for (565, 784) -> (128, 128)
// that is ~139 MFLOP/frame even though the triangle filter touches at most
// ~ceil(2*scale)+1 input rows/cols per output. Here the weights arrive in
// *banded* form (per-output start index + padded tap window), so the row
// pass reads the uint8 source directly (no float32 (25, 565, 784)
// intermediate) and does only the nonzero taps: ~2.4 MFLOP/frame, one
// streaming pass per axis.
//
// Any value scaling (the reference's frames/255, Shanghai.py:48) must be
// pre-folded into the row weights by the caller; resizing is linear so this
// is exact up to float rounding.
//
// Layout contracts (enforced by the Python wrapper):
//   src    (n, H, W)       uint8 / float32, C-contiguous
//   wh     (Ho, max_th)    float32, taps for output row o start at hstart[o]
//   ww     (Wo, max_tw)    float32, taps for output col p start at wstart[p]
//   out    (n, Ho, Wo)     float32
//   tmp    (Ho, W)         float32 scratch (caller-allocated, per thread)
// with 0 <= hstart[o] <= H - max_th (starts are left-shifted and the tap
// window zero-padded so the inner loops never branch on bounds).
//
// Threading: none here -- calls release the GIL via ctypes, so the Python
// DataLoader's worker threads provide concurrency on multi-core hosts.

#include <cstdint>

namespace {

template <typename SrcT>
void resize_banded(const SrcT* src, long n, long H, long W,
                   const float* wh, const int* hstart, long max_th, long Ho,
                   const float* ww, const int* wstart, long max_tw, long Wo,
                   float* out, float* tmp) {
  for (long f = 0; f < n; ++f) {
    const SrcT* sf = src + f * H * W;
    // Row pass: tmp[o, :] = sum_t wh[o, t] * src[hstart[o] + t, :].
    // Inner loop is over the full row width -> auto-vectorizes.
    for (long o = 0; o < Ho; ++o) {
      float* trow = tmp + o * W;
      const float* wrow = wh + o * max_th;
      const SrcT* srow0 = sf + (long)hstart[o] * W;
      {
        const float wt = wrow[0];
        for (long w = 0; w < W; ++w) trow[w] = wt * (float)srow0[w];
      }
      for (long t = 1; t < max_th; ++t) {
        const float wt = wrow[t];
        if (wt == 0.0f) continue;  // zero-padded tail of the tap window
        const SrcT* srow = srow0 + t * W;
        for (long w = 0; w < W; ++w) trow[w] += wt * (float)srow[w];
      }
    }
    // Column pass: out[o, p] = sum_t ww[p, t] * tmp[o, wstart[p] + t].
    float* of = out + f * Ho * Wo;
    for (long o = 0; o < Ho; ++o) {
      const float* trow = tmp + o * W;
      float* orow = of + o * Wo;
      for (long p = 0; p < Wo; ++p) {
        const float* wcol = ww + p * max_tw;
        const float* t0 = trow + wstart[p];
        float acc = 0.0f;
        for (long t = 0; t < max_tw; ++t) acc += wcol[t] * t0[t];
        orow[p] = acc;
      }
    }
  }
}

}  // namespace

extern "C" {

void km_resize_u8(const uint8_t* src, long n, long H, long W,
                  const float* wh, const int* hstart, long max_th, long Ho,
                  const float* ww, const int* wstart, long max_tw, long Wo,
                  float* out, float* tmp) {
  resize_banded<uint8_t>(src, n, H, W, wh, hstart, max_th, Ho,
                         ww, wstart, max_tw, Wo, out, tmp);
}

void km_resize_f32(const float* src, long n, long H, long W,
                   const float* wh, const int* hstart, long max_th, long Ho,
                   const float* ww, const int* wstart, long max_tw, long Wo,
                   float* out, float* tmp) {
  resize_banded<float>(src, n, H, W, wh, hstart, max_th, Ho,
                       ww, wstart, max_tw, Wo, out, tmp);
}

}  // extern "C"
