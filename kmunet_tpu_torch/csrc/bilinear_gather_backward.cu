// Backward of the bilinear gather at pixel coordinates, NHWC, border or
// zeros padding: d_img, d_x and d_y from the upstream gradient g, for one
// coordinate set per image (the backward of K5), one per channel group
// (the backward of K4), or one source sampled at G coordinate sets (the
// backward of K7).
//
// Replaces the TPU kernel K6 of the JAX package:
// kmunet_tpu/kernels/bilinear_pallas.py::_backward_impl (its pl.pallas_call
// of _kernel_bwd at :414), reached from the custom VJP of _make_gather_op.
// With shared=False for gather_bilinear_{zeros,border} (G = 1) and
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
// Design: bin the units by anchor cell, then let each source pixel own its
// sum. A unit is one coordinate pair: q indexes its coordinates ([b, group
// or view, output pixel]), u = (b * HoWo + output pixel) * G + group (view)
// its block of Cg channels of g (g + u * Cg). Its four taps are the cells
// (y0, x0), (y0, x1), (y1, x0), (y1, x1) of its clamped, floored
// coordinates, so source pixel (i, j) receives only from the units anchored
// at (i-1, j-1), (i-1, j), (i, j-1) and (i, j). The TPU kernel transposes
// its tap-row matmuls and accumulates d_src over the output tiles in grid
// order. Here the units are binned per segment, (b, group) or (b, view),
// whose cell grid is (H + 1) x (W + 1) with an offset of one: an anchor at
// x0 = -1 (zeros mode) still reaches column 0 through its far tap, and
// anchors at x0 <= -2 or x0 >= W reach nothing and go into no bin. Three
// passes, none of which adds floats atomically:
//   1. Unit pass, one group of LANES threads per unit: d_x and d_y as fp32
//      per-thread sums over channel vectors, reduced by __shfl_xor_sync in a
//      fixed order, and the unit's cell.
//   2. Bin pass, one block per segment: the units' counts per cell (integer
//      atomics), their exclusive scan into bin offsets (written by hand),
//      the fill (each unit's u at a slot that an integer atomic cursor hands
//      out, in no fixed order), the sort of each bin into ascending u (up to
//      32 units by one thread, more by the block: a bitonic network, so that
//      a degenerate bin, every unit of a segment on one pixel as in
//      last_pixel's 16,384 at dec3, costs O(n log^2 n)), and each entry's
//      weights (wx, wy). The offsets and the list are staged in shared memory
//      where they fit in 96 KB (every gather of the models at 128^2 input),
//      else built in place in global memory.
//   3. Owner pass, one group of LANES threads per (b, group, source pixel),
//      or per (b, source pixel) for shared=True, each thread a channel
//      vector: in each of its segments in order (the views 0..G-1 for
//      shared=True, every view scattering into the one d_img) it walks the
//      bins of the anchors (i-1, j-1), (i-1, j), then (i, j-1), (i, j) (two
//      ranges of the list), each in ascending u, and adds g * w_tap in fp32
//      registers for every tap of the unit that lands on (i, j), its weight
//      the forward's product of the fractions. One tap lands, except in
//      border mode on the last row or column, where x1 = min(x0 + 1, W - 1)
//      lands a unit's near and far taps on the same pixel: both are added,
//      the far one 0 * g, so that an inf or NaN in g travels as in the plain
//      version. It writes d_img once, in the image dtype (the TPU kernel also
//      accumulates d_src in fp32 and casts at the end): no fp32 scratch, no
//      zeroing, no rounding pass.
// The only atomics are on integers, whose addition is exact, and the sort
// undoes the order in which they ran: every d_img element adds its terms in
// an order fixed by the inputs, so two calls on the same inputs give bitwise
// equal d_img, d_x and d_y, as the TPU kernel's do.
// tests/test_torch_k6_owner.py holds a numpy model of these passes (the
// anchor cells, the offset grid, the bins in ascending u after a fill in any
// order, the border duplicates, the four-neighbour owner sum) to jax.vjp of
// the XLA gathers on the CPU.
// A unit reads its Cg / VEC channel vectors 16 bytes at a time along C
// (VEC = 4 fp32 or 8 bf16/fp16, else 1 where Cg is no multiple of it, so
// that a vector never straddles two groups), by LANES threads, LANES the
// power of 2 at or above Cg / VEC (at most 32), an aligned group of one
// warp; lanes past Cg / VEC hold 0 (Cg = 6 in fp32: 6 channel vectors on 8
// lanes), and more than 32 vectors loop. Consecutive units are consecutive
// groups (views) of one output pixel, then the next pixel; consecutive owners
// the groups of one source pixel, then the next: a warp reads contiguous g
// and writes contiguous d_img.
//
// Bound. Bytes: img, g and the coordinates read once, d_img, d_x and d_y
// written once. At the DAGEM bridge shape (B=128, 16x16, C=64, G=1, bf16)
// about 13.1 MB, or 3.9 us at 3.35 TB/s; at DySample's dec3 shape (B=128,
// 64x64 -> 128x128, C=64, G=4, bf16) about 537 MB or 160 us; shared=True at
// TrajGRU's enc_rnn1 shape (B=16, 32x32, C=64, G=13, bf16) about 34.9 MB or
// 10.4 us. The operations (about 20 fp32 per element) are far below the
// card's rate. What the passes move beyond that, each array read once per
// pass: each unit's cell (4 bytes, written, read twice), its coordinates a
// second time (gathered by the bin pass), its list entry (4 bytes) and
// weights (8 bytes), written by the bin pass and read by the owner pass; the
// offsets (4 bytes per cell and segment); and g a second time (the owner
// pass; each unit's block by up to four owners, the repeats from L2). In all
// about 1,192 MB at dec3 (356 us at the HBM rate: the unit pass 503, the bin
// pass 244, the owner pass 445), 73.3 MB at enc_rnn1 (21.9 us) and 19.0 MB
// at the bridge (5.7 us), in three kernel launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

// to_f32, from_f32, Vec and taps, shared with K5, K4 and K7. The unit and
// the bin pass both take a unit's taps from taps(), so the owner pass's
// weights are the unit pass's, bit for bit.
#include "gather_taps.cuh"

namespace {

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

// d/dv of jnp.clip(v, lo, hi) = minimum(maximum(v, lo), hi), ties at half.
__device__ __forceinline__ float clip_vjp(float v, float lo, float hi) {
  float f = v > lo ? 1.f : (v == lo ? 0.5f : 0.f);
  const float m = fmaxf(v, lo);
  return f * (m < hi ? 1.f : (m == hi ? 0.5f : 0.f));
}

// The unit's bin in its segment's (H + 1) x (W + 1) cell grid (anchor
// (y0, x0) at cell (y0 + 1, x0 + 1)), or -1 where none of its taps lies in
// the image. In border mode every anchor lies in [0, H-1] x [0, W-1].
__device__ __forceinline__ int anchor_cell(const Taps& t, int H, int W) {
  if (t.x0 < -1 || t.x0 > W - 1 || t.y0 < -1 || t.y0 > H - 1) return -1;
  return (t.y0 + 1) * (W + 1) + (t.x0 + 1);
}

// Pass 1. C is img's channel count; g has C (shared=False) or G * C (SHARED)
// channels. cells_of[q] gets the unit's cell in its segment, or -1.
template <typename T, int VEC, bool ZEROS, bool SHARED>
__global__ void __launch_bounds__(256)
unit_kernel(const T* __restrict__ img, const float* __restrict__ xs,
            const float* __restrict__ ys, const T* __restrict__ g, float* __restrict__ d_x,
            float* __restrict__ d_y, int* __restrict__ cells_of, int B, int H, int W, int C,
            int G, int HoWo, int lanes_log2) {
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
    int q = 0;      // index of the unit's coordinates, [b, group, pixel]
    int cell = -1;  // the unit's bin in its segment
    if (active) {
      const int p = u / G;  // b * HoWo + output pixel
      const int grp = u - p * G;
      const int b = p / HoWo;
      q = (b * G + grp) * HoWo + (p - b * HoWo);
      xr = xs[q];
      yr = ys[q];
      const Taps t = taps<ZEROS>(xr, yr, H, W);
      cell = anchor_cell(t, H, W);
      const float wx = t.wx, wy = t.wy;
      const bool v00 = t.vy0 && t.vx0, v01 = t.vy0 && t.vx1, v10 = t.vy1 && t.vx0,
                 v11 = t.vy1 && t.vx1;
      // Masked taps never form an address: their pixel index may be out of range.
      const int pix00 = v00 ? (b * H + t.y0) * W + t.x0 : 0;
      const int pix01 = v01 ? (b * H + t.y0) * W + t.x1 : 0;
      const int pix10 = v10 ? (b * H + t.y1) * W + t.x0 : 0;
      const int pix11 = v11 ? (b * H + t.y1) * W + t.x1 : 0;
      for (int j = sub; j < cvg; j += lanes) {
        const int cout0 = grp * Cg + j * VEC;     // channel of g
        const int c0 = SHARED ? j * VEC : cout0;  // channel of img
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
      cells_of[q] = cell;
    }
  }
}

constexpr int kBinThreads = 1024;
constexpr int kSmallBin = 32;          // bins up to this size are sorted by one thread
constexpr int kBinShared = 96 * 1024;  // a segment's offsets and list staged up to this

// In-place exclusive scan of a[0:n] by the whole block; ends synchronised.
__device__ void block_exclusive_scan(int* a, int n) {
  __shared__ int s_warp[32];
  __shared__ int s_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int carry = 0;
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < n ? a[i] : 0;
    int incl = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int w = lane < nwarps ? s_warp[lane] : 0;
      int wi = w;
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, wi, o);
        if (lane >= o) wi += t;
      }
      if (lane < nwarps) s_warp[lane] = wi - w;
      if (lane == 31) s_total = wi;
    }
    __syncthreads();
    if (i < n) a[i] = carry + s_warp[warp] + incl - v;
    carry += s_total;
    __syncthreads();  // s_warp and s_total are rewritten by the next chunk
  }
}

// Sorts a[0:n] ascending by the whole block: a bitonic network whose
// comparators all put the smaller value at the lower index (each merge
// starts by comparing i with its mirror i ^ (k - 1)), so the entries past n
// of the padding to a power of 2 act as +inf and are never touched. a may lie
// in shared or global memory; ends synchronised.
__device__ void block_sort(int* a, int n) {
  int P = 1;
  while (P < n) P <<= 1;
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < (P >> 1); t += blockDim.x) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));  // bit j of i is 0
        const int partner = j == (k >> 1) ? i ^ (k - 1) : i + j;
        if (partner < n) {
          const int ai = a[i], ap = a[partner];
          if (ai > ap) {
            a[i] = ap;
            a[partner] = ai;
          }
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ void insertion_sort(int* a, int n) {
  for (int x = 1; x < n; ++x) {
    const int v = a[x];
    int y = x - 1;
    while (y >= 0 && a[y] > v) {
      a[y + 1] = a[y];
      --y;
    }
    a[y + 1] = v;
  }
}

// Pass 2, one block per segment b * G + group (view), its units q =
// segment * HoWo + output pixel: the counts per cell by integer atomics,
// their exclusive scan, the fill (u at the slot an atomic cursor hands out),
// the sort of each bin into ascending u, and weights[k] = (wx, wy) of
// list[k]'s unit. The fill leaves offs[c] at the end of bin c, so bin c is
// [offs[c - 1], offs[c]) from then on, and counts gets the offsets shifted
// back: bin c is [counts[c], counts[c + 1]). STAGED builds the offsets and
// the list in shared memory and copies them out; else they are built in
// place in global memory, read back after other threads wrote them, so
// neither is taken through the read-only path. Each thread keeps kBatch
// independent loads in flight.
constexpr int kBatch = 4;
template <bool ZEROS, bool STAGED>
__global__ void __launch_bounds__(kBinThreads)
bin_kernel(int* counts, const int* __restrict__ cells_of, const float* __restrict__ xs,
           const float* __restrict__ ys, int* list, float2* __restrict__ weights, int H, int W,
           int G, int HoWo) {
  extern __shared__ int s_stage[];
  __shared__ int s_big[kBinThreads];
  const int cells = (H + 1) * (W + 1);
  const int b = blockIdx.x / G;
  const int s = blockIdx.x - b * G;
  const int first = blockIdx.x * HoWo;  // the segment's first unit
  const int step = kBatch * blockDim.x;
  int* counts_seg = counts + (size_t)blockIdx.x * (cells + 1);
  int* offs = STAGED ? s_stage : counts_seg;
  int* bins = STAGED ? s_stage + cells + 1 : list + first;
  for (int c = threadIdx.x; c <= cells; c += blockDim.x) offs[c] = 0;
  __syncthreads();
  for (int r0 = threadIdx.x; r0 < HoWo; r0 += step) {
    int c[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int r = r0 + k * blockDim.x;
      c[k] = r < HoWo ? cells_of[first + r] : -1;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (c[k] >= 0) atomicAdd(offs + c[k], 1);
    }
  }
  __syncthreads();
  block_exclusive_scan(offs, cells + 1);  // offs[cells] is the segment's total
  for (int r0 = threadIdx.x; r0 < HoWo; r0 += step) {
    int c[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int r = r0 + k * blockDim.x;
      c[k] = r < HoWo ? cells_of[first + r] : -1;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (c[k] < 0) continue;
      const int r = r0 + k * blockDim.x;  // output pixel
      bins[atomicAdd(offs + c[k], 1)] = (b * HoWo + r) * G + s;
    }
  }
  __syncthreads();
  for (int c0 = 0; c0 < cells; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    int n = 0;
    if (c < cells) {
      const int lo = c ? offs[c - 1] : 0;
      n = offs[c] - lo;
      if (n <= kSmallBin) insertion_sort(bins + lo, n);
    }
    const bool big = n > kSmallBin;
    s_big[threadIdx.x] = big;
    if (__syncthreads_or(big)) {  // the block sorts this chunk's large bins in turn
      for (int t = 0; t < blockDim.x; ++t) {
        if (!s_big[t]) continue;
        const int lo = c0 + t ? offs[c0 + t - 1] : 0;
        block_sort(bins + lo, offs[c0 + t] - lo);
      }
    }
    __syncthreads();  // s_big is rewritten by the next chunk; the sorts are done
  }
  const int total = offs[cells];
  for (int k0 = threadIdx.x; k0 < total; k0 += step) {
    int u[kBatch];
    float xr[kBatch], yr[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int e = k0 + k * blockDim.x;
      u[k] = e < total ? bins[e] : -1;
      if (u[k] < 0) continue;
      const int q = blockIdx.x * HoWo + u[k] / G - b * HoWo;
      xr[k] = xs[q];
      yr[k] = ys[q];
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (u[k] < 0) continue;
      const int e = k0 + k * blockDim.x;
      if (STAGED) list[first + e] = u[k];
      const Taps t = taps<ZEROS>(xr[k], yr[k], H, W);
      weights[first + e] = make_float2(t.wx, t.wy);
    }
  }
  // counts[c] = the start of bin c = offs[c - 1]; in place from the top
  // chunk down, each chunk reading below itself before anything there moves.
  for (int top = cells; top >= 0; top -= blockDim.x) {
    const int c = top - threadIdx.x;
    const int start = c > 0 ? offs[c - 1] : 0;
    __syncthreads();
    if (c >= 0) counts_seg[c] = start;
  }
}

// Pass 3: d_img of (b, group, source pixel) per group of LANES threads, or
// of (b, source pixel) with S = 1 (shared=True: all C channels, the G views'
// segments in turn). In a segment the bins of the anchors (i-1, j-1) and
// (i-1, j) are adjacent in the list, and so are those of (i, j-1) and
// (i, j): two ranges, each entry's anchor known from the bin it lies in.
template <typename T, int VEC, bool ZEROS>
__global__ void __launch_bounds__(256)
owner_kernel(const T* __restrict__ g, const int* __restrict__ counts,
             const int* __restrict__ list, const float2* __restrict__ weights,
             T* __restrict__ d_img, int B, int H, int W, int C, int G, int S, int HoWo,
             int lanes_log2) {
  const int lanes = 1 << lanes_log2;
  const int Cg = C / S;     // channels per group; all C where the views share the source
  const int views = G / S;  // segments per owner: its group's, or every view's
  const int cvg = Cg / VEC;
  const int cells = (H + 1) * (W + 1);
  const int nowners = B * H * W * S;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (lanes - 1);
  const int owners_per_warp = 32 >> lanes_log2;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int nwarps = (gridDim.x * blockDim.x) >> 5;
  for (int base = warp * owners_per_warp; base < nowners; base += nwarps * owners_per_warp) {
    const int o = base + (lane >> lanes_log2);  // (b * H * W + source pixel) * S + group
    if (o >= nowners) continue;                // no warp-wide call below
    const int pix = o / S;                      // (b * H + i) * W + j
    const int s = o - pix * S;
    const int j = pix % W;
    const int i = (pix / W) % H;
    const int seg0 = (pix / (H * W)) * G + s;
    // One tap of each unit in the four bins lands on (i, j), except in border
    // mode on the last row or column.
    const bool one_tap = ZEROS || (i < H - 1 && j < W - 1);
    for (int v = sub; v < cvg; v += lanes) {
      const int cg0 = v * VEC;  // channel within the group
      float acc[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
      for (int view = 0; view < views; ++view) {
        const int seg = seg0 + view;
        const int* offs = counts + (size_t)seg * (cells + 1);
        const int* bins = list + (size_t)seg * HoWo;
        const float2* wts = weights + (size_t)seg * HoWo;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {  // anchors on row i - 1, then row i
          const int c = (i + rr) * (W + 1) + j;
          const int lo = offs[c], mid = offs[c + 1], hi = offs[c + 2];
          if (one_tap) {
            // Anchor row i - 1 lands its far row here (weight wy), row i its
            // near one (1 - wy); anchor column j - 1 its far column (wx),
            // column j its near one (1 - wx).
#pragma unroll 4
            for (int e = lo; e < hi; ++e) {
              const int u = bins[e];
              const float2 w = wts[e];
              const float wt = (e < mid ? w.x : 1.f - w.x) * (rr ? 1.f - w.y : w.y);
              float gv[VEC];
              load_vec<T, VEC>(g + (size_t)u * Cg + cg0, true, gv);
#pragma unroll
              for (int k = 0; k < VEC; ++k) acc[k] += gv[k] * wt;
            }
            continue;
          }
          // Border mode, last row or column: the taps in order 00, 01, 10, 11.
          const bool row0 = rr == 1;
          const bool row1 = min(i + rr, H - 1) == i;
          for (int e = lo; e < hi; ++e) {
            const int u = bins[e];
            const float2 w = wts[e];
            const int x0 = e < mid ? j - 1 : j;  // anchor column
            const bool col0 = x0 == j;
            const bool col1 = min(x0 + 1, W - 1) == j;
            float gv[VEC];
            load_vec<T, VEC>(g + (size_t)u * Cg + cg0, true, gv);
            const float w00 = (1.f - w.x) * (1.f - w.y), w01 = w.x * (1.f - w.y);
            const float w10 = (1.f - w.x) * w.y, w11 = w.x * w.y;
#pragma unroll
            for (int k = 0; k < VEC; ++k) {
              if (row0 && col0) acc[k] += gv[k] * w00;
              if (row0 && col1) acc[k] += gv[k] * w01;
              if (row1 && col0) acc[k] += gv[k] * w10;
              if (row1 && col1) acc[k] += gv[k] * w11;
            }
          }
        }
      }
      Vec<T, VEC> out;
#pragma unroll
      for (int k = 0; k < VEC; ++k) out.v[k] = from_f32<T>(acc[k]);
      *reinterpret_cast<Vec<T, VEC>*>(d_img + (size_t)pix * C + s * Cg + cg0) = out;
    }
  }
}

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 32;  // then grid-stride

// The workspace: the bins' weights (float2 per unit), the units' cells and
// the bin lists (int per unit each), the offsets ((cells + 1) ints per
// segment). -1 where an index would reach 2^30.
long long workspace_bytes(int B, int H, int W, int G, int Ho, int Wo) {
  const long long units = (long long)B * G * Ho * Wo;
  const long long bins = (long long)B * G * ((long long)(H + 1) * (W + 1) + 1);
  if (units >= (1LL << 30) || bins >= (1LL << 30)) return -1;
  return 16 * units + 4 * bins;
}

int grid_for(long long threads) {
  const long long wanted = (threads + kThreads - 1) / kThreads;
  return wanted < kMaxBlocks ? (int)wanted : kMaxBlocks;
}

template <typename T, int VEC, bool ZEROS, bool SHARED>
int launch(const void* img, const void* x, const void* y, const void* g, void* workspace,
           void* d_img, float* d_x, float* d_y, int B, int H, int W, int C, int G, int Ho,
           int Wo, cudaStream_t stream) {
  const int HoWo = Ho * Wo;
  const int S = SHARED ? 1 : G;
  const int nunits = B * HoWo * G;
  const int nseg = B * G;
  const int cells = (H + 1) * (W + 1);
  const int cvg = (SHARED ? C : C / G) / VEC;
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < cvg && lanes_log2 < 5) ++lanes_log2;
  float2* weights = static_cast<float2*>(workspace);
  int* cells_of = reinterpret_cast<int*>(weights + nunits);
  int* list = cells_of + nunits;
  int* counts = list + nunits;
  const T* gs = static_cast<const T*>(g);
  const float* xs = static_cast<const float*>(x);
  const float* ys = static_cast<const float*>(y);
  cudaError_t err = cudaSuccess;
  if (nunits > 0) {
    unit_kernel<T, VEC, ZEROS, SHARED>
        <<<grid_for((long long)nunits << lanes_log2), kThreads, 0, stream>>>(
            static_cast<const T*>(img), xs, ys, gs, d_x, d_y, cells_of, B, H, W, C, G, HoWo,
            lanes_log2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (nseg > 0) {  // also without units: it writes the (empty) bins' offsets
    const size_t stage = ((size_t)cells + 1 + HoWo) * sizeof(int);
    if (stage <= (size_t)kBinShared) {
      err = cudaFuncSetAttribute(bin_kernel<ZEROS, true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kBinShared);
      if (err != cudaSuccess) return (int)err;
      bin_kernel<ZEROS, true><<<nseg, kBinThreads, stage, stream>>>(
          counts, cells_of, xs, ys, list, weights, H, W, G, HoWo);
    } else {
      bin_kernel<ZEROS, false><<<nseg, kBinThreads, 0, stream>>>(
          counts, cells_of, xs, ys, list, weights, H, W, G, HoWo);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long nowners = (long long)B * H * W * S;
  if (nowners > 0) {
    owner_kernel<T, VEC, ZEROS><<<grid_for(nowners << lanes_log2), kThreads, 0, stream>>>(
        gs, counts, list, weights, static_cast<T*>(d_img), B, H, W, C, G, S, HoWo, lanes_log2);
    err = cudaGetLastError();
  }
  return (int)err;
}

template <typename T, bool SHARED>
int dispatch(int vec, int zeros, const void* img, const void* x, const void* y, const void* g,
             void* workspace, void* d_img, float* d_x, float* d_y, int B, int H, int W, int C,
             int G, int Ho, int Wo, cudaStream_t stream) {
  constexpr int kWide = 16 / sizeof(T);
  if (vec == kWide) {
    return zeros ? launch<T, kWide, true, SHARED>(img, x, y, g, workspace, d_img, d_x, d_y, B,
                                                  H, W, C, G, Ho, Wo, stream)
                 : launch<T, kWide, false, SHARED>(img, x, y, g, workspace, d_img, d_x, d_y,
                                                   B, H, W, C, G, Ho, Wo, stream);
  }
  if (vec == 1) {
    return zeros ? launch<T, 1, true, SHARED>(img, x, y, g, workspace, d_img, d_x, d_y, B, H,
                                              W, C, G, Ho, Wo, stream)
                 : launch<T, 1, false, SHARED>(img, x, y, g, workspace, d_img, d_x, d_y, B, H,
                                               W, C, G, Ho, Wo, stream);
  }
  return -1;
}

// -1 for arguments the kernel does not take, else the workspace's bytes.
template <bool SHARED>
long long check(int B, int H, int W, int C, int G, int Ho, int Wo, int vec) {
  const int cg = SHARED ? C : C / G;  // source channels per group (view)
  if (vec < 1 || G < 1 || B < 0 || H < 1 || W < 1 || C < 1 || Ho < 0 || Wo < 0 ||
      (!SHARED && C % G != 0) || cg % vec != 0)
    return -1;
  const long long limit = 1LL << 30;  // keeps every index and the grid stride in int
  const long long cout = SHARED ? (long long)G * C : C;
  if ((long long)B * H * W * C >= limit || (long long)B * Ho * Wo * cout >= limit) return -1;
  return workspace_bytes(B, H, W, G, Ho, Wo);
}

template <bool SHARED>
int backward(const void* img, const void* x, const void* y, const void* g, void* workspace,
             void* d_img, void* d_x, void* d_y, int B, int H, int W, int C, int G, int Ho,
             int Wo, int dtype, int zeros, int vec, void* stream) {
  if (check<SHARED>(B, H, W, C, G, Ho, Wo, vec) < 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dx = static_cast<float*>(d_x);
  float* dy = static_cast<float*>(d_y);
  switch (dtype) {
    case 0:
      return dispatch<float, SHARED>(vec, zeros, img, x, y, g, workspace, d_img, dx, dy, B, H,
                                     W, C, G, Ho, Wo, s);
    case 1:
      return dispatch<__nv_bfloat16, SHARED>(vec, zeros, img, x, y, g, workspace, d_img, dx,
                                             dy, B, H, W, C, G, Ho, Wo, s);
    case 2:
      return dispatch<__half, SHARED>(vec, zeros, img, x, y, g, workspace, d_img, dx, dy, B, H,
                                      W, C, G, Ho, Wo, s);
    default:
      return -1;
  }
}

}  // namespace

// The bytes of workspace that the entries below take at these shapes
// (shared: 1 for the backward of K7, else 0), or -1 for shapes they refuse.
extern "C" long long kmunet_bilinear_gather_backward_workspace(int B, int H, int W, int C,
                                                               int G, int Ho, int Wo,
                                                               int shared) {
  return shared ? check<true>(B, H, W, C, G, Ho, Wo, 1) : check<false>(B, H, W, C, G, Ho, Wo, 1);
}

// dtype: 0 = fp32, 1 = bf16, 2 = fp16, of img, g and d_img; x, y, d_x and
// d_y are fp32. workspace: at least
// kmunet_bilinear_gather_backward_workspace's bytes, 8-byte aligned, with
// no content needed. vec: channels per thread, either 16 / sizeof(dtype)
// (C / G, for K7's backward C, divisible by it, img, g and d_img 16-byte
// aligned) or 1. Three kernel launches on stream: the unit, bin and owner
// passes (the unit pass only where there are units).
// Returns cudaGetLastError() after each launch (the first nonzero one), or
// -1 for an argument the kernel does not take.

// The backward of K5: x, y, d_x, d_y (B, Ho, Wo).
extern "C" int kmunet_bilinear_gather_backward(const void* img, const void* x, const void* y,
                                               const void* g, void* workspace, void* d_img,
                                               void* d_x, void* d_y, int B, int H, int W,
                                               int C, int Ho, int Wo, int dtype, int zeros,
                                               int vec, void* stream) {
  return backward<false>(img, x, y, g, workspace, d_img, d_x, d_y, B, H, W, C, 1, Ho, Wo, dtype,
                         zeros, vec, stream);
}

// The backward of K4: x, y, d_x, d_y (B, G, Ho, Wo).
extern "C" int kmunet_bilinear_gather_grouped_backward(
    const void* img, const void* x, const void* y, const void* g, void* workspace, void* d_img,
    void* d_x, void* d_y, int B, int H, int W, int C, int G, int Ho, int Wo, int dtype,
    int zeros, int vec, void* stream) {
  return backward<false>(img, x, y, g, workspace, d_img, d_x, d_y, B, H, W, C, G, Ho, Wo, dtype,
                         zeros, vec, stream);
}

// The backward of K7 (shared=True): x, y, d_x, d_y (B, G, Ho, Wo); g (B, Ho, Wo, G * C);
// d_img (B, H, W, C) summed over the views.
extern "C" int kmunet_bilinear_gather_multiview_backward(
    const void* img, const void* x, const void* y, const void* g, void* workspace, void* d_img,
    void* d_x, void* d_y, int B, int H, int W, int C, int G, int Ho, int Wo, int dtype,
    int zeros, int vec, void* stream) {
  return backward<true>(img, x, y, g, workspace, d_img, d_x, d_y, B, H, W, C, G, Ho, Wo, dtype,
                        zeros, vec, stream);
}
