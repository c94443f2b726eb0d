// K3a: the HSM-SSD mixer ablation, K3's compress phase and scatter without
// the gated MLP, in five modes (MODE, the order of kernels/ablate_mix.py's
// MODES), bf16 in and out:
//
//   h[b,c,n] = sum_l x[b,c,l] w[b,l,n]      w = bf16(e * Bm), e by the mode
//   y[b,c,l] = bf16(sum_n bf16(h / (den + 1))[b,c,n] Cm[b,l,n])
//
//   full      s = dt + A, e = exp(s - M_j), den = sum e, M_j the running max
//             from 0 at the end of TPU tile j, max(0, m_0, ..., m_j); tile
//             j's h and den are scaled by exp(M_j - M_last)
//   bf16_e    e = bf16(exp(s - m_j)), m_j = max(0, max of s over TPU tile j);
//             tile j's h and den are scaled by exp(-m_k) for each later k
//   no_max    e = exp(s)
//   no_exp    e = s for both den and w
//   dma_only  y over TPU tile j = bf16(sum of Cm's first 8 tokens of tile j);
//             every byte of x, dt, Bm and Cm is still loaded, into checksums
//
// x (B, C, L), dt, Bm, Cm (B, L, N), all contiguous bf16 and 16-byte
// aligned, and A (N,) bf16; every sum in fp32, with the TPU kernel's roundings.
//
// Replaces the TPU kernel of scripts/ablate_mix_kernel.py::run (the
// pl.pallas_call at :98, its body make_kernel at :17), a diagnosis of what
// the pieces of K3's first phase cost on the TPU.
//
// Design. csrc/hsmssd.cu's pipeline (K2 and K3), in K3a's layout: dt, Bm
// and Cm hold a token's N states contiguous, so a 64-token tile of each is
// one contiguous (64, N) block. Both products go to the tensor cores, exact:
// w and hn are bf16 by definition (the TPU kernel rounds them so), x and Cm
// are bf16, and mma.m16n8k16.bf16 sums their exact products in fp32; no
// hi + lo split as in K3. All five modes run this one pipeline, so that the
// ablation measures the kernel that runs: dma_only is its load floor,
// no_exp and no_max add the products, full and bf16_e the tile maxima.
//   tilemax   (full, bf16_e) one block per (slice, b): the max of dt over
//             the slice's tokens by 16-byte loads and bf16x2 max, reduced in
//             the block, + A, max(0, .), one write per (slice, n) into smax
//             (B, S, N). max(dt) + A is max(dt + A): rounding is monotonic.
//   compress  one block per (slice, b), a slice being spt-th of one TPU
//             tile's 64-token kernel tiles, 32 threads per 16 states. Its
//             tiles stream through a ring of kStages stages filled by
//             16-byte cp.async kStages - 1 tiles ahead: x as (C, 64) rows of
//             kXRow, dt and Bm as (64, N16) rows of N16 + 8 (the 8 of
//             padding put the 8 rows an ldmatrix reads in distinct banks;
//             N = 8 pads to N16 = 16 states with dt = Bm = A = 0, so w = 0).
//             The slice's M (full: the prefix max of smax over the slices
//             of tiles 0..j; bf16_e: tile j's) is fixed for the whole block.
//             Per 16-token k-step a warp reads its 16 states' dt and Bm by
//             ldmatrix.trans straight in the m16n8k16 A-fragment layout
//             (rows n, columns t), forms s = dt + A, e by the mode (expf),
//             its part of den, and w = bf16(e * Bm) packed into the A
//             fragment; the B fragments are x^T from the staged x tile by
//             ldmatrix. C pads to CP = 8, 16, 32 or 64 with zero rows. Each
//             slice writes its den (N) and h (N, CP), fp32.
//   merge     one block per (16 states, b): each TPU tile's weight (full:
//             exp(M_j - M_last); bf16_e: exp(-the sum of the later tiles'
//             m); 1 otherwise) from smax, den and h summed over the slices in
//             order, hn = bf16(h / (den + 1)) into hn (B, N, C).
//   scatter   one block per (slice, b), 4 warps: y (C x 64) = hn^T (C x N)
//             . Cm^T (N x 64) per tile with mma.m16n8k16.bf16; hn^T's A
//             fragments loaded once per block; Cm's tiles stream through the
//             same kind of ring, read by ldmatrix in the B-fragment layout
//             (a token's states are contiguous); y rounded once to bf16 into
//             a staged tile and out as 16-byte row segments.
//   dma_only  the compress and the scatter stream every tile through their
//             rings as the other modes do and sum what each thread copied
//             into checksums (part_d, sink); the scatter writes its TPU
//             tile's sum of Cm's first 8 tokens, read apart.
// So a call is 3 device launches, 4 for full and bf16_e, 2 for dma_only.
//
// Bound. At the TPU script's shape (B = 64, C = 16, L = 16384, N = 64) it
// moves x 33.6 MB, dt, Bm and Cm 134.2 MB each and y 33.6 MB: 470 MB, 140 us
// at 3.35 TB/s; its 4 B L C N = 4.3 GFLOP of products take 4.3 us on the
// tensor cores (989 TFLOP/s bf16): bytes bound it. full's and bf16_e's
// tilemax reads dt a second time (134 MB, 40 us at that rate), which the
// bound does not count.
//
// Measured there, on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit
// (scripts/torch_kernel_timing.py ablate, device us of calls queued behind a
// spin; by pass, the profiler's): full 254.2-254.6 (tilemax 50.2, compress
// 132, merge 9.2, scatter 57.3), bf16_e 253.4-253.7, no_max 184.9-185.0
// (compress 115.7, merge 7.4), no_exp 181.1-181.2, dma_only 166.7-166.8
// (compress 106.5, scatter 56.8: 2.8-3.0 TB/s); the design before it (FMAs
// from shared memory, a thread per token in the scatter) took 537-542,
// 454, 422 and 176 on the same card. Tried there in turns
// (scripts/torch_ablate_variants.py, edited copies of this source; full,
// bf16_e, no_max 258.2-258.6, 258.2, 190.3-190.4 as kept in that call):
// bf16_e's tile max in clusters of the spt blocks of a TPU tile (each
// block streams its slice's dt first, the maxima meet in distributed
// shared memory, no tilemax pass): the same bits, 338.3-338.9, its first
// phase unoverlapped; the slices' maxima read after the ring's first
// copies: full 270.4-270.5, bf16_e 267.6-267.9 (kept: before them); the
// tilemax pass with 128 or 512 threads, unrolled 8, or with streaming
// loads: 258.6-260.6. Not taken: exp2f((s - M) log2 e) in place of expf,
// full 246.1-246.2 and bf16_e 248.2-248.3, but another rounding of e than
// the plain version's exp, which w = bf16(e * Bm) would carry.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

enum Mode { kFull = 0, kBf16E = 1, kNoMax = 2, kNoExp = 3, kDmaOnly = 4 };

constexpr int kT = 64;              // tokens per kernel tile
constexpr int kStages = 4;          // tiles in a block's ring
constexpr int kXRow = kT + 8;       // a staged x or y row in elements, 8 of padding
constexpr int kMaxN = 64;           // N in {8, 16, 32, 64}
constexpr int kMaxC = 64;
constexpr int kTilemaxThreads = 256;
constexpr int kMergeThreads = 256;  // 16 states x 16 lanes
constexpr int kMergeRows = 16;      // states per merge block
constexpr int kScatterWarps = 4;
constexpr int kDmaTokens = 8;       // dma_only sums Cm over a tile's first 8 tokens

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a . b, m16n8k16, bf16 operands, fp32 d.
__device__ __forceinline__ void mma(float* d, const unsigned* a, const unsigned* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The two bf16 values of r (low first) as fp32.
__device__ __forceinline__ float2 unpack(unsigned r) {
  return make_float2(__uint_as_float(r << 16), __uint_as_float(r & 0xffff0000u));
}

// (a, b) rounded to bf16 (to nearest even), a in the low half.
__device__ __forceinline__ unsigned pack(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  unsigned r;
  memcpy(&r, &h, 4);
  return r;
}

// The sum of the 8 bf16 values of a 16-byte chunk.
__device__ __forceinline__ float chunk_sum(const bf16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = unpack(w[k]);
    s += f.x + f.y;
  }
  return s;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The kernel tiles [begin, end) of slice s: the k-th spt-th of TPU tile j.
struct Slice {
  int j, begin, end;
  __device__ Slice(int s, int tile, int spt, int tps) {
    const int per_tile = tile / kT, k = s % spt;
    j = s / spt;
    begin = j * per_tile + k * tps;
    end = j * per_tile + min((k + 1) * tps, per_tile);
  }
};

// 64 tokens of a (B, L, N) tensor from src (N states a token) into the
// staged rows of nr elements at dst: N / 8 16-byte copies a token, by all
// threads of the block; sum_states adds up the same chunks (dma_only).
__device__ __forceinline__ void load_states(bf16* dst, const bf16* src, int nr, int nv_shift) {
  const int chunks = kT << nv_shift;
  for (int i = threadIdx.x; i < chunks; i += blockDim.x) {
    const int t = i >> nv_shift, v = i & ((1 << nv_shift) - 1);
    cp_async16(dst + t * nr + v * 8, src + (i << 3));
  }
}
__device__ __forceinline__ float sum_states(const bf16* st, int nr, int nv_shift) {
  float s = 0.f;
  const int chunks = kT << nv_shift;
  for (int i = threadIdx.x; i < chunks; i += blockDim.x)
    s += chunk_sum(st + (i >> nv_shift) * nr + (i & ((1 << nv_shift) - 1)) * 8);
  return s;
}

// full's and bf16_e's slice maxima: block (s, b) writes max(0, max over its
// tokens of dt + A) into smax[b, s, :]. 256 threads: thread tid reads the
// 16-byte vector tid % (N / 8) of every (256 / (N / 8))-th token.
__global__ void __launch_bounds__(kTilemaxThreads) tilemax_kernel(
    const bf16* __restrict__ dt, const bf16* __restrict__ A, float* __restrict__ smax, int L,
    int N, int tile, int spt, int tps, int nv_shift) {
  __shared__ __align__(16) __nv_bfloat162 red[kTilemaxThreads][4];
  const int b = blockIdx.y, s = blockIdx.x, S = gridDim.x, tid = threadIdx.x;
  const Slice sl(s, tile, spt, tps);
  const int nv = 1 << nv_shift, v = tid & (nv - 1), step = kTilemaxThreads >> nv_shift;
  const uint4* base = reinterpret_cast<const uint4*>(dt + ((long long)b * L + sl.begin * kT) * N) + v;
  const int tokens = (sl.end - sl.begin) * kT;
  const __nv_bfloat162 lowest = __float2bfloat162_rn(-INFINITY);
  __nv_bfloat162 mx[4] = {lowest, lowest, lowest, lowest};
#pragma unroll 4
  for (int t = tid >> nv_shift; t < tokens; t += step) {
    const uint4 u = __ldg(base + ((long long)t << nv_shift));
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      __nv_bfloat162 h;
      memcpy(&h, &w[k], 4);
      mx[k] = __hmax2(mx[k], h);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) red[tid][k] = mx[k];
  __syncthreads();
  if (tid < N) {
    const int vv = tid >> 3, k = (tid & 7) >> 1, hi = tid & 1;
    float m = -INFINITY;
    for (int p = 0; p < step; ++p) {
      const float2 f = __bfloat1622float2(red[(p << nv_shift) + vv][k]);
      m = fmaxf(m, hi ? f.y : f.x);
    }
    smax[((long long)b * S + s) * N + tid] = fmaxf(m + __bfloat162float(A[tid]), 0.f);
  }
}

// The compress pass: block (s, b), 32 * N16 / 16 threads, writes its partial
// den and h (N, CP) at (b, s); dma_only its checksum at part_d[b, s, 0].
// Dynamic shared memory: the ring, kStages x (CP kXRow + 2 x 64 (N16 + 8))
// elements.
template <int MODE, int CT>
__global__ void __launch_bounds__(128) compress_kernel(
    const bf16* __restrict__ xt, const bf16* __restrict__ dt, const bf16* __restrict__ Bm,
    const bf16* __restrict__ A, const float* __restrict__ smax, float* __restrict__ part_d,
    float* __restrict__ part_h, int C, int L, int N, int tile, int spt, int tps, int nv_shift) {
  constexpr int CP = 8 * CT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  __shared__ float red[4];
  const int N16 = max(N, 16), nr = N16 + 8;
  const int stage = CP * kXRow + 2 * kT * nr;
  const int b = blockIdx.y, s = blockIdx.x, S = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, n0 = warp * 16;
  const int g = lane >> 2, q = lane & 3, m = lane >> 3;
  const Slice sl(s, tile, spt, tps);
  const bf16* xb = xt + (long long)b * C * L;
  const bf16* dtb = dt + (long long)b * L * N;
  const bf16* bmb = Bm + (long long)b * L * N;

  // This thread's two states n0 + g and n0 + g + 8: A and the slice's max,
  // the quad's four lanes each taking every fourth slice. Read before the
  // ring's first copies: behind them these loads cost full's and bf16_e's
  // compress 9-13 us at the TPU script's shape.
  float a[2], mx[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = n0 + g + 8 * r;
    a[r] = n < N ? __bfloat162float(A[n]) : 0.f;
    if ((MODE == kFull || MODE == kBf16E) && n < N) {
      const float* sm = smax + (long long)b * S * N + n;
#pragma unroll 4
      for (int i = (MODE == kFull ? 0 : sl.j * spt) + q; i < (sl.j + 1) * spt; i += 4)
        mx[r] = fmaxf(mx[r], sm[(long long)i * N]);
    }
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }

  // Rows past C and states past N are never loaded: zeroed once, they hold
  // x = 0, dt = 0 and Bm = 0.
  {
    uint4* z = reinterpret_cast<uint4*>(ring);
    const int chunks = kStages * stage / 8;
    for (int i = tid; i < chunks; i += blockDim.x) z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  auto issue = [&](int tile_i) {
    bf16* st = ring + ((tile_i - sl.begin) % kStages) * stage;
    const int l0 = tile_i * kT;
    for (int i = tid; i < C * (kT / 8); i += blockDim.x)
      cp_async16(st + (i >> 3) * kXRow + (i & 7) * 8, xb + (long long)(i >> 3) * L + l0 + (i & 7) * 8);
    load_states(st + CP * kXRow, dtb + (long long)l0 * N, nr, nv_shift);
    load_states(st + CP * kXRow + kT * nr, bmb + (long long)l0 * N, nr, nv_shift);
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (sl.begin + i < sl.end) issue(sl.begin + i);
    cp_async_commit();
  }

  float d[2] = {0.f, 0.f};
  float acc[CT][4];
#pragma unroll
  for (int j = 0; j < CT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  float check = 0.f;

  for (int tile_i = sl.begin; tile_i < sl.end; ++tile_i) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile_i have landed
    __syncthreads();               // everyone's have; the stage read last is free
    if (tile_i + kStages - 1 < sl.end) issue(tile_i + kStages - 1);
    cp_async_commit();
    const bf16* xs = ring + ((tile_i - sl.begin) % kStages) * stage;
    const bf16* ds = xs + CP * kXRow;
    const bf16* bs = ds + kT * nr;
    if (MODE == kDmaOnly) {
      for (int i = tid; i < C * (kT / 8); i += blockDim.x)
        check += chunk_sum(xs + (i >> 3) * kXRow + (i & 7) * 8);
      check += sum_states(ds, nr, nv_shift) + sum_states(bs, nr, nv_shift);
      continue;
    }
#pragma unroll
    for (int kk = 0; kk < kT; kk += 16) {
      // dt and Bm of states n0.. x tokens kk.. in the A-fragment layout:
      // register i holds state g + 8 (i & 1), tokens 2q, 2q + 1 (+ 8 (i >> 1)).
      const int off = (kk + (m >> 1) * 8 + (lane & 7)) * nr + n0 + (m & 1) * 8;
      unsigned dr[4], br[4], w[4];
      ldsm_x4_trans(dr, ds + off);
      ldsm_x4_trans(br, bs + off);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i & 1;
        const float2 dv = unpack(dr[i]), bv = unpack(br[i]);
        const float s0 = dv.x + a[r], s1 = dv.y + a[r];
        float e0, e1;
        if (MODE == kFull) {
          e0 = expf(s0 - mx[r]);
          e1 = expf(s1 - mx[r]);
        } else if (MODE == kBf16E) {
          const float2 e = __bfloat1622float2(__floats2bfloat162_rn(expf(s0 - mx[r]),
                                                                    expf(s1 - mx[r])));
          e0 = e.x;
          e1 = e.y;
        } else if (MODE == kNoMax) {
          e0 = expf(s0);
          e1 = expf(s1);
        } else {
          e0 = s0;
          e1 = s1;
        }
        d[r] += e0 + e1;
        w[i] = pack(e0 * bv.x, e1 * bv.y);
      }
#pragma unroll
      for (int j = 0; j < CT; j += 2) {
        unsigned xr[4];  // x^T: xr[0..1] channels 8j.., xr[2..3] channels 8j + 8..
        if constexpr (CT == 1)
          ldsm_x2(xr, xs + (lane & 7) * kXRow + kk + (m & 1) * 8);
        else
          ldsm_x4(xr, xs + (8 * (j + (m >> 1)) + (lane & 7)) * kXRow + kk + (m & 1) * 8);
        mma(acc[j], w, xr);
        if constexpr (CT > 1) mma(acc[j + 1], w, xr + 2);
      }
    }
  }

  const long long part = (long long)b * S + s;
  if (MODE == kDmaOnly) {
    check = warp_sum(check);
    if (lane == 0) red[warp] = check;
    __syncthreads();
    if (tid == 0) {
      float total = 0.f;
      for (int w = 0; w < (int)blockDim.x / 32; ++w) total += red[w];
      part_d[part * N] = total;
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    d[r] += __shfl_xor_sync(0xffffffffu, d[r], 1);
    d[r] += __shfl_xor_sync(0xffffffffu, d[r], 2);
    const int n = n0 + g + 8 * r;
    if (n < N) {
      if (q == 0) part_d[part * N + n] = d[r];
      float* ph = part_h + (part * N + n) * CP + 2 * q;
#pragma unroll
      for (int j = 0; j < CT; ++j)
        *reinterpret_cast<float2*>(ph + 8 * j) = make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
    }
  }
}

// The merge pass: block (r, b) merges the R = min(N, 16) states from r R of
// batch element b over its S slices, in slice order, and writes hn (B, N, C)
// in bf16. Dynamic shared memory: S x R + R floats (full and bf16_e: each
// slice's weight).
template <int MODE>
__global__ void __launch_bounds__(kMergeThreads) merge_kernel(
    const float* __restrict__ part_d, const float* __restrict__ part_h,
    const float* __restrict__ smax, bf16* __restrict__ hn, int C, int N, int CP, int S, int spt,
    int n_tiles) {
  constexpr bool kWeighted = MODE == kFull || MODE == kBf16E;
  extern __shared__ float smem[];
  const int R = min(N, kMergeRows);
  float* wgt = smem;          // [S][R]: each slice's weight, its TPU tile's
  float* dsum = wgt + S * R;  // [R]
  const int b = blockIdx.y, n0 = blockIdx.x * R, tid = threadIdx.x;
  const float* pd = part_d + (long long)b * S * N + n0;
  const float* ph = part_h + ((long long)b * S * N + n0) * CP;

  if (kWeighted) {
    const float* sm = smax + (long long)b * S * N + n0;
    for (int p = tid; p < n_tiles * R; p += kMergeThreads) {  // tile j's m, from 0, at its first slice
      const int j = p / R, r = p % R;
      float m = 0.f;
      for (int i = j * spt; i < (j + 1) * spt; ++i) m = fmaxf(m, sm[(long long)i * N + r]);
      wgt[j * spt * R + r] = m;
    }
    __syncthreads();
    if (tid < R) {
      float* w = wgt + tid;
      if (MODE == kFull) {  // exp(M_j - M_last), M_j the running max at tile j
        float M = 0.f;
        for (int j = 0; j < n_tiles; ++j) w[j * spt * R] = M = fmaxf(M, w[j * spt * R]);
        for (int j = 0; j < n_tiles; ++j) {
          const float v = expf(w[j * spt * R] - M);
          for (int k = 0; k < spt; ++k) w[(j * spt + k) * R] = v;
        }
      } else {  // exp(-the sum of the later tiles' m)
        float later = 0.f;
        for (int j = n_tiles - 1; j >= 0; --j) {
          const float m = w[j * spt * R], v = expf(-later);
          for (int k = 0; k < spt; ++k) w[(j * spt + k) * R] = v;
          later += m;
        }
      }
    }
    __syncthreads();
  }
  {
    const int r = tid >> 4, j = tid & 15;  // R is even: a warp's two states are both in or out
    if (r < R) {
      float d = 0.f;
      for (int i = j; i < S; i += 16)
        d = kWeighted ? fmaf(pd[(long long)i * N + r], wgt[i * R + r], d)
                      : d + pd[(long long)i * N + r];
#pragma unroll
      for (int off = 8; off > 0; off /= 2) d += __shfl_xor_sync(0xffffffffu, d, off);
      if (j == 0) dsum[r] = d;
    }
  }
  __syncthreads();
  // Lanes run over c, so that the partials' reads are contiguous.
  for (int p = tid; p < R * C; p += kMergeThreads) {
    const int r = p / C, c = p % C;
    const float* src = ph + (long long)r * CP + c;
    float acc = 0.f;
#pragma unroll 4
    for (int i = 0; i < S; ++i) {
      const float v = src[(long long)i * N * CP];
      acc = kWeighted ? fmaf(wgt[i * R + r], v, acc) : acc + v;
    }
    hn[((long long)b * N + n0 + r) * C + c] = __float2bfloat16(acc / (dsum[r] + 1.f));
  }
}

// The scatter pass: block (s, b) walks slice s's tiles and writes y[b, :,
// tile] = hn[b]^T Cm[b, tile]^T; dma_only its TPU tile's sum and its
// checksum at sink[b, s]. MT: 16-channel rows of hn^T, 16 MT >= C. Dynamic
// shared memory: kStages x 64 rows of N16 + 8 elements (Cm) and 16 MT rows
// of kXRow (y).
template <int MODE, int MT>
__global__ void __launch_bounds__(32 * kScatterWarps) scatter_kernel(
    const bf16* __restrict__ hn, const bf16* __restrict__ Cm, bf16* __restrict__ yt,
    float* __restrict__ sink, int C, int L, int N, int tile, int spt, int tps, int nv_shift) {
  constexpr int TG = kScatterWarps / MT;  // warps that share a channel block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  __shared__ float red[kScatterWarps], tile_sum;
  const int N16 = max(N, 16), nr = N16 + 8, stage = kT * nr;
  bf16* ys = ring + kStages * stage;
  const int b = blockIdx.y, s = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mt = warp % MT, tg = warp / MT;
  const int g = lane >> 2, q = lane & 3, m = lane >> 3;
  const Slice sl(s, tile, spt, tps);
  const bf16* cb = Cm + (long long)b * L * N;
  bf16* yb = yt + (long long)b * C * L;

  {  // states past N are never loaded: zeroed once
    uint4* z = reinterpret_cast<uint4*>(ring);
    const int chunks = kStages * stage / 8;
    for (int i = tid; i < chunks; i += blockDim.x) z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  auto issue = [&](int tile_i) {
    load_states(ring + ((tile_i - sl.begin) % kStages) * stage, cb + (long long)tile_i * kT * N,
                nr, nv_shift);
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (sl.begin + i < sl.end) issue(sl.begin + i);
    cp_async_commit();
  }

  unsigned ha[kMaxN / 16][4];  // hn^T (channels 16 mt.. x states), per 16 states an A fragment
  if (MODE == kDmaOnly) {
    if (warp == 0) {  // Cm's first kDmaTokens tokens of TPU tile j, summed
      const bf16* first = cb + (long long)sl.j * tile * N;
      float sum = 0.f;
      for (int i = lane; i < kDmaTokens * N; i += 32) sum += __bfloat162float(first[i]);
      sum = warp_sum(sum);
      if (lane == 0) tile_sum = sum;
    }
  } else {
    const uint16_t* h = reinterpret_cast<const uint16_t*>(hn + (long long)b * N * C);
    auto at = [&](int n, int c) -> unsigned { return n < N && c < C ? h[n * C + c] : 0u; };
#pragma unroll
    for (int ks = 0; ks < kMaxN / 16; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 16 * mt + g + 8 * (i & 1), n = 16 * ks + 2 * q + 8 * (i >> 1);
        ha[ks][i] = at(n, c) | (at(n + 1, c) << 16);
      }
  }
  float check = 0.f;

  for (int tile_i = sl.begin; tile_i < sl.end; ++tile_i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // Cm's tile has landed; the y tile and the stage read last are free
    if (tile_i + kStages - 1 < sl.end) issue(tile_i + kStages - 1);
    cp_async_commit();
    const bf16* cs = ring + ((tile_i - sl.begin) % kStages) * stage;
    const long long l0 = (long long)tile_i * kT;
    if (MODE == kDmaOnly) {
      check += sum_states(cs, nr, nv_shift);
      const unsigned v = pack(tile_sum, tile_sum);
      for (int i = tid; i < C * (kT / 8); i += blockDim.x)
        *reinterpret_cast<uint4*>(yb + (i >> 3) * (long long)L + l0 + (i & 7) * 8) =
            make_uint4(v, v, v, v);
      continue;
    }
    for (int p = tg; p < kT / 16; p += TG) {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < kMaxN / 16; ++ks) {
        if (16 * ks >= N16) break;
        // Cm^T (states x tokens) in the B-fragment layout: cr[0..1] tokens
        // 16p.., cr[2..3] tokens 16p + 8..; a token's states are contiguous.
        unsigned cr[4];
        ldsm_x4(cr, cs + (16 * p + (m >> 1) * 8 + (lane & 7)) * nr + 16 * ks + (m & 1) * 8);
        mma(acc[0], ha[ks], cr);
        mma(acc[1], ha[ks], cr + 2);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<__nv_bfloat162*>(ys + (16 * mt + g + 8 * r) * kXRow + 16 * p +
                                             8 * hh + 2 * q) =
              __floats2bfloat162_rn(acc[hh][2 * r], acc[hh][2 * r + 1]);
    }
    __syncthreads();
    for (int i = tid; i < C * (kT / 8); i += blockDim.x)
      *reinterpret_cast<uint4*>(yb + (i >> 3) * (long long)L + l0 + (i & 7) * 8) =
          *reinterpret_cast<const uint4*>(ys + (i >> 3) * kXRow + (i & 7) * 8);
  }
  if (MODE == kDmaOnly) {
    check = warp_sum(check);
    if (lane == 0) red[warp] = check;
    __syncthreads();
    if (tid == 0) {
      float total = 0.f;
      for (int w = 0; w < kScatterWarps; ++w) total += red[w];
      sink[(long long)b * gridDim.x + s] = total;
    }
  }
}

// Dynamic shared memory above 48 KB must be asked for.
template <typename K>
int allow_smem(K kernel, size_t smem) {
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
  return 0;
}

// 8-channel blocks of the compress (1, 2, 4 or 8): C padded to CP = 8 CT.
int channel_tiles(int C) {
  int ct = 1;
  while (8 * ct < C) ct *= 2;
  return ct;
}

struct Args {
  const bf16 *xt, *dt, *Bm, *Cm, *A;
  float *smax, *part_d, *part_h, *sink;
  bf16 *hn, *yt;
  int B, C, L, N, tile, spt, tps, nv_shift;
  cudaStream_t stream;
};

template <int MODE, int CT>
int compress_ct(const Args& a, dim3 grid) {
  const int N16 = a.N < 16 ? 16 : a.N;
  const size_t smem = sizeof(bf16) * kStages * ((size_t)8 * CT * kXRow + 2 * kT * (N16 + 8));
  int err = allow_smem(compress_kernel<MODE, CT>, smem);
  if (err != 0) return err;
  compress_kernel<MODE, CT><<<grid, 32 * (N16 / 16), smem, a.stream>>>(
      a.xt, a.dt, a.Bm, a.A, a.smax, a.part_d, a.part_h, a.C, a.L, a.N, a.tile, a.spt, a.tps,
      a.nv_shift);
  return (int)cudaGetLastError();
}

template <int MODE>
int compress(const Args& a, dim3 grid) {
  switch (channel_tiles(a.C)) {
    case 1: return compress_ct<MODE, 1>(a, grid);
    case 2: return compress_ct<MODE, 2>(a, grid);
    case 4: return compress_ct<MODE, 4>(a, grid);
    default: return compress_ct<MODE, 8>(a, grid);
  }
}

template <int MODE, int MT>
int scatter_mt(const Args& a, dim3 grid) {
  const int N16 = a.N < 16 ? 16 : a.N;
  const size_t smem = sizeof(bf16) * ((size_t)kStages * kT * (N16 + 8) + 16 * MT * kXRow);
  int err = allow_smem(scatter_kernel<MODE, MT>, smem);
  if (err != 0) return err;
  scatter_kernel<MODE, MT><<<grid, 32 * kScatterWarps, smem, a.stream>>>(
      a.hn, a.Cm, a.yt, a.sink, a.C, a.L, a.N, a.tile, a.spt, a.tps, a.nv_shift);
  return (int)cudaGetLastError();
}

template <int MODE>
int scatter(const Args& a, dim3 grid) {
  if constexpr (MODE == kDmaOnly) return scatter_mt<MODE, 1>(a, grid);
  if (a.C <= 16) return scatter_mt<MODE, 1>(a, grid);
  if (a.C <= 32) return scatter_mt<MODE, 2>(a, grid);
  return scatter_mt<MODE, 4>(a, grid);
}

template <int MODE>
int run(const Args& a) {
  const int n_tiles = a.L / a.tile, S = n_tiles * a.spt;
  const dim3 grid(S, a.B);
  int err;
  if (MODE == kFull || MODE == kBf16E) {
    tilemax_kernel<<<grid, kTilemaxThreads, 0, a.stream>>>(a.dt, a.A, a.smax, a.L, a.N, a.tile,
                                                           a.spt, a.tps, a.nv_shift);
    if ((err = (int)cudaGetLastError()) != 0) return err;
  }
  if ((err = compress<MODE>(a, grid)) != 0) return err;
  if (MODE != kDmaOnly) {
    const int R = a.N < kMergeRows ? a.N : kMergeRows;
    const size_t msmem = sizeof(float) * ((size_t)S * R + R);
    if ((err = allow_smem(merge_kernel<MODE>, msmem)) != 0) return err;
    merge_kernel<MODE><<<dim3(a.N / R, a.B), kMergeThreads, msmem, a.stream>>>(
        a.part_d, a.part_h, a.smax, a.hn, a.C, a.N, 8 * channel_tiles(a.C), S, a.spt, n_tiles);
    if ((err = (int)cudaGetLastError()) != 0) return err;
  }
  return scatter<MODE>(a, grid);
}

bool valid(int B, int C, int L, int N, int tile, int spt, int tps) {
  if (B < 1 || B > 65535 || C < 1 || C > kMaxC || N < 8 || N > kMaxN || (N & (N - 1)) != 0 ||
      tile < kT || tile % kT != 0 || L < tile || L % tile != 0 || spt < 1 || tps < 1)
    return false;
  const int per_tile = tile / kT;
  return (long long)spt * tps >= per_tile && (long long)(spt - 1) * tps < per_tile &&
         (long long)(L / tile) * spt <= 2147483647LL;
}

}  // namespace

// mode: kernels/ablate_mix.py's MODES index. x (B, C, L), dt, Bm, Cm (B, L,
// N) and y (B, C, L) contiguous bf16, each 16-byte aligned; A (N,) bf16;
// each TPU tile of `tile` tokens (a multiple of 64 dividing L) goes to spt
// slices of tps 64-token tiles. Scratch: smax (B, S, N) fp32 (full and
// bf16_e only, else unused), part_d (B, S, N) and part_h (B, S, N, CP) fp32
// with S = (L / tile) spt and CP = C rounded up to 8, 16, 32 or 64, hn (B,
// N, C) bf16, sink (B, S) fp32. Returns cudaGetLastError() after the first
// launch that fails or after the last, or -1 for an argument the kernels do
// not take (C in [1, 64], N in {8, 16, 32, 64}).
extern "C" int kmunet_hsmssd_ablate(int mode, const void* xt, const void* dt, const void* Bm,
                                    const void* Cm, const void* A, void* smax, void* part_d,
                                    void* part_h, void* hn, void* sink, void* yt, int B, int C,
                                    int L, int N, int tile, int spt, int tps, void* stream) {
  if (!valid(B, C, L, N, tile, spt, tps)) return -1;
  int nv_shift = 0;
  while ((8 << nv_shift) < N) ++nv_shift;
  const Args a{static_cast<const bf16*>(xt), static_cast<const bf16*>(dt),
               static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm),
               static_cast<const bf16*>(A), static_cast<float*>(smax),
               static_cast<float*>(part_d), static_cast<float*>(part_h),
               static_cast<float*>(sink), static_cast<bf16*>(hn), static_cast<bf16*>(yt), B, C, L,
               N, tile, spt, tps, nv_shift, static_cast<cudaStream_t>(stream)};
  switch (mode) {
    case kFull: return run<kFull>(a);
    case kBf16E: return run<kBf16E>(a);
    case kNoMax: return run<kNoMax>(a);
    case kNoExp: return run<kNoExp>(a);
    case kDmaOnly: return run<kDmaOnly>(a);
    default: return -1;
  }
}
