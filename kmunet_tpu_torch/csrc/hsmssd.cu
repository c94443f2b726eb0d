// K2 and K3: the HSM-SSD mixer's online-softmax compress (K2) and the whole
// mixer fused (K3).
//
//   h[b,n,c]  = sum_l softmax_L(dt + A)[b,n,l] * B[b,n,l] * x[b,c,l]        (K2)
//   h_, z     = split(h . W_hz^T)                  W_hz (2C, C)
//   h2[b,n,c] = (h_ * silu(z) + h_ * D) . W_out^T   W_out (C, C), h2 in x's dtype
//   y[b,c,l]  = sum_n h2[b,n,c] * C[b,n,l]                                  (K3: y, h2)
//
// x (B, C, L) contiguous; dt, B and C (B, N, L) with tokens contiguous and any
// batch stride, so that they may be the slices of one (B, 3N, L) tensor;
// A (N,), W_hz, W_out and D fp32; x, dt, B, C and the outputs in one dtype
// (fp32, bf16 or fp16); every sum in fp32.
//
// Replaces the TPU kernels kmunet_tpu/kernels/ssd_pallas.py::hsmssd_compress
// (K2, the pl.pallas_call at :79) and kmunet_tpu/kernels/ssd_mix_pallas.py::
// hsmssd_mix (K3, the pl.pallas_call at :150). K3's gradient is the autodiff
// of its plain version (kernels/ssd.py), as the TPU kernel's custom VJP is the
// autodiff of hsmssd_mix_reference; so is K2's.
//
// Design. The TPU kernels walk the L tiles of a batch element in order on one
// core, carrying the running max, denominator and unnormalised h in VMEM,
// with both products on the MXU. A GPU has 132 SMs and nothing carries
// between blocks, so the carry becomes a split into slices and a merge, and
// the products go to the tensor cores (mma.sync):
//   compress  one block per (slice of L, b) walks its tiles of kT tokens
//             through a ring of kStages tiles in shared memory: x (C, kT),
//             dt and B (N, kT), each row padded by 8 elements so that the 8
//             rows an ldmatrix reads fall in distinct banks. All threads fill
//             the ring with 16-byte cp.async (zero-filled past L), kStages - 1
//             tiles ahead of the one being computed, one __syncthreads per
//             tile. cp.async and not TMA: three small tiles from three tensors
//             with ragged ends, written straight into the padded rows, and no
//             tensor maps to encode per call. Where a row of L tokens is not
//             16-byte aligned (L * esz % 16 != 0, or a base or batch stride
//             that is not), the same threads fill the same layout with plain
//             loads and stores (a choice by shape inside the kernel; nothing
//             else changes). Each warp owns 16 states n (N = 4 and 8 pad to
//             16 rows with dt = 0, A = 0 and B = 0: a finite s, w = 0, never
//             written) and computes h^T (16 x C) in the FlashAttention-2
//             layout: per tile the max of dt over its tokens per row (within
//             the thread, then 2 shuffles over the quad; max(dt) + A is
//             max(dt + A) since rounding is monotonic), m_new = max(m, that),
//             scale = exp(m - m_new) (0 on a slice's first tile, where m =
//             -inf meets zero accumulators), then per k-step of 16 tokens
//             s = dt + A, e = exp(s - m_new) (0 past L), the thread's part of
//             d, and w = e * B straight into the A-fragment registers of
//             mma.m16n8k16 (rows n, columns t); the B operand x^T (tokens x
//             channels) comes from the staged x tile by ldmatrix. A tile's
//             products go to zeroed fp32 fragments, added to the running h^T
//             by one fma with the rescale, h = h * scale + tile, so that no
//             chain of tensor-core accumulations spans more than a tile. Each
//             slice writes its partial m, d (N) and h (N, CP), fp32, CP = C
//             padded to 8, 16, 32 or 64 channels.
//   merge     one block per (16 states, b): m = max_i m_i, d = sum_i d_i
//             e^(m_i - m), h = sum_i h_i e^(m_i - m) / d over the slices in
//             order; K2 writes h; K3 computes the gated MLP on the block's
//             states (W_hz and W_out staged in shared memory) and writes h2
//             rounded to x's dtype (the TPU kernel rounds it so before its
//             scatter, ssd_mix_pallas.py:106,111).
//   scatter   (K3) one block per (slice of L, b) with 4 warps: y (C x kT) =
//             h2^T (C x N) . C (N x kT) per tile. The A fragments of h2^T are
//             loaded once per block into registers; C's tiles stream through
//             the same kind of ring and are read by ldmatrix.trans; y goes
//             through a staged tile in shared memory and out as 16-byte row
//             segments. Warp w takes the 16 channels w % MT (MT = ceil(C /
//             16) rounded to 1, 2 or 4) and every (4 / MT)-th pair of 8-token
//             columns.
// So K2 is two device launches (compress, merge) and K3 three. dt, B and x
// are read once, C once; neither the softmax nor e*B is ever written.
//
// The split of w. The plain version keeps w = e * B in fp32; the TPU kernel
// rounds it once to x's dtype (ssd_mix_pallas.py:80), an error of up to
// 2^-9 |w| per term in bf16 that the check (one bf16 ulp of each h element
// beyond 1e-5 + 1e-5 max|h|) does not leave room for where h is small by
// cancellation. So per dtype:
//   bf16  w = w_hi + w_lo, two bf16 values (the rest at most 2^-18 |w|), as
//         two mma.m16n8k16.bf16 into the same fragments; x is exact in bf16.
//   fp16  mma.m16n8k8.tf32: x is exact in TF32, w split into two TF32 parts
//         (the rest at most 2^-22 |w|): two products per 8 tokens.
//   fp32  the same with x split too: w_hi x_hi + w_lo x_hi + w_hi x_lo.
// In the TF32 products the 16 tokens of a k-step are taken as two k = 8
// halves whose k = q, q + 4 are the tokens 2q, 2q + 1 (+ 8), so that every
// dtype holds the same (n, token) pairs in the same registers. The scatter's
// products are exact in bf16 and fp16 (h2 is rounded to x's dtype before it,
// as the TPU kernel rounds it); fp32 takes 3xTF32 there too. The exps are
// ex2.approx of (s - m) log2(e).
//
// Bound. At KM_UNetV3-SH's enc1 mixer (B = 128, C = 16, L = 16384, N = 64,
// bf16) K3 moves x 67.1 MB, dt, B and C 268.4 MB each and y 67.1 MB: 939 MB,
// 280 us at 3.35 TB/s, against 8.6 GFLOP of products, 8.7 us on the tensor
// cores: bytes bound both passes (K2 moves 604 MB, 180 us; the scatter 336
// MB, 100 us). Each (b, l, n) costs the compress about 12 fp32 and SFU
// instructions (two reads of dt, the max, s, e, d, w and its split) against
// 4 bytes of dt and B read, and each 16 x 16 x 8 block of products two mma
// (bf16). Measured there (chip_smoke.py's mixer_timing, NVIDIA H100 80GB
// HBM3 at 700 W): the compress 207-234 us (1.15-1.3x its bytes), the
// scatter 112-119 us, the merge 6-12 us. Tiles of 32 or 16 tokens ran 1.4x
// slower while a cheaper max pass changed nothing: the 128-byte segment
// each row gives a tile, and the ring's depth (2 blocks of 83 KB per SM in
// bf16), set the compress's rate, not its instructions. The merge's MLP is
// (4C + 2) C N operations per batch element, its largest pass at C = 64.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kT = 64;              // tokens per tile, compress and scatter
constexpr int kStages = 4;          // tiles in a block's ring
constexpr int kRow = kT + 8;        // a staged row in elements: 8 of padding against bank conflicts
constexpr int kMaxN = 64;           // N a power of two in [4, kMaxN]
constexpr int kMaxC = 64;
constexpr int kMergeThreads = 256;  // 16 states x 16 lanes
constexpr int kMergeRows = 16;      // states per merge block
constexpr int kScatterWarps = 4;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half(v);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; zeros where
// !in_bounds (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in_bounds) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in_bounds ? 16 : 0)
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

// d += a . b, m16n8k16 (bf16 or fp16 operands) or m16n8k8 (tf32), fp32 d.
__device__ __forceinline__ void mma(float* d, const unsigned* a, const unsigned* b,
                                    __nv_bfloat16) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma(float* d, const unsigned* a, const unsigned* b, __half) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_tf32(float* d, float a0, float a1, float a2, float a3,
                                         float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a0)), "r"(__float_as_uint(a1)), "r"(__float_as_uint(a2)),
        "r"(__float_as_uint(a3)), "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

__device__ __forceinline__ float fast_exp2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}

// v rounded to TF32 (ties away), as an fp32 value with the low 13 bits 0.
__device__ __forceinline__ float tf32(float v) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// The two 16-bit values of r (low first) as fp32.
__device__ __forceinline__ float2 unpack(unsigned r, __nv_bfloat16) {
  return make_float2(__uint_as_float(r << 16), __uint_as_float(r & 0xffff0000u));
}
__device__ __forceinline__ float2 unpack(unsigned r, __half) {
  __half2 h;
  memcpy(&h, &r, 4);
  return __half22float2(h);
}

// (a, b) as hi + lo, each a pair of bf16 (a in the low half).
__device__ __forceinline__ void split_bf16(float a, float b, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  memcpy(&hi, &h, 4);
  memcpy(&lo, &l, 4);
}

// Tokens [l0, l0 + kT) of `rows` rows (row r at src + r * stride) into the
// staged rows of kRow elements at dst, zeros past L. aligned: 16-byte
// cp.async (every row start and l0 16-byte aligned, so a chunk lies wholly
// before or past L); else plain loads and stores.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long stride, int rows,
                                          int l0, int L, int aligned) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = kT / kVec;
  if (aligned) {
    for (int i = threadIdx.x; i < rows * kChunks; i += blockDim.x) {
      const int r = i / kChunks, c = (i % kChunks) * kVec, l = l0 + c;
      const T* row = src + r * stride;
      cp_async16(dst + r * kRow + c, l < L ? row + l : row, l < L);
    }
  } else {
    for (int i = threadIdx.x; i < rows * kT; i += blockDim.x) {
      const int r = i / kT, t = i % kT, l = l0 + t;
      dst[r * kRow + t] = l < L ? src[r * stride + l] : from_f32<T>(0.f);
    }
  }
}

// The staged rows [0, rows) x tokens [l0, min(l0 + kT, L)) out to dst.
template <typename T>
__device__ __forceinline__ void store_rows(T* dst, const T* src, long long stride, int rows,
                                           int l0, int L, int aligned) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = kT / kVec;
  if (aligned) {
    for (int i = threadIdx.x; i < rows * kChunks; i += blockDim.x) {
      const int r = i / kChunks, c = (i % kChunks) * kVec, l = l0 + c;
      if (l < L)
        *reinterpret_cast<uint4*>(dst + r * stride + l) =
            *reinterpret_cast<const uint4*>(src + r * kRow + c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * kT; i += blockDim.x) {
      const int r = i / kT, t = i % kT, l = l0 + t;
      if (l < L) dst[r * stride + l] = src[r * kRow + t];
    }
  }
}

// Thread (g, q) = (lane / 4, lane % 4) of a warp holds, of a 16 x 16 block
// of a staged tile (rows r0.., tokens c0..), the eight values of the
// mma.m16n8k16 A-fragment layout: v[0..1] (g, 2q..2q+1), v[2..3] (g + 8,
// 2q..), v[4..5] (g, 2q + 8..), v[6..7] (g + 8, 2q + 8..). Value i is at row
// g + 8 ((i >> 1) & 1) and token 2q + (i & 1) + 8 (i >> 2).
template <typename T>
__device__ __forceinline__ void load_frag(const T* tile, int r0, int c0, int lane,
                                          float (&v)[8]) {
  const int m = lane >> 3;
  unsigned r[4];
  ldsm_x4(r, tile + (r0 + (m & 1) * 8 + (lane & 7)) * kRow + c0 + (m >> 1) * 8);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = unpack(r[i], T());
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
template <>
__device__ __forceinline__ void load_frag<float>(const float* tile, int r0, int c0, int lane,
                                                 float (&v)[8]) {
  const float* p = tile + (r0 + (lane >> 2)) * kRow + c0 + 2 * (lane & 3);
  const float2 a = *reinterpret_cast<const float2*>(p);
  const float2 b = *reinterpret_cast<const float2*>(p + 8 * kRow);
  const float2 c = *reinterpret_cast<const float2*>(p + 8);
  const float2 d = *reinterpret_cast<const float2*>(p + 8 * kRow + 8);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  v[4] = c.x; v[5] = c.y; v[6] = d.x; v[7] = d.y;
}

// The compress's products for one k-step: acc[j] (16 states x 8 channels
// 8j..8j+7) += w (16 states x 16 tokens kk..) . x^T, w in load_frag's
// layout, x the staged (CP x kT) tile.
template <typename T, int CT>
struct CompressProducts;

template <int CT>
struct CompressProducts<__nv_bfloat16, CT> {
  static __device__ __forceinline__ void run(float (&acc)[CT][4], const float (&w)[8],
                                             const __nv_bfloat16* xs, int kk, int lane) {
    unsigned hi[4], lo[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) split_bf16(w[2 * p], w[2 * p + 1], hi[p], lo[p]);
    const int m = lane >> 3;
#pragma unroll
    for (int j = 0; j < CT; j += 2) {
      unsigned b[4];  // b[0..1] channels 8j.., b[2..3] channels 8j + 8..
      if constexpr (CT == 1)
        ldsm_x2(b, xs + (lane & 7) * kRow + kk + (m & 1) * 8);
      else
        ldsm_x4(b, xs + (8 * (j + (m >> 1)) + (lane & 7)) * kRow + kk + (m & 1) * 8);
      mma(acc[j], hi, b, __nv_bfloat16());
      mma(acc[j], lo, b, __nv_bfloat16());
      if constexpr (CT > 1) {
        mma(acc[j + 1], hi, b + 2, __nv_bfloat16());
        mma(acc[j + 1], lo, b + 2, __nv_bfloat16());
      }
    }
  }
};

// fp16: TF32 products, x exact; the k = 8 half h holds the tokens 2q + 8h
// (k = q) and 2q + 8h + 1 (k = q + 4).
template <int CT>
struct CompressProducts<__half, CT> {
  static __device__ __forceinline__ void run(float (&acc)[CT][4], const float (&w)[8],
                                             const __half* xs, int kk, int lane) {
    float hi[8], lo[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      hi[i] = tf32(w[i]);
      lo[i] = tf32(w[i] - hi[i]);
    }
    const int m = lane >> 3;
#pragma unroll
    for (int j = 0; j < CT; j += 2) {
      unsigned b[4];
      if constexpr (CT == 1)
        ldsm_x2(b, xs + (lane & 7) * kRow + kk + (m & 1) * 8);
      else
        ldsm_x4(b, xs + (8 * (j + (m >> 1)) + (lane & 7)) * kRow + kk + (m & 1) * 8);
#pragma unroll
      for (int jj = 0; jj < (CT > 1 ? 2 : 1); ++jj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 xv = unpack(b[2 * jj + h], __half());
          const int o = 4 * h;
          mma_tf32(acc[j + jj], hi[o], hi[o + 2], hi[o + 1], hi[o + 3], xv.x, xv.y);
          mma_tf32(acc[j + jj], lo[o], lo[o + 2], lo[o + 1], lo[o + 3], xv.x, xv.y);
        }
    }
  }
};

// fp32: 3xTF32, w and x each split in two.
template <int CT>
struct CompressProducts<float, CT> {
  static __device__ __forceinline__ void run(float (&acc)[CT][4], const float (&w)[8],
                                             const float* xs, int kk, int lane) {
    float hi[8], lo[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      hi[i] = tf32(w[i]);
      lo[i] = tf32(w[i] - hi[i]);
    }
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const float* p = xs + (8 * j + g) * kRow + kk + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 xv = *reinterpret_cast<const float2*>(p + 8 * h);
        const float x0 = tf32(xv.x), x1 = tf32(xv.y);
        const float y0 = tf32(xv.x - x0), y1 = tf32(xv.y - x1);
        const int o = 4 * h;
        mma_tf32(acc[j], hi[o], hi[o + 2], hi[o + 1], hi[o + 3], x0, x1);
        mma_tf32(acc[j], lo[o], lo[o + 2], lo[o + 1], lo[o + 3], x0, x1);
        mma_tf32(acc[j], hi[o], hi[o + 2], hi[o + 1], hi[o + 3], y0, y1);
      }
    }
  }
};

// One staged tile of the compress for the warp's 16 states from row n0:
// the online-softmax update of m, d (this thread's part) and h^T. MASK: the
// tile's tokens from rem on lie past L.
template <typename T, int CT, bool MASK>
__device__ __forceinline__ void compress_tile(const T* xs, const T* ds, const T* bs, int n0,
                                              int lane, const float (&a)[2], float (&m)[2],
                                              float (&d)[2], float (&acc)[CT][4], int rem) {
  const int q = lane & 3;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int kk = 0; kk < kT; kk += 16) {
    float v[8];
    load_frag(ds, n0, kk, lane, v);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (!MASK || kk + 2 * q + (i & 1) + 8 * (i >> 2) < rem)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], v[i]);
  }
  float scale[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] + a[r]);  // finite: the tile has a token
    scale[r] = fast_exp2((m[r] - m_new) * kLog2e);  // 0 on the slice's first tile
    m[r] = m_new;
    d[r] *= scale[r];
  }
  float tile[CT][4];
#pragma unroll
  for (int j = 0; j < CT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) tile[j][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kT; kk += 16) {
    float v[8], bv[8], w[8];
    load_frag(ds, n0, kk, lane, v);
    load_frag(bs, n0, kk, lane, bv);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = (i >> 1) & 1;
      const float s = v[i] + a[r];
      float e = fast_exp2((s - m[r]) * kLog2e);
      if (MASK && kk + 2 * q + (i & 1) + 8 * (i >> 2) >= rem) e = 0.f;
      d[r] += e;
      w[i] = e * bv[i];
    }
    CompressProducts<T, CT>::run(tile, w, xs, kk, lane);
  }
#pragma unroll
  for (int j = 0; j < CT; ++j) {
    acc[j][0] = fmaf(acc[j][0], scale[0], tile[j][0]);
    acc[j][1] = fmaf(acc[j][1], scale[0], tile[j][1]);
    acc[j][2] = fmaf(acc[j][2], scale[1], tile[j][2]);
    acc[j][3] = fmaf(acc[j][3], scale[1], tile[j][3]);
  }
}

// The compress pass: block (s, b), 32 * max(N, 16) / 16 threads, walks tiles
// [s * tps, min((s + 1) * tps, tiles)) of batch element b and writes its
// partial max, denominator and unnormalised h at (b, s). Dynamic shared
// memory: the ring, kStages x (CP + 2 max(N, 16)) rows of kRow elements.
template <typename T, int CT>
__global__ void __launch_bounds__(128) compress_kernel(
    const T* __restrict__ x, const T* __restrict__ dt, const T* __restrict__ Bm,
    const float* __restrict__ A, float* __restrict__ part_m, float* __restrict__ part_d,
    float* __restrict__ part_h, int C, int L, int N, int tps, long long dt_bstride,
    long long bm_bstride, int aligned) {
  constexpr int CP = 8 * CT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int N16 = max(N, 16);
  const int stage = (CP + 2 * N16) * kRow;
  const int b = blockIdx.y, s = blockIdx.x, S = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, n0 = (tid >> 5) * 16;
  const int g = lane >> 2, q = lane & 3;
  const int tiles = (L + kT - 1) / kT;
  const int first = s * tps, last = min(tiles, first + tps);
  const T* xb = x + (long long)b * C * L;
  const T* dtb = dt + b * dt_bstride;
  const T* bmb = Bm + b * bm_bstride;

  // Rows past C and N are never loaded: zeroed once, they hold x = 0, dt =
  // 0 and B = 0.
  {
    uint4* z = reinterpret_cast<uint4*>(ring);
    const int chunks = kStages * stage * (int)sizeof(T) / 16;
    for (int i = tid; i < chunks; i += blockDim.x) z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  auto issue = [&](int tile) {
    T* st = ring + ((tile - first) % kStages) * stage;
    const int l0 = tile * kT;
    load_rows(st, xb, L, C, l0, L, aligned);
    load_rows(st + CP * kRow, dtb, L, N, l0, L, aligned);
    load_rows(st + (CP + N16) * kRow, bmb, L, N, l0, L, aligned);
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (first + i < last) issue(first + i);
    cp_async_commit();
  }

  const float a[2] = {n0 + g < N ? A[n0 + g] : 0.f, n0 + g + 8 < N ? A[n0 + g + 8] : 0.f};
  float m[2] = {-INFINITY, -INFINITY}, d[2] = {0.f, 0.f};
  float acc[CT][4];
#pragma unroll
  for (int j = 0; j < CT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  for (int tile = first; tile < last; ++tile) {
    cp_async_wait<kStages - 2>();  // this thread's copies of `tile` have landed
    __syncthreads();               // everyone's have; the stage read last is free
    if (tile + kStages - 1 < last) issue(tile + kStages - 1);
    cp_async_commit();
    const T* xs = ring + ((tile - first) % kStages) * stage;
    const T* ds = xs + CP * kRow;
    const T* bs = ds + N16 * kRow;
    const int rem = L - tile * kT;
    if (rem >= kT)
      compress_tile<T, CT, false>(xs, ds, bs, n0, lane, a, m, d, acc, kT);
    else
      compress_tile<T, CT, true>(xs, ds, bs, n0, lane, a, m, d, acc, rem);
  }

  const long long part = (long long)b * S + s;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    d[r] += __shfl_xor_sync(0xffffffffu, d[r], 1);
    d[r] += __shfl_xor_sync(0xffffffffu, d[r], 2);
    const int n = n0 + g + 8 * r;
    if (n < N) {
      if (q == 0) {
        part_m[part * N + n] = m[r];
        part_d[part * N + n] = d[r];
      }
      float* ph = part_h + (part * N + n) * CP + 2 * q;
#pragma unroll
      for (int j = 0; j < CT; ++j)
        *reinterpret_cast<float2*>(ph + 8 * j) = make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
    }
  }
}

// The merge pass: block (r, b) merges the R = min(N, 16) states from r R of
// batch element b over its S slices, in slice order. MIX = false writes h
// (B, N, C) (K2); MIX = true computes the gated MLP on those states and
// writes h2 (B, N, C) (K3). part_h rows hold CP channels. 256 threads: 16
// lanes per state take every 16th slice for the max, the weights and the
// denominator, combined by shuffles in a fixed order; then a thread per
// (state, channel) walks the slices; the MLP reads W_hz^T and W_out^T
// staged in shared memory. Dynamic shared memory: merge_smem bytes.
template <typename T, bool MIX>
__global__ void __launch_bounds__(kMergeThreads) merge_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_d,
    const float* __restrict__ part_h, const float* __restrict__ w_hz,
    const float* __restrict__ w_out, const float* __restrict__ Dp, T* __restrict__ out,
    int S, int N, int C, int CP) {
  extern __shared__ float smem[];
  const int R = min(N, kMergeRows), C2 = 2 * C;
  float* wgt = smem;                 // [S][R]: e^(m_i - m)
  float* dsum = wgt + S * R;         // [R]
  float* hs = dsum + R;              // [R][C + 1]: h, then the gated states
  float* hz = hs + R * (C + 1);      // [R][2C + 1]: h W_hz^T
  float* wt = hz + R * (C2 + 1);     // [C][2C + 1]: W_hz^T
  float* wo = wt + C * (C2 + 1);     // [C][C + 1]: W_out^T
  const int b = blockIdx.y, n0 = blockIdx.x * R, tid = threadIdx.x;
  const float* pm = part_m + (long long)b * S * N + n0;
  const float* pd = part_d + (long long)b * S * N + n0;
  const float* ph = part_h + ((long long)b * S * N + n0) * CP;

  if (MIX) {  // the MLP's weights, transposed, for after the merge; 8 loads in flight
#pragma unroll 8
    for (int p = tid; p < C2 * C; p += kMergeThreads) wt[(p % C) * (C2 + 1) + p / C] = w_hz[p];
#pragma unroll 8
    for (int p = tid; p < C * C; p += kMergeThreads) wo[(p % C) * (C + 1) + p / C] = w_out[p];
  }
  {
    const int r = tid >> 4, j = tid & 15;  // R is even: a warp's two states are both in or out
    if (r < R) {
      float m = -INFINITY;
      for (int i = j; i < S; i += 16) m = fmaxf(m, pm[i * N + r]);
#pragma unroll
      for (int off = 8; off > 0; off /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      float d = 0.f;
      for (int i = j; i < S; i += 16) {
        const float e = expf(pm[i * N + r] - m);
        wgt[i * R + r] = e;
        d = fmaf(pd[i * N + r], e, d);
      }
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
    for (int i = 0; i < S; ++i) acc = fmaf(wgt[i * R + r], src[(long long)i * N * CP], acc);
    const float h = acc / dsum[r];
    if (MIX)
      hs[r * (C + 1) + c] = h;
    else
      out[((long long)b * N + n0 + r) * C + c] = from_f32<T>(h);
  }
  if (!MIX) return;
  __syncthreads();
  for (int p = tid; p < R * C2; p += kMergeThreads) {
    const int r = p / C2, j = p % C2;
    const float* hr = hs + r * (C + 1);
    float acc = 0.f;
#pragma unroll 8
    for (int k = 0; k < C; ++k) acc = fmaf(hr[k], wt[k * (C2 + 1) + j], acc);
    hz[r * (C2 + 1) + j] = acc;
  }
  __syncthreads();
  const float D = Dp[0];
  for (int p = tid; p < R * C; p += kMergeThreads) {
    const int r = p / C, c = p % C;
    const float hv = hz[r * (C2 + 1) + c], z = hz[r * (C2 + 1) + C + c];
    hs[r * (C + 1) + c] = hv * (z / (1.f + expf(-z))) + hv * D;
  }
  __syncthreads();
  for (int p = tid; p < R * C; p += kMergeThreads) {
    const int r = p / C, c = p % C;
    const float* gr = hs + r * (C + 1);
    float h2 = 0.f;
#pragma unroll 8
    for (int k = 0; k < C; ++k) h2 = fmaf(gr[k], wo[k * (C + 1) + c], h2);
    out[((long long)b * N + n0 + r) * C + c] = from_f32<T>(h2);
  }
}

// The scatter's A operand, h2^T (channels c0..c0+15 x states), and its
// products with a staged C tile (N16 x kT): acc[h] (16 channels x 8 tokens
// t0 + 8h..) += h2^T . C[:, t0 + 8h..].
template <typename T>
struct ScatterProducts {
  unsigned a[kMaxN / 16][4];  // per 16 states: the m16n8k16 A fragment

  __device__ __forceinline__ void load(const T* h2b, int C, int N, int c0, int lane) {
    const uint16_t* h = reinterpret_cast<const uint16_t*>(h2b);
    const int g = lane >> 2, q = lane & 3;
    auto at = [&](int n, int c) -> unsigned { return n < N && c < C ? h[n * C + c] : 0u; };
#pragma unroll
    for (int ks = 0; ks < kMaxN / 16; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = c0 + g + 8 * (i & 1), n = 16 * ks + 2 * q + 8 * (i >> 1);
        a[ks][i] = at(n, c) | (at(n + 1, c) << 16);
      }
  }

  __device__ __forceinline__ void run(float (&acc)[2][4], const T* cs, int N16, int t0,
                                      int lane) const {
    const int m = lane >> 3;
#pragma unroll
    for (int ks = 0; ks < kMaxN / 16; ++ks) {
      if (16 * ks >= N16) break;
      unsigned b[4];
      ldsm_x4_trans(b, cs + (16 * ks + (m & 1) * 8 + (lane & 7)) * kRow + t0 + (m >> 1) * 8);
      mma(acc[0], a[ks], b, T());
      mma(acc[1], a[ks], b + 2, T());
    }
  }
};

// fp32: 3xTF32 m16n8k8 over 8 states a step.
template <>
struct ScatterProducts<float> {
  float hi[kMaxN / 8][4], lo[kMaxN / 8][4];

  __device__ __forceinline__ void load(const float* h2b, int C, int N, int c0, int lane) {
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int ks = 0; ks < kMaxN / 8; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4): (channel, state)
        const int c = c0 + g + 8 * (i & 1), n = 8 * ks + q + 4 * (i >> 1);
        const float v = n < N && c < C ? h2b[n * C + c] : 0.f;
        hi[ks][i] = tf32(v);
        lo[ks][i] = tf32(v - hi[ks][i]);
      }
  }

  __device__ __forceinline__ void run(float (&acc)[2][4], const float* cs, int N16, int t0,
                                      int lane) const {
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int ks = 0; ks < kMaxN / 8; ++ks) {
      if (8 * ks >= N16) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* p = cs + (8 * ks + q) * kRow + t0 + 8 * h + g;
        const float b0 = p[0], b1 = p[4 * kRow];
        const float x0 = tf32(b0), x1 = tf32(b1);
        const float y0 = tf32(b0 - x0), y1 = tf32(b1 - x1);
        mma_tf32(acc[h], hi[ks][0], hi[ks][1], hi[ks][2], hi[ks][3], x0, x1);
        mma_tf32(acc[h], lo[ks][0], lo[ks][1], lo[ks][2], lo[ks][3], x0, x1);
        mma_tf32(acc[h], hi[ks][0], hi[ks][1], hi[ks][2], hi[ks][3], y0, y1);
      }
    }
  }
};

// Two adjacent outputs into the staged y tile.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// The scatter pass of K3: block (s, b) walks the compress's tiles of slice s
// and writes y[b, :, tile] = h2[b]^T C[b, :, tile]. MT: 16-channel rows of
// h2^T, 16 MT >= C. Dynamic shared memory: kStages x max(N, 16) rows of C
// and 16 MT rows of y, kRow elements each.
template <typename T, int MT>
__global__ void __launch_bounds__(32 * kScatterWarps) scatter_kernel(
    const T* __restrict__ h2, const T* __restrict__ Cm, T* __restrict__ y, int C, int L, int N,
    int tps, long long cm_bstride, int aligned) {
  constexpr int TG = kScatterWarps / MT;  // warps that share a channel block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int N16 = max(N, 16);
  const int stage = N16 * kRow;
  T* ys = ring + kStages * stage;
  const int b = blockIdx.y, s = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mt = warp % MT, tg = warp / MT;
  const int g = lane >> 2, q = lane & 3;
  const int tiles = (L + kT - 1) / kT;
  const int first = s * tps, last = min(tiles, first + tps);
  const T* cb = Cm + b * cm_bstride;
  T* yb = y + (long long)b * C * L;

  {  // rows past N are never loaded: zeroed once
    uint4* z = reinterpret_cast<uint4*>(ring);
    const int chunks = kStages * stage * (int)sizeof(T) / 16;
    for (int i = tid; i < chunks; i += blockDim.x) z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  auto issue = [&](int tile) {
    load_rows(ring + ((tile - first) % kStages) * stage, cb, L, N, tile * kT, L, aligned);
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (first + i < last) issue(first + i);
    cp_async_commit();
  }
  ScatterProducts<T> prod;
  prod.load(h2 + (long long)b * N * C, C, N, 16 * mt, lane);

  for (int tile = first; tile < last; ++tile) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // C's tile has landed; the y tile and the stage read last are free
    if (tile + kStages - 1 < last) issue(tile + kStages - 1);
    cp_async_commit();
    const T* cs = ring + ((tile - first) % kStages) * stage;
    const int rem = L - tile * kT;
    for (int p = tg; p < kT / 16; p += TG) {
      if (16 * p >= rem) break;
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      prod.run(acc, cs, N16, 16 * p, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          store2(ys + (16 * mt + g + 8 * r) * kRow + 16 * p + 8 * h + 2 * q, acc[h][2 * r],
                 acc[h][2 * r + 1]);
    }
    __syncthreads();
    store_rows(yb, ys, L, C, tile * kT, L, aligned);
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

bool valid(int B, int C, int L, int N, int S, int tps) {
  if (B < 1 || B > 65535 || C < 1 || C > kMaxC || L < 1 || N < 4 || N > kMaxN ||
      (N & (N - 1)) != 0 || S < 1 || tps < 1)
    return false;
  const int tiles = (L + kT - 1) / kT;
  return (long long)S * tps >= tiles && (long long)(S - 1) * tps < tiles && S <= 65535;
}

template <typename T, int CT>
int compress_ct(const void* x, const void* dt, const void* Bm, const void* A, void* part_m,
                void* part_d, void* part_h, int B, int C, int L, int N, int S, int tps,
                long long dt_bstride, long long bm_bstride, int aligned, cudaStream_t stream) {
  const int N16 = N < 16 ? 16 : N;
  const size_t smem = sizeof(T) * kStages * (size_t)(8 * CT + 2 * N16) * kRow;
  int err = allow_smem(compress_kernel<T, CT>, smem);
  if (err != 0) return err;
  compress_kernel<T, CT><<<dim3(S, B), 32 * (N16 / 16), smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const T*>(Bm),
      static_cast<const float*>(A), static_cast<float*>(part_m), static_cast<float*>(part_d),
      static_cast<float*>(part_h), C, L, N, tps, dt_bstride, bm_bstride, aligned);
  return (int)cudaGetLastError();
}

template <typename T>
int compress(const void* x, const void* dt, const void* Bm, const void* A, void* part_m,
             void* part_d, void* part_h, int B, int C, int L, int N, int S, int tps,
             long long sdt, long long sbm, int aligned, cudaStream_t stream) {
  switch (channel_tiles(C)) {
    case 1: return compress_ct<T, 1>(x, dt, Bm, A, part_m, part_d, part_h, B, C, L, N, S, tps,
                                     sdt, sbm, aligned, stream);
    case 2: return compress_ct<T, 2>(x, dt, Bm, A, part_m, part_d, part_h, B, C, L, N, S, tps,
                                     sdt, sbm, aligned, stream);
    case 4: return compress_ct<T, 4>(x, dt, Bm, A, part_m, part_d, part_h, B, C, L, N, S, tps,
                                     sdt, sbm, aligned, stream);
    default: return compress_ct<T, 8>(x, dt, Bm, A, part_m, part_d, part_h, B, C, L, N, S, tps,
                                      sdt, sbm, aligned, stream);
  }
}

// The merge block's shared memory in floats (the MLP's only with MIX).
size_t merge_smem(int S, int N, int C, bool mix) {
  const size_t R = N < kMergeRows ? N : kMergeRows;
  size_t f = S * R + R + R * (C + 1);
  if (mix) f += R * (2 * C + 1) + (size_t)C * (2 * C + 1) + (size_t)C * (C + 1);
  return f * sizeof(float);
}

template <typename T, bool MIX>
int merge(const void* part_m, const void* part_d, const void* part_h, const void* w_hz,
          const void* w_out, const void* Dp, void* out, int B, int C, int N, int S,
          cudaStream_t stream) {
  const size_t smem = merge_smem(S, N, C, MIX);
  int err = allow_smem(merge_kernel<T, MIX>, smem);
  if (err != 0) return err;
  const int R = N < kMergeRows ? N : kMergeRows;
  merge_kernel<T, MIX><<<dim3(N / R, B), kMergeThreads, smem, stream>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_d),
      static_cast<const float*>(part_h), static_cast<const float*>(w_hz),
      static_cast<const float*>(w_out), static_cast<const float*>(Dp), static_cast<T*>(out), S,
      N, C, 8 * channel_tiles(C));
  return (int)cudaGetLastError();
}

template <typename T, int MT>
int scatter_mt(const void* h2, const void* Cm, void* y, int B, int C, int L, int N, int S,
               int tps, long long cm_bstride, int aligned, cudaStream_t stream) {
  const int N16 = N < 16 ? 16 : N;
  const size_t smem = sizeof(T) * (size_t)(kStages * N16 + 16 * MT) * kRow;
  int err = allow_smem(scatter_kernel<T, MT>, smem);
  if (err != 0) return err;
  scatter_kernel<T, MT><<<dim3(S, B), 32 * kScatterWarps, smem, stream>>>(
      static_cast<const T*>(h2), static_cast<const T*>(Cm), static_cast<T*>(y), C, L, N, tps,
      cm_bstride, aligned);
  return (int)cudaGetLastError();
}

template <typename T>
int scatter(const void* h2, const void* Cm, void* y, int B, int C, int L, int N, int S, int tps,
            long long cm_bstride, int aligned, cudaStream_t stream) {
  if (C <= 16) return scatter_mt<T, 1>(h2, Cm, y, B, C, L, N, S, tps, cm_bstride, aligned, stream);
  if (C <= 32) return scatter_mt<T, 2>(h2, Cm, y, B, C, L, N, S, tps, cm_bstride, aligned, stream);
  return scatter_mt<T, 4>(h2, Cm, y, B, C, L, N, S, tps, cm_bstride, aligned, stream);
}

template <typename T>
int run_compress(const void* x, const void* dt, const void* Bm, const void* A, void* part_m,
                 void* part_d, void* part_h, void* h, int B, int C, int L, int N, int S,
                 int tps, int aligned, long long sdt, long long sbm, cudaStream_t stream) {
  int err = compress<T>(x, dt, Bm, A, part_m, part_d, part_h, B, C, L, N, S, tps, sdt, sbm,
                        aligned, stream);
  if (err != 0) return err;
  return merge<T, false>(part_m, part_d, part_h, nullptr, nullptr, nullptr, h, B, C, N, S,
                         stream);
}

template <typename T>
int run_mix(const void* x, const void* dt, const void* Bm, const void* Cm, const void* A,
            const void* w_hz, const void* w_out, const void* Dp, void* part_m, void* part_d,
            void* part_h, void* y, void* h2, int B, int C, int L, int N, int S, int tps,
            int aligned, long long sdt, long long sbm, long long scm, cudaStream_t stream) {
  int err = compress<T>(x, dt, Bm, A, part_m, part_d, part_h, B, C, L, N, S, tps, sdt, sbm,
                        aligned, stream);
  if (err != 0) return err;
  err = merge<T, true>(part_m, part_d, part_h, w_hz, w_out, Dp, h2, B, C, N, S, stream);
  if (err != 0) return err;
  return scatter<T>(h2, Cm, y, B, C, L, N, S, tps, scm, aligned, stream);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16, 2 = fp16, of x, dt, B, C and the outputs; A,
// W_hz, W_out and D fp32. The compress (and scatter) pass splits the
// ceil(L / 64) tiles of each batch element into S slices of tps tiles (S =
// ceil(tiles / tps)); part_m, part_d (B, S, N) and part_h (B, S, N, CP) are
// its fp32 scratch, CP = C rounded up to 8, 16, 32 or 64. aligned: every
// tensor's base, batch stride and row of L tokens is a multiple of 16 bytes
// (the tiles move by 16-byte cp.async; else by plain loads). The batch
// strides are in elements. Returns cudaGetLastError() after the first launch
// that fails or after the last, or -1 for an argument the kernels do not take
// (C in [1, 64], N a power of two in [4, 64]).

// K2: h (B, N, C).
extern "C" int kmunet_hsmssd_compress(const void* x, const void* dt, const void* Bm,
                                      const void* A, void* part_m, void* part_d, void* part_h,
                                      void* h, int B, int C, int L, int N, int S, int tps,
                                      int aligned, long long dt_bstride, long long bm_bstride,
                                      int dtype, void* stream) {
  if (!valid(B, C, L, N, S, tps)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return run_compress<float>(x, dt, Bm, A, part_m, part_d, part_h, h, B, C, L, N, S,
                                       tps, aligned, dt_bstride, bm_bstride, s);
    case 1: return run_compress<__nv_bfloat16>(x, dt, Bm, A, part_m, part_d, part_h, h, B, C,
                                               L, N, S, tps, aligned, dt_bstride, bm_bstride, s);
    case 2: return run_compress<__half>(x, dt, Bm, A, part_m, part_d, part_h, h, B, C, L, N, S,
                                        tps, aligned, dt_bstride, bm_bstride, s);
    default: return -1;
  }
}

// K3: y (B, C, L) and h2 (B, N, C).
extern "C" int kmunet_hsmssd_mix(const void* x, const void* dt, const void* Bm, const void* Cm,
                                 const void* A, const void* w_hz, const void* w_out,
                                 const void* Dp, void* part_m, void* part_d, void* part_h,
                                 void* y, void* h2, int B, int C, int L, int N, int S, int tps,
                                 int aligned, long long dt_bstride, long long bm_bstride,
                                 long long cm_bstride, int dtype, void* stream) {
  if (!valid(B, C, L, N, S, tps)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return run_mix<float>(x, dt, Bm, Cm, A, w_hz, w_out, Dp, part_m, part_d, part_h, y,
                                  h2, B, C, L, N, S, tps, aligned, dt_bstride, bm_bstride,
                                  cm_bstride, s);
    case 1: return run_mix<__nv_bfloat16>(x, dt, Bm, Cm, A, w_hz, w_out, Dp, part_m, part_d,
                                          part_h, y, h2, B, C, L, N, S, tps, aligned,
                                          dt_bstride, bm_bstride, cm_bstride, s);
    case 2: return run_mix<__half>(x, dt, Bm, Cm, A, w_hz, w_out, Dp, part_m, part_d, part_h, y,
                                   h2, B, C, L, N, S, tps, aligned, dt_bstride, bm_bstride,
                                   cm_bstride, s);
    default: return -1;
  }
}
