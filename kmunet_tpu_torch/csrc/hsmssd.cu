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
// The wide path (C > 64 or N > 64: the EfficientViM classifier's mixers, C
// 128-512, N 9-64, L 16-196). The Pallas kernels take any N and C, and so do
// these; make_plan picks the layout of a call:
//   compress  the same kernel with CP = 64 channels a warp: a block holds
//             ngb groups of 16 states x ccb chunks of 64 channels, one warp
//             each, up to 16 warps (N = 49 pads to 64 rows: dt = A = B = 0
//             in the padded rows, which are never written), so that dt and B
//             are staged once per block for all its chunks; a ring of 4
//             stages, or 2 where 4 do not fit the block's shared memory,
//             then fewer chunks and state groups a block (grid z) where 2 do
//             not. At M4's first stage (C = 224, N = 64) a block is 16 warps,
//             4 stages, dt and B read once.
//   merge     as above, writing h in fp32 (B, N, C) for the MLP.
//   MLP       two products over all B N rows on the tensor cores
//             (mlp_kernel): hz = h W_hz^T, then h2 = gate(hz) W_out^T with
//             the gate applied as its operand is staged, in 64 x 64 tiles.
//             At C = 512, B = 128 staging W_hz and W_out (1.5 MB in bf16) in
//             each batch element's merge block would be 200 MB of L2 reads.
//   scatter   the same kernel with a warp per 16 channels (8 or 16 warps) and
//             grid z over groups of 256 channels; past 64 states a warp
//             reloads its A fragments per chunk of 64 states.
// So wide K3 is five device launches. What cannot fit a block's shared
// memory (the scatter's ring of N rows of C: N in the thousands) is refused
// (-2), never run elsewhere.
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
// K3's bounds at M4's three mixers (B = 128, bf16; chip_smoke.mixer_bound:
// bytes at 3.35 TB/s against the products at 989 TFLOP/s): 36.4 MB, 10.9 us
// at (C, L, N) = (224, 196, 64); 13.1 MB, 3.9 us at (320, 49, 32); 9.6 MB,
// 2.9 us against 3.29 GFLOP of products (the MLP's most of them), 3.3 us,
// at (512, 16, 16), where the products bound it. Measured there (NVIDIA
// H100 80GB HBM3, 700 W, chip_smoke's mixer_timing): 241, 192 and 148 us,
// the MLP's two products 104-116 us of it (mma.sync in 3xTF32 with split
// accumulators: three TF32 products per product, not the bf16 rate the
// bound assumes).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kT = 64;              // tokens per tile, compress and scatter
constexpr int kStages = 4;          // tiles in a block's ring (the wide path: 2 where 4 do not fit)
constexpr int kRow = kT + 8;        // a staged row in elements: 8 of padding against bank conflicts
constexpr int kNarrow = 64;         // the narrow path: C <= 64 and N <= 64
constexpr int kFragStates = 64;     // states whose scatter A fragments a warp holds at once
constexpr int kMergeThreads = 256;  // 16 states x 16 lanes
constexpr int kMergeRows = 16;      // states per merge block
constexpr int kScatterWarps = 4;    // the narrow scatter's warps
constexpr int kWideWarps = 16;      // the wide compress's and scatter's most warps a block
constexpr int kMlpTile = 64;        // the wide MLP's output tile (rows x columns) a block
constexpr int kMlpK = 32;           // and its k-chunk staged in shared memory
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

// The same with the fragments as 32-bit registers of TF32 values.
__device__ __forceinline__ void mma_tf32(float* d, const unsigned* a, const unsigned* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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

// cp.async.wait_group for a ring of STAGES tiles: this thread's copies of
// the tile STAGES - 1 behind the newest have landed.
template <int STAGES>
__device__ __forceinline__ void wait_ring() {
  cp_async_wait<STAGES - 2>();
}

// The compress pass: block (s, b, z) walks tiles [s * tps, min((s + 1) *
// tps, tiles)) of batch element b for ngb groups of 16 states from state
// 16 ngb (z % sgc) and ccb chunks of CP = 8 CT channels from channel CP ccb
// (z / sgc), one warp per (state group, channel chunk), and writes its
// partial max, denominator and unnormalised h at (b, s); part_h rows hold
// cpt channels. The narrow path is one block per (s, b) with every state
// (ngb = N16 / 16, ccb = 1, cpt = CP); the wide one takes CP = 64 and as
// many state groups and chunks as fit 16 warps and the ring, so that x, dt
// and B are each read once where they do. Dynamic shared memory: the ring,
// STAGES x (CP ccb + 2 x 16 ngb) rows of kRow elements.
template <typename T, int CT, int STAGES, int THREADS>
__global__ void __launch_bounds__(THREADS) compress_kernel(
    const T* __restrict__ x, const T* __restrict__ dt, const T* __restrict__ Bm,
    const float* __restrict__ A, float* __restrict__ part_m, float* __restrict__ part_d,
    float* __restrict__ part_h, int C, int L, int N, int tps, long long dt_bstride,
    long long bm_bstride, int aligned, int ngb, int ccb, int sgc, int cpt) {
  constexpr int CP = 8 * CT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int NR = 16 * ngb, XR = CP * ccb;
  const int stage = (XR + 2 * NR) * kRow;
  const int b = blockIdx.y, s = blockIdx.x, S = gridDim.x;
  const int sb = blockIdx.z % sgc, cb = blockIdx.z / sgc;
  const int ns = sb * NR, cs = cb * XR;  // the block's first state and channel
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = (warp % ngb) * 16, cc = warp / ngb;
  const int g = lane >> 2, q = lane & 3;
  const int tiles = (L + kT - 1) / kT;
  const int first = s * tps, last = min(tiles, first + tps);
  const int nrows = min(NR, N - ns), xrows = min(XR, C - cs);
  const T* xb = x + ((long long)b * C + cs) * L;
  const T* dtb = dt + b * dt_bstride + (long long)ns * L;
  const T* bmb = Bm + b * bm_bstride + (long long)ns * L;

  // Rows past C and N are never loaded: zeroed once, they hold x = 0, dt =
  // 0 and B = 0.
  {
    uint4* z = reinterpret_cast<uint4*>(ring);
    const int chunks = STAGES * stage * (int)sizeof(T) / 16;
    for (int i = tid; i < chunks; i += blockDim.x) z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  auto issue = [&](int tile) {
    T* st = ring + ((tile - first) % STAGES) * stage;
    const int l0 = tile * kT;
    if (xrows > 0) load_rows(st, xb, L, xrows, l0, L, aligned);
    load_rows(st + XR * kRow, dtb, L, nrows, l0, L, aligned);
    load_rows(st + (XR + NR) * kRow, bmb, L, nrows, l0, L, aligned);
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (first + i < last) issue(first + i);
    cp_async_commit();
  }

  const int na = ns + n0 + g;
  const float a[2] = {na < N ? A[na] : 0.f, na + 8 < N ? A[na + 8] : 0.f};
  float m[2] = {-INFINITY, -INFINITY}, d[2] = {0.f, 0.f};
  float acc[CT][4];
#pragma unroll
  for (int j = 0; j < CT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  for (int tile = first; tile < last; ++tile) {
    wait_ring<STAGES>();  // this thread's copies of `tile` have landed
    __syncthreads();      // everyone's have; the stage read last is free
    if (tile + STAGES - 1 < last) issue(tile + STAGES - 1);
    cp_async_commit();
    const T* st = ring + ((tile - first) % STAGES) * stage;
    const T* xs = st + cc * CP * kRow;
    const T* ds = st + XR * kRow;
    const T* bs = ds + NR * kRow;
    const int rem = L - tile * kT;
    if (rem >= kT)
      compress_tile<T, CT, false>(xs, ds, bs, n0, lane, a, m, d, acc, kT);
    else
      compress_tile<T, CT, true>(xs, ds, bs, n0, lane, a, m, d, acc, rem);
  }

  const long long part = (long long)b * S + s;
  const int c0 = cs + cc * CP;  // the warp's first channel
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    d[r] += __shfl_xor_sync(0xffffffffu, d[r], 1);
    d[r] += __shfl_xor_sync(0xffffffffu, d[r], 2);
    const int n = na + 8 * r;
    if (n < N) {
      if (q == 0 && cs == 0 && cc == 0) {
        part_m[part * N + n] = m[r];
        part_d[part * N + n] = d[r];
      }
      if (c0 < cpt) {
        float* ph = part_h + (part * N + n) * cpt + c0 + 2 * q;
#pragma unroll
        for (int j = 0; j < CT; ++j)
          *reinterpret_cast<float2*>(ph + 8 * j) =
              make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
      }
    }
  }
}

// The merge pass: block (r, b) merges the states [r R, r R + Rh) of batch
// element b (R = min(N, 16), Rh = min(R, N - r R)) over its S slices, in
// slice order. MIX = false writes h (B, N, C) in T (K2; the wide K3's
// merge writes it in fp32 for the MLP's products); MIX = true computes the
// gated MLP on those states and writes h2 (B, N, C) (the narrow K3). part_h
// rows hold CP channels. 256 threads: 16 lanes per state take every 16th
// slice for the max, the weights and the denominator, combined by shuffles
// in a fixed order (every lane shuffles; lanes past Rh hold -inf and 0);
// then a thread per (state, channel) walks the slices; the MLP reads W_hz^T
// and W_out^T staged in shared memory. Dynamic shared memory: merge_smem
// bytes.
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
  const int Rh = min(R, N - n0);
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
    const int r = tid >> 4, j = tid & 15;
    const bool live = r < Rh;
    float m = -INFINITY;
    if (live)
      for (int i = j; i < S; i += 16) m = fmaxf(m, pm[i * N + r]);
#pragma unroll
    for (int off = 8; off > 0; off /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float d = 0.f;
    if (live)
      for (int i = j; i < S; i += 16) {
        const float e = expf(pm[i * N + r] - m);
        wgt[i * R + r] = e;
        d = fmaf(pd[i * N + r], e, d);
      }
#pragma unroll
    for (int off = 8; off > 0; off /= 2) d += __shfl_xor_sync(0xffffffffu, d, off);
    if (live && j == 0) dsum[r] = d;
  }
  __syncthreads();
  // Lanes run over c, so that the partials' reads are contiguous.
  for (int p = tid; p < Rh * C; p += kMergeThreads) {
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
  for (int p = tid; p < Rh * C2; p += kMergeThreads) {
    const int r = p / C2, j = p % C2;
    const float* hr = hs + r * (C + 1);
    float acc = 0.f;
#pragma unroll 8
    for (int k = 0; k < C; ++k) acc = fmaf(hr[k], wt[k * (C2 + 1) + j], acc);
    hz[r * (C2 + 1) + j] = acc;
  }
  __syncthreads();
  const float D = Dp[0];
  for (int p = tid; p < Rh * C; p += kMergeThreads) {
    const int r = p / C, c = p % C;
    const float hv = hz[r * (C2 + 1) + c], z = hz[r * (C2 + 1) + C + c];
    hs[r * (C + 1) + c] = hv * (z / (1.f + expf(-z))) + hv * D;
  }
  __syncthreads();
  for (int p = tid; p < Rh * C; p += kMergeThreads) {
    const int r = p / C, c = p % C;
    const float* gr = hs + r * (C + 1);
    float h2 = 0.f;
#pragma unroll 8
    for (int k = 0; k < C; ++k) h2 = fmaf(gr[k], wo[k * (C + 1) + c], h2);
    out[((long long)b * N + n0 + r) * C + c] = from_f32<T>(h2);
  }
}

// The wide K3's gated MLP as two products over all B N rows on the tensor
// cores: out (M x O) = a (M x K) . W^T, W (O x K) as nn.Linear stores it,
// 3xTF32 (a_hi w_hi + a_lo w_hi + a_hi w_lo, the parts TF32-rounded) into
// fp32. GATE = false: a = src, rows of K (h . W_hz^T, O = 2K); GATE = true:
// a[m, k] = h_ silu(z) + h_ D with h_ = src[m, k], z = src[m, K + k], rows
// of 2K (the gated states . W_out^T, out in x's dtype). A block of 4 warps
// takes a 64 x 64 tile of out, each warp 32 x 32 (2 x 4 mma.m16n8k8), over
// k-chunks of 32: each thread loads its part of the next chunk (16-byte
// loads where K is a multiple of 4) into registers while the warps multiply
// the current one, which sits in shared memory already split into its TF32
// hi and lo parts, rows padded by 4 floats, so that one ldmatrix.x4 reads a
// whole A fragment (or two B fragments) of 32-bit values without bank
// conflicts. A chunk's hi . hi products and its two small terms go to
// zeroed fragments of their own, added to the running sums by fp32 adds:
// the tensor cores' accumulation truncates, and one chain over all of K
// (3 K / 8 mma) drifted several times further from float64 than the plain
// version's cuBLAS products at C = 224-600. With these the fp32 h2 lies
// 0.7-2.3x the plain version's distance from float64 at the classifier's
// shapes (chip_smoke's k3_float64_distance).
template <typename OutT, bool GATE>
__global__ void __launch_bounds__(128) mlp_kernel(const float* __restrict__ src,
                                                  const float* __restrict__ w,
                                                  const float* __restrict__ Dp,
                                                  OutT* __restrict__ out, int M, int O, int K) {
  constexpr int LD = kMlpK + 4;
  constexpr int kGroups = kMlpK / 4;                 // 4-element groups a staged row holds
  constexpr int kPer = kMlpTile * kGroups / 128;     // groups a thread stages per operand
  __shared__ __align__(16) float ah[kMlpTile][LD];
  __shared__ __align__(16) float al[kMlpTile][LD];
  __shared__ __align__(16) float wh[kMlpTile][LD];
  __shared__ __align__(16) float wl[kMlpTile][LD];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lm = lane >> 3, lr = lane & 7;  // the ldmatrix row this lane addresses
  const long long m0 = (long long)blockIdx.y * kMlpTile;
  const int o0 = blockIdx.x * kMlpTile;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
  const long long lda = GATE ? 2LL * K : (long long)K;
  const bool vec = (K & 3) == 0;
  const float D = GATE ? Dp[0] : 0.f;
  float4 ra[kPer], rz[kPer], rw[kPer];

  // Group i of a chunk: row i / kGroups, columns 4 (i % kGroups) .. + 3.
  auto fetch4 = [&](const float* base, long long row, int k, bool in_rows) -> float4 {
    if (!in_rows) return make_float4(0.f, 0.f, 0.f, 0.f);
    const float* p = base + row + k;
    if (vec && k + 3 < K) return *reinterpret_cast<const float4*>(p);
    return make_float4(k < K ? p[0] : 0.f, k + 1 < K ? p[1] : 0.f, k + 2 < K ? p[2] : 0.f,
                       k + 3 < K ? p[3] : 0.f);
  };
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = tid + 128 * j, r = i / kGroups, k = k0 + 4 * (i % kGroups);
      const long long m = m0 + r;
      ra[j] = fetch4(src, m * lda, k, m < M);
      if (GATE) rz[j] = fetch4(src + K, m * lda, k, m < M);
      rw[j] = fetch4(w, (long long)(o0 + r) * K, k, o0 + r < O);
    }
  };
  auto split4 = [](float4 v, float* hi, float* lo) {
    const float4 h = make_float4(tf32(v.x), tf32(v.y), tf32(v.z), tf32(v.w));
    *reinterpret_cast<float4*>(hi) = h;
    *reinterpret_cast<float4*>(lo) =
        make_float4(tf32(v.x - h.x), tf32(v.y - h.y), tf32(v.z - h.z), tf32(v.w - h.w));
  };
  auto gate = [D](float h, float z) { return h * (z / (1.f + expf(-z))) + h * D; };
  auto stage = [&]() {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = tid + 128 * j, r = i / kGroups, c = 4 * (i % kGroups);
      float4 a = ra[j];
      if (GATE)
        a = make_float4(gate(a.x, rz[j].x), gate(a.y, rz[j].y), gate(a.z, rz[j].z),
                        gate(a.w, rz[j].w));
      split4(a, &ah[r][c], &al[r][c]);
      split4(rw[j], &wh[r][c], &wl[r][c]);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  load(0);
  for (int k0 = 0; k0 < K; k0 += kMlpK) {
    stage();
    __syncthreads();
    if (k0 + kMlpK < K) load(k0 + kMlpK);  // in flight while this chunk multiplies
    float thi[2][4][4], tlo[2][4][4];  // the chunk's hi . hi products and its two small terms
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) thi[i][j][e] = tlo[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kMlpK; kk += 8) {
      unsigned fa[2][2][4], fb[2][2][4];  // [tile pair][hi, lo][register]
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4)
        const int r = wm + 16 * i + lr + 8 * (lm & 1), c = kk + 4 * (lm >> 1);
        ldsm_x4(fa[i][0], &ah[r][c]);
        ldsm_x4(fa[i][1], &al[r][c]);
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {  // b0, b1 of n-tile 2p, then of 2p + 1
        const int r = wn + 16 * p + lr + 8 * (lm >> 1), c = kk + 4 * (lm & 1);
        ldsm_x4(fb[p][0], &wh[r][c]);
        ldsm_x4(fb[p][1], &wl[r][c]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const unsigned* bh = &fb[j >> 1][0][2 * (j & 1)];
          const unsigned* bl = &fb[j >> 1][1][2 * (j & 1)];
          mma_tf32(thi[i][j], fa[i][0], bh);
          mma_tf32(tlo[i][j], fa[i][1], bh);
          mma_tf32(tlo[i][j], fa[i][0], bl);
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += thi[i][j][e] + tlo[i][j][e];
    __syncthreads();
  }
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // c0 (g, 2q), c1 (g, 2q + 1), c2 (g + 8, 2q), c3 (g + 8, ..)
        const long long m = m0 + wm + 16 * i + g + 8 * (e >> 1);
        const int o = o0 + wn + 8 * j + 2 * q + (e & 1);
        if (m < M && o < O) out[m * O + o] = from_f32<OutT>(acc[i][j][e]);
      }
}

// The scatter's A operand, h2^T (channels c0..c0+15 x up to kFragStates
// states), and its products with a staged C tile (rows x kT, rows a
// multiple of 16 and at most kFragStates): acc[h] (16 channels x 8 tokens
// t0 + 8h..) += h2^T . C[:, t0 + 8h..].
template <typename T>
struct ScatterProducts {
  unsigned a[kFragStates / 16][4];  // per 16 states: the m16n8k16 A fragment

  __device__ __forceinline__ void load(const T* h2b, int C, int N, int c0, int lane) {
    const uint16_t* h = reinterpret_cast<const uint16_t*>(h2b);
    const int g = lane >> 2, q = lane & 3;
    auto at = [&](int n, int c) -> unsigned { return n < N && c < C ? h[n * C + c] : 0u; };
#pragma unroll
    for (int ks = 0; ks < kFragStates / 16; ++ks)
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
    for (int ks = 0; ks < kFragStates / 16; ++ks) {
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
  float hi[kFragStates / 8][4], lo[kFragStates / 8][4];

  __device__ __forceinline__ void load(const float* h2b, int C, int N, int c0, int lane) {
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int ks = 0; ks < kFragStates / 8; ++ks)
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
    for (int ks = 0; ks < kFragStates / 8; ++ks) {
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

// The scatter pass of K3: block (s, b, z) walks the compress's tiles of
// slice s and writes y[b, c, tile] = h2[b]^T C[b, :, tile] for the 16 MT
// channels from 16 MT z. MT 16-channel rows of h2^T over WARPS warps:
// where MT < WARPS, WARPS / MT warps share a row and take every (WARPS /
// MT)-th pair of 8-token columns (the narrow path: 4 warps, MT 1, 2 or 4);
// the wide one has a warp per row (MT = WARPS = 8 or 16). A warp holds its
// row's A fragments for up to kFragStates states: with more, it reloads
// them per chunk of states. Dynamic shared memory: STAGES x N16 rows of C
// and 16 MT rows of y, kRow elements each (N16: N rounded up to 16).
template <typename T, int MT, int WARPS, int STAGES>
__global__ void __launch_bounds__(32 * WARPS) scatter_kernel(
    const T* __restrict__ h2, const T* __restrict__ Cm, T* __restrict__ y, int C, int L, int N,
    int tps, long long cm_bstride, int aligned) {
  static_assert(MT <= WARPS && WARPS % MT == 0, "a warp takes one 16-channel row");
  constexpr int TG = WARPS / MT;  // warps that share a channel row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int N16 = (N + 15) / 16 * 16;
  const int stage = N16 * kRow;
  T* ys = ring + STAGES * stage;
  const int b = blockIdx.y, s = blockIdx.x, cz = blockIdx.z * 16 * MT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mt = warp % MT, tg = warp / MT;
  const int g = lane >> 2, q = lane & 3;
  const int tiles = (L + kT - 1) / kT;
  const int first = s * tps, last = min(tiles, first + tps);
  const int chunks = (N16 + kFragStates - 1) / kFragStates;
  const T* cb = Cm + b * cm_bstride;
  const T* h2b = h2 + (long long)b * N * C;
  T* yb = y + ((long long)b * C + cz) * L;

  {  // rows past N are never loaded: zeroed once
    uint4* z = reinterpret_cast<uint4*>(ring);
    const int n16 = STAGES * stage * (int)sizeof(T) / 16;
    for (int i = tid; i < n16; i += blockDim.x) z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  auto issue = [&](int tile) {
    load_rows(ring + ((tile - first) % STAGES) * stage, cb, L, N, tile * kT, L, aligned);
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (first + i < last) issue(first + i);
    cp_async_commit();
  }
  ScatterProducts<T> prod;
  if (chunks == 1) prod.load(h2b, C, N, cz + 16 * mt, lane);

  for (int tile = first; tile < last; ++tile) {
    wait_ring<STAGES>();
    __syncthreads();  // C's tile has landed; the y tile and the stage read last are free
    if (tile + STAGES - 1 < last) issue(tile + STAGES - 1);
    cp_async_commit();
    const T* cs = ring + ((tile - first) % STAGES) * stage;
    const int rem = L - tile * kT;
    for (int p = tg; p < kT / 16; p += TG) {
      if (16 * p >= rem) break;
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      if (chunks == 1) {
        prod.run(acc, cs, N16, 16 * p, lane);
      } else {
        for (int k = 0; k < chunks; ++k) {
          const int n0 = k * kFragStates;
          prod.load(h2b + (long long)n0 * C, C, N - n0, cz + 16 * mt, lane);
          prod.run(acc, cs + n0 * kRow, min(kFragStates, N16 - n0), 16 * p, lane);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          store2(ys + (16 * mt + g + 8 * r) * kRow + 16 * p + 8 * h + 2 * q, acc[h][2 * r],
                 acc[h][2 * r + 1]);
    }
    __syncthreads();
    store_rows(yb, ys, L, min(16 * MT, C - cz), tile * kT, L, aligned);
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

// 8-channel blocks of the narrow compress (1, 2, 4 or 8): C padded to CP = 8 CT.
int channel_tiles(int C) {
  int ct = 1;
  while (8 * ct < C) ct *= 2;
  return ct;
}

// How a call is laid out, from (C, N), the element size and the block's
// shared-memory limit. The narrow path (C <= 64 and N <= 64) is PR 13's
// design: one compress block per (slice, b), the MLP in the merge. The wide
// path splits the compress's warps over 16-state groups and 64-channel
// chunks, runs the MLP as two tiled products and the scatter over groups of
// up to 256 channels. ok = false where a pass's shared memory cannot fit.
struct Plan {
  bool ok, wide;
  int ct, cstages, ngb, ccb, sgc, cgc, cpt;  // compress
  size_t csmem;
  int mt, sstages, sgroups;  // scatter
  size_t ssmem;
};

size_t compress_smem(int esz, int ct, int stages, int ngb, int ccb) {
  return (size_t)esz * stages * (size_t)(8 * ct * ccb + 32 * ngb) * kRow;
}

size_t scatter_smem(int esz, int stages, int N16, int mt) {
  return (size_t)esz * (size_t)(stages * N16 + 16 * mt) * kRow;
}

size_t smem_limit() {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return 48 * 1024;
  return (size_t)limit;
}

Plan make_plan(int C, int N, int esz, size_t limit) {
  Plan p{};
  const int N16 = (N + 15) / 16 * 16, NG = N16 / 16;
  p.wide = C > kNarrow || N > kNarrow;
  if (!p.wide) {
    p.ct = channel_tiles(C);
    p.cstages = kStages;
    p.ngb = NG;
    p.ccb = p.sgc = p.cgc = 1;
    p.cpt = 8 * p.ct;
    p.csmem = compress_smem(esz, p.ct, kStages, NG, 1);
    p.mt = C <= 16 ? 1 : C <= 32 ? 2 : 4;
    p.sstages = kStages;
    p.sgroups = 1;
    p.ssmem = scatter_smem(esz, kStages, N16, p.mt);
    p.ok = p.csmem <= limit && p.ssmem <= limit;
    return p;
  }
  // Compress: every state group and chunk in one block where 16 warps and
  // two ring stages take them, fewer chunks (x read once, dt and B once per
  // block of chunks) and then fewer state groups where they do not.
  const int CC = (C + 63) / 64;
  p.ct = 8;
  p.cpt = 64 * CC;
  p.ngb = NG < kWideWarps ? NG : kWideWarps;
  p.ccb = CC < kWideWarps / p.ngb ? CC : kWideWarps / p.ngb;
  while (p.ccb > 1 && compress_smem(esz, 8, 2, p.ngb, p.ccb) > limit) --p.ccb;
  while (p.ngb > 1 && compress_smem(esz, 8, 2, p.ngb, p.ccb) > limit) --p.ngb;
  p.cstages = compress_smem(esz, 8, kStages, p.ngb, p.ccb) <= limit ? kStages : 2;
  p.csmem = compress_smem(esz, 8, p.cstages, p.ngb, p.ccb);
  p.sgc = (NG + p.ngb - 1) / p.ngb;
  p.cgc = (CC + p.ccb - 1) / p.ccb;
  // Scatter: a warp per 16 channels, 8 or 16 warps a block.
  p.mt = C <= 128 ? 8 : 16;
  p.sgroups = (C + 16 * p.mt - 1) / (16 * p.mt);
  p.sstages = scatter_smem(esz, kStages, N16, p.mt) <= limit ? kStages : 2;
  p.ssmem = scatter_smem(esz, p.sstages, N16, p.mt);
  p.ok = p.csmem <= limit && p.ssmem <= limit && (long long)p.sgc * p.cgc <= 65535;
  return p;
}

bool valid(int B, int C, int L, int N, int S, int tps) {
  if (B < 1 || B > 65535 || C < 1 || L < 1 || N < 1 || S < 1 || tps < 1 || S > 65535)
    return false;
  const int tiles = (L + kT - 1) / kT;
  return (long long)S * tps >= tiles && (long long)(S - 1) * tps < tiles;
}

template <typename T, int CT, int STAGES, int THREADS>
int compress_launch(const void* x, const void* dt, const void* Bm, const void* A,
                    void* part_m, void* part_d, void* part_h, int B, int C, int L, int N, int S,
                    int tps, long long sdt, long long sbm, int aligned, const Plan& p,
                    cudaStream_t stream) {
  auto kernel = compress_kernel<T, CT, STAGES, THREADS>;
  int err = allow_smem(kernel, p.csmem);
  if (err != 0) return err;
  kernel<<<dim3(S, B, p.sgc * p.cgc), 32 * p.ngb * p.ccb, p.csmem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const T*>(Bm),
      static_cast<const float*>(A), static_cast<float*>(part_m), static_cast<float*>(part_d),
      static_cast<float*>(part_h), C, L, N, tps, sdt, sbm, aligned, p.ngb, p.ccb, p.sgc, p.cpt);
  return (int)cudaGetLastError();
}

template <typename T>
int compress(const void* x, const void* dt, const void* Bm, const void* A, void* part_m,
             void* part_d, void* part_h, int B, int C, int L, int N, int S, int tps,
             long long sdt, long long sbm, int aligned, const Plan& p, cudaStream_t stream) {
#define KMUNET_COMPRESS(CT, STAGES, THREADS)                                                  \
  compress_launch<T, CT, STAGES, THREADS>(x, dt, Bm, A, part_m, part_d, part_h, B, C, L, N, S, \
                                          tps, sdt, sbm, aligned, p, stream)
  if (p.wide) return p.cstages == kStages ? KMUNET_COMPRESS(8, kStages, 32 * kWideWarps)
                                          : KMUNET_COMPRESS(8, 2, 32 * kWideWarps);
  switch (p.ct) {
    case 1: return KMUNET_COMPRESS(1, kStages, 128);
    case 2: return KMUNET_COMPRESS(2, kStages, 128);
    case 4: return KMUNET_COMPRESS(4, kStages, 128);
    default: return KMUNET_COMPRESS(8, kStages, 128);
  }
#undef KMUNET_COMPRESS
}

// The merge block's shared memory in floats (the MLP's only with MIX).
size_t merge_smem(int S, int N, int C, bool mix) {
  const size_t R = N < kMergeRows ? N : kMergeRows;
  size_t f = S * R + R;
  if (mix)
    f += R * (C + 1) + R * (2 * C + 1) + (size_t)C * (2 * C + 1) + (size_t)C * (C + 1);
  return f * sizeof(float);
}

template <typename T, bool MIX>
int merge(const void* part_m, const void* part_d, const void* part_h, const void* w_hz,
          const void* w_out, const void* Dp, void* out, int B, int C, int N, int S, int cpt,
          cudaStream_t stream) {
  const size_t smem = merge_smem(S, N, C, MIX);
  int err = allow_smem(merge_kernel<T, MIX>, smem);
  if (err != 0) return err;
  const int R = N < kMergeRows ? N : kMergeRows;
  merge_kernel<T, MIX><<<dim3((N + R - 1) / R, B), kMergeThreads, smem, stream>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_d),
      static_cast<const float*>(part_h), static_cast<const float*>(w_hz),
      static_cast<const float*>(w_out), static_cast<const float*>(Dp), static_cast<T*>(out), S,
      N, C, cpt);
  return (int)cudaGetLastError();
}

template <typename OutT, bool GATE>
int mlp(const void* src, const void* w, const void* Dp, void* out, long long M, int O, int K,
        cudaStream_t stream) {
  mlp_kernel<OutT, GATE><<<dim3((O + kMlpTile - 1) / kMlpTile,
                                (unsigned)((M + kMlpTile - 1) / kMlpTile)),
                           128, 0, stream>>>(static_cast<const float*>(src),
                                             static_cast<const float*>(w),
                                             static_cast<const float*>(Dp),
                                             static_cast<OutT*>(out), (int)M, O, K);
  return (int)cudaGetLastError();
}

template <typename T, int MT, int WARPS, int STAGES>
int scatter_launch(const void* h2, const void* Cm, void* y, int B, int C, int L, int N, int S,
                   int tps, long long cm_bstride, int aligned, const Plan& p,
                   cudaStream_t stream) {
  auto kernel = scatter_kernel<T, MT, WARPS, STAGES>;
  int err = allow_smem(kernel, p.ssmem);
  if (err != 0) return err;
  kernel<<<dim3(S, B, p.sgroups), 32 * WARPS, p.ssmem, stream>>>(
      static_cast<const T*>(h2), static_cast<const T*>(Cm), static_cast<T*>(y), C, L, N, tps,
      cm_bstride, aligned);
  return (int)cudaGetLastError();
}

template <typename T>
int scatter(const void* h2, const void* Cm, void* y, int B, int C, int L, int N, int S, int tps,
            long long scm, int aligned, const Plan& p, cudaStream_t stream) {
#define KMUNET_SCATTER(MT, WARPS, STAGES) \
  scatter_launch<T, MT, WARPS, STAGES>(h2, Cm, y, B, C, L, N, S, tps, scm, aligned, p, stream)
  if (p.wide) {
    if (p.mt == 8)
      return p.sstages == kStages ? KMUNET_SCATTER(8, 8, kStages) : KMUNET_SCATTER(8, 8, 2);
    return p.sstages == kStages ? KMUNET_SCATTER(16, 16, kStages) : KMUNET_SCATTER(16, 16, 2);
  }
  switch (p.mt) {
    case 1: return KMUNET_SCATTER(1, kScatterWarps, kStages);
    case 2: return KMUNET_SCATTER(2, kScatterWarps, kStages);
    default: return KMUNET_SCATTER(4, kScatterWarps, kStages);
  }
#undef KMUNET_SCATTER
}

template <typename T>
int run_compress(const void* x, const void* dt, const void* Bm, const void* A, void* part_m,
                 void* part_d, void* part_h, void* h, int B, int C, int L, int N, int S,
                 int tps, int aligned, long long sdt, long long sbm, const Plan& p,
                 cudaStream_t stream) {
  int err = compress<T>(x, dt, Bm, A, part_m, part_d, part_h, B, C, L, N, S, tps, sdt, sbm,
                        aligned, p, stream);
  if (err != 0) return err;
  return merge<T, false>(part_m, part_d, part_h, nullptr, nullptr, nullptr, h, B, C, N, S,
                         p.cpt, stream);
}

template <typename T>
int run_mix(const void* x, const void* dt, const void* Bm, const void* Cm, const void* A,
            const void* w_hz, const void* w_out, const void* Dp, void* part_m, void* part_d,
            void* part_h, void* h32, void* hz32, void* y, void* h2, int B, int C, int L, int N,
            int S, int tps, int aligned, long long sdt, long long sbm, long long scm,
            const Plan& p, cudaStream_t stream) {
  int err = compress<T>(x, dt, Bm, A, part_m, part_d, part_h, B, C, L, N, S, tps, sdt, sbm,
                        aligned, p, stream);
  if (err != 0) return err;
  if (p.wide) {
    const long long M = (long long)B * N;
    err = merge<float, false>(part_m, part_d, part_h, nullptr, nullptr, nullptr, h32, B, C, N,
                              S, p.cpt, stream);
    if (err == 0) err = mlp<float, false>(h32, w_hz, nullptr, hz32, M, 2 * C, C, stream);
    if (err == 0) err = mlp<T, true>(hz32, w_out, Dp, h2, M, C, C, stream);
  } else {
    err = merge<T, true>(part_m, part_d, part_h, w_hz, w_out, Dp, h2, B, C, N, S, p.cpt,
                         stream);
  }
  if (err != 0) return err;
  return scatter<T>(h2, Cm, y, B, C, L, N, S, tps, scm, aligned, p, stream);
}

int element_size(int dtype) { return dtype == 0 ? 4 : 2; }

}  // namespace

// dtype: 0 = fp32, 1 = bf16, 2 = fp16, of x, dt, B, C and the outputs; A,
// W_hz, W_out and D fp32. The compress (and scatter) pass splits the
// ceil(L / 64) tiles of each batch element into S slices of tps tiles (S =
// ceil(tiles / tps)); part_m, part_d (B, S, N) and part_h (B, S, N, cpt) are
// its fp32 scratch, cpt from kmunet_hsmssd_plan; the wide K3 also takes h32
// (B, N, C) and hz32 (B, N, 2C) fp32 (null on the narrow path). aligned:
// every tensor's base, batch stride and row of L tokens is a multiple of 16
// bytes (the tiles move by 16-byte cp.async; else by plain loads). The batch
// strides are in elements. Returns cudaGetLastError() after the first launch
// that fails or after the last, -1 for an argument the kernels do not take
// and -2 where a pass's shared memory exceeds the device's block limit.

// The layout of a call at (C, N, dtype) on the current device: cpt, the
// channels of a part_h row, and wide (1: the wide path, which needs h32 and
// hz32). Returns 0, or -2 if the call cannot fit (N in the thousands; no
// model of the repo comes near), -1 for a bad argument.
extern "C" int kmunet_hsmssd_plan(int C, int N, int dtype, int* cpt, int* wide) {
  if (C < 1 || N < 1 || dtype < 0 || dtype > 2) return -1;
  const Plan p = make_plan(C, N, element_size(dtype), smem_limit());
  *cpt = p.cpt;
  *wide = p.wide ? 1 : 0;
  return p.ok ? 0 : -2;
}

// K2: h (B, N, C).
extern "C" int kmunet_hsmssd_compress(const void* x, const void* dt, const void* Bm,
                                      const void* A, void* part_m, void* part_d, void* part_h,
                                      void* h, int B, int C, int L, int N, int S, int tps,
                                      int aligned, long long dt_bstride, long long bm_bstride,
                                      int dtype, void* stream) {
  if (!valid(B, C, L, N, S, tps) || dtype < 0 || dtype > 2) return -1;
  const Plan p = make_plan(C, N, element_size(dtype), smem_limit());
  if (!p.ok) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return run_compress<float>(x, dt, Bm, A, part_m, part_d, part_h, h, B, C, L, N, S,
                                       tps, aligned, dt_bstride, bm_bstride, p, s);
    case 1: return run_compress<__nv_bfloat16>(x, dt, Bm, A, part_m, part_d, part_h, h, B, C,
                                               L, N, S, tps, aligned, dt_bstride, bm_bstride, p,
                                               s);
    default: return run_compress<__half>(x, dt, Bm, A, part_m, part_d, part_h, h, B, C, L, N,
                                         S, tps, aligned, dt_bstride, bm_bstride, p, s);
  }
}

// K3: y (B, C, L) and h2 (B, N, C).
extern "C" int kmunet_hsmssd_mix(const void* x, const void* dt, const void* Bm, const void* Cm,
                                 const void* A, const void* w_hz, const void* w_out,
                                 const void* Dp, void* part_m, void* part_d, void* part_h,
                                 void* h32, void* hz32, void* y, void* h2, int B, int C, int L,
                                 int N, int S, int tps, int aligned, long long dt_bstride,
                                 long long bm_bstride, long long cm_bstride, int dtype,
                                 void* stream) {
  if (!valid(B, C, L, N, S, tps) || dtype < 0 || dtype > 2) return -1;
  const Plan p = make_plan(C, N, element_size(dtype), smem_limit());
  if (!p.ok) return -2;
  if (p.wide && (h32 == nullptr || hz32 == nullptr)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return run_mix<float>(x, dt, Bm, Cm, A, w_hz, w_out, Dp, part_m, part_d, part_h,
                                  h32, hz32, y, h2, B, C, L, N, S, tps, aligned, dt_bstride,
                                  bm_bstride, cm_bstride, p, s);
    case 1: return run_mix<__nv_bfloat16>(x, dt, Bm, Cm, A, w_hz, w_out, Dp, part_m, part_d,
                                          part_h, h32, hz32, y, h2, B, C, L, N, S, tps, aligned,
                                          dt_bstride, bm_bstride, cm_bstride, p, s);
    default: return run_mix<__half>(x, dt, Bm, Cm, A, w_hz, w_out, Dp, part_m, part_d, part_h,
                                    h32, hz32, y, h2, B, C, L, N, S, tps, aligned, dt_bstride,
                                    bm_bstride, cm_bstride, p, s);
  }
}
