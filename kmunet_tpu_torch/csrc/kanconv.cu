// K1: the fused KAN convolution, stride 1, 3x3, over a pre-padded input.
//
//   out[b,f,i,j] = sum_{c,kh,kw} silu(xp[b,c,i+kh,j+kw]) * base[f,c,kh,kw]
//                + sum_{c,kh,kw,q} B_q(xp[b,c,i+kh,j+kw]) * spline[f,c*8+q,kh,kw]
//
// B_q is basis q of the cubic B-spline on the uniform grid of 5 intervals
// over [-1, 1] (8 bases, each a shift of the cardinal spline M4 on [0, 4)):
// B_q(x) = M4(u - q), u = (x + 1) / 0.4 + 3. xp (B, C, H+2, W+2) NCHW, zero
// padded by the caller (a padded pixel adds silu(0) = 0 to the base branch
// but B_q(0) != 0 to the spline branch, so the padding must be zeros of x);
// xp and out (B, F, H, W) in one dtype (fp32, bf16 or fp16). The weights
// come from the wrapper (kernels/kanconv.py) as bf16 pairs in the order the
// kernel reads them (below); every basis and every sum is fp32.
//
// Replaces the TPU kernel kmunet_tpu/kernels/kanconv_pallas.py::fused_kanconv
// (the pl.pallas_call in _forward, :151). Its gradient is the autodiff of the
// plain version (kernels/kanconv.py), as the TPU kernel's custom VJP is the
// autodiff of kanconv_reference.
//
// Design: an implicit GEMM on the tensor cores. M is the output pixels, N
// the output channels F (padded to a multiple of 8 with zero weights), K the
// 9 taps x C channels x 9 terms (silu(x) and the 8 bases), each term split in
// two bf16 parts: hi = bf16(v), lo = bf16(v - hi) (the rest at most 2^-17
// |v|). One rounding of the basis to bf16 (2^-9 |v|) summed over C x 9 taps
// x 4 nonzero bases lands 20-200x outside the check's 1e-5 of the largest
// output; tests/test_torch_k1_tiles.py models both. So every dtype, fp32
// included, is computed to about 16 significant bits per product (silu by
// __expf and __fdividef, the weights of fp32 and fp16 models split the same
// way, a_lo w_lo dropped), summed in fp32: fp32 results lie 3-12x farther
// from float64 than the plain fp32 version's (PERF.md), at 0.4-0.6 of the
// fp32 check's tolerance in the model up to C = 128.
//   Blocks of 8 warps are persistent: each walks work items (batch element,
// 16 x 16 output pixels, FB output channels), FB = 16 (two blocks per SM),
// or 32 for bf16 weights with F > 16 (one). Per chunk of 8 input channels it
// evaluates the terms once per value of the item's 18 x 18 halo: u by one
// fma, the 4 bases that may be nonzero from the fraction of u by the uniform
// cubic B-spline's pieces (the plain version's values within rounding), the
// other 4 zero, and stores them in shared memory as 32-byte rows per (term,
// halo position): the 8 channels' hi parts, then their lo parts, the two
// 16-byte halves swapped where bit 2 of the column is set, so that the 8
// rows an ldmatrix reads (8 neighbouring columns) fall in distinct banks. The
// bases' rows are zeroed first (16-byte stores) and each value written once
// where it is nonzero; a thread stages 2 (FB = 32: 4) channels of a
// position, so that the silu terms go out in pairs and no two lanes of a
// store share a 32-bit word. A row is one k = 16 slice of A: its k 0-7 the
// hi parts and k 8-15 the lo parts of the same 8 channels, so that one
// mma.m16n8k16 against the weight rows duplicated (k 0-7 and 8-15 both w_hi:
// the B fragment's two registers are one) adds a_hi w_hi + a_lo w_hi. Where
// the weights are not exact in bf16 (fp32 and fp16 models) an mma.m16n8k8 on
// the hi half adds a_hi w_lo too, so one loop serves every dtype. The taps
// read shifted rows: tap (kh, kw) of output row o is the A fragment of halo
// row o + kh at column offset kw (ldmatrix takes one address per row, so the
// shift costs nothing), and a warp that owns R output rows (2; FB = 32: 4 of
// 16 channels) loads each halo row's fragment once per (term, kw) for the up
// to 3 output rows that use it: (R + 2) / (3R) of the loads. The weights of
// a chunk (81 rows x FB / 8 x 128 bytes, twice with lo parts) are staged by
// cp.async in fragment order, one 32-bit load per (row, n8) per lane.
//   Each term's products go to zeroed fragments (a chain of at most 18 mma)
// and are added to the fp32 sums once per term, so that no long chain of
// tensor-core accumulations carries its rounding. While a chunk's products
// run, the next chunk's halo values (or the next item's first) are already
// loaded into registers and stay unconverted until the staging uses them:
// the rows of xp are W + 2 elements, so their segments are not 16-byte
// aligned for cp.async. Each block owns its outputs: no atomics, and two
// calls give the same bits.
//
// Bound. At KM_UNetV3-SH's enc1 (B = 128, 16 -> 16 channels at 128^2, bf16)
// xp is 69.2 MB and the output 67.1 MB: 136 MB, 40.7 us at 3.35 TB/s. The
// nonzero contraction is (4 + 1) MACs per (pixel, f, c, tap) inside [-1, 1]:
// 48.3 GFLOP, 48.9 us on the tensor cores (the dense one, (8 + 1) MACs, 87.0
// GFLOP, 88 us). So operations bound it. This kernel does the dense count
// twice over (hi and lo): 174 GFLOP, 176 us at the tensor cores' 989
// TFLOP/s. Measured on an H100 (PERF.md), the staging alone takes about half
// the time and the products alone about two thirds: the basis (about 60
// instructions per halo value, 1.27 halo values per pixel) and the shared
// memory the products read (each 512-byte A fragment feeds 2 mma at F = 16,
// plus the weights) set the pace, not the tensor cores; the halo rows' reuse
// over kh, the larger tile and two blocks per SM are what the design does
// about it. A wgmma version (A from registers, the staged weights as B, the
// k 8-15 half of B repeating k 0-7 by a zero leading-byte offset) computed the
// same sums no faster at F = 16.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kTH = 16;                  // output rows per block
constexpr int kTW = 16;                  // output columns per block: one A fragment's 16 rows
constexpr int kHW = kTW + 2;             // halo width
constexpr int kHalo = (kTH + 2) * kHW;   // halo positions
constexpr int kCC = 8;                   // input channels per chunk
constexpr int kTaps = 9;
constexpr int kBases = 8;
constexpr int kTerms = 1 + kBases;       // silu, then the 8 bases
constexpr int kWRows = kTaps * kTerms;   // weight rows per chunk: tap * kTerms + term
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// A thread stages CH channels of a halo position at a time (CH = 2 or 4):
// the items and rounds per chunk.
template <int CH> constexpr int kItems = kHalo * kCC / CH;
template <int CH> constexpr int kRounds = (kItems<CH> + kThreads - 1) / kThreads;
constexpr int kTermBytes = kHalo * 32;   // a term's rows: 8 hi + 8 lo bf16 per position
constexpr int kABytes = kTerms * kTermBytes;
constexpr float kLo = -1.f;
constexpr float kKnot = 0.4f;            // (1 - (-1)) / 5
constexpr float kSixth = 1.f / 6.f;
constexpr int kMaxDevices = 64;          // devices whose launch geometry is kept

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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a . [b; b]: m16n8k16, bf16 operands, fp32 d, the B fragment's two
// registers one (k 8-15 repeat the weights of k 0-7).
__device__ __forceinline__ void mma_k16(float* d, const uint32_t (&a)[4], uint32_t b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b), "r"(b));
}
// d += a[k 0-7] . b: m16n8k8 on the fragment's hi half.
__device__ __forceinline__ void mma_k8(float* d, const uint32_t (&a)[4], uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// silu(x) into s and the 4 bases that may be nonzero at x, B_{j-3} .. B_j
// for j = floor(u), u = (x + 1) / 0.4 + 3 (as one fma), into p: the uniform
// cubic B-spline's pieces at the fraction f = u - j, the plain version's
// pieces of M4 written in f (the same values within rounding; M4 is
// continuous, so an x on a knot whose u lands an ulp below the integer
// gives the same terms within rounding). Returns j, or -1 where u is outside
// [0, 11) (or NaN), where none of the 8 bases is nonzero.
__device__ __forceinline__ int terms_at(float x, float& s, float (&p)[4]) {
  s = __fdividef(x, 1.f + __expf(-x));
  const float u = fmaf(x, 1.f / kKnot, 3.f - kLo / kKnot);
  if (!(u >= 0.f && u < 11.f)) return -1;
  const float fl = floorf(u), f = u - fl, g = 1.f - f, f2 = f * f, f3 = f2 * f;
  p[0] = g * g * g * kSixth;
  p[1] = fmaf(3.f, f3, fmaf(-6.f, f2, 4.f)) * kSixth;
  p[2] = fmaf(-3.f, f3, fmaf(3.f, f2, fmaf(3.f, f, 1.f))) * kSixth;
  p[3] = f3 * kSixth;
  return (int)fl;
}

// v split into bf16 hi = bf16(v) and lo = bf16(v - hi), stored at a + hi and
// a + lo.
__device__ __forceinline__ void store_split(unsigned char* a, int hi, int lo, float v) {
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  *reinterpret_cast<__nv_bfloat16*>(a + hi) = h;
  *reinterpret_cast<__nv_bfloat16*>(a + lo) = __float2bfloat16_rn(v - __bfloat162float(h));
}

// One channel's nonzero bases p of interval j (terms_at) into the rows of
// terms 1 + (j - 3) .. 1 + j that are among the 8, at hi and lo of term 0's.
__device__ __forceinline__ void store_bases(unsigned char* a, int hi, int lo, int j,
                                            const float (&p)[4]) {
  if (j < 0) return;
  const int o = (j - 2) * kTermBytes;  // the rows of term 1 + (j - 3)
  if (j >= 3) store_split(a, hi + o, lo + o, p[0]);
  if (j >= 2 && j <= 9) store_split(a, hi + o + kTermBytes, lo + o + kTermBytes, p[1]);
  if (j >= 1 && j <= 8) store_split(a, hi + o + 2 * kTermBytes, lo + o + 2 * kTermBytes, p[2]);
  if (j <= 7) store_split(a, hi + o + 3 * kTermBytes, lo + o + 3 * kTermBytes, p[3]);
}

// The halo values of channels c0 .. c0+7 of batch element b at the
// thread's staging items (below) for the tile at (i0, j0), 0 outside xp and
// past C, as they are in memory: they are converted where they are used, so
// that the loads stay in flight until then.
template <int CH, typename T>
__device__ __forceinline__ void load_x(T (&xv)[kRounds<CH>][CH], const T* __restrict__ xp,
                                       const int (&items)[kRounds<CH>], int b, int i0, int j0,
                                       int c0, int C, int Hp, int Wp) {
  const long long plane = (long long)Hp * Wp;
  const T* xb = xp + (long long)b * C * plane;
#pragma unroll
  for (int r = 0; r < kRounds<CH>; ++r) {
    const int gi = i0 + (items[r] >> 26), gj = j0 + ((items[r] >> 20) & 63);
#pragma unroll
    for (int e = 0; e < CH; ++e) {
      const int c = c0 + ((items[r] >> 1) & 7) + e;
      xv[r][e] = from_f32<T>(0.f);
      if (items[r] >= 0 && c < C && gi < Hp && gj < Wp) xv[r][e] = xb[c * plane + gi * Wp + gj];
    }
  }
}

// R output rows of 16 columns and NW output channels per warp; P weight
// parts (1: w_hi, 2: w_hi and w_lo); CH channels per staging item. The 8
// warps are kTH / R row groups by NG channel groups: FB = NG * NW channels
// per block.
template <typename T, int R, int NW, int P, int CH>
__global__ void __launch_bounds__(kThreads) kanconv_kernel(
    const T* __restrict__ xp, const uint32_t* __restrict__ wk, T* __restrict__ out, int C, int F,
    int H, int W, int tiles_w, int tiles, int groups, int works, int fp8) {
  constexpr int RG = kTH / R, NG = kWarps / RG, N8 = NW / 8, FB8 = NG * N8;
  static_assert(RG * NG == kWarps && NW % 8 == 0, "8 warps of R rows and NW channels");
  extern __shared__ __align__(128) unsigned char smem[];
  uint32_t* s_w = reinterpret_cast<uint32_t*>(smem + kABytes);  // [row][n8][part][lane]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp % RG, ng = warp / RG;
  const int Hp = H + 2, Wp = W + 2;

  // The thread's staging items, (halo position, group of CH channels),
  // group fastest, each packed as the position's row and column in the halo
  // (bits 26-30, 20-25) and the byte offset of its first channel's hi part in
  // a term's rows (bits 0-14; the lo parts at ^ 16, the channel in bits 1-3);
  // -1 past the items.
  int items[kRounds<CH>];
#pragma unroll
  for (int r = 0; r < kRounds<CH>; ++r) {
    const int item = tid + r * kThreads, pos = item / (kCC / CH);
    const int ch = item % (kCC / CH) * CH, row = pos / kHW, col = pos % kHW;
    items[r] = item < kItems<CH>
                   ? row << 26 | col << 20 | (pos * 32 + (((col >> 2) & 1) << 4) + ch * 2)
                   : -1;
  }
  T xv[kRounds<CH>][CH];

  // ldmatrix rows: lanes 8m .. 8m+7 address matrix m's rows, pixels
  // (m & 1) * 8 + (lane & 7), the hi (m < 2) or lo half; per kw the byte
  // offset of that row in halo row 0.
  const int m = lane >> 3, px = ((m & 1) << 3) + (lane & 7), half = m >> 1;
  unsigned lane_off[3];
#pragma unroll
  for (int kw = 0; kw < 3; ++kw) {
    const int col = kw + px;
    lane_off[kw] = (col << 5) + ((half ^ ((col >> 2) & 1)) << 4);
  }
  const unsigned a_warp = smem_addr(smem) + ((rg * R * kHW) << 5);

  // Persistent: the block walks the work items (batch element, tile, group
  // of FB channels) w = blockIdx.x, + gridDim.x, ...; the halo values of each
  // next chunk, or of the next item's first, are loaded into registers while
  // the current chunk's products run.
  const int chunks = (C + kCC - 1) / kCC;
  auto origin = [&](int w, int& b, int& i0, int& j0, int& n80) {
    const int tile = w / groups % tiles;
    b = w / groups / tiles;
    i0 = tile / tiles_w * kTH;
    j0 = tile % tiles_w * kTW;
    n80 = w % groups * FB8;  // the item's first 8 output channels
  };
  int b, i0, j0, n80;
  if ((int)blockIdx.x < works) {
    origin(blockIdx.x, b, i0, j0, n80);
    load_x<CH>(xv, xp, items, b, i0, j0, 0, C, Hp, Wp);
  }
#pragma unroll 1
  for (int w = blockIdx.x; w < works; w += gridDim.x) {
    origin(w, b, i0, j0, n80);
    float acc[R][N8][4];
#pragma unroll
    for (int o = 0; o < R; ++o)
#pragma unroll
      for (int n = 0; n < N8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[o][n][e] = 0.f;

#pragma unroll 1
    for (int k = 0; k < chunks; ++k) {
      // The chunk's weights, in flight while its terms are computed.
      constexpr int kWUnits = kWRows * FB8 * P * 8;  // 16-byte units
      for (int u = tid; u < kWUnits; u += kThreads) {
        const int q = u & 7, part = (u >> 3) % P, n8l = (u >> 3) / P % FB8;
        const int row = (u >> 3) / P / FB8;
        const bool ok = n80 + n8l < fp8;
        const uint32_t* src =
            wk + ((((long long)k * kWRows + row) * fp8 + (ok ? n80 + n8l : 0)) * P + part) * 32 +
            q * 4;
        cp_async16(s_w + u * 4, src, ok);
      }
      // The bases' rows are zero but where an item writes one of its 4.
      for (int i = tid; i < kBases * kTermBytes / 16; i += kThreads)
        reinterpret_cast<uint4*>(smem + kTermBytes)[i] = make_uint4(0u, 0u, 0u, 0u);
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kRounds<CH>; ++r) {
        if (items[r] < 0) continue;
        float sv[CH], p[CH][4];
        int jv[CH];
#pragma unroll
        for (int e = 0; e < CH; ++e) jv[e] = terms_at(to_f32(xv[r][e]), sv[e], p[e]);
        const int hi = items[r] & 0xfffff, lo = hi ^ 16;
#pragma unroll
        for (int e = 0; e < CH; e += 2) {  // silu of two channels per word
          const __nv_bfloat162 h = __floats2bfloat162_rn(sv[e], sv[e + 1]);
          *reinterpret_cast<__nv_bfloat162*>(smem + hi + 2 * e) = h;
          *reinterpret_cast<__nv_bfloat162*>(smem + lo + 2 * e) =
              __floats2bfloat162_rn(sv[e] - __low2float(h), sv[e + 1] - __high2float(h));
        }
#pragma unroll
        for (int e = 0; e < CH; ++e) store_bases(smem, hi + 2 * e, lo + 2 * e, jv[e], p[e]);
      }
      cp_async_wait_all();
      __syncthreads();
      if (k + 1 < chunks) {  // in flight over the products
        load_x<CH>(xv, xp, items, b, i0, j0, (k + 1) * kCC, C, Hp, Wp);
      } else if (w + gridDim.x < works) {
        int b2, i2, j2, n2;
        origin(w + gridDim.x, b2, i2, j2, n2);
        load_x<CH>(xv, xp, items, b2, i2, j2, 0, C, Hp, Wp);
      }

#pragma unroll 1
      for (int t = 0; t < kTerms; ++t) {
        float part[R][N8][4];
#pragma unroll
        for (int o = 0; o < R; ++o)
#pragma unroll
          for (int n = 0; n < N8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[o][n][e] = 0.f;
        const unsigned a_t = a_warp + t * kTermBytes;
        const uint32_t* w_t = s_w + (t * FB8 + ng * N8) * P * 32 + lane;
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          uint32_t w_hi[3][N8], w_lo[3][N8];
#pragma unroll
          for (int kh = 0; kh < 3; ++kh)
#pragma unroll
            for (int n = 0; n < N8; ++n) {
              const uint32_t* w = w_t + ((kh * 3 + kw) * kTerms * FB8 + n) * P * 32;
              w_hi[kh][n] = w[0];
              w_lo[kh][n] = P == 2 ? w[32] : 0u;
            }
#pragma unroll
          for (int hr = 0; hr < R + 2; ++hr) {
            uint32_t a[4];
            ldsm_x4(a, a_t + lane_off[kw] + hr * kHW * 32);
#pragma unroll
            for (int kh = 0; kh < 3; ++kh) {
              const int o = hr - kh;
              if (o < 0 || o >= R) continue;
#pragma unroll
              for (int n = 0; n < N8; ++n) {
                mma_k16(part[o][n], a, w_hi[kh][n]);
                if (P == 2) mma_k8(part[o][n], a, w_lo[kh][n]);
              }
            }
          }
        }
#pragma unroll
        for (int o = 0; o < R; ++o)
#pragma unroll
          for (int n = 0; n < N8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[o][n][e] += part[o][n][e];
      }
      __syncthreads();  // the terms and weights are rewritten by the next chunk
    }

    // Fragment element e of (o, n): pixel g (+ 8 for e >= 2), channel 2 tl (+ 1
    // for odd e) of the warp's n-th 8 channels.
    const int g = lane >> 2, tl = lane & 3;
#pragma unroll
    for (int o = 0; o < R; ++o) {
      const int i = i0 + rg * R + o;
      if (i >= H) continue;
#pragma unroll
      for (int n = 0; n < N8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + g + ((e >> 1) << 3);
          const int f = (n80 + ng * N8 + n) * 8 + 2 * tl + (e & 1);
          if (j < W && f < F)
            out[(((long long)b * F + f) * H + i) * W + j] = from_f32<T>(acc[o][n][e]);
        }
    }
  }
}

template <typename T, int R, int NW, int P, int CH>
int launch(const void* xp, const void* wk, void* out, int B, int C, int F, int H, int W,
           cudaStream_t stream) {
  constexpr int FB8 = kWarps / (kTH / R) * NW / 8;
  constexpr int kSmem = kABytes + kWRows * FB8 * P * 128;
  const int fp8 = (F + 7) / 8;
  const int tiles_w = (W + kTW - 1) / kTW, tiles_h = (H + kTH - 1) / kTH;
  const int groups = (fp8 + FB8 - 1) / FB8;
  const long long works = (long long)B * tiles_h * tiles_w * groups;
  if (works > 0x7fffffffLL) return -1;
  auto kernel = kanconv_kernel<T, R, NW, P, CH>;
  // The blocks resident on the device at once (SMs x blocks per SM), found
  // at the instantiation's first launch on each device, where its shared
  // memory limit is raised, and kept: later calls go straight to the launch.
  static std::atomic<int> resident[kMaxDevices];
  int device = 0;
  int err = (int)cudaGetDevice(&device);
  if (err != 0) return err;
  if (device >= kMaxDevices) return -1;
  int blocks = resident[device].load(std::memory_order_relaxed);
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err == 0) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == 0)
      err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, kSmem);
    if (err != 0) return err;
    blocks = sms * per_sm;
    resident[device].store(blocks, std::memory_order_relaxed);
  }
  const int grid = (int)(works < blocks ? works : blocks);
  kernel<<<grid > 0 ? grid : 1, kThreads, kSmem, stream>>>(
      static_cast<const T*>(xp), static_cast<const uint32_t*>(wk), static_cast<T*>(out), C, F,
      H, W, tiles_w, tiles_h * tiles_w, groups, (int)works, fp8);
  return (int)cudaGetLastError();
}

// 16 output channels per block, 2 rows per warp, pairs of channels staged
// per thread (124 registers and 114 KB: two blocks per SM); bf16 weights
// with F > 16: 32 channels, 4 rows per warp in 2 channel groups, 4 channels
// staged per thread (one block per SM), which keeps the staged weights at
// 41 KB (as 16 channels with lo parts).
template <typename T>
int run(const void* xp, const void* wk, void* out, int B, int C, int F, int H, int W, int parts,
        cudaStream_t stream) {
  if (parts == 2) return launch<T, 2, 16, 2, 2>(xp, wk, out, B, C, F, H, W, stream);
  if (F > 16) return launch<T, 4, 16, 1, 4>(xp, wk, out, B, C, F, H, W, stream);
  return launch<T, 2, 16, 1, 2>(xp, wk, out, B, C, F, H, W, stream);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16, 2 = fp16, of xp (B, C, H+2, W+2) and out
// (B, F, H, W). wk: the weights as 32-bit words, (ceil(C / 8), 9 taps, 9
// terms, ceil(F / 8), parts, 32 lanes): lane 4g + l of chunk k, row (tap,
// term), n8 tile n and part p holds the bf16 pair (w_p[8k + 2l, f],
// w_p[8k + 2l + 1, f]) of f = 8n + g, low half first; term 0 the base weight
// and terms 1-8 the spline weights of the 8 bases; part 0 w_hi = bf16(w),
// part 1 (parts = 2) w_lo = bf16(w - w_hi); zeros for channels past C and F.
// Returns cudaGetLastError() after the launch, or -1 for an argument the
// kernel does not take.
extern "C" int kmunet_kanconv(const void* xp, const void* wk, void* out, int B, int C, int F,
                              int H, int W, int dtype, int parts, void* stream) {
  if (B < 1 || B > 65535 || C < 1 || F < 1 || H < 1 || W < 1 || (parts != 1 && parts != 2) ||
      (long long)(H + 2) * (W + 2) > 0x7fffffffLL)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return run<float>(xp, wk, out, B, C, F, H, W, parts, s);
    case 1: return run<__nv_bfloat16>(xp, wk, out, B, C, F, H, W, parts, s);
    case 2: return run<__half>(xp, wk, out, B, C, F, H, W, parts, s);
    default: return -1;
  }
}
