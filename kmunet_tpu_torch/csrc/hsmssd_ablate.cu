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
// x (B, C, L), dt, Bm, Cm (B, L, N), all contiguous bf16; A (N,) fp32; every
// sum and product in fp32, with the TPU kernel's roundings.
//
// Replaces the TPU kernel of scripts/ablate_mix_kernel.py::run (the
// pl.pallas_call at :98, its body make_kernel at :17), a diagnosis of what
// the pieces of K3's first phase cost on the TPU.
//
// Design. csrc/hsmssd.cu's three passes, with the TPU kernel's tiles of
// `tile` tokens kept where the result depends on them:
//   tilemax   (full, bf16_e) one block per (slice, b): the max of s over its
//             tokens, max(0, .), atomicMax'ed as int bits (order-preserving
//             for floats >= 0) into tmax (B, tiles, N), zeroed by the caller.
//             So w rounds against the max the TPU kernel holds at that tile.
//   compress  one block per (slice, b); a slice is spt-th of one TPU tile's
//             64-token kernel tiles. Per kernel tile it stages x (C, 64), s
//             and Bm (64, N) in shared memory (16-byte loads), takes the
//             tile's e and w for all N (warp w takes n = w, w + 8, ...; lane
//             tokens lane and lane + 32), and adds x (C, 64) . w (64, N) to
//             its (n quad, c) accumulators; it writes its m (full: M_j),
//             den and h.
//             dma_only only loads and sums.
//   merge     one block per b: each slice's weight (full: exp(m_i - max m);
//             bf16_e: exp(-sum of the later tiles' m); 1 otherwise), den and
//             h summed, h / (den + 1) rounded to bf16 into hn (B, N, C).
//   scatter   one thread per token: y[:, l] = hn^T Cm[l, :], hn staged in
//             shared memory, all C channels in registers; dma_only writes
//             its tile's sum and loads its Cm row into a checksum.
// Bound. At the TPU script's shape (B = 64, C = 16, L = 16384, N = 64) it
// moves x 33.6 MB, dt, Bm and Cm 134.2 MB each and y 33.6 MB: 470 MB, 140 us
// at 3.35 TB/s; its 4 B L C N = 4.3 GFLOP of products take 64 us at the 67
// TFLOP/s of fp32 outside the tensor cores: bytes bound it. full's and
// bf16_e's tilemax pass reads dt a second time. The compress does 2 shared loads per 4 FMAs,
// the scatter one broadcast float4 per 4 FMAs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

enum Mode { kFull = 0, kBf16E = 1, kNoMax = 2, kNoExp = 3, kDmaOnly = 4 };

constexpr int kThreads = 256;  // tilemax, compress and merge blocks
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;      // tokens per compress tile: two per lane
constexpr int kMaxN = 64;      // N in {8, 16, 32, 64}: rows of 16-byte vectors
constexpr int kMaxC = 64;
constexpr int kNPerWarp = kMaxN / kWarps;
constexpr int kPairs = kMaxN / 4 * kMaxC / kThreads;  // (n quad, c) pairs per thread
constexpr int kScatterTokens = 64;  // tokens per scatter block: one TPU tile's
constexpr int kDmaTokens = 8;       // dma_only sums Cm over a tile's first 8 tokens

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The 8 bf16 values at p (16-byte aligned) as floats.
__device__ __forceinline__ void load8(const bf16* p, float* out) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    out[2 * k] = f.x;
    out[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Index of w[t][n] in the compress tile, as csrc/hsmssd.cu's: quads of n,
// XOR-swizzled by the token, so that a thread reads the 4 n of its quad at
// one token as one float4.
__device__ __forceinline__ int ws_index(int t, int n, int nq_mask) {
  return t * (nq_mask + 1) * 4 + ((((n >> 2) ^ (t & nq_mask))) << 2) + (n & 3);
}

// The kernel tiles [begin, end) of slice s: the k-th spt-th of TPU tile j.
struct Slice {
  int j, begin, end;
  __device__ Slice(int s, int tile, int spt, int tps) {
    const int per_tile = tile / kTile, k = s % spt;
    j = s / spt;
    begin = j * per_tile + k * tps;
    end = j * per_tile + min((k + 1) * tps, per_tile);
  }
};

// full's and bf16_e's tile maxima: block (s, b) folds max(0, s) over its
// tokens into tmax[b, j, :].
__global__ void __launch_bounds__(kThreads) tilemax_kernel(
    const bf16* __restrict__ dt, const float* __restrict__ A, float* __restrict__ tmax, int L,
    int N, int tile, int spt, int tps) {
  __shared__ float red[kThreads];
  const int b = blockIdx.y, tid = threadIdx.x;
  const Slice sl(blockIdx.x, tile, spt, tps);
  const int n = tid % N, part = tid / N, parts = kThreads / N;
  const bf16* dtb = dt + (long long)b * L * N;
  const float a = A[n];
  float mx = 0.f;
  for (long long l = (long long)sl.begin * kTile + part; l < (long long)sl.end * kTile;
       l += parts)
    mx = fmaxf(mx, __bfloat162float(dtb[l * N + n]) + a);
  red[tid] = mx;
  __syncthreads();
  if (part == 0) {
    for (int p = 1; p < parts; ++p) mx = fmaxf(mx, red[p * N + n]);
    atomicMax(reinterpret_cast<int*>(tmax + ((long long)b * (L / tile) + sl.j) * N + n),
              __float_as_int(mx));
  }
}

// The compress pass: block (s, b) writes its partial m, den and h (N, C) at
// (b, s); dma_only its checksum at part_d[b, s, 0]. Dynamic shared memory:
// 64 N + C (64 + 1) + 2 * 64 (N + 1) + 2 N floats.
template <int MODE>
__global__ void __launch_bounds__(kThreads) compress_kernel(
    const bf16* __restrict__ xt, const bf16* __restrict__ dt, const bf16* __restrict__ Bm,
    const float* __restrict__ A, const float* __restrict__ tmax, float* __restrict__ part_m,
    float* __restrict__ part_d, float* __restrict__ part_h, int C, int L, int N, int tile,
    int spt, int tps) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // w, [t][n] swizzled
  float* xs = ws + kTile * N;                   // x, [c][t], rows padded
  float* ss = xs + C * (kTile + 1);             // s, [t][n], rows padded
  float* bs = ss + kTile * (N + 1);             // Bm, [t][n], rows padded
  float* m_s = bs + kTile * (N + 1);
  float* d_s = m_s + N;
  __shared__ float red[kWarps];

  const int b = blockIdx.y, s = blockIdx.x, S = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Slice sl(s, tile, spt, tps);
  const int nq_mask = N / 4 - 1, nv = N / 8;
  const bf16* xb = xt + (long long)b * C * L;
  const bf16* dtb = dt + (long long)b * L * N;
  const bf16* bmb = Bm + (long long)b * L * N;

  if (tid < N) {
    // full: the running max at the end of TPU tile j; bf16_e: tile j's own.
    float m = 0.f;
    if (MODE == kFull || MODE == kBf16E) {
      const float* tm = tmax + (long long)b * (L / tile) * N + tid;
      if (MODE == kFull)
        for (int j = 0; j <= sl.j; ++j) m = fmaxf(m, tm[j * N]);
      else
        m = tm[sl.j * N];
    }
    m_s[tid] = m;
    d_s[tid] = 0.f;
  }
  const int pairs = N / 4 * C;
  float acc[kPairs][4];
#pragma unroll
  for (int k = 0; k < kPairs; ++k)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[k][q] = 0.f;
  float check = 0.f;
  __syncthreads();

  for (int tile_i = sl.begin; tile_i < sl.end; ++tile_i) {
    const int l0 = tile_i * kTile;
    for (int i = tid; i < C * (kTile / 8); i += kThreads) {
      const int c = i / (kTile / 8), q = i % (kTile / 8);
      float v[8];
      load8(xb + (long long)c * L + l0 + q * 8, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (MODE == kDmaOnly)
          check += v[k];
        else
          xs[c * (kTile + 1) + q * 8 + k] = v[k];
      }
    }
    for (int i = tid; i < kTile * nv; i += kThreads) {
      const int t = i / nv, q = i % nv;
      const long long off = (long long)(l0 + t) * N + q * 8;
      float dv[8], bv[8];
      load8(dtb + off, dv);
      load8(bmb + off, bv);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (MODE == kDmaOnly) {
          check += dv[k] + bv[k];
        } else {
          ss[t * (N + 1) + q * 8 + k] = dv[k] + A[q * 8 + k];
          bs[t * (N + 1) + q * 8 + k] = bv[k];
        }
      }
    }
    if (MODE == kDmaOnly) continue;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kNPerWarp; ++k) {
      const int n = warp + k * kWarps;
      if (n >= N) break;  // warp-uniform
      const float s0 = ss[lane * (N + 1) + n], s1 = ss[(lane + 32) * (N + 1) + n];
      float e0, e1;
      if (MODE == kFull) {
        e0 = expf(s0 - m_s[n]);
        e1 = expf(s1 - m_s[n]);
      } else if (MODE == kBf16E) {
        e0 = bf16_round(expf(s0 - m_s[n]));
        e1 = bf16_round(expf(s1 - m_s[n]));
      } else if (MODE == kNoMax) {
        e0 = expf(s0);
        e1 = expf(s1);
      } else {
        e0 = s0;
        e1 = s1;
      }
      const float e_sum = warp_sum(e0 + e1);
      ws[ws_index(lane, n, nq_mask)] = bf16_round(e0 * bs[lane * (N + 1) + n]);
      ws[ws_index(lane + 32, n, nq_mask)] = bf16_round(e1 * bs[(lane + 32) * (N + 1) + n]);
      __syncwarp();
      if (lane == 0) d_s[n] += e_sum;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int p = tid + k * kThreads;
      if (p < pairs) {
        const int c = p % C, nq = p / C;
        const float* xr = xs + c * (kTile + 1);
#pragma unroll 8
        for (int t = 0; t < kTile; ++t) {
          const float4 w = *reinterpret_cast<const float4*>(
              ws + t * N + ((nq ^ (t & nq_mask)) << 2));
          const float xval = xr[t];
          acc[k][0] = fmaf(w.x, xval, acc[k][0]);
          acc[k][1] = fmaf(w.y, xval, acc[k][1]);
          acc[k][2] = fmaf(w.z, xval, acc[k][2]);
          acc[k][3] = fmaf(w.w, xval, acc[k][3]);
        }
      }
    }
    __syncthreads();
  }

  const long long part = (long long)b * S + s;
  if (MODE == kDmaOnly) {
    check = warp_sum(check);
    if (lane == 0) red[warp] = check;
    __syncthreads();
    if (tid == 0) {
      float total = 0.f;
      for (int w = 0; w < kWarps; ++w) total += red[w];
      part_d[part * N] = total;
    }
    return;
  }
  if (tid < N) {
    part_m[part * N + tid] = m_s[tid];
    part_d[part * N + tid] = d_s[tid];
  }
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const int p = tid + k * kThreads;
    if (p < pairs) {
      const int c = p % C, nq = p / C;
#pragma unroll
      for (int q = 0; q < 4; ++q) part_h[(part * N + nq * 4 + q) * C + c] = acc[k][q];
    }
  }
}

// The merge pass: one block per b writes hn (B, N, C), bf16-rounded floats.
// Dynamic shared memory: S * N + N floats.
template <int MODE>
__global__ void __launch_bounds__(kThreads) merge_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_d,
    const float* __restrict__ part_h, const float* __restrict__ tmax, float* __restrict__ hn,
    int C, int N, int S, int spt, int n_tiles) {
  extern __shared__ float smem[];
  float* wgt = smem;          // [S][N]: each slice's scale in the final sums
  float* dsum = wgt + S * N;  // [N]
  const int b = blockIdx.x, tid = threadIdx.x;
  const float* pm = part_m + (long long)b * S * N;
  const float* pd = part_d + (long long)b * S * N;
  const float* ph = part_h + (long long)b * S * N * C;

  for (int n = tid; n < N; n += kThreads) {
    if (MODE == kFull) {
      float m = 0.f;  // the running max at the last tile, from 0
      for (int i = 0; i < S; ++i) m = fmaxf(m, pm[i * N + n]);
      for (int i = 0; i < S; ++i) wgt[i * N + n] = expf(pm[i * N + n] - m);
    } else if (MODE == kBf16E) {
      // Tile j's sums are scaled by exp(-m_k) for every later tile k.
      const float* tm = tmax + (long long)b * n_tiles * N + n;
      float later = 0.f;
      for (int j = n_tiles - 1; j >= 0; --j) {
        const float w = expf(-later);
        for (int i = j * spt; i < (j + 1) * spt; ++i) wgt[i * N + n] = w;
        later += tm[j * N];
      }
    } else {
      for (int i = 0; i < S; ++i) wgt[i * N + n] = 1.f;
    }
    float d = 0.f;
    for (int i = 0; i < S; ++i) d = fmaf(pd[i * N + n], wgt[i * N + n], d);
    dsum[n] = d;
  }
  __syncthreads();
  for (int p = tid; p < N * C; p += kThreads) {
    const int n = p % N, c = p / N;
    float acc = 0.f;
    for (int i = 0; i < S; ++i) acc = fmaf(wgt[i * N + n], ph[((long long)i * N + n) * C + c], acc);
    hn[((long long)b * N + n) * C + c] = bf16_round(acc / (dsum[n] + 1.f));
  }
}

// The scatter pass: thread l of block (tile, b) writes y[b, :, l], CM >= C
// channels in registers; dma_only the sum of Cm over its TPU tile's first
// kDmaTokens tokens, and its Cm row's checksum at sink[b, tile].
template <int MODE, int CM>
__global__ void __launch_bounds__(kScatterTokens) scatter_kernel(
    const float* __restrict__ hn, const bf16* __restrict__ Cm, bf16* __restrict__ yt,
    float* __restrict__ sink, int C, int L, int N, int tile) {
  __shared__ __align__(16) float hs[kMaxN * CM];  // hn[b], [n][CM], zeros past C
  __shared__ float red[kScatterTokens / 32], tile_sum;
  const int b = blockIdx.y, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int l = blockIdx.x * kScatterTokens + tid;  // L is a multiple of the block
  const bf16* cb = Cm + ((long long)b * L + l) * N;
  bf16* yb = yt + (long long)b * C * L + l;
  if (MODE == kDmaOnly) {
    float check = 0.f;
    for (int q = 0; q < N / 8; ++q) {
      float v[8];
      load8(cb + q * 8, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) check += v[k];
    }
    check = warp_sum(check);
    if (lane == 0) red[warp] = check;
    if (warp == 0) {
      const long long first =
          (long long)b * L + (long long)(blockIdx.x * kScatterTokens / tile) * tile;
      float sum = 0.f;
      for (int i = lane; i < kDmaTokens * N; i += 32) sum += __bfloat162float(Cm[first * N + i]);
      sum = warp_sum(sum);
      if (lane == 0) tile_sum = sum;
    }
    __syncthreads();
    if (tid == 0) sink[(long long)b * gridDim.x + blockIdx.x] = red[0] + red[1];
    const bf16 v = __float2bfloat16(tile_sum);
    for (int c = 0; c < C; ++c) yb[(long long)c * L] = v;
    return;
  }
  for (int i = tid; i < N * CM; i += kScatterTokens) {
    const int n = i / CM, c = i % CM;
    hs[i] = c < C ? hn[((long long)b * N + n) * C + c] : 0.f;
  }
  __syncthreads();
  float acc[CM];
#pragma unroll
  for (int c = 0; c < CM; ++c) acc[c] = 0.f;
#pragma unroll 2
  for (int q = 0; q < N / 8; ++q) {
    float v[8];
    load8(cb + q * 8, v);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float4* hr = reinterpret_cast<const float4*>(hs + (q * 8 + k) * CM);
#pragma unroll
      for (int u = 0; u < CM / 4; ++u) {
        const float4 w = hr[u];
        acc[4 * u] = fmaf(w.x, v[k], acc[4 * u]);
        acc[4 * u + 1] = fmaf(w.y, v[k], acc[4 * u + 1]);
        acc[4 * u + 2] = fmaf(w.z, v[k], acc[4 * u + 2]);
        acc[4 * u + 3] = fmaf(w.w, v[k], acc[4 * u + 3]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < CM; ++c)
    if (c < C) yb[(long long)c * L] = __float2bfloat16(acc[c]);
}

// Dynamic shared memory above 48 KB must be asked for.
template <typename K>
int allow_smem(K kernel, size_t smem) {
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
  return 0;
}

template <int MODE, int CM>
int scatter_cm(const void* hn, const void* Cm, void* yt, void* sink, int B, int C, int L, int N,
               int tile, cudaStream_t stream) {
  scatter_kernel<MODE, CM><<<dim3(L / kScatterTokens, B), kScatterTokens, 0, stream>>>(
      static_cast<const float*>(hn), static_cast<const bf16*>(Cm), static_cast<bf16*>(yt),
      static_cast<float*>(sink), C, L, N, tile);
  return (int)cudaGetLastError();
}

// One instantiation per power of two of channels in registers.
template <int MODE>
int scatter(const void* hn, const void* Cm, void* yt, void* sink, int B, int C, int L, int N,
            int tile, cudaStream_t stream) {
  if (MODE == kDmaOnly || C <= 4)
    return scatter_cm<MODE, 4>(hn, Cm, yt, sink, B, C, L, N, tile, stream);
  if (C <= 8) return scatter_cm<MODE, 8>(hn, Cm, yt, sink, B, C, L, N, tile, stream);
  if (C <= 16) return scatter_cm<MODE, 16>(hn, Cm, yt, sink, B, C, L, N, tile, stream);
  if (C <= 32) return scatter_cm<MODE, 32>(hn, Cm, yt, sink, B, C, L, N, tile, stream);
  return scatter_cm<MODE, 64>(hn, Cm, yt, sink, B, C, L, N, tile, stream);
}

template <int MODE>
int run(const void* xt, const void* dt, const void* Bm, const void* Cm, const void* A,
        void* tmax, void* part_m, void* part_d, void* part_h, void* hn, void* sink, void* yt,
        int B, int C, int L, int N, int tile, int spt, int tps, cudaStream_t stream) {
  const int n_tiles = L / tile, S = n_tiles * spt;
  const dim3 grid(S, B);
  int err;
  if (MODE == kFull || MODE == kBf16E) {
    tilemax_kernel<<<grid, kThreads, 0, stream>>>(static_cast<const bf16*>(dt),
                                                  static_cast<const float*>(A),
                                                  static_cast<float*>(tmax), L, N, tile, spt, tps);
    if ((err = (int)cudaGetLastError()) != 0) return err;
  }
  const size_t csmem = sizeof(float) * ((size_t)kTile * N + (size_t)C * (kTile + 1) +
                                        2 * (size_t)kTile * (N + 1) + 2 * (size_t)N);
  if ((err = allow_smem(compress_kernel<MODE>, csmem)) != 0) return err;
  compress_kernel<MODE><<<grid, kThreads, csmem, stream>>>(
      static_cast<const bf16*>(xt), static_cast<const bf16*>(dt), static_cast<const bf16*>(Bm),
      static_cast<const float*>(A), static_cast<const float*>(tmax),
      static_cast<float*>(part_m), static_cast<float*>(part_d), static_cast<float*>(part_h), C,
      L, N, tile, spt, tps);
  if ((err = (int)cudaGetLastError()) != 0) return err;
  if (MODE != kDmaOnly) {
    const size_t msmem = sizeof(float) * ((size_t)S * N + N);
    if ((err = allow_smem(merge_kernel<MODE>, msmem)) != 0) return err;
    merge_kernel<MODE><<<B, kThreads, msmem, stream>>>(
        static_cast<const float*>(part_m), static_cast<const float*>(part_d),
        static_cast<const float*>(part_h), static_cast<const float*>(tmax),
        static_cast<float*>(hn), C, N, S, spt, n_tiles);
    if ((err = (int)cudaGetLastError()) != 0) return err;
  }
  return scatter<MODE>(hn, Cm, yt, sink, B, C, L, N, tile, stream);
}

bool valid(int B, int C, int L, int N, int tile, int spt, int tps) {
  if (B < 1 || B > 65535 || C < 1 || C > kMaxC || N < 8 || N > kMaxN || (N & (N - 1)) != 0 ||
      tile < kTile || tile % kTile != 0 || L < tile || L % tile != 0 || spt < 1 || tps < 1)
    return false;
  const int per_tile = tile / kTile;
  return (long long)spt * tps >= per_tile && (long long)(spt - 1) * tps < per_tile &&
         (long long)(L / tile) * spt <= 2147483647LL;
}

}  // namespace

// mode: kernels/ablate_mix.py's MODES index. x (B, C, L), dt, Bm, Cm (B, L,
// N) and y (B, C, L) contiguous bf16; A (N,) fp32; each TPU tile of `tile`
// tokens (a multiple of 64 dividing L) goes to spt compress slices of tps
// 64-token tiles. Scratch, fp32: tmax (B, L / tile, N) zeroed (full and
// bf16_e only, else unused), part_m, part_d (B, S, N) and part_h (B, S, N, C) with S =
// (L / tile) spt, hn (B, N, C), sink (B, L / 64). Returns cudaGetLastError()
// after the first launch that fails or after the last, or -1 for an argument
// the kernel does not take (C in [1, 64], N in {8, 16, 32, 64}).
extern "C" int kmunet_hsmssd_ablate(int mode, const void* xt, const void* dt, const void* Bm,
                                    const void* Cm, const void* A, void* tmax, void* part_m,
                                    void* part_d, void* part_h, void* hn, void* sink, void* yt,
                                    int B, int C, int L, int N, int tile, int spt, int tps,
                                    void* stream) {
  if (!valid(B, C, L, N, tile, spt, tps)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kFull: return run<kFull>(xt, dt, Bm, Cm, A, tmax, part_m, part_d, part_h, hn, sink, yt,
                                  B, C, L, N, tile, spt, tps, s);
    case kBf16E: return run<kBf16E>(xt, dt, Bm, Cm, A, tmax, part_m, part_d, part_h, hn, sink,
                                    yt, B, C, L, N, tile, spt, tps, s);
    case kNoMax: return run<kNoMax>(xt, dt, Bm, Cm, A, tmax, part_m, part_d, part_h, hn, sink,
                                    yt, B, C, L, N, tile, spt, tps, s);
    case kNoExp: return run<kNoExp>(xt, dt, Bm, Cm, A, tmax, part_m, part_d, part_h, hn, sink,
                                    yt, B, C, L, N, tile, spt, tps, s);
    case kDmaOnly: return run<kDmaOnly>(xt, dt, Bm, Cm, A, tmax, part_m, part_d, part_h, hn,
                                        sink, yt, B, C, L, N, tile, spt, tps, s);
    default: return -1;
  }
}
