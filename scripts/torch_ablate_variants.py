#!/usr/bin/env python3
"""K3a's design choices measured on the card: edited copies of
``kmunet_tpu_torch/csrc/hsmssd_ablate.cu``, each built with
``kernels/build.py``'s flags, called through the port's own launcher
(``ablate_mix.ablate_mix_forward``, its entry swapped for the copy's), held
to the plain version (``chip_smoke.check_ablate``) and timed in turns at the
TPU script's shape; and K5's chunk at the bridge.

    python3 scripts/torch_ablate_variants.py [VARIANT ...] [--k5-chunks]

Variants (``VARIANTS``; ``kept`` is the source as it is):

- ``maxima_after_copies``: the compress reads its slices' maxima after the
  ring's first copies instead of before them;
- ``exp2``: ``full`` and ``bf16_e`` take e = exp2f((s - M) log2 e), not
  expf(s - M);
- ``clusters``: ``bf16_e`` without the tile-max pass: the spt blocks of a
  TPU tile run as one thread-block cluster, each streams its slice's dt
  for the max first, and the maxima meet in distributed shared memory;
- ``tilemax_128``, ``tilemax_512``: the tile-max pass with 128 or 512
  threads a block; ``tilemax_unroll8``: its loop unrolled 8 times;
  ``tilemax_ldcs``: its loads marked streaming (``__ldcs``).

Each variant's modes (``full``, ``bf16_e``, ``no_max`` unless it changes
fewer) are timed in the order given and back: device us of calls queued
behind a spin, and the profiler's us by kernel (the passes). With
``--k5-chunks``, K5 (``bilinear_gather_forward``) at the bridge (B=128,
16^2, C=64, bf16, zeros) with K7's chunk forced to each of 0, 2, 4, 8, 15,
32 and back, each output first held to the plain version, beside ``zero_``
of its output. Prints JSON lines, the first the card's ``nvidia-smi`` name
and power limit. Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

MAXIMA_ANCHOR = "  float d[2] = {0.f, 0.f};\n  float acc[CT][4];"
TILEMAX_LOAD = "    const uint4 u = __ldg(base + ((long long)t << nv_shift));"

CLUSTER_PHASE = r'''  if constexpr (FUSED) {
    // The slice's max of dt, streamed once, written for the merge and
    // shared through the cluster, whose blocks are TPU tile j's slices.
    __shared__ __align__(16) __nv_bfloat162 red2[128][4];
    __shared__ float slice_m[kMaxN];
    const int nv = 1 << nv_shift, v = tid & (nv - 1), step = (int)blockDim.x >> nv_shift;
    const uint4* base = reinterpret_cast<const uint4*>(dtb + (long long)sl.begin * kT * N) + v;
    const int tokens = (sl.end - sl.begin) * kT;
    const __nv_bfloat162 lowest = __float2bfloat162_rn(-INFINITY);
    __nv_bfloat162 hm[4] = {lowest, lowest, lowest, lowest};
#pragma unroll 4
    for (int t = tid >> nv_shift; t < tokens; t += step) {
      const uint4 u = __ldg(base + ((long long)t << nv_shift));
      const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        __nv_bfloat162 h;
        memcpy(&h, &w[k], 4);
        hm[k] = __hmax2(hm[k], h);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) red2[tid][k] = hm[k];
    __syncthreads();
    if (tid < N) {
      const int vv = tid >> 3, k = (tid & 7) >> 1, hi = tid & 1;
      float m = -INFINITY;
      for (int p = 0; p < step; ++p) {
        const float2 f = __bfloat1622float2(red2[(p << nv_shift) + vv][k]);
        m = fmaxf(m, hi ? f.y : f.x);
      }
      m = fmaxf(m + __bfloat162float(A[tid]), 0.f);
      slice_m[tid] = m;
      smax[((long long)b * S + s) * N + tid] = m;
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = n0 + g + 8 * r;
      if (n < N)
        for (int k = 0; k < spt; ++k) mx[r] = fmaxf(mx[r], cluster.map_shared_rank(slice_m, k)[n]);
    }
    cluster.sync();
  }
'''

CLUSTER_LAUNCH_OLD = '''template <int MODE, int CT>
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
}'''

CLUSTER_LAUNCH_NEW = '''template <int MODE, int CT, bool FUSED>
int compress_ct(const Args& a, dim3 grid) {
  const int N16 = a.N < 16 ? 16 : a.N;
  const size_t smem = sizeof(bf16) * kStages * ((size_t)8 * CT * kXRow + 2 * kT * (N16 + 8));
  auto kernel = compress_kernel<MODE, CT, FUSED>;
  int err = allow_smem(kernel, smem);
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(32 * (N16 / 16));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = FUSED ? a.spt : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = FUSED ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, kernel, a.xt, a.dt, a.Bm, a.A, a.smax, a.part_d,
                                 a.part_h, a.C, a.L, a.N, a.tile, a.spt, a.tps, a.nv_shift);
}

template <int MODE, bool FUSED>
int compress(const Args& a, dim3 grid) {
  switch (channel_tiles(a.C)) {
    case 1: return compress_ct<MODE, 1, FUSED>(a, grid);
    case 2: return compress_ct<MODE, 2, FUSED>(a, grid);
    case 4: return compress_ct<MODE, 4, FUSED>(a, grid);
    default: return compress_ct<MODE, 8, FUSED>(a, grid);
  }
}'''

# name -> (the modes it changes, [(text of the source, its replacement), ...])
VARIANTS = {
    "kept": (("full", "bf16_e", "no_max"), []),
    "maxima_after_copies": (("full", "bf16_e"), ["MOVE_MAXIMA"]),
    "exp2": (("full", "bf16_e"), [
        ("          e0 = expf(s0 - mx[r]);\n          e1 = expf(s1 - mx[r]);",
         "          e0 = exp2f((s0 - mx[r]) * 1.4426950408889634f);\n"
         "          e1 = exp2f((s1 - mx[r]) * 1.4426950408889634f);"),
        ("__floats2bfloat162_rn(expf(s0 - mx[r]),\n"
         "                                                                    expf(s1 - mx[r])",
         "__floats2bfloat162_rn(exp2f((s0 - mx[r]) * 1.4426950408889634f),\n"
         "                                                       exp2f((s1 - mx[r]) * 1.4426950408889634f)"),
    ]),
    "clusters": (("bf16_e",), [
        ("#include <cuda_bf16.h>", "#include <cooperative_groups.h>\n#include <cuda_bf16.h>"),
        ("namespace {\n\nenum Mode", "namespace cg = cooperative_groups;\n\nnamespace {\n\nenum Mode"),
        ("template <int MODE, int CT>\n__global__ void __launch_bounds__(128) compress_kernel(",
         "template <int MODE, int CT, bool FUSED>\n"
         "__global__ void __launch_bounds__(128) compress_kernel("),
        ("    const bf16* __restrict__ A, const float* __restrict__ smax, float* __restrict__ part_d,",
         "    const bf16* __restrict__ A, float* __restrict__ smax, float* __restrict__ part_d,"),
        ("    if ((MODE == kFull || MODE == kBf16E) && n < N) {",
         "    if (!FUSED && (MODE == kFull || MODE == kBf16E) && n < N) {"),
        (MAXIMA_ANCHOR, CLUSTER_PHASE + "\n" + MAXIMA_ANCHOR),
        (CLUSTER_LAUNCH_OLD, CLUSTER_LAUNCH_NEW),
        ("template <int MODE>\nint run(const Args& a) {", "template <int MODE, bool FUSED = false>\nint run(const Args& a) {"),
        ("  if (MODE == kFull || MODE == kBf16E) {\n    tilemax_kernel",
         "  if ((MODE == kFull || MODE == kBf16E) && !FUSED) {\n    tilemax_kernel"),
        ("  if ((err = compress<MODE>(a, grid)) != 0) return err;",
         "  if ((err = compress<MODE, FUSED>(a, grid)) != 0) return err;"),
        ("    case kBf16E: return run<kBf16E>(a);",
         "    case kBf16E: return a.spt <= 8 ? run<kBf16E, true>(a) : -1;"),
    ]),
    "tilemax_128": (("full",), [("constexpr int kTilemaxThreads = 256;",
                                 "constexpr int kTilemaxThreads = 128;")]),
    "tilemax_512": (("full",), [("constexpr int kTilemaxThreads = 256;",
                                 "constexpr int kTilemaxThreads = 512;")]),
    "tilemax_unroll8": (("full",), [("#pragma unroll 4\n  for (int t = tid >> nv_shift;",
                                     "#pragma unroll 8\n  for (int t = tid >> nv_shift;")]),
    "tilemax_ldcs": (("full",), [(TILEMAX_LOAD, TILEMAX_LOAD.replace("__ldg(", "__ldcs("))]),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def variant_source(source: str, edits) -> str:
    for edit in edits:
        if edit == "MOVE_MAXIMA":  # the maxima's reads moved after the ring's first copies
            start = source.index("  // This thread's two states n0 + g and n0 + g + 8")
            end = source.index("  // Rows past C and states past N are never loaded")
            block = source[start:end]
            source = source[:start] + source[end:]
            source = source.replace(MAXIMA_ANCHOR, block + MAXIMA_ANCHOR)
            continue
        old, new = edit
        if source.count(old) != 1:
            raise ValueError(f"the edit's text is not in the source once: {old[:60]!r}")
        source = source.replace(old, new)
    return source


def build_variant(name: str, source: str) -> str:
    """The variant's library under kmunet_tpu_torch/_build/variants/."""
    from kmunet_tpu_torch.kernels import build

    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha256(source.encode()).hexdigest()[:12]
    path, lib = out / f"{name}_{digest}.cu", out / f"{name}_{digest}.so"
    if not lib.exists():
        path.write_text(source)
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(path)],
                              capture_output=True, text=True, timeout=build.NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout + proc.stderr}")
    return str(lib)


def entry(lib: str):
    fn = ctypes.CDLL(lib).kmunet_hsmssd_ablate
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def run_variants(torch, chip_smoke, names) -> None:
    from concurrent.futures import ThreadPoolExecutor

    from kmunet_tpu_torch.kernels import ablate_mix, build

    source = (build.CSRC_DIR / ablate_mix.SOURCE).read_text()
    sources = {n: variant_source(source, VARIANTS[n][1]) for n in names}
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc each, started together
        libs = dict(zip(names, pool.map(lambda n: build_variant(n, sources[n]), names)))
    shape = chip_smoke.ABLATE_SHAPES["script"]
    args = chip_smoke.ablate_inputs(torch, shape, len(chip_smoke.ABLATE_SHAPES), "cuda")
    kept_kernel = ablate_mix.kernel
    try:
        for name in names:  # each variant held to the plain version first
            fn = entry(libs[name])
            ablate_mix.kernel = lambda fn=fn: fn
            errors = {}
            for mode in VARIANTS[name][0]:
                want = ablate_mix.ablate_mix_plain(mode, *args, shape[4]).float()
                got = ablate_mix.ablate_mix_forward(mode, *args, shape[4]).float()
                ulp = 2.0 ** (torch.floor(torch.log2(want.abs().max())) - 7)
                errors[mode] = [float((got - want).abs().max()), float(ulp)]
            emit({"variant": name, "max_abs_err_and_bound": errors})
        for name in names + names[::-1]:
            fn = entry(libs[name])
            ablate_mix.kernel = lambda fn=fn: fn
            for mode in VARIANTS[name][0]:
                call = lambda mode=mode: ablate_mix.ablate_mix_forward(mode, *args, shape[4])  # noqa: E731
                _, _, by_kernel = chip_smoke.device_ms(torch, call, 20)
                emit({"variant": name, "mode": mode,
                      "queued_us": chip_smoke.queued_ms(torch, call, 20)[0] * 1e3,
                      "device_us_by_kernel": {k: v * 1e3 for k, v in by_kernel.items()}})
    finally:
        ablate_mix.kernel = kept_kernel


def k5_chunks(torch, chip_smoke) -> None:
    from kmunet_tpu_torch.kernels import bilinear, sm_count

    B, H, W, C = chip_smoke.BRIDGE
    img = torch.randn(B, H, W, C, device="cuda").to(torch.bfloat16)
    y = (torch.arange(H, device="cuda", dtype=torch.float32).view(1, H, 1)
         + torch.randn(B, H, W, device="cuda")).contiguous()
    x = (torch.arange(W, device="cuda", dtype=torch.float32).view(1, 1, W)
         + torch.randn(B, H, W, device="cuda")).contiguous()
    want = bilinear.bilinear_gather_plain(img.float(), x, y, "zeros")
    tol = 1e-5 + chip_smoke.ulp_tolerance(torch, want, torch.bfloat16)
    out = torch.empty_like(img)
    rule = bilinear.multiview_chunk
    emit({"k5_rule_chunk": rule(B, 1, H, W, sm_count(0))})
    try:
        for k in (0, 2, 4, 8, 15, 32, 15, 8, 4, 2, 0):
            bilinear.multiview_chunk = lambda *a, k=k: k
            fn = lambda: bilinear.bilinear_gather_forward(img, x, y, "zeros")  # noqa: E731
            chip_smoke.check_close(f"K5 chunk {k}", fn(), want, tol)
            emit({"k5_chunk": k, "queued_us": chip_smoke.queued_ms(torch, fn, 50)[0] * 1e3,
                  "zero_queued_us": chip_smoke.queued_ms(torch, out.zero_, 50)[0] * 1e3})
    finally:
        bilinear.multiview_chunk = rule


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("variants", nargs="*", metavar="VARIANT",
                        help=f"of {', '.join(VARIANTS)}: timed in this order and back "
                             "(default: all)")
    parser.add_argument("--k5-chunks", action="store_true", help="also K5's chunk sweep")
    args = parser.parse_args()
    unknown = [v for v in args.variants if v not in VARIANTS]
    if unknown:
        parser.error(f"unknown variants {unknown}; known: {list(VARIANTS)}")

    import torch

    if not torch.cuda.is_available():
        print("torch_ablate_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=30,
                          check=True).stdout.strip().splitlines()[0]
    emit({"card": card, "torch": torch.__version__})
    run_variants(torch, chip_smoke, args.variants or list(VARIANTS))
    if args.k5_chunks:
        k5_chunks(torch, chip_smoke)
    return 0


if __name__ == "__main__":
    sys.exit(main())
