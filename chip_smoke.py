#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``kmunet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:

1. device  -- the card's name; ``nvidia-smi``'s name and power limit line.
2. build   -- ``kmunet_tpu_torch/csrc/bilinear_gather.cu`` (K5, K4 and K7,
              the gather and its grouped and multiview forms) and
              ``csrc/bilinear_gather_backward.cu`` (K6, the backward of all
              three) built with nvcc for sm_90a, one nvcc each, both started
              together; the ``-Xptxas -v`` reports are printed once.
3. kernel  -- K5 and K6 against their plain PyTorch versions on the card,
              zeros and border modes, fp32/bf16/fp16, at the DAGEM bridge
              shape, a ragged one and one whose C takes no 16-byte vectors,
              on out-of-range, integer, last-pixel,
              grid and far-outside coordinates. K5: fp32 within 1e-5 abs of
              the plain version; bf16 and fp16 within one ulp of the
              kernel's fp32 result on the same rounded image. K6: fp32
              within 1e-5 abs + 1e-5 relative of the plain version, plus
              for d_img 1e-6 of the sum of its terms' |values| (about 17
              fp32 ulps of it: its atomics add those terms, as many as the
              outputs that land on the pixel, in another order, and so do
              the warp sums of d_x and d_y); bf16 and fp16 against the
              kernel's own fp32 result on the same rounded image and
              gradient: d_img within one ulp plus that slack, d_x and d_y
              (fp32) within the slack. Then K4 and K6's grouped entry the
              same way, with the same bounds, at DySample's three shapes
              (dec1/dec2/dec3 at B=2, C=64, G=4), a ragged shape of Cg=6,
              one of Cg=3, and G=1 and G=8, each group on its own draw of
              the coordinate cases. Then K7 and K6's shared-source entry the
              same way, with the same bounds, at TrajGRU's three RNN shapes
              (32^2 C=64 G=13, 8^2 C=192 G=13, 4^2 C=192 G=9, at B=2), C=6
              and C=3 (one channel per thread in fp32 and bf16), and G=1 and
              G=16, each view on its own draw of the coordinate cases; and a
              layout case: at integer coordinates x = j - dx_l, y = i - dy_l,
              K7's channel block l must equal the source shifted by
              (dy_l, dx_l), zeros outside, exactly.
4. slice   -- the serving path: KM_UNetV3-SH at full width (embed_dims
              16/32/64, 128^2, 5 -> 20 frames), seeded weights, eval mode,
              built and served through ``kmunet_tpu_torch.serve`` on the card
              for a few requests of B=2 in fp32 with TF32 off. Every kernel's
              launch count is set to 0 just before and read just after; K5
              must launch 9 times per forward and K4 never. Each answer must
              have the shape (2, 128, 128, 20), be finite and match the same
              weights on the CPU (plain gathers) within 1e-4 abs. Then
              ``serve_exact``: the same with ``dysample_window=False``, each
              DySample's offset conv scaled so that its largest offset on
              the first request is 2 px (the seeded init gives about 1e-3
              px); K4 must launch 3 times per forward and K5 9 times.
5. train   -- the training path, through ``kmunet_tpu_torch.train.engine``:
              the SH recipe (hybrid loss, AdamW, per-epoch cosine) at full
              width, 128^2, seq_len 25, B=16, bf16 compute, takes 3 steps on
              ``SyntheticNowcastDataset`` items from a seed, with the launch
              counts set to 0 just before and read just after: K5 and K6 must
              launch 9 times per step and K4 never, every loss must be
              finite and the parameters must move. Then one fp32 step at B=2
              with TF32 off on the card against the same step on the CPU:
              loss within 1e-5 relative, grad norm within 5e-5 relative, and
              every parameter's gradient (the ones the optimizer applied)
              within 1e-3 of that parameter's largest |gradient| plus 1e-6
              abs (the floor of the leaves whose exact gradient is 0, where
              both sides hold rounding noise). ``train_exact`` repeats both
              with ``dysample_window=False``: K4 and K6's grouped entry must
              launch 3 times per step, K5 and K6 9 times. No SH path may
              launch K7 or its backward.
   serve_trajgru -- TrajGRU_EF at full width (encoder RNNs 64/192/192
              channels with 13/13/9 flow fields, forecaster 192/192/64 with
              13/13/9), 128^2, 5 -> 20 frames, seeded weights, built and
              served through ``serve.build_zoo_model("trajgru")`` for a few
              requests of B=2 in fp32 with TF32 off, each cell's flow conv
              scaled so that its largest flow on the first request is 2 px
              (the seeded init gives about 0.1 px); K7 must launch 75 times
              per forward (15 encoder and 60 forecaster cell steps) and no
              other kernel; each answer (2, 20, 128, 128), finite, within 1e-4
              abs and 1e-5 of its largest |value| (about 1e-2) of the same
              weights on the CPU.
   train_trajgru -- one fp32 step of the ("trajgru", "pic") recipe (Adam
              lr 1e-4, weighted_mse_mae over the thresholds 20/30/35/40,
              MultiStepLR) at full width, 128^2, seq_len 25, B=2, the flow
              convs scaled by FLOW_SCALE, on the card against the same
              gradient in float64 on the CPU (``float64_gradients``) through
              ``compare_steps``: K7 and K6's shared-source entry must launch
              75 times each and no other kernel. The CPU's fp32 step is no
              reference here: its bias gradient of the last 1x1 conv, a sum
              over 655 k outputs, lies 7e-5 of the leaf from float64, which
              moves its grad norm 6.1e-5 (the card's: 7e-8), by
              scripts/torch_grad_precision.py --model trajgru --size 128.
6. timing  -- CUDA events after warm-up, PyTorch's default TF32 settings:
              the forward at B=128 bf16 on the window and the exact path and
              at B=8 fp32 (ms, frames/s = B*20/s); the train step at B=16 and
              B=32 bf16 on both paths (ms); K5 and K6 at the bridge shape in
              bf16, K4 and K6's grouped entry at DySample's dec3 shape (B=128,
              64^2 -> 128^2, C=64, G=4, bf16, border), beside their bounds,
              their plain versions and the PyTorch call that computes the
              same function (``F.grid_sample``, ``aten.grid_sampler_2d_backward``;
              for the grouped ones on the groups folded into the batch, a
              layout copy made before timing) on the same data, each per call
              by CUDA events over back-to-back calls (``ms``: what a caller
              waits, host issue included), by CUDA events over calls queued
              behind a spinning kernel (``queued_ms``: device time, no host
              gap) and by the profiler's device time (``device_ms``). For
              TrajGRU: the forward at B=16 bf16 (ms, frames/s) and the
              recipe's train step at B=16 bf16 (ms), and K7 and K6's
              shared-source entry at enc_rnn1's shape (B=16, 32^2, C=64,
              G=13, bf16, zeros, coordinates grid + N(0, 1) px) against
              ``F.grid_sample`` (align_corners, zeros) and
              ``aten.grid_sampler_2d_backward`` plus the sum over the views,
              on the source broadcast into the batch (a copy made before
              timing).
Then the kernels line, and last ``{"ok": true, "device": {...}}``. Any failed
phase raises: the run exits non-zero and prints no result, also when no CUDA
device is present. A hard deadline ends a run that hangs.
"""

from __future__ import annotations

import faulthandler
import json
import os
import re
import subprocess
import sys
import time

DEADLINE_S = 900
REPO = os.path.dirname(os.path.abspath(__file__))

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12  # fp32 outside the tensor cores
REQUESTS = 3
REQUEST_BATCH = 2
BRIDGE = (128, 16, 16, 64)  # K5's shape on the main path at B=128 (B, H, W, C)
RAGGED = (3, 7, 9, 24)
ODD = (2, 5, 6, 3)  # C of no 16-byte vector: one channel per thread
K5_SOURCE = "kmunet_tpu_torch/csrc/bilinear_gather.cu"
K5_REPLACES = "kmunet_tpu/kernels/bilinear_pallas.py:646"
K6_SOURCE = "kmunet_tpu_torch/csrc/bilinear_gather_backward.cu"
K6_REPLACES = "kmunet_tpu/kernels/bilinear_pallas.py:414"
K4_SOURCE = K5_SOURCE  # one kernel with a group count
K4_REPLACES = "kmunet_tpu/kernels/bilinear_pallas.py:747"
K6G_SOURCE = K6_SOURCE
K6G_REPLACES = K6_REPLACES  # _backward_impl, shared=False, G > 1
# K4's shapes (B, H, W, C, G, Ho, Wo): DySample's three 2x upsamplings of the
# SH decoder at a small batch, a ragged one of Cg=6 and one of Cg=3 (no
# 16-byte vector in fp32), and G=1 and G=8.
GROUPED_SHAPES = {
    "dec1": (2, 16, 16, 64, 4, 32, 32),
    "dec2": (2, 32, 32, 64, 4, 64, 64),
    "dec3": (2, 64, 64, 64, 4, 128, 128),
    "ragged_cg6": (3, 7, 9, 24, 4, 8, 7),
    "cg3": (2, 5, 6, 6, 2, 4, 8),
    "g1": (2, 7, 9, 24, 1, 8, 7),
    "g8": (2, 9, 7, 64, 8, 10, 12),
}
DEC3 = (128, 64, 64, 64, 4, 128, 128)  # K4's timing shape: dec3 at B=128
DYSAMPLES = 3  # one K4 launch per DySample forward, one grouped K6 per backward
OFFSET_REACH_PX = 2.0  # serve_exact's largest learned offset per DySample
TRAIN_STEPS = 3
TRAIN_BATCH = 16  # the bench's SH train step: 128^2, seq_len 25, bf16 compute
CHECK_BATCH = 2  # the fp32 card-vs-CPU step
# The fp32 card-vs-CPU step's bounds (also tests/test_torch_gpu.py's), a few
# times the gaps that scripts/torch_grad_precision.py reads on an H100: the
# grad norms 1.6e-5 apart at 32^2 (the card 1.2e-5 below the float64 norm,
# the CPU 3.5e-6 above it; spread over the large convs at 4x4-8x8, each
# 3.5-5e-5 off in its own norm) and 2.4e-6 at 128^2; each side's worst leaf
# within 4.2e-4 of its largest |float64 gradient|.
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_NORM_RTOL = 5e-5
STEP_LEAF_RTOL = 1e-3
STEP_LEAF_ATOL = 1e-6  # the leaves whose exact gradient is 0 hold rounding noise
TAPS = 9  # DeformConv2d 3x3: one K5 launch per tap, one K6 launch per tap's backward
K7_SOURCE = K5_SOURCE  # the same kernel with a shared-source flag
K7_REPLACES = K4_REPLACES  # _forward_grouped's pallas_call, shared=True
K6S_SOURCE = K6_SOURCE
K6S_REPLACES = K6_REPLACES  # _backward_impl, shared=True
# K7's shapes (B, H, W, C, G, Ho, Wo): TrajGRU's three RNN levels at 128^2
# input and B=2, C of 6 and 3 (no 16-byte vector in fp32), and G=1 and G=16.
MULTIVIEW_SHAPES = {
    "rnn1": (2, 32, 32, 64, 13, 32, 32),
    "rnn2": (2, 8, 8, 192, 13, 8, 8),
    "rnn3": (2, 4, 4, 192, 9, 4, 4),
    "c6": (2, 7, 9, 6, 3, 8, 7),
    "c3": (2, 5, 6, 3, 9, 4, 8),
    "g1": (2, 7, 9, 24, 1, 8, 7),
    "g16": (2, 9, 7, 16, 16, 10, 12),
}
RNN1 = (16, 32, 32, 64, 13, 32, 32)  # K7's timing shape: enc_rnn1 at B=16
# TrajGRU cell steps per forward: 5 input frames through 3 encoder RNNs, 20
# output frames through 3 forecaster RNNs; one K7 launch each, one K6
# shared-source launch each in the backward.
TRAJGRU_WARPS = 3 * 5 + 3 * 20
FLOW_REACH_PX = 2.0  # serve_trajgru's largest flow per cell
FLOW_SCALE = 30.0  # train_trajgru's flow convs: flows reach about 3 px at enc_rnn1
TRAJGRU_BATCH = 16  # bench.py's zoo batch for trajgru, timed in bf16


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Phase:
    """Times a phase and prints its JSON line when it ends without error."""

    def __init__(self, name: str):
        self.name = name
        self.fields = {}

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self.fields

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            emit({"phase": self.name, "seconds": round(time.perf_counter() - self.t0, 3),
                  **self.fields})
        return False


def coordinate_cases(rng, B, H, W, Ho, Wo):
    """Named (x, y) pixel-coordinate fields, (B, Ho, Wo) float32 each."""
    import numpy as np

    shape = (B, Ho, Wo)
    f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)  # noqa: E731
    jj = np.broadcast_to(np.arange(Wo) % W, shape)
    ii = np.broadcast_to((np.arange(Ho) % H)[:, None], shape)
    return {
        "spread": (f32(rng.uniform(-1.5, W + 0.5, shape)), f32(rng.uniform(-1.5, H + 0.5, shape))),
        "integer": (f32(rng.integers(-1, W + 1, shape)), f32(rng.integers(-1, H + 1, shape))),
        "last_pixel": (f32(np.full(shape, W - 1)), f32(np.full(shape, H - 1))),
        "grid": (f32(jj), f32(ii)),
        "far_outside": (
            f32(np.where(rng.uniform(size=shape) < 0.5, -2.0 - rng.uniform(0, 9, shape),
                         W + 1.0 + rng.uniform(0, 9, shape))),
            f32(np.where(rng.uniform(size=shape) < 0.5, -1e6, H + 1e3 * rng.uniform(size=shape))),
        ),
    }


def ulp_tolerance(torch, ref, dtype):
    """One ulp of ``dtype`` at the magnitude of the fp32 ``ref`` (at least the
    spacing of its subnormals)."""
    bits = {torch.bfloat16: 8, torch.float16: 11}[dtype]
    ulp = torch.ldexp(torch.ones_like(ref), torch.frexp(ref).exponent - bits)
    return ulp.clamp_min(torch.finfo(dtype).smallest_normal * 2.0 ** (1 - bits))


def ptxas_summary(output: str):
    """One line per compiled kernel from nvcc's ``-Xptxas -v`` report:
    its template arguments, registers and spills."""
    name = "?"
    for line in output.splitlines():
        m = re.search(r"Compiling entry function '.*?kernelI(.*?)EEvP", line)
        if m:
            name = m.group(1)
        elif "Used" in line or "spill" in line:
            yield f"ptxas {name}: {line.split(':', 1)[-1].strip()}"


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(torch, fn, iters: int, spin_cycles: int = 50_000_000):
    """(mean device time of ``fn()`` per call, the host's time to issue the
    ``iters`` calls, the spin's time), by CUDA events around ``iters`` calls
    queued behind a spinning kernel: the host issues them all while the card
    spins, so no host gap falls between the two events as long as the issue
    takes less than the spin."""
    fn()
    torch.cuda.synchronize()
    spin0, spin1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    spin0.record()
    torch.cuda._sleep(spin_cycles)
    spin1.record()
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    issue_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, issue_ms, spin0.elapsed_time(spin1)


def device_ms(torch, fn, iters: int) -> float | None:
    """Mean device time of ``fn()`` per call, summed over the kernels it
    launches, from ``torch.profiler``: unlike ``cuda_ms`` it leaves out the
    gaps in which the device waits for the host to issue the next call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in kernels)
    return total_us / 1e3 / iters if total_us > 0 else None  # None: no CUPTI trace


def check_close(name, got, want, tol) -> float:
    """Raises unless |got - want| <= tol elementwise; returns the max error."""
    err = (got.float() - want.float()).abs()
    bad = err > tol
    if bool(bad.any()):
        i = int(bad.flatten().nonzero()[0])
        raise AssertionError(f"{name}: got {float(got.flatten()[i])}, want "
                             f"{float(want.flatten()[i])}, tolerance {float(tol.flatten()[i])}")
    return float(err.max())


def gather_bound(torch, img, x, n_out, backward: bool):
    """(bound_ms, bound_by, bytes, ops) of K5 or K6 on these inputs: each
    input read once and each output written once, over the HBM rate, against
    the fp32 operations over the fp32 rate. K5 reads img, x, y and writes
    out; K6 reads img, g, x, y and writes d_img, d_x, d_y. Operations per
    output element: K5 three lerps of 3; K6 7 for each coordinate term and a
    multiply and an add into each of the 4 taps of d_img."""
    esz = img.element_size()
    coords = 2 * x.numel() * 4
    if backward:
        moved = 2 * img.numel() * esz + n_out * esz + 2 * coords
        ops = 22 * n_out
    else:
        moved = img.numel() * esz + coords + n_out * esz
        ops = 9 * n_out
    bytes_ms = moved / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_FP32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), moved, ops


def synthetic_batch(np, B, seed):
    """B items of the synthetic SH corpus (128^2, seq_len 25) from ``seed``."""
    from kmunet_tpu_torch.data import SyntheticNowcastDataset

    data = SyntheticNowcastDataset(length=B, img_size=128, seq_len=25, seed=seed)
    return np.stack([data[i] for i in range(B)])


def sh_config(B, dtype, drop_path=0.1, img_size=128, seq_len=25, out_frames=20):
    """The bench's SH train recipe (hybrid loss, AdamW, per-epoch cosine;
    128^2, seq_len 25, 5 -> 20) at batch B in compute ``dtype``."""
    from kmunet_tpu_torch.configs import shanghai_km_unet

    cfg = shanghai_km_unet()
    cfg.data.img_size, cfg.data.batch_size = img_size, B
    cfg.data.seq_len, cfg.data.out_frames = seq_len, out_frames
    cfg.model.num_classes = out_frames
    cfg.train.compute_dtype = dtype
    cfg.model.extra["drop_path"] = drop_path
    return cfg


def trajgru_config(B, dtype, img_size=128, seq_len=25, out_frames=20):
    """The ("trajgru", "pic") recipe (Adam lr 1e-4, weighted_mse_mae over
    the thresholds 20/30/35/40, MultiStepLR) on the SH data config (128^2,
    seq_len 25, 5 -> 20) at batch B in compute ``dtype``."""
    from kmunet_tpu_torch.configs import shanghai_km_unet
    from kmunet_tpu_torch.train.recipes import apply_recipe

    cfg = apply_recipe(shanghai_km_unet(), "trajgru", "pic")
    cfg.data.img_size, cfg.data.batch_size = img_size, B
    cfg.data.seq_len, cfg.data.out_frames = seq_len, out_frames
    cfg.model.num_classes = out_frames
    cfg.train.compute_dtype = dtype
    return cfg


def flow_convs(model):
    """The flow conv of each TrajGRU cell of ``model``, in the order of the
    forward."""
    from kmunet_tpu_torch.models.ef import TrajGRUCell

    return [m.flows_conv for m in model.modules() if isinstance(m, TrajGRUCell)]


def scale_flows(model, factor):
    """Multiplies each TrajGRU cell's flows (its flow conv's weight and
    bias) by ``factor``: the seeded init's flows are about 0.1 px."""
    import torch

    with torch.no_grad():
        for m in flow_convs(model):
            m.weight.mul_(factor)
            m.bias.mul_(factor)


def largest_flows(torch, model, frames):
    """The largest |flow| (px) of each TrajGRU cell of ``model`` on ``frames``."""
    seen = {}
    convs = flow_convs(model)
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, i=i: seen.__setitem__(i, max(seen.get(i, 0.0),
                                                            float(out.abs().max()))))
        for i, m in enumerate(convs)]
    with torch.inference_mode():
        model(frames)
    for h in hooks:
        h.remove()
    return [seen[i] for i in range(len(convs))]


def reach_flows(torch, model, frames, reach):
    """Scales each TrajGRU cell's flow conv, in the order of the forward, so
    that its largest |flow| on ``frames`` is ``reach`` px (as
    ``reach_offsets`` does for DySample); returns the largest flows before
    and after."""
    before = largest_flows(torch, model, frames)
    for i, m in enumerate(flow_convs(model)):
        factor = reach / largest_flows(torch, model, frames)[i]
        with torch.no_grad():
            m.weight.mul_(factor)
            m.bias.mul_(factor)
    return before, largest_flows(torch, model, frames)


def train_setup(cfg, device, seed=0, dysample_window=True, flow_scale=1.0):
    """(model, state, step, tx) of ``cfg`` with weights from ``seed``, on
    DySample's window path or (``dysample_window=False``) its exact path; a
    TrajGRU's flows multiplied by ``flow_scale``."""
    from kmunet_tpu_torch.train import engine

    model = engine.build_model(cfg, dysample_window=dysample_window)
    tx = engine.build_optimizer(cfg, steps_per_epoch=100)
    state = engine.init_state(cfg, model, tx, seed=seed, device=device)
    if flow_scale != 1.0:
        scale_flows(model, flow_scale)
    return model, state, engine.make_train_step(model, engine.build_loss(cfg), tx, cfg), tx


def step_gradients(cfg, device, batch, seed=0, dysample_window=True, flow_scale=1.0):
    """One train step of ``cfg`` on ``device`` from weights made from
    ``seed``: (loss, grad norm, {name: gradient}), the gradients read on the
    CPU where the optimizer takes them, so they are the ones the step
    applied."""
    _, state, step, tx = train_setup(cfg, device, seed, dysample_window, flow_scale)
    seen = []
    update = tx.update
    tx.update = lambda grads, st, params: seen.append([g.cpu() for g in grads]) or update(
        grads, st, params)
    _, m = step(state, batch)
    return float(m["loss"]), float(m["grad_norm"]), dict(zip(state.params, seen[0]))


def float64_gradients(cfg, batch, seed=0, flow_scale=1.0):
    """The exact reference of ``step_gradients(cfg, "cuda", batch, seed,
    flow_scale=flow_scale)``: (loss, grad norm, {name: gradient}) of the same
    loss from the same weights, computed in float64 on the CPU."""
    import torch

    from kmunet_tpu_torch.train import engine

    model, _, _, _ = train_setup(cfg, "cpu", seed, flow_scale=flow_scale)
    model.double()
    layout = engine._model_layout(cfg)
    inp, tgt = engine._split_batch(torch.as_tensor(batch, dtype=torch.float64),
                                   cfg.data.in_frames, cfg.data.out_frames, layout)
    loss = engine.build_loss(cfg)(engine._to_btHW(model(inp), layout), tgt)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True,
                                materialize_grads=True)
    norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
    return float(loss.detach()), float(norm), dict(zip(named, grads))


def compare_steps(card, cpu):
    """Holds a card's ``step_gradients`` to the CPU's: the loss within
    STEP_LOSS_RTOL, the grad norm within STEP_GRAD_NORM_RTOL, every leaf's
    gradient within STEP_LEAF_RTOL of that leaf's largest |gradient| on the
    CPU plus STEP_LEAF_ATOL. Raises if not; returns the readings."""
    (loss_gpu, gn_gpu, g_gpu), (loss_cpu, gn_cpu, g_cpu) = card, cpu
    loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    gn_rel = abs(gn_gpu - gn_cpu) / gn_cpu
    leaf_ratio, worst = 0.0, ""
    for k, want in g_cpu.items():
        err = float((g_gpu[k] - want).abs().max())
        ratio = err / (STEP_LEAF_RTOL * float(want.abs().max()) + STEP_LEAF_ATOL)
        if ratio > leaf_ratio:
            leaf_ratio, worst = ratio, k
    readings = {"loss": [loss_gpu, loss_cpu], "grad_norm": [gn_gpu, gn_cpu], "loss_rel": loss_rel,
                "grad_norm_rel": gn_rel, "worst_leaf": worst, "worst_leaf_share_of_tol": leaf_ratio}
    if loss_rel > STEP_LOSS_RTOL or gn_rel > STEP_GRAD_NORM_RTOL or leaf_ratio > 1.0:
        raise AssertionError(f"card vs CPU fp32 step: {readings}")
    return readings


def grouped_case_inputs(np, rng, shape):
    """img (B, H, W, C), an upstream gradient (B, Ho, Wo, C) and the named
    coordinate cases, each (x, y) of (B, G, Ho, Wo) with every group on its
    own draw, numpy fp32."""
    B, H, W, C, G, Ho, Wo = shape
    img = rng.normal(size=(B, H, W, C)).astype(np.float32)
    g = rng.normal(size=(B, Ho, Wo, C)).astype(np.float32)
    cases = {name: (x.reshape(B, G, Ho, Wo), y.reshape(B, G, Ho, Wo)) for name, (x, y)
             in coordinate_cases(rng, B * G, H, W, Ho, Wo).items()}
    return img, g, cases


def shifted_views(torch, img, shifts):
    """What K7 returns at integer coordinates x = j - dx_l, y = i - dy_l for
    the (dy_l, dx_l) in ``shifts``: view l is ``img`` (B, H, W, C) shifted by
    (dy_l, dx_l), zeros where it leaves the image -> (B, H, W, L*C); and
    those coordinates, (B, L, H, W) fp32 each."""
    B, H, W, C = img.shape
    views, xs, ys = [], [], []
    jj = torch.arange(W, device=img.device, dtype=torch.float32).view(1, W)
    ii = torch.arange(H, device=img.device, dtype=torch.float32).view(H, 1)
    for dy, dx in shifts:
        out = torch.zeros_like(img)
        out[:, max(dy, 0):H + min(dy, 0), max(dx, 0):W + min(dx, 0)] = img[
            :, max(-dy, 0):H - max(dy, 0), max(-dx, 0):W - max(dx, 0)]
        views.append(out)
        xs.append((jj - dx).expand(H, W))
        ys.append((ii - dy).expand(H, W))
    stack = lambda t: torch.stack(t).expand(B, -1, -1, -1).contiguous()  # noqa: E731
    return torch.cat(views, -1), stack(xs), stack(ys)


def expect_launches(path, launches, want):
    """Raises unless every kernel launched as often as ``want`` says on
    ``path``."""
    if launches != want:
        raise AssertionError(f"{path}: launches {launches}, want {want}")


def largest_offsets(torch, model, frames):
    """The largest |offset| (px) of each DySample of ``model`` on ``frames``."""
    from kmunet_tpu_torch.nn.resample import DySample

    seen = []
    hooks = [m.offset.register_forward_hook(
        lambda mod, inp, out: seen.append(float(out.abs().max()) * 0.25))
        for m in model.modules() if isinstance(m, DySample)]
    with torch.inference_mode():
        model(frames)
    for h in hooks:
        h.remove()
    return seen


def reach_offsets(torch, model, frames, reach):
    """Scales each DySample's offset conv (weight and bias), in the order of
    the forward, so that its largest |offset| on ``frames`` is ``reach`` px
    (the offset is linear in the conv's parameters, and each DySample sees
    the ones before it already scaled); returns the largest offsets before
    and after."""
    from kmunet_tpu_torch.nn.resample import DySample

    before = largest_offsets(torch, model, frames)
    for i, m in enumerate(m for m in model.modules() if isinstance(m, DySample)):
        factor = reach / largest_offsets(torch, model, frames)[i]
        with torch.no_grad():
            m.offset.weight.mul_(factor)
            m.offset.bias.mul_(factor)
    return before, largest_offsets(torch, model, frames)


def main() -> int:
    faulthandler.dump_traceback_later(DEADLINE_S, exit=True)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from concurrent.futures import ThreadPoolExecutor

    import torch.nn.functional as F

    from kmunet_tpu_torch import serve
    from kmunet_tpu_torch.kernels import bilinear, build

    kernels = {"bilinear_gather": bilinear.bilinear_gather,
               "bilinear_gather_backward": bilinear.bilinear_gather_backward,
               "bilinear_gather_grouped": bilinear.bilinear_gather_grouped,
               "bilinear_gather_grouped_backward": bilinear.bilinear_gather_grouped_backward,
               "bilinear_gather_multiview": bilinear.bilinear_gather_multiview,
               "bilinear_gather_multiview_backward": bilinear.bilinear_gather_multiview_backward}

    def launches_per(k5=0, k6=0, k4=0, k6g=0, k7=0, k6s=0):
        return {"bilinear_gather": k5, "bilinear_gather_backward": k6,
                "bilinear_gather_grouped": k4, "bilinear_gather_grouped_backward": k6g,
                "bilinear_gather_multiview": k7, "bilinear_gather_multiview_backward": k6s}

    def reset_counts():
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        return {name: k.launches for name, k in kernels.items()}

    with Phase("device") as f:
        kind = torch.cuda.get_device_name(0)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
        card = smi.stdout.strip().splitlines()[0]
        f.update(kind=kind, count=torch.cuda.device_count(), nvidia_smi=card,
                 torch=torch.__version__, cuda=torch.version.cuda)
    print(card, flush=True)

    with Phase("build") as f:
        sources = (bilinear.SOURCE, bilinear.BACKWARD_SOURCE)
        with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc each, started together
            builds = list(pool.map(build.build, sources))
        for entry in (bilinear.forward_kernel, bilinear.backward_kernel,
                      bilinear.grouped_kernel, bilinear.grouped_backward_kernel,
                      bilinear.multiview_kernel, bilinear.multiview_backward_kernel):
            entry()
        f.update(sources=[K5_SOURCE, K6_SOURCE],
                 libraries=[os.path.relpath(b.path, REPO) for b in builds],
                 nvcc_seconds=[round(b.seconds, 3) for b in builds])
    for source, built in zip(sources, builds):
        for line in ptxas_summary(built.compiler_output):
            print(f"{source} {line}", flush=True)

    dev = torch.device("cuda")

    def check_kernels(names, ops, img32, x, y, g32, key, errors_f, errors_b):
        """Holds a gather kernel and its backward, ``ops`` = (forward,
        backward, forward_plain, backward_plain), to the plain versions at
        fp32/bf16/fp16 in ``mode``; records the worst errors under ``key``."""
        forward, backward, forward_plain, backward_plain = ops
        mode = key.split("/")[-1]
        # fp32: the kernel against the plain version. bf16/fp16: against the
        # kernel's own fp32 result on the same (rounded) inputs, so that only
        # the output rounding differs.
        ref = forward_plain(img32, x, y, mode)
        ref_b = backward_plain(img32, x, y, g32, mode)
        # Sum of |terms| of each d_img element (the tap weights are >= 0):
        # many outputs may land on one pixel.
        term_sums = backward_plain(img32, x, y, g32.abs(), mode)[0]
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            img, g = img32.to(dtype), g32.to(dtype)
            k = f"{key}/{str(dtype)[6:]}"
            got = forward(img, x, y, mode).float()
            if dtype == torch.float32:
                want, tol = ref, torch.full_like(ref, 1e-5)
            else:
                want = forward(img.float(), x, y, mode)
                tol = ulp_tolerance(torch, want, dtype)
            errors_f[k] = check_close(f"{names[0]} {k}", got, want, tol)
            # The backward: atomics and warp sums add in another order.
            got_b = backward(img, x, y, g, mode)
            want_b = ref_b if dtype == torch.float32 else backward(img.float(), x, y,
                                                                    g.float(), mode)
            errs = []
            for name, a, b in zip(("d_img", "d_x", "d_y"), got_b, want_b):
                tol = 1e-5 + 1e-5 * b.abs()
                if name == "d_img":
                    tol = tol + 1e-6 * term_sums
                    if dtype != torch.float32:
                        tol = tol + ulp_tolerance(torch, b, dtype)
                errs.append(check_close(f"{names[1]} {k} {name}", a, b, tol))
            errors_b[k] = max(errs)

    errors, k6_errors, k4_errors, k6g_errors, k7_errors, k6s_errors = {}, {}, {}, {}, {}, {}
    with Phase("kernel") as f:
        rng = np.random.default_rng(0)
        plain_ops = (bilinear.bilinear_gather_forward, bilinear.bilinear_gather_backward,
                     bilinear.bilinear_gather_plain, bilinear.bilinear_gather_backward_plain)
        for shape_name, (B, H, W, C), (Ho, Wo) in (("bridge", BRIDGE, BRIDGE[1:3]),
                                                   ("ragged", RAGGED, (RAGGED[1] + 1, RAGGED[2] - 2)),
                                                   ("odd", ODD, (ODD[1] - 1, ODD[2] + 2))):
            img32 = torch.from_numpy(rng.normal(size=(B, H, W, C)).astype(np.float32)).to(dev)
            g32 = torch.from_numpy(rng.normal(size=(B, Ho, Wo, C)).astype(np.float32)).to(dev)
            for case, (x, y) in coordinate_cases(rng, B, H, W, Ho, Wo).items():
                x, y = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
                for mode in ("zeros", "border"):
                    check_kernels(("K5", "K6"), plain_ops, img32, x, y, g32,
                                  f"{shape_name}/{case}/{mode}", errors, k6_errors)
        grouped_ops = (bilinear.bilinear_gather_grouped_forward,
                       bilinear.bilinear_gather_grouped_backward,
                       bilinear.bilinear_gather_grouped_plain,
                       bilinear.bilinear_gather_grouped_backward_plain)
        for shape_name, shape in GROUPED_SHAPES.items():
            img, g, coords = grouped_case_inputs(np, rng, shape)
            img32, g32 = torch.from_numpy(img).to(dev), torch.from_numpy(g).to(dev)
            for case, (x, y) in coords.items():
                x, y = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
                for mode in ("zeros", "border"):
                    check_kernels(("K4", "K6 grouped"), grouped_ops, img32, x, y, g32,
                                  f"{shape_name}/{case}/{mode}", k4_errors, k6g_errors)
        multiview_ops = (bilinear.bilinear_gather_multiview_forward,
                         bilinear.bilinear_gather_multiview_backward,
                         bilinear.bilinear_gather_multiview_plain,
                         bilinear.bilinear_gather_multiview_backward_plain)
        for shape_name, (B, H, W, C, G, Ho, Wo) in MULTIVIEW_SHAPES.items():
            # grouped_case_inputs draws a (B, Ho, Wo, C) gradient: K7's has G*C channels.
            img, _, coords = grouped_case_inputs(np, rng, (B, H, W, C, G, Ho, Wo))
            g = rng.normal(size=(B, Ho, Wo, G * C)).astype(np.float32)
            img32, g32 = torch.from_numpy(img).to(dev), torch.from_numpy(g).to(dev)
            for case, (x, y) in coords.items():
                x, y = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
                for mode in ("zeros", "border"):
                    check_kernels(("K7", "K6 shared"), multiview_ops, img32, x, y, g32,
                                  f"{shape_name}/{case}/{mode}", k7_errors, k6s_errors)
        # The view-block layout: view l at integer coordinates is the source
        # shifted, exactly (the taps' weights are 0 and 1).
        img32 = torch.from_numpy(rng.normal(size=(2, 6, 7, 16)).astype(np.float32)).to(dev)
        want, x, y = shifted_views(torch, img32, [(0, 0), (1, 0), (0, -2), (-1, 3), (2, 2)])
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            got = bilinear.bilinear_gather_multiview_forward(img32.to(dtype), x, y, "zeros")
            if not torch.equal(got, want.to(dtype)):
                raise AssertionError(f"K7 layout {dtype}: view l is not the source shifted")
        torch.cuda.synchronize()
        f.update(cases=len(errors) + len(k4_errors) + len(k7_errors), k5_max_abs_err=errors,
                 k6_max_abs_err=k6_errors, k4_max_abs_err=k4_errors,
                 k6_grouped_max_abs_err=k6g_errors, k7_max_abs_err=k7_errors,
                 k6_shared_max_abs_err=k6s_errors, k7_layout="exact")

    def serve_path(path, window, f):
        """Serves REQUESTS fp32 requests of B=2 on the card with
        ``dysample_window=window``, counting launches, and holds the answers
        to the same weights on the CPU."""
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        model = serve.build_km_unet_v3_sh(device="cuda", dtype=torch.float32, seed=0,
                                          dysample_window=window)
        requests = [rng.uniform(size=(REQUEST_BATCH, 128, 128, 5)).astype(np.float32)
                    for _ in range(REQUESTS)]
        if not window:  # seeded offsets are ~1e-3 px: make them reach OFFSET_REACH_PX
            offsets = reach_offsets(torch, model, torch.from_numpy(requests[0]).to(dev),
                                    OFFSET_REACH_PX)
            f.update(largest_offset_px_seeded=offsets[0], largest_offset_px=offsets[1])
        reset_counts()
        answers = [serve.predict(model, frames) for frames in requests]
        launches = path_launches[path] = read_counts()
        expect_launches(path, launches, launches_per(k5=TAPS * REQUESTS,
                                                     k4=0 if window else DYSAMPLES * REQUESTS))
        model_cpu = serve.build_km_unet_v3_sh(device="cpu", dtype=torch.float32, seed=0,
                                              dysample_window=window)
        model_cpu.load_state_dict(model.state_dict())
        slice_err = 0.0
        for frames, answer in zip(requests, answers):
            if tuple(answer.shape) != (REQUEST_BATCH, 128, 128, 20):
                raise AssertionError(f"answer shape {tuple(answer.shape)}")
            if not bool(torch.isfinite(answer).all()):
                raise AssertionError("answer has non-finite values")
            want = serve.predict(model_cpu, frames)
            slice_err = max(slice_err, float((answer.cpu() - want).abs().max()))
        if slice_err > 1e-4:
            raise AssertionError(f"{path}: card vs CPU forward: max abs err {slice_err} > 1e-4")
        f.update(requests=REQUESTS, batch=REQUEST_BATCH, launches=launches,
                 max_abs_err_vs_cpu=slice_err, tf32=False)

    def train_path(path, window, f):
        """TRAIN_STEPS bf16 steps of B=16 on the card with
        ``dysample_window=window``, counting launches, then one fp32 B=2 step
        against the CPU's."""
        # The bench's step: full width, 128^2, B=16, bf16 compute, 3 steps.
        batch = torch.from_numpy(synthetic_batch(np, TRAIN_BATCH, seed=0)).to(dev)
        model, state, step, _ = train_setup(sh_config(TRAIN_BATCH, "bfloat16"), "cuda",
                                            dysample_window=window)
        before = [p.detach().clone() for p in state.params.values()]
        gen = torch.Generator(device=dev).manual_seed(0)
        reset_counts()
        metrics = [step(state, batch, gen)[1] for _ in range(TRAIN_STEPS)]
        launches = path_launches[path] = read_counts()
        grouped = 0 if window else DYSAMPLES * TRAIN_STEPS
        expect_launches(path, launches, launches_per(
            k5=TAPS * TRAIN_STEPS, k6=TAPS * TRAIN_STEPS, k4=grouped, k6g=grouped))
        losses = [float(m["loss"]) for m in metrics]
        grad_norms = [float(m["grad_norm"]) for m in metrics]
        if not np.isfinite(losses + grad_norms).all():
            raise AssertionError(f"non-finite train step: losses {losses}, grad norms {grad_norms}")
        moved = max(float((p.detach() - b).abs().max()) for p, b in zip(state.params.values(), before))
        if not moved > 0.0:
            raise AssertionError("the parameters did not move")
        del model, state, step, before, batch

        # One fp32 step on the card against the same step on the CPU, with no
        # stochastic depth: the two devices' generators draw differently.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        batch = synthetic_batch(np, CHECK_BATCH, seed=1)
        cfg = sh_config(CHECK_BATCH, "float32", drop_path=0.0)
        runs = {device: step_gradients(cfg, device, batch, dysample_window=window)
                for device in ("cuda", "cpu")}
        check = compare_steps(runs["cuda"], runs["cpu"])
        f.update(batch=TRAIN_BATCH, compute="bfloat16", steps=TRAIN_STEPS, losses=losses,
                 grad_norms=grad_norms, launches=launches, max_param_change=moved,
                 check_batch=CHECK_BATCH, check=check, tf32=False)

    path_launches = {}
    with Phase("slice") as f:
        serve_path("serve", True, f)
    with Phase("slice_exact") as f:
        serve_path("serve_exact", False, f)
    with Phase("train") as f:
        train_path("train", True, f)
    with Phase("train_exact") as f:
        train_path("train_exact", False, f)

    with Phase("serve_trajgru") as f:
        # REQUESTS fp32 requests of B=2 on the card, TF32 off, held to the
        # same weights on the CPU.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        model = serve.build_zoo_model("trajgru", device="cuda", dtype=torch.float32, seed=0)
        requests = [rng.uniform(size=(REQUEST_BATCH, 5, 128, 128)).astype(np.float32)
                    for _ in range(REQUESTS)]
        flows = reach_flows(torch, model, torch.from_numpy(requests[0]).to(dev), FLOW_REACH_PX)
        reset_counts()
        answers = [serve.predict(model, frames) for frames in requests]
        launches = path_launches["serve_trajgru"] = read_counts()
        expect_launches("serve_trajgru", launches, launches_per(k7=TRAJGRU_WARPS * REQUESTS))
        model_cpu = serve.build_zoo_model("trajgru", device="cpu", dtype=torch.float32, seed=0)
        model_cpu.load_state_dict(model.state_dict())
        err, scale = 0.0, 0.0
        for frames, answer in zip(requests, answers):
            if tuple(answer.shape) != (REQUEST_BATCH, 20, 128, 128):
                raise AssertionError(f"trajgru answer shape {tuple(answer.shape)}")
            if not bool(torch.isfinite(answer).all()):
                raise AssertionError("trajgru answer has non-finite values")
            err = max(err, float((answer.cpu() - serve.predict(model_cpu, frames)).abs().max()))
            scale = max(scale, float(answer.abs().max()))
        # The seeded model's answers are about 1e-2: besides 1e-4 abs, hold
        # the error to 1e-5 of the largest answer.
        if err > min(1e-4, 1e-5 * scale):
            raise AssertionError(f"serve_trajgru: card vs CPU forward: max abs err {err} > "
                                 f"min(1e-4, 1e-5 * {scale})")
        f.update(requests=REQUESTS, batch=REQUEST_BATCH, largest_flow_px_seeded=flows[0],
                 largest_flow_px=flows[1], launches=launches, max_abs_err_vs_cpu=err,
                 answer_max_abs=scale, tf32=False)
        del model, model_cpu, answers

    with Phase("train_trajgru") as f:
        # One fp32 step of the recipe on the card, TF32 off, against the
        # same gradient in float64 on the CPU.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        batch = synthetic_batch(np, CHECK_BATCH, seed=2)
        cfg = trajgru_config(CHECK_BATCH, "float32")
        reset_counts()
        card = step_gradients(cfg, "cuda", batch, flow_scale=FLOW_SCALE)
        launches = path_launches["train_trajgru"] = read_counts()
        expect_launches("train_trajgru", launches,
                        launches_per(k7=TRAJGRU_WARPS, k6s=TRAJGRU_WARPS))
        check = compare_steps(card, float64_gradients(cfg, batch, flow_scale=FLOW_SCALE))
        f.update(batch=CHECK_BATCH, compute="float32", reference="float64 on the CPU",
                 flow_scale=FLOW_SCALE, launches=launches, check=check, tf32=False)

    def time_kernel(kernel, plain, library, img, x, n_out, backward, iters, plain_iters):
        """A kernel's numbers beside its bound, its plain version and the
        library call on the same inputs: ms by CUDA events over back-to-back
        calls, queued ms by CUDA events over calls queued behind a spin,
        device ms by the profiler."""
        bound, bound_by, moved, ops = gather_bound(torch, img, x, n_out, backward)
        queued = queued_ms(torch, kernel, min(iters, 50))
        library_queued = queued_ms(torch, library, min(iters, 50))
        return {"ms": cuda_ms(torch, kernel, iters, 10),
                "queued_ms": queued[0], "library_queued_ms": library_queued[0],
                "queued_issue_ms": [queued[1], library_queued[1]],
                "queued_spin_ms": [queued[2], library_queued[2]],
                "plain_ms": cuda_ms(torch, plain, plain_iters),
                "library_ms": cuda_ms(torch, library, iters, 10),
                "device_ms": device_ms(torch, kernel, min(iters, 50)),
                "plain_device_ms": device_ms(torch, plain, plain_iters),
                "library_device_ms": device_ms(torch, library, min(iters, 50)),
                "bound_ms": bound, "bound_by": bound_by, "bytes": moved, "ops": ops}

    with Phase("timing") as f:
        torch.backends.cudnn.allow_tf32 = True  # PyTorch's defaults
        torch.backends.cuda.matmul.allow_tf32 = False
        forward = {}
        for B, dtype, iters, window in ((128, torch.bfloat16, 5, True),
                                        (128, torch.bfloat16, 5, False),
                                        (8, torch.float32, 10, True)):
            model = serve.build_km_unet_v3_sh(device="cuda", dtype=dtype, seed=0,
                                              dysample_window=window)
            frames = torch.rand(B, 128, 128, 5, device=dev).to(dtype)
            out = serve.predict(model, frames)
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"B={B} {dtype} forward has non-finite values")
            ms = cuda_ms(torch, lambda: serve.predict(model, frames), iters)
            key = f"B{B}_{str(dtype)[6:]}" + ("" if window else "_exact")
            forward[key] = {"ms": ms, "frames_per_s": B * 20 / (ms / 1e3)}
            del model, frames, out

        train = {}
        for B, window in ((16, True), (16, False), (32, True), (32, False)):
            model, state, step, _ = train_setup(sh_config(B, "bfloat16"), "cuda",
                                                dysample_window=window)
            batch = torch.rand(B, 25, 128, 128, device=dev)
            gen = torch.Generator(device=dev).manual_seed(1)
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(torch, lambda: step(state, batch, gen), 5)
            train[f"B{B}_bfloat16" + ("" if window else "_exact")] = {
                "ms": ms, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
            del model, state, step, batch

        # K5 and K6 at the bridge shape, zeros mode, a deformable tap's
        # coordinates (grid + N(0, 1)).
        B, H, W, C = BRIDGE
        img = torch.randn(B, H, W, C, device=dev).to(torch.bfloat16)
        ii = torch.arange(H, device=dev, dtype=torch.float32).view(1, H, 1)
        jj = torch.arange(W, device=dev, dtype=torch.float32).view(1, 1, W)
        y = (ii + torch.randn(B, H, W, device=dev)).contiguous()
        x = (jj + torch.randn(B, H, W, device=dev)).contiguous()
        g = torch.randn(B, H, W, C, device=dev).to(torch.bfloat16)
        grid = torch.stack([x / (W - 1) * 2 - 1, y / (H - 1) * 2 - 1], dim=-1).to(img.dtype)
        img_nchw = img.permute(0, 3, 1, 2)  # the same NHWC memory, as an NCHW view
        g_nchw = g.permute(0, 3, 1, 2)
        k5 = lambda: bilinear.bilinear_gather_forward(img, x, y, "zeros")  # noqa: E731
        timed = {"bilinear_gather": time_kernel(
            k5, lambda: bilinear.bilinear_gather_plain(img, x, y, "zeros"),
            lambda: F.grid_sample(img_nchw, grid, mode="bilinear", padding_mode="zeros",
                                  align_corners=True),
            img, x, B * H * W * C, False, 200, 20)}
        timed["bilinear_gather"]["library_max_abs_diff"] = float((F.grid_sample(
            img_nchw, grid, mode="bilinear", padding_mode="zeros", align_corners=True).permute(
                0, 2, 3, 1).float() - k5().float()).abs().max())
        timed["bilinear_gather_backward"] = time_kernel(
            lambda: bilinear.bilinear_gather_backward(img, x, y, g, "zeros"),
            lambda: bilinear.bilinear_gather_backward_plain(img, x, y, g, "zeros"),
            # bilinear (0), zeros padding (0), align_corners
            lambda: torch.ops.aten.grid_sampler_2d_backward(g_nchw, img_nchw, grid, 0, 0, True,
                                                            [True, True]),
            img, x, B * H * W * C, True, 200, 20)
        del img, x, y, g, grid, img_nchw, g_nchw

        # K4 and K6's grouped entry at DySample's dec3 shape, border mode, at
        # DySample-like coordinates (the 2x subpixel grid + N(0, 0.5) px).
        B, H, W, C, G, Ho, Wo = DEC3
        Cg = C // G
        img = torch.randn(B, H, W, C, device=dev).to(torch.bfloat16)
        sub_y = ((torch.arange(Ho, device=dev) + 0.5) / 2 - 0.5).view(1, 1, Ho, 1)
        sub_x = ((torch.arange(Wo, device=dev) + 0.5) / 2 - 0.5).view(1, 1, 1, Wo)
        y = (sub_y + 0.5 * torch.randn(B, G, Ho, Wo, device=dev)).contiguous()
        x = (sub_x + 0.5 * torch.randn(B, G, Ho, Wo, device=dev)).contiguous()
        g = torch.randn(B, Ho, Wo, C, device=dev).to(torch.bfloat16)
        # The library takes the groups folded into the batch, NCHW: these
        # layout copies are made here, outside the timed calls.
        img_lib = img.view(B, H, W, G, Cg).permute(0, 3, 4, 1, 2).reshape(B * G, Cg, H, W)
        g_lib = g.view(B, Ho, Wo, G, Cg).permute(0, 3, 4, 1, 2).reshape(B * G, Cg, Ho, Wo)
        grid = torch.stack([(x + 0.5) * 2 / W - 1, (y + 0.5) * 2 / H - 1], dim=-1).reshape(
            B * G, Ho, Wo, 2).to(img.dtype)
        k4 = lambda: bilinear.bilinear_gather_grouped_forward(img, x, y, "border")  # noqa: E731

        def library_grouped():
            return F.grid_sample(img_lib, grid, mode="bilinear", padding_mode="border",
                                 align_corners=False)

        timed["bilinear_gather_grouped"] = time_kernel(
            k4, lambda: bilinear.bilinear_gather_grouped_plain(img, x, y, "border"),
            library_grouped, img, x, B * Ho * Wo * C, False, 100, 5)
        timed["bilinear_gather_grouped"]["library_max_abs_diff"] = float((
            library_grouped().view(B, G, Cg, Ho, Wo).permute(0, 3, 4, 1, 2).reshape(
                B, Ho, Wo, C).float() - k4().float()).abs().max())
        timed["bilinear_gather_grouped_backward"] = time_kernel(
            lambda: bilinear.bilinear_gather_grouped_backward(img, x, y, g, "border"),
            lambda: bilinear.bilinear_gather_grouped_backward_plain(img, x, y, g, "border"),
            # bilinear (0), border padding (1), align_corners=False
            lambda: torch.ops.aten.grid_sampler_2d_backward(g_lib, img_lib, grid, 0, 1, False,
                                                            [True, True]),
            img, x, B * Ho * Wo * C, True, 20, 3)
        del img, x, y, g, grid, img_lib, g_lib

        # TrajGRU: the forward and the recipe's step at B=16 bf16.
        model = serve.build_zoo_model("trajgru", device="cuda", dtype=torch.bfloat16, seed=0)
        frames = torch.rand(TRAJGRU_BATCH, 5, 128, 128, device=dev).to(torch.bfloat16)
        out = serve.predict(model, frames)
        if not bool(torch.isfinite(out).all()):
            raise AssertionError("TrajGRU B=16 bf16 forward has non-finite values")
        ms = cuda_ms(torch, lambda: serve.predict(model, frames), 5)
        forward[f"trajgru_B{TRAJGRU_BATCH}_bfloat16"] = {
            "ms": ms, "frames_per_s": TRAJGRU_BATCH * 20 / (ms / 1e3)}
        del model, frames, out
        model, state, step, _ = train_setup(trajgru_config(TRAJGRU_BATCH, "bfloat16"), "cuda")
        batch = torch.from_numpy(synthetic_batch(np, TRAJGRU_BATCH, seed=3)).to(dev)
        torch.cuda.reset_peak_memory_stats()
        losses = []
        ms = cuda_ms(torch, lambda: losses.append(step(state, batch)[1]["loss"]), 5)
        if not all(bool(torch.isfinite(v)) for v in losses):
            raise AssertionError("TrajGRU B=16 bf16 step has a non-finite loss")
        train[f"trajgru_B{TRAJGRU_BATCH}_bfloat16"] = {
            "ms": ms, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del model, state, step, batch

        # K7 and K6's shared-source entry at enc_rnn1's shape, zeros mode, at
        # TrajGRU-like coordinates (the grid - N(0, 1) px flows).
        B, H, W, C, G, Ho, Wo = RNN1
        img = torch.randn(B, H, W, C, device=dev).to(torch.bfloat16)
        ii = torch.arange(Ho, device=dev, dtype=torch.float32).view(1, 1, Ho, 1)
        jj = torch.arange(Wo, device=dev, dtype=torch.float32).view(1, 1, 1, Wo)
        y = (ii - torch.randn(B, G, Ho, Wo, device=dev)).contiguous()
        x = (jj - torch.randn(B, G, Ho, Wo, device=dev)).contiguous()
        g = torch.randn(B, Ho, Wo, G * C, device=dev).to(torch.bfloat16)
        # The library takes the source broadcast into the batch, NCHW, and
        # returns the views batch-major: these copies are made here.
        img_lib = img.permute(0, 3, 1, 2)[:, None].expand(B, G, C, H, W).reshape(B * G, C, H, W)
        g_lib = g.view(B, Ho, Wo, G, C).permute(0, 3, 4, 1, 2).reshape(B * G, C, Ho, Wo)
        grid = torch.stack([x / (W - 1) * 2 - 1, y / (H - 1) * 2 - 1], dim=-1).reshape(
            B * G, Ho, Wo, 2).to(img.dtype)
        k7 = lambda: bilinear.bilinear_gather_multiview_forward(img, x, y, "zeros")  # noqa: E731

        def library_multiview():
            return F.grid_sample(img_lib, grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=True)

        def library_multiview_backward():
            d_img, d_grid = torch.ops.aten.grid_sampler_2d_backward(
                g_lib, img_lib, grid, 0, 0, True, [True, True])  # bilinear, zeros, align_corners
            return d_img.view(B, G, C, H, W).sum(1), d_grid

        timed["bilinear_gather_multiview"] = time_kernel(
            k7, lambda: bilinear.bilinear_gather_multiview_plain(img, x, y, "zeros"),
            library_multiview, img, x, B * Ho * Wo * G * C, False, 100, 5)
        timed["bilinear_gather_multiview"]["library_max_abs_diff"] = float((
            library_multiview().view(B, G, C, Ho, Wo).permute(0, 3, 4, 1, 2).reshape(
                B, Ho, Wo, G * C).float() - k7().float()).abs().max())
        timed["bilinear_gather_multiview_backward"] = time_kernel(
            lambda: bilinear.bilinear_gather_multiview_backward(img, x, y, g, "zeros"),
            lambda: bilinear.bilinear_gather_multiview_backward_plain(img, x, y, g, "zeros"),
            library_multiview_backward, img, x, B * Ho * Wo * G * C, True, 20, 3)
        del img, x, y, g, grid, img_lib, g_lib
        f.update(forward=forward, train_step=train, tf32_conv=True,
                 shapes={"bilinear_gather": list(BRIDGE), "bilinear_gather_backward": list(BRIDGE),
                         "bilinear_gather_grouped": list(DEC3),
                         "bilinear_gather_grouped_backward": list(DEC3),
                         "bilinear_gather_multiview": list(RNN1),
                         "bilinear_gather_multiview_backward": list(RNN1)},
                 dtype="bfloat16", kernels=timed)

    def by_path(name):
        return {path: counts[name] for path, counts in path_launches.items()}

    def worst(errs, dtype):
        return max(v for k, v in errs.items() if k.endswith(dtype))

    line = []
    for name, source, replaces, errs in (
            ("bilinear_gather", K5_SOURCE, K5_REPLACES, errors),
            ("bilinear_gather_backward", K6_SOURCE, K6_REPLACES, k6_errors),
            ("bilinear_gather_grouped", K4_SOURCE, K4_REPLACES, k4_errors),
            ("bilinear_gather_grouped_backward", K6G_SOURCE, K6G_REPLACES, k6g_errors),
            ("bilinear_gather_multiview", K7_SOURCE, K7_REPLACES, k7_errors),
            ("bilinear_gather_multiview_backward", K6S_SOURCE, K6S_REPLACES, k6s_errors)):
        t = timed[name]
        line.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": sum(by_path(name).values()),
                     "launches_by_path": by_path(name),
                     "max_abs_err": worst(errs, "float32"),
                     "max_abs_err_bfloat16": worst(errs, "bfloat16"),
                     "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                     "device_ms": t["device_ms"], "plain_device_ms": t["plain_device_ms"],
                     "library_device_ms": t["library_device_ms"], "queued_ms": t["queued_ms"],
                     "library_queued_ms": t["library_queued_ms"]})
    emit({"kernels": line})
    faulthandler.cancel_dump_traceback_later()
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
