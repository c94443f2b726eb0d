#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``kmunet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line with its seconds:

1. device  -- the card's name; ``nvidia-smi``'s name and power limit line.
2. build   -- ``kmunet_tpu_torch/csrc/bilinear_gather.cu`` (K4, the
              grouped gather), ``csrc/multiview_gather.cu`` (K7, the
              multiview gather, and K5, the gather, as its kernel at G=1),
              ``csrc/bilinear_gather_backward.cu`` (K6, the backward of all
              three), ``csrc/selective_scan.cu`` (K8, the selective scan,
              and its backward), ``csrc/kanconv.cu`` (K1, the fused KAN
              conv), ``csrc/hsmssd.cu`` (K2, the HSM-SSD compress, and
              K3, the fused mixer) and ``csrc/hsmssd_ablate.cu`` (K3a, the
              mixer ablation) built with nvcc for sm_90a, one nvcc each, all
              started together; the ``-Xptxas -v`` reports are printed once.
3. kernel  -- K5 and K6 against their plain PyTorch versions on the card,
              zeros and border modes, fp32/bf16/fp16, at the DAGEM bridge
              shape, a ragged one, one whose C takes no 16-byte vectors and
              one of 16^2 -> 160^2 (K6's bin lists past its shared memory),
              on out-of-range, integer, last-pixel, grid and far-outside
              coordinates. K5: fp32 within 1e-5 abs of the plain version;
              bf16 and fp16 within one ulp of the kernel's fp32 result on
              the same rounded image. K6: fp32 within 1e-5 abs + 1e-5
              relative of the plain version, plus for d_img 1e-6 of the sum
              of its terms' |values| (about 17 fp32 ulps of it: its owner
              pass adds those terms, as many as the outputs that land on the
              pixel, in another order than the plain version, and so do the
              warp sums of d_x and d_y); bf16 and fp16 against the kernel's
              own fp32 result on the same rounded image and gradient: d_img
              within one ulp plus that slack, d_x and d_y (fp32) within the
              slack; and a second call on the same inputs must give bitwise
              equal d_img, d_x and d_y (every entry, shape, case, mode and
              dtype). Then K4 and K6's grouped entry the same way, with the
              same bounds, at DySample's three shapes (dec1/dec2/dec3 at
              B=2, C=64, G=4), a ragged shape of Cg=6, one of Cg=3, G=1, G=8
              and 16^2 -> 160^2, each group on its own draw of the
              coordinate cases. Then K7 and K6's shared-source entry the
              same way, with the same bounds, at TrajGRU's five K7 shapes
              (32^2 C=64 G=13 and G=9, 8^2 C=192 G=13, 4^2 C=192 G=9 and
              G=13, at B=2), the deformable conv's 9 taps at the bridge
              (16^2, C=64, G=9), C=6 and C=3 (one channel per thread in fp32
              and bf16), G=1, G=16 and 16^2 -> 160^2, and at the main
              paths' batches, whose chunks B=2 does not give (enc_rnn1 and
              rnn2 at B=16, the bridge at B=128), each view on its own
              draw of the coordinate cases; and a layout case: at integer
              coordinates x = j - dx_l, y = i - dy_l, K7's channel block l
              must equal the source shifted by (dy_l, dx_l), zeros outside,
              exactly. Then K8 and its backward
              (y and the six gradients) at Mamba-UNet's scan shapes at B=2
              (the refine layers at L=16384 with D=16/32/48, encoder4 at
              L=256, the L=64 and L=16 levels with D=64-128), a ragged L of
              1000, ragged D of 6 and 24, N of 4 and 8, L=1 and L=65 (one
              token past the kernels' 64-token chunk), with A as
              MambaBlock's init makes it and dt as the seeded block makes it,
              small (decay near 1) and large (decay near 0)
              (``SCAN_SHAPES``): fp32 within 4 times the plain version's own
              largest distance from float64 on the same inputs plus 1e-6 of
              the largest |value| (``scan_reference``), bf16 and fp16
              against the plain versions on the same rounded inputs within
              that plus one ulp of the dtype (``check_scan``); beside each,
              the kernels' and the plain version's largest distance from
              the float64 result on the same rounded inputs. Then, with
              TF32 off, K1 at KM_UNetV3-SH's four KAN shapes at B=2,
              KM_UNetV3-LAPS's four at B=1 (256^2 at enc1) and a ragged one
              (``KAN_SHAPES``), x in [-1.2, 1.2], in [-3, 3] and at the
              knots (``check_kanconv``), and K2 and K3 at SH's three mixer
              shapes at B=2, LAPS's three at B=1 (L=65536 at enc1), a
              ragged L=1000 with N=8, L=1 and L=65 (one token past the
              kernels' 64-token tile), dt
              N(0, 1) and 40 N(0, 1), dt, B and C the strided slices of one
              bcdt (``MIXER_SHAPES``, ``check_mixer``): fp32 within 1e-5 abs
              + 1e-5 of the largest |value| of the plain version, bf16 and
              fp16 against the plain version in fp32 on the same rounded
              inputs within that plus one ulp of the dtype (K3's y also
              one ulp of each h2 carried through the scatter); at enc1 and
              LAPS's enc1 beside each, in fp32 and bf16, the kernels' and
              the plain version's largest distance from float64 on the same
              rounded inputs (``mixer_float64_distance``). Then K3a in
              its five modes at the TPU script's shape (B=64, C=16,
              L=16384, N=64, tiles of 4096, bf16), several tiles of 64, C
              != N and one tile (``ABLATE_SHAPES``, ``check_ablate``):
              within one bf16 ulp of the output's scale of the plain
              version on the same inputs.
   k1_float64_distance -- K1 at enc1 in the three x cases, dec1 "wide"
              and LAPS's enc1 "unit" (``KAN_FLOAT64_CASES``): per dtype
              (fp32, bf16) the kernel's and the plain version's largest
              distance from the plain version in float64 on the same
              rounded inputs (``kan_float64_distance``).
4. slice   -- the serving path: KM_UNetV3-SH at full width (embed_dims
              16/32/64, 128^2, 5 -> 20 frames), seeded weights, eval mode,
              built and served through ``kmunet_tpu_torch.serve`` on the card
              for a few requests of B=2 in fp32 with TF32 off. Every kernel's
              launch count is set to 0 just before and read just after; K7
              must launch once per forward (DAGEM's deformable conv, its 9
              taps as the views) and K4 never. Each answer must
              have the shape (2, 128, 128, 20), be finite and match the same
              weights on the CPU (plain gathers) within 1e-4 abs. Then
              ``serve_exact``: the same with ``dysample_window=False``, each
              DySample's offset conv scaled so that its largest offset on
              the first request is 2 px (the seeded init gives about 1e-3
              px); K4 must launch 3 times per forward and K7 once.
5. train   -- the training path, through ``kmunet_tpu_torch.train.engine``:
              the SH recipe (hybrid loss, AdamW, per-epoch cosine) at full
              width, 128^2, seq_len 25, B=16, bf16 compute, takes 3 steps on
              ``SyntheticNowcastDataset`` items from a seed, with the launch
              counts set to 0 just before and read just after: K7 and K6's
              shared-source entry must launch once per step and K4 never,
              every loss must be
              finite and the parameters must move. Then one fp32 step at B=2
              with TF32 off on the card against the same step on the CPU:
              loss within 1e-5 relative, grad norm within 5e-5 relative, and
              every parameter's gradient (the ones the optimizer applied)
              within 1e-3 of that parameter's largest |gradient| plus 1e-6
              abs (the floor of the leaves whose exact gradient is 0, where
              both sides hold rounding noise). ``train_exact`` repeats both
              with ``dysample_window=False``: K4 and K6's grouped entry must
              launch 3 times per step, K7 and K6 shared once. Every SH path
              launches K7 once per forward at G=9 and no SH path K5, K6
              (G=1), K8 or its backward. No phase above launches K1, K2 or
              K3.
   serve_fused -- the serving path with ``kan_fused=True,
              ssd_mixer="fused"``: K1 must launch 4 times per forward (the
              four KAN convs), K3 15 times (the 15 HSM-SSD mixers), K7 once
              and no other kernel; each answer within 1e-4 abs of the
              same weights on the CPU (the plain versions).
   serve_compress -- the same with ``ssd_mixer="compress"``: K2 15 times
              per forward, K7 once, no other kernel.
   train_fused -- one fp32 SH step at B=2 (no stochastic depth) through K1
              and K3 (their backward the plain versions' autograd) on the
              card, TF32 off, against the same step on the CPU through
              ``compare_steps``: K1 4, K3 15, K7 and K6 shared 1 launch.
   train_options -- the same SH step through K1 and K3 with every option
              that changes the step's function (``options_config``:
              kan_reg_weight 1e-5, grad_clip 1.0, wd_mask_norms) and drop
              path 0.1 from a CUDA generator: in fp32 at B=2, TF32 off, the
              step with remat against the step without it from the same
              weights, batch and generator state (``compare_steps``, and the
              parameters and BatchNorm running buffers after it within the
              same leaf gate, a parameter also within what the two
              gradients make of AdamW's first update, ``compare_states``;
              the generator must end in the same state): K1 8, K3 30 and K7
              2 launches with remat (the recompute runs the forward's
              again), K6 shared 1; then the
              remat step without stochastic depth against the CPU's
              (``compare_steps``). The bf16 step at B=16 and B=32 with remat
              off and on: ms by CUDA events after 2 warm-up steps and
              ``torch.cuda.max_memory_allocated``. Each optimizer of the
              factory, SGD with nesterov and two of build_optimizer's chains
              (the clip, the masked decay, the plateau's scale at 0.1):
              three updates of seeded parameters on the card against the
              CPU's, within 1e-6 of each leaf's largest |value|, rprop bit
              for bit (``optimizer_cases``).
   grid_sample -- the port's ``F.grid_sample``-style op
              (``ops.sample.grid_sample_bilinear``, zeros, at the bridge's
              16^2 x 64, B=2), forward and backward on the card for a few
              calls: K5 and K6 (the single-set entries, on no model path)
              must launch once per call each and no other kernel; the
              output and the image's gradient within 1e-5 abs + 1e-5
              relative of the same calls on the CPU, the grid's within
              1e-5 relative and 1e-5 x 8 abs (K6's coordinate gradient
              chained through d(pixel)/d(grid) = 16/2).
   serve_trajgru -- TrajGRU_EF at full width (encoder RNNs 64/192/192
              channels with 13/13/9 flow fields, forecaster 192/192/64 with
              13/13/9), 128^2, 5 -> 20 frames, seeded weights, built and
              served through ``serve.build_zoo_model("trajgru")`` for a few
              requests of B=2 in fp32 with TF32 off, each cell's flow conv
              scaled so that its largest flow on the first request is 2 px
              (the seeded init gives about 0.1 px); K7 must launch 75 times
              per forward (15 encoder and 60 forecaster cell steps) and no
              other kernel (no K8 either); each answer (2, 20, 128, 128), finite, within 1e-4
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
   serve_mamba -- Mamba_UNet at full width (c_list 8/16/24/32/48/64, the
              bridge, 10 DMFM layers), 128^2, 5 -> 20 frames, seeded
              weights, built and served through
              ``serve.build_zoo_model("mamba_unet")`` for a few requests of
              B=2 in fp32 with TF32 off: K8 must launch 20 times per forward
              (one MambaBlock on two token views in each DMFM) and no other
              kernel; each answer (2, 128, 128, 20), finite, within 1e-4 abs
              of the same weights on the CPU.
   train_mamba -- one fp32 step of the ("mamba_unet", "pic") recipe (SGD lr
              1e-3, momentum 0.9, coupled decay 1e-4, rainfall loss,
              CosineAnnealingLR) at full width, 128^2, seq_len 25, B=2, on
              the card against the same gradient in float64 on the CPU
              through ``compare_steps``: K8 and its backward must launch 20
              times each and no other kernel.
   ablate_mix -- the K3a script's path: ``scripts/torch_ablate_mix_kernel.py``
              (``run``) at its default shape, ABLATE_ITERS chained calls per
              mode after 2 warm-up calls and as many of K2; K3a must launch
              5 x (2 + ABLATE_ITERS) times, K2 2 + ABLATE_ITERS times, no
              other kernel.
   serve_laps -- KM_UNetV3-LAPS at full width (embed_dims 16/32/64, no
              bridge, align-corners bilinear x2), 256^2, 5 -> 3 frames,
              seeded weights, built and served through
              ``serve.build_km_unet_v3_laps`` for a few requests of B=1 in
              fp32 with TF32 off, on its plain path (no kernel), with
              ``head_norm=False`` (no kernel), through K1 and K3
              (``kan_fused=True, ssd_mixer="fused"``: 4 K1 and 15 K3 per
              forward) and through K2 (``ssd_mixer="compress"``: 15 per
              forward); each answer (1, 256, 256, 3), finite, within 1e-4
              abs of the same weights on the CPU.
   train_laps -- one fp32 ``laps_km_unet()`` step (the SH recipe's hybrid
              loss and AdamW) at full width, 256^2, seq_len 8, B=1, no
              stochastic depth, through K1 and K3 on the card (4 and 15
              launches, no other kernel) against the same step on the CPU
              through ``compare_steps``.
   trainer -- the port's whole loop, ``engine.train_and_evaluate``, as a
              user runs it: the SH recipe (``sh_config``: 128^2, 5 -> 20,
              B=16, bf16, AdamW, drop path 0.1 from the loop's CUDA
              generator) on synthetic data of TRAINER_LENGTH items, 4 train
              steps, one val batch and one test batch an epoch, for
              TRAINER_EPOCHS epochs, with best-val checkpoints and
              results.json in a temporary directory and no PNG strips. The
              launch counts are set to 0 just before and read just after:
              K7 once per forward (8 train steps, 2 val batches, 1 test
              batch: 11), K6's shared-source entry once per step (8), no
              other kernel. The losses and results.json's CSI, POD, HSS,
              FAR, RMSE and SSIM must be finite, and
              ``evaluate_checkpoint(which="best")`` (the last epoch's
              checkpoint, which must be the best) must reproduce the loop's
              test results bit for bit: both test passes run with
              ``cudnn.deterministic`` (the same convolution algorithms on
              the same weights and batch), TF32 convolutions as PyTorch's
              default. Printed: seconds per epoch (the epoch CSV), per test
              pass and per checkpoint save, the loop's wall seconds and the
              peak ``max_memory_allocated``. Then ``Evaluator`` on the card
              and on the CPU on the same seeded (16, 20, 128, 128)
              prediction and target (values on the bins' edges among
              them): the same contingency counts, RMSE and SSIM within 1e-6
              relative. Then the LAPS recipe (``laps_config``: 256^2, 5 -> 3,
              B=1, fp32, ``scatter_eval``) for one epoch of 2 steps: no
              kernel, a finite ``scatter`` block.
   data_parallel -- training across cards: one process per visible card
              (up to DP_MAX_CARDS; 1, 2 or 4), each on cuda:rank in one NCCL
              group (``spawn_ranks``: a store on a free localhost port).
              World 1 through the mesh path (``dp_world1_job``): the SH
              recipe's B=16 bf16 step with drop path 0.1, plain and through a
              1 x 1 x 1 mesh whose collectives run on a group of one, from
              the same weights, batch and CUDA generator state under
              ``cudnn.deterministic``: the loss, grad norm and every
              parameter and buffer after the step bit for bit; its K7 and K6
              shared launches are this path's; its bf16 step's ms and peak
              memory (``dp_bf16_step``). With one card it prints
              ``cards: 1`` and that the multi-card checks did not run. With
              N >= 2 cards (``dp_multi_job``), against one card's run on
              card 0 of the same thing: the fp32 B=16 step (TF32 off, drop
              path 0.1 from each rank's CUDA generator seeded alike) at dp =
              N and with FSDP at data N/2 x model 2, each rank's gradients
              and state after the step (gathered whole) through
              ``compare_steps`` and ``compare_states``, every rank's state
              alike; the trainer (``dp_trainer_config``: ``trainer_config`` in
              fp32 with SGD) for 2 epochs at dp = N, its results and history
              within DP_RESULTS_RTOL relative (``same_results``); the bf16
              dp step's ms by CUDA events over DP_TIMED_STEPS steps, peak
              memory and K7 / K6 shared launches per step, per rank, beside
              one card's B=16 step by the same protocol (``dp_bf16_step``); and
              ``selective_scan_sharded`` at DP_SCAN_SHAPE over the N cards (K8
              and its backward once per rank) within ``scan_reference``'s
              tolerances of the plain version, its distance from unsharded
              K8 beside. ``python3 chip_smoke.py --phase data_parallel`` runs
              the build of K7's, K6's and K8's sources and this phase alone.
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
              gap) and by the profiler's device time (``device_ms``), with
              the device launches it counts per call and the device time of
              each kernel it names (K6's unit, bin and owner passes). For
              TrajGRU: the forward at B=16 bf16 (ms, frames/s) and the
              recipe's train step at B=16 bf16 (ms), and K7 and K6's
              shared-source entry at enc_rnn1's shape (B=16, 32^2, C=64,
              G=13, bf16, zeros, coordinates grid + N(0, 1) px) against
              ``F.grid_sample`` (align_corners, zeros) and
              ``aten.grid_sampler_2d_backward`` plus the sum over the views,
              on the source broadcast into the batch (a copy made before
              timing). For Mamba-UNet: the forward at B=16 bf16 (ms,
              frames/s) and the recipe's train step at B=16 bf16 (ms), and K8
              and its backward at refine3's shape (B=16, L=16384, D=48,
              N=16, bf16, the "mamba" dt), beside their bounds (the larger of
              the bytes over the HBM rate and the recurrence's fp32
              operations, 8*B*L*D*N + 2*B*L*D as scan_pallas.py counts them,
              over the fp32 rate) and their plain versions; no one PyTorch
              call computes the scan, so their library time is null; and
              both at refine1's (B=16, L=16384, D=16), encoder4's (B=16,
              L=256, D=48) and decoder1's (B=16, L=16, D=128) shapes beside
              their bounds, on the timing line
              (``scan_timing``: ms, queued ms, device ms, device launches
              per call and device ms by kernel, no plain version). For
              KM_UNetV3-SH through K1 and K3: the forward at B=128 bf16
              beside the default path's and the train step at B=16 bf16;
              K1 at enc1 (B=128, 16 -> 16 at 128^2, bf16) and K2 and K3 at
              enc1_vim's mixer (B=128, C=16, L=16384, N=64, bf16), beside
              their bounds (the bytes, against the operations these inputs
              need over the tensor cores' rate: for K1 a MAC per nonzero
              basis and one for the base branch, the dense count beside it)
              and their plain versions (today's default paths); no one
              PyTorch call computes them, so their library time is null;
              and K2 and K3 by pass at SH's three mixer shapes at B=128 and
              LAPS's enc1 at B=32 (``mixer_timing``: ms, queued ms, device
              ms, device launches per call and device ms by kernel, beside
              the bound). K3a in each mode at the TPU script's shape beside
              its bound (bytes; the products on the tensor cores), its
              plain version (library null) and its device ms by pass (tile
              max, compress, merge, scatter). KM_UNetV3-LAPS:
              the forward at B=1 and B=32 bf16 at 256^2 (B=32 has as many
              pixels as SH's B=128 at 128^2) on the plain and the K1 + K3
              path, and the bf16 ``laps_km_unet()`` step at B=1 on both.
7. kan_timing -- K1 in bf16 at SH's four KAN convs at B=128 (enc1 16 -> 16
              at 128^2, enc2 16 -> 32 at 64^2, enc3 32 -> 64 and dec1 64 ->
              32 at 32^2) and LAPS's enc1 at B=32 (``KAN_TIMING_SHAPES``):
              ms, queued ms, the profiler's device ms, device launches per
              call and device ms by kernel (the weight packing beside K1),
              beside ``kan_bound`` and the dense products' time on the
              tensor cores (``kan_timing``).
8. multiview_timing -- K7 in bf16 at TrajGRU's five K7 shapes at B=16 and
              the deformable conv's (B=128, 16^2, C=64, G=9)
              (``MULTIVIEW_TIMING_SHAPES``, with each one's K7 launches per
              forward), each output first held to the plain version (fp32,
              1e-5 abs + one bf16 ulp): ms, queued ms, the profiler's device
              ms and device launches per call, beside ``gather_bound`` and
              ``F.grid_sample``'s numbers on the source broadcast into the
              batch; at the bridge also the nine K5 calls and ``torch.cat``
              that K7 replaced there; K5 alone at the bridge shape, beside
              ``zero_`` of its output; and K4 at DySample's dec3
              (``multiview_timing``).
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
BRIDGE = (128, 16, 16, 64)  # DAGEM's deformable conv input at B=128 (B, H, W, C)
RAGGED = (3, 7, 9, 24)
ODD = (2, 5, 6, 3)  # C of no 16-byte vector: one channel per thread
K5_SOURCE = "kmunet_tpu_torch/csrc/multiview_gather.cu"  # K7's kernel at G=1
K5_REPLACES = "kmunet_tpu/kernels/bilinear_pallas.py:646"
K6_SOURCE = "kmunet_tpu_torch/csrc/bilinear_gather_backward.cu"
K6_REPLACES = "kmunet_tpu/kernels/bilinear_pallas.py:414"
K4_SOURCE = "kmunet_tpu_torch/csrc/bilinear_gather.cu"
K4_REPLACES = "kmunet_tpu/kernels/bilinear_pallas.py:747"
K6G_SOURCE = K6_SOURCE
K6G_REPLACES = K6_REPLACES  # _backward_impl, shared=False, G > 1
# K4's shapes (B, H, W, C, G, Ho, Wo): DySample's three 2x upsamplings of the
# SH decoder at a small batch, a ragged one of Cg=6 and one of Cg=3 (no
# 16-byte vector in fp32), G=1 and G=8, and segments of 25,600 units, whose
# bin lists K6's bin pass builds in global memory (past its shared memory).
GROUPED_SHAPES = {
    "dec1": (2, 16, 16, 64, 4, 32, 32),
    "dec2": (2, 32, 32, 64, 4, 64, 64),
    "dec3": (2, 64, 64, 64, 4, 128, 128),
    "ragged_cg6": (3, 7, 9, 24, 4, 8, 7),
    "cg3": (2, 5, 6, 6, 2, 4, 8),
    "g1": (2, 7, 9, 24, 1, 8, 7),
    "g8": (2, 9, 7, 64, 8, 10, 12),
    "unstaged": (1, 16, 16, 8, 2, 160, 160),
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
OPTIONS_KAN_REG = 1e-5  # train_options: kan_reg_weight
OPTIONS_GRAD_CLIP = 1.0  # train_options: grad_clip
OPTIONS_BATCHES = (16, 32)  # train_options: the bench's bf16 steps, timed with remat off and on
OPTIMIZER_SHAPES = ((64, 32, 3, 3), (16, 16, 8, 3, 3), (4096,), (64,), ())
OPTIMIZER_RTOL = 1e-6  # card vs CPU, of each leaf's largest |value|
# DeformConv2d 3x3 (DAGEM's bridge): its 9 taps are the views of one K7
# launch per forward, one K6 shared-source launch per backward.
TAPS = 9
DEFORM_CONVS = 1
K7_SOURCE = "kmunet_tpu_torch/csrc/multiview_gather.cu"
K7_REPLACES = K4_REPLACES  # _forward_grouped's pallas_call, shared=True
K6S_SOURCE = K6_SOURCE
K6S_REPLACES = K6_REPLACES  # _backward_impl, shared=True
# K7's shapes (B, H, W, C, G, Ho, Wo): TrajGRU's five K7 shapes at 128^2
# input and B=2 (rnn1 enc_rnn1, fore_rnn1 its G=9, rnn2 enc_rnn2 and
# fore_rnn2, rnn3 enc_rnn3, fore_rnn3 its G=13), the deformable conv's 9 taps
# at DAGEM's bridge, C of 6 and 3 (no 16-byte vector in fp32), G=1 and G=16,
# and K6's unstaged segments as in GROUPED_SHAPES. K7 takes its chunk from
# the batch (kernels/bilinear.py::multiview_chunk): at B=2 these give 0, 2,
# 8, 12 and 24; the last three are the main paths' own batches, whose chunks
# differ: 32 at enc_rnn1 (B=16) and at the bridge (B=128), 6 at rnn2 (B=16).
MULTIVIEW_SHAPES = {
    "rnn1": (2, 32, 32, 64, 13, 32, 32),
    "fore_rnn1": (2, 32, 32, 64, 9, 32, 32),
    "rnn2": (2, 8, 8, 192, 13, 8, 8),
    "rnn3": (2, 4, 4, 192, 9, 4, 4),
    "fore_rnn3": (2, 4, 4, 192, 13, 4, 4),
    "bridge": (2, 16, 16, 64, TAPS, 16, 16),
    "c6": (2, 7, 9, 6, 3, 8, 7),
    "c3": (2, 5, 6, 3, 9, 4, 8),
    "g1": (2, 7, 9, 24, 1, 8, 7),
    "g16": (2, 9, 7, 16, 16, 10, 12),
    "unstaged": (1, 16, 16, 8, 2, 160, 160),
    "rnn1_b16": (16, 32, 32, 64, 13, 32, 32),
    "rnn2_b16": (16, 8, 8, 192, 13, 8, 8),
    "bridge_b128": (*BRIDGE, TAPS, *BRIDGE[1:3]),
}
RNN1 = (16, 32, 32, 64, 13, 32, 32)  # K7's timing shape: enc_rnn1 at B=16
# K7's shapes on the model paths, bf16, timed by ``multiview_timing``:
# TrajGRU's five at B=16 and the deformable conv at the bridge at B=128
# (the SH forward's batch), with the K7 launches of one forward of each.
MULTIVIEW_TIMING_SHAPES = {
    "enc_rnn1": (RNN1, 5),
    "fore_rnn1": ((16, 32, 32, 64, 9, 32, 32), 20),
    "rnn2": ((16, 8, 8, 192, 13, 8, 8), 25),
    "enc_rnn3": ((16, 4, 4, 192, 9, 4, 4), 5),
    "fore_rnn3": ((16, 4, 4, 192, 13, 4, 4), 20),
    "bridge": ((*BRIDGE, TAPS, *BRIDGE[1:3]), DEFORM_CONVS),
}
# TrajGRU cell steps per forward: 5 input frames through 3 encoder RNNs, 20
# output frames through 3 forecaster RNNs; one K7 launch each, one K6
# shared-source launch each in the backward.
TRAJGRU_WARPS = 3 * 5 + 3 * 20
FLOW_REACH_PX = 2.0  # serve_trajgru's largest flow per cell
FLOW_SCALE = 30.0  # train_trajgru's flow convs: flows reach about 3 px at enc_rnn1
TRAJGRU_BATCH = 16  # bench.py's zoo batch for trajgru, timed in bf16

K8_SOURCE = "kmunet_tpu_torch/csrc/selective_scan.cu"
K8_REPLACES = "kmunet_tpu/kernels/scan_pallas.py:145"
K8B_SOURCE = K8_SOURCE  # the backward is a second entry of the same source
K8B_REPLACES = "kmunet_tpu/kernels/scan_pallas.py:299"
# K8's shapes (B, L, D, N): Mamba-UNet's scans at 128^2 and B=2 (the refine
# layers at 128^2, encoder4 at 16^2, encoder5 and decoder3 at 8^2, encoder6,
# decoder1 and decoder2 at 4^2), a ragged L, ragged D of 6 and 24, N of 4
# and 8, L=1, and L one past the kernels' 64-token chunk; each with the dt
# cases listed (SCAN_DT_CASES).
SCAN_SHAPES = {
    "refine1": ((2, 16384, 16, 16), ("mamba",)),
    "refine2": ((2, 16384, 32, 16), ("mamba",)),
    "refine3": ((2, 16384, 48, 16), ("mamba", "small")),
    "encoder4": ((2, 256, 48, 16), ("mamba", "small", "large")),
    "encoder5": ((2, 64, 64, 16), ("mamba", "small", "large")),
    "encoder6": ((2, 16, 96, 16), ("mamba",)),
    "decoder1": ((2, 16, 128, 16), ("mamba", "small", "large")),
    "ragged_l1000": ((2, 1000, 24, 16), ("mamba", "small", "large")),
    "d6_n4": ((2, 100, 6, 4), ("mamba", "small", "large")),
    "d24_n8": ((2, 77, 24, 8), ("mamba", "small", "large")),
    "l1": ((2, 1, 16, 16), ("mamba",)),
    "l65": ((2, 65, 48, 16), ("mamba", "small", "large")),
}
# dt of each case: "mamba" as the seeded MambaBlock makes it, softplus of a
# N(0, 0.5) projection plus its bias (dt_proj_bias: softplus^-1 of
# LogUniform(1e-3, 0.1)); "small" U(1e-4, 1e-3), a decay exp(dt*A) near 1
# (memory over the whole sequence); "large" U(4, 16), a decay near 0.
SCAN_DT_CASES = ("mamba", "small", "large")
REFINE3 = (16, 16384, 48, 16)  # K8's timing shape: refine3 at B=16 (B, L, D, N)
# K8's other timing shapes at B=16: refine1 (the fewest channels), encoder4
# (a short scan, L=256) and decoder1 (L=16, one chunk, the widest D).
SCAN_TIMING_SHAPES = {"refine1": (16, 16384, 16, 16), "encoder4": (16, 256, 48, 16),
                      "decoder1": (16, 16, 128, 16)}
MAMBA_SCANS = 20  # 10 DMFM layers, one MambaBlock each on two token views
MAMBA_BATCH = 16  # bench.py's zoo batch, timed in bf16

H100_BF16_FLOPS = 989e12  # dense bf16/fp16 on the tensor cores: K1-K3's and K3a's products
K1_SOURCE = "kmunet_tpu_torch/csrc/kanconv.cu"
K1_REPLACES = "kmunet_tpu/kernels/kanconv_pallas.py:151"
K2_SOURCE = "kmunet_tpu_torch/csrc/hsmssd.cu"
K2_REPLACES = "kmunet_tpu/kernels/ssd_pallas.py:79"
K3_SOURCE = K2_SOURCE  # the fused mixer is a second entry of the same source
K3_REPLACES = "kmunet_tpu/kernels/ssd_mix_pallas.py:150"
# K1's shapes (B, C, F, H, W): KM_UNetV3-SH's four KAN convs at 128^2 input
# and B=2 (enc1 16->16 at 128^2, enc2 16->32 at 64^2, enc3 32->64 and dec1
# 64->32 at 32^2), KM_UNetV3-LAPS's four at 256^2 input and B=1 (the same
# convs at twice the side), and a ragged one; each with the x cases of
# KAN_X_CASES.
KAN_SHAPES = {
    "enc1": (2, 16, 16, 128, 128),
    "enc2": (2, 16, 32, 64, 64),
    "enc3": (2, 32, 64, 32, 32),
    "dec1": (2, 64, 32, 32, 32),
    "laps_enc1": (1, 16, 16, 256, 256),
    "laps_enc2": (1, 16, 32, 128, 128),
    "laps_enc3": (1, 32, 64, 64, 64),
    "laps_dec1": (1, 64, 32, 64, 64),
    "ragged": (2, 3, 5, 7, 9),
}
# x of each case: "unit" U(-1.2, 1.2); "wide" U(-3, 3), past the outer knots
# (+-2.2) where fewer than 4 bases are nonzero; "knots" exactly at the
# extended grid's knots -2.2, -1.8, ..., 2.2. Zero padding around each.
KAN_X_CASES = ("unit", "wide", "knots")
KAN_CONVS = 4  # enc1-3 and dec1: one K1 launch each per forward
ENC1_KAN = (128, 16, 16, 128, 128)  # K1's timing shape (B, C, F, H, W): enc1 at B=128
# K1's timing shapes (``kan_timing``): SH's four KAN convs at B=128 and
# LAPS's enc1 at B=32 (256^2), bf16.
KAN_TIMING_SHAPES = {"enc1": ENC1_KAN, "enc2": (128, 16, 32, 64, 64),
                     "enc3": (128, 32, 64, 32, 32), "dec1": (128, 64, 32, 32, 32),
                     "laps_enc1": (32, 16, 16, 256, 256)}
# The K1 cases whose outputs are also held to float64 (k1_float64_distance).
KAN_FLOAT64_CASES = ("enc1/unit", "enc1/wide", "enc1/knots", "dec1/wide", "laps_enc1/unit")
# K2's and K3's shapes (B, C, L, N): KM_UNetV3-SH's three mixer shapes at B=2
# (enc1 and dec3 at 128^2, enc2 and dec2 at 64^2, enc3 at 32^2),
# KM_UNetV3-LAPS's three at B=1 (enc1 and dec3 at 256^2: 128 slices of the
# compress pass per batch element on 132 SMs, against SH's 32; enc2 and dec2
# at 128^2; enc3 at 64^2), a ragged L with N=8, L=1 and L one past the
# kernels' 64-token tile; each with the dt cases listed: "seeded" N(0, 1),
# "large" 40 N(0, 1), where one token takes most of a softmax.
MIXER_SHAPES = {
    "enc1": ((2, 16, 16384, 64), ("seeded", "large")),
    "enc2": ((2, 32, 4096, 64), ("seeded",)),
    "enc3": ((2, 64, 1024, 64), ("seeded", "large")),
    "laps_enc1": ((1, 16, 65536, 64), ("seeded", "large")),
    "laps_enc2": ((1, 32, 16384, 64), ("seeded", "large")),
    "laps_enc3": ((1, 64, 4096, 64), ("seeded", "large")),
    "ragged_l1000_n8": ((2, 16, 1000, 8), ("seeded", "large")),
    "l1": ((2, 16, 1, 64), ("seeded",)),
    "t_plus_1": ((2, 16, 65, 64), ("seeded", "large")),
}
# The mixer cases whose outputs are also held to float64 (k3_float64_distance).
MIXER_FLOAT64_CASES = ("enc1/seeded", "enc1/large", "laps_enc1/seeded", "laps_enc1/large")
SSD_MIXERS = 15  # 5 EnhancedViM blocks of 3 directional ViMs: one K2 or K3 call each
ENC1_MIX = (128, 16, 16384, 64)  # K2's and K3's timing shape (B, C, L, N): enc1_vim's mixer
# K2's and K3's timing shapes by pass (``mixer_timing``): SH's three mixer
# shapes at B=128 and LAPS's enc1 at B=32 (256^2).
MIXER_TIMING_SHAPES = {"enc1": ENC1_MIX, "enc2": (128, 32, 4096, 64),
                       "enc3": (128, 64, 1024, 64), "laps_enc1": (32, 16, 65536, 64)}

K3A_SOURCE = "kmunet_tpu_torch/csrc/hsmssd_ablate.cu"
K3A_REPLACES = "scripts/ablate_mix_kernel.py:98"
K3A_SCRIPT = "scripts/torch_ablate_mix_kernel.py"
# K3a's shapes (B, C, L, N, tile): the TPU script's (B=64, C=16, 128^2
# tokens, N=64, tiles of 4096), several tiles of 64 tokens, C != N with N=32,
# one tile with C=24 and N=16, and C=5 with N=8.
ABLATE_SHAPES = {
    "script": (64, 16, 16384, 64, 4096),
    "tile64": (2, 16, 1024, 64, 64),
    "c8_n32": (3, 8, 4096, 32, 1024),
    "one_tile_c24_n16": (2, 24, 512, 16, 512),
    "c5_n8": (1, 5, 256, 8, 128),
}
ABLATE_ITERS = 3  # the ablate_mix phase's chained calls per mode, after 2 warm-up calls
LAPS_SIZE = 256  # laps_km_unet()'s img_size
LAPS_FRAMES = 3
LAPS_SEQ = 8
LAPS_BATCHES = (1, 32)  # the recipe's batch, and SH's B=128 at 128^2 in pixels
TRAINER_LENGTH = 64  # the trainer phase's synthetic items: 4 steps of B=16 an epoch
TRAINER_EPOCHS = 2
LAPS_TRAINER_LENGTH = 2  # the LAPS loop: one epoch of 2 steps at B=1
EVALUATOR_RTOL = 1e-6  # RMSE and SSIM, card vs CPU
DP_MAX_CARDS = 4  # data_parallel: one process per visible card, up to this many
DP_TIMED_STEPS = 3  # data_parallel: the bf16 dp step, timed after 2 warm-up steps
DP_RESULTS_RTOL = 1e-4  # data_parallel: the dp trainer's losses and scores against one card's
DP_SCAN_SHAPE = (2, 4096, 16, 16)  # data_parallel: (B, L, D, N) of the sharded scan
DP_SECONDS = 300  # data_parallel: each spawn's deadline


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


def device_ms(torch, fn, iters: int):
    """(mean device time of ``fn()`` per call, summed over the kernels it
    launches; its device launches per call; its device ms per call by
    kernel name), from ``torch.profiler``: unlike ``cuda_ms`` it leaves out
    the gaps in which the device waits for the host to issue the next call.
    (None, None, None) where the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in kernels)
    if total_us <= 0:
        return None, None, None  # no CUPTI trace
    by_name = {}
    for e in kernels:  # "void (anonymous namespace)::owner_kernel<...>(...)" -> "owner_kernel"
        name = e.key.removeprefix("void ").replace("(anonymous namespace)::", "")
        name = re.split(r"[<(]", name)[0].split("::")[-1].strip()
        by_name[name] = by_name.get(name, 0.0) + e.self_device_time_total / 1e3 / iters
    return total_us / 1e3 / iters, sum(e.count for e in kernels) / iters, by_name


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


def scan_bound(shape, esz, backward: bool):
    """(bound_ms, bound_by, bytes, ops) of K8 or its backward at (B, L, D, N)
    with x, dt, B, C (and g) of ``esz`` bytes and A, D fp32: each input read
    once and each output written once over the HBM rate (K8 reads x, dt, B,
    C, A, D and writes y; its backward also reads g and writes dx, ddt, dA,
    dB, dC, dD), against the recurrence's fp32 operations as
    scan_pallas.py counts them (8 per (b, l, d, n) and 2 per (b, l, d)) over
    the fp32 rate."""
    B, L, D, N = shape
    bld, bln, params = B * L * D * esz, B * L * N * esz, (D * N + D) * 4
    moved = 5 * bld + 4 * bln + 2 * params if backward else 3 * bld + 2 * bln + params
    ops = 8 * B * L * D * N + 2 * B * L * D
    bytes_ms = moved / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_FP32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), moved, ops


def synthetic_batch(np, B, seed, img_size=128, seq_len=25):
    """B items of the synthetic corpus (by default the SH bench's: 128^2,
    seq_len 25) from ``seed``."""
    from kmunet_tpu_torch.data import SyntheticNowcastDataset

    data = SyntheticNowcastDataset(length=B, img_size=img_size, seq_len=seq_len, seed=seed)
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


def laps_config(B, dtype, drop_path=0.1, img_size=LAPS_SIZE):
    """``laps_km_unet()`` (the LAPS variant, 5 -> 3 frames, seq_len 8, the SH
    recipe's hybrid loss and AdamW) at batch B in compute ``dtype``."""
    from kmunet_tpu_torch.configs import laps_km_unet

    cfg = laps_km_unet()
    cfg.data.img_size, cfg.data.batch_size = img_size, B
    cfg.train.compute_dtype = dtype
    cfg.model.extra["drop_path"] = drop_path
    return cfg


def zoo_config(model, B, dtype, img_size=128, seq_len=25, out_frames=20):
    """The zoo ``model``'s "pic" recipe (trajgru: Adam lr 1e-4,
    weighted_mse_mae over the thresholds 20/30/35/40, MultiStepLR;
    mamba_unet: SGD lr 1e-3, momentum 0.9, coupled decay 1e-4, rainfall
    loss, CosineAnnealingLR T_max 50) on the SH data config (128^2, seq_len
    25, 5 -> 20) at batch B in compute ``dtype``."""
    from kmunet_tpu_torch.configs import shanghai_km_unet
    from kmunet_tpu_torch.train.recipes import apply_recipe

    cfg = apply_recipe(shanghai_km_unet(), model, "pic")
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


def train_setup(cfg, device, seed=0, dysample_window=True, flow_scale=1.0, kan_fused=False,
                ssd_mixer="einsum"):
    """(model, state, step, tx) of ``cfg`` with weights from ``seed``, on
    DySample's window path or (``dysample_window=False``) its exact path, with
    ``kan_fused`` and ``ssd_mixer`` as ``KM_UNetV3`` takes them; a TrajGRU's
    flows multiplied by ``flow_scale``."""
    from kmunet_tpu_torch.train import engine

    model = engine.build_model(cfg, dysample_window=dysample_window, kan_fused=kan_fused,
                               ssd_mixer=ssd_mixer)
    tx = engine.build_optimizer(cfg, steps_per_epoch=100)
    state = engine.init_state(cfg, model, tx, seed=seed, device=device)
    if flow_scale != 1.0:
        scale_flows(model, flow_scale)
    return model, state, engine.make_train_step(model, engine.build_loss(cfg), tx, cfg), tx


def step_readings(cfg, device, batch, seed=0, dysample_window=True, flow_scale=1.0,
                  kan_fused=False, ssd_mixer="einsum", generator=None):
    """One train step of ``cfg`` on ``device`` from weights made from
    ``seed``, DropPath drawing from ``generator``: ((loss, grad norm, {name:
    gradient}), the model's state_dict after the step), all on the CPU; the
    gradients are read where the optimizer takes them, so they are the ones
    the step applied."""
    model, state, step, tx = train_setup(cfg, device, seed, dysample_window, flow_scale,
                                         kan_fused, ssd_mixer)
    seen = []
    update = tx.update
    tx.update = lambda grads, st, params: seen.append([g.cpu() for g in grads]) or update(
        grads, st, params)
    _, m = step(state, batch, generator)
    after = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    return (float(m["loss"]), float(m["grad_norm"]), dict(zip(state.params, seen[0]))), after


def step_gradients(cfg, device, batch, seed=0, dysample_window=True, flow_scale=1.0,
                   kan_fused=False, ssd_mixer="einsum"):
    """(loss, grad norm, {name: gradient}) of ``step_readings`` with no
    stochastic depth's generator."""
    return step_readings(cfg, device, batch, seed, dysample_window, flow_scale, kan_fused,
                         ssd_mixer)[0]


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


def adamw_first_update(g, grad_norm, clip):
    """AdamW's first update direction for the gradient ``g`` (moments from
    0, bias-corrected: g / (|g| + eps)) after the global-norm clip, in
    float64: what one step makes of a gradient, but for lr and the decay."""
    g = g.double() * min(1.0, clip / grad_norm)
    return g / (g.abs() + 1e-8)


def compare_states(got, want, lr, clip):
    """Holds the state_dicts after two AdamW steps, ``got`` and ``want``
    ((readings, state) of ``step_readings``), to the step gate: every
    parameter and BatchNorm running buffer within STEP_LEAF_RTOL of its
    largest |value| in ``want`` plus STEP_LEAF_ATOL, a parameter also
    within what the two steps' gradients (held by ``compare_steps``) make of
    the update at ``lr`` (``adamw_first_update``): AdamW's first update is
    about lr whatever |g|, so a gradient of rounding noise (the leaves whose
    exact gradient is 0) moves its parameter by lr with either sign.
    Raises if not; returns the worst share of the tolerance and its key."""
    ((_, gn_got, g_got), s_got), ((_, gn_want, g_want), s_want) = got, want
    ratio, worst = 0.0, ""
    for k, w in s_want.items():
        if not w.is_floating_point():
            continue
        tol = STEP_LEAF_RTOL * float(w.abs().max()) + STEP_LEAF_ATOL
        err = (s_got[k] - w).abs().double()
        if k in g_want:
            err = err - lr * (adamw_first_update(g_got[k], gn_got, clip)
                              - adamw_first_update(g_want[k], gn_want, clip)).abs()
        r = float(err.max()) / tol
        if r > ratio:
            ratio, worst = r, k
    if ratio > 1.0:
        raise AssertionError(f"states differ at {worst}: {ratio} of the tolerance")
    return {"worst_state": worst, "worst_state_share_of_tol": ratio}


def options_config(B, dtype, remat, drop_path=0.1):
    """``sh_config`` with every option of the train step that changes its
    function on: the KAN regularizer (1e-5), the global-norm clip (1.0) and
    the decay on the tensors of 2 or more dims only; ``remat`` on or off."""
    cfg = sh_config(B, dtype, drop_path=drop_path)
    cfg.train.kan_reg_weight = OPTIONS_KAN_REG
    cfg.train.grad_clip = OPTIONS_GRAD_CLIP
    cfg.train.wd_mask_norms = True
    cfg.train.remat = remat
    return cfg


def optimizer_cases():
    """{name: a fresh optimizer}: the nine of ``make_optimizer`` (decay 1e-2,
    a MultiStepLR halving the lr at each update; rprop its constant lr),
    SGD with nesterov, and two of build_optimizer's chains: AdamW with its
    decay on the tensors of 2 or more dims, the clip and the plateau's
    scale (set to 0.1), and SGD behind the clip and the masked coupled
    decay."""
    from kmunet_tpu_torch.train import optimizers as opt
    from kmunet_tpu_torch.train.schedule import make_schedule

    lr = make_schedule("MultiStepLR", 1e-2, 1, milestones=(1, 2), gamma=0.5)
    cases = {name: (lambda name=name: opt.make_optimizer(
        name, 1e-2 if name == "rprop" else lr, weight_decay=1e-2))
        for name in ("adadelta", "adagrad", "adam", "adamw", "adamax", "asgd", "rmsprop",
                     "rprop", "sgd")}
    cases["sgd_nesterov"] = lambda: opt.make_optimizer("sgd", lr, weight_decay=1e-2,
                                                       nesterov=True)
    cases["adamw_plateau"] = lambda: opt.Chain(opt.AdamW(lr, 0.05, mask_norms=True),
                                               grad_clip=1.0, plateau=True)
    cases["sgd_chain"] = lambda: opt.Chain(opt.make_optimizer("sgd", lr), grad_clip=1.0,
                                           masked_decay=1e-2)
    return cases


def run_optimizer(torch, make, params, grads, device):
    """Three updates of ``make()`` on ``params`` (numpy) with ``grads`` on
    ``device``; the plateau's scale set to 0.1. Returns the parameters on
    the CPU."""
    p = [torch.from_numpy(a.copy()).to(device) for a in params]
    tx = make()
    state = tx.init(p)
    if getattr(state, "scale", None) is not None:
        state.scale = 0.1
    for g in grads:
        state = tx.update([torch.from_numpy(a).to(device) for a in g], state, p)
    return [t.cpu() for t in p]


def scan_inputs(np, rng, shape, dt_case):
    """(x, dt, A, B, C, D) of K8 and an upstream gradient g, numpy fp32: x,
    B, C and g N(0, 1), D U(0.5, 1.5), A = -exp(A_log) with A_log as
    MambaBlock's init makes it (row d is -1, ..., -N), dt by ``dt_case``."""
    Bsz, L, D, N = shape
    x = rng.normal(size=(Bsz, L, D))
    if dt_case == "mamba":
        dt0 = np.exp(rng.uniform(np.log(1e-3), np.log(0.1), D))
        dt = np.logaddexp(0.0, rng.normal(0.0, 0.5, (Bsz, L, D)) + dt0 + np.log(-np.expm1(-dt0)))
    elif dt_case == "small":
        dt = rng.uniform(1e-4, 1e-3, (Bsz, L, D))
    else:
        dt = rng.uniform(4.0, 16.0, (Bsz, L, D))
    A = -np.tile(np.arange(1, N + 1, dtype=np.float64), (D, 1))
    Bm, Cm = rng.normal(size=(Bsz, L, N)), rng.normal(size=(Bsz, L, N))
    Dp = rng.uniform(0.5, 1.5, D)
    g = rng.normal(size=(Bsz, L, D))
    return [a.astype(np.float32) for a in (x, dt, A, Bm, Cm, Dp)], g.astype(np.float32)


SCAN_OUTPUTS = ("y", "dx", "ddt", "dA", "dB", "dC", "dD")


def scan_plain_outputs(a, g):
    """y and the six gradients of the plain versions on ``a`` and ``g``."""
    from kmunet_tpu_torch.kernels import scan

    return (scan.selective_scan_plain(*a), *scan.selective_scan_backward_plain(*a, g))


def scan_reference(torch, args, g):
    """The plain versions' outputs (y and the six gradients) on fp32 ``args``
    and ``g``, the tolerance of each, and their float64 results: the
    tolerance is 4 times the plain version's largest distance from its own
    float64 result on the same inputs, plus 1e-6 of the largest |float64
    value| (the floor where the plain version lands on it)."""
    ref = scan_plain_outputs(args, g)
    exact = scan_plain_outputs([a.double() for a in args], g.double())
    tols = [4.0 * float((r.double() - e).abs().max()) + 1e-6 * float(e.abs().max())
            for r, e in zip(ref, exact)]
    return ref, tols, exact


def check_scan(torch, key, args, g, ref, tols, dtype, errors_f, errors_b, distances=None,
               exact=None):
    """Holds K8 and its backward in ``dtype`` (x, dt, B, C and g in it; A and
    D fp32) to the plain versions: in fp32 to ``ref`` within ``tols``
    (``scan_reference``); in bf16 and fp16 to the plain versions on the same
    rounded inputs within the same tolerances plus one ulp of the dtype for
    the outputs in it. Records the worst errors under ``key``/dtype and,
    given ``distances``, per output the kernels' and the plain version's
    largest distance from the float64 result on the same (rounded) inputs:
    ``exact`` for fp32 (``scan_reference``'s), computed here for the others."""
    from kmunet_tpu_torch.kernels import scan

    a = [t.to(dtype) if i in (0, 1, 3, 4) else t for i, t in enumerate(args)]
    gd = g.to(dtype)
    got = (scan.selective_scan_forward(*a), *scan.selective_scan_backward(*a, gd))
    want = ref if dtype == torch.float32 else scan_plain_outputs(a, gd)
    k = f"{key}/{str(dtype)[6:]}"
    errs = []
    for name, out, w, tol in zip(SCAN_OUTPUTS, got, want, tols):
        if out.dtype != w.dtype or out.shape != w.shape:
            raise AssertionError(f"K8 {k} {name}: {out.dtype} {tuple(out.shape)}, want "
                                 f"{w.dtype} {tuple(w.shape)}")
        bound = torch.full_like(w, tol, dtype=torch.float32)
        if w.dtype != torch.float32:
            bound = bound + ulp_tolerance(torch, w.float(), w.dtype)
        errs.append(check_close(f"K8 {k} {name}", out, w, bound))
    errors_f[k] = errs[0]
    errors_b[k] = max(errs[1:])
    if distances is not None:
        if dtype != torch.float32:
            exact = scan_plain_outputs([t.double() for t in a], gd.double())
        distances[k] = {name: [float((o.double() - e).abs().max()),
                               float((w.double() - e).abs().max())]
                        for name, o, w, e in zip(SCAN_OUTPUTS, got, want, exact)}


def check_kanconv(torch, key, xp32, base32, spline32, errors):
    """Holds K1 in fp32, bf16 and fp16 (xp and the weights in the dtype, as
    a model in it holds them) to the plain version: in fp32 within 1e-5 abs
    + 1e-5 of the largest |value|; in bf16 and fp16 against the plain version
    in fp32 on the same rounded inputs, within that plus one ulp of the
    dtype. Records the worst error under ``key``/dtype. TF32 must be off."""
    from kmunet_tpu_torch.kernels import kanconv

    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        xp, base, spline = (t.to(dtype) for t in (xp32, base32, spline32))
        got = kanconv.kanconv_forward(xp, base, spline)
        want = kanconv.kanconv_plain(xp.float(), base.float(), spline.float())
        if got.dtype != dtype or got.shape != want.shape:
            raise AssertionError(f"K1 {key}: {got.dtype} {tuple(got.shape)}")
        tol = 1e-5 + 1e-5 * want.abs().max()
        if dtype != torch.float32:
            tol = tol + ulp_tolerance(torch, want, dtype)
        k = f"{key}/{str(dtype)[6:]}"
        errors[k] = check_close(f"K1 {k}", got, want, torch.broadcast_to(tol, want.shape))


def kan_float64_distance(torch, xp32, base32, spline32):
    """Per dtype (fp32, bf16): [K1's, the plain version's] largest distance
    from the plain version in float64 on the same rounded inputs."""
    from kmunet_tpu_torch.kernels import kanconv

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        xp, base, spline = (t.to(dtype) for t in (xp32, base32, spline32))
        exact = kanconv.kanconv_plain(xp.double(), base.double(), spline.double())
        got = kanconv.kanconv_forward(xp, base, spline)
        plain = kanconv.kanconv_plain(xp, base, spline)
        out[str(dtype)[6:]] = [float((got.double() - exact).abs().max()),
                               float((plain.double() - exact).abs().max())]
    return out


def kan_timing(torch, kanconv, shapes=None, iters: int = 20):
    """K1 (``kanconv``'s launcher) in bf16 at each (B, C, F, H, W) of
    ``shapes`` (KAN_TIMING_SHAPES by default), x N(0, 1) as the GroupNorm
    before it makes it, zero padded, the weights N(0, 0.3): ms by CUDA
    events over back-to-back calls, queued ms (device time, no host gap),
    the profiler's device ms, device launches per call and device ms per
    call by kernel (the wrapper's weight packing beside K1), beside the
    bound and the dense products' time on the tensor cores."""
    import torch.nn.functional as tF

    out = {}
    for name, shape in (shapes or KAN_TIMING_SHAPES).items():
        B, C, Fo, H, W = shape
        xp = tF.pad(torch.randn(B, C, H, W, device="cuda"), (1, 1, 1, 1)).to(torch.bfloat16)
        base = (0.3 * torch.randn(Fo, C, 3, 3, device="cuda")).to(torch.bfloat16)
        spline = (0.3 * torch.randn(Fo, 8 * C, 3, 3, device="cuda")).to(torch.bfloat16)
        bound, bound_by, _, _, dense_ops = kan_bound(torch, xp, Fo)
        fn = lambda: kanconv.kanconv_forward(xp, base, spline)  # noqa: E731
        device, launches, by_kernel = device_ms(torch, fn, iters)
        out[name] = {"shape": list(shape), "ms": cuda_ms(torch, fn, iters, 5),
                     "queued_ms": queued_ms(torch, fn, iters)[0], "device_ms": device,
                     "device_launches_per_call": launches, "device_ms_by_kernel": by_kernel,
                     "bound_ms": bound, "bound_by": bound_by,
                     "dense_ms": dense_ops / H100_BF16_FLOPS * 1e3}
        del xp, base, spline
    return out


def multiview_timing(torch, bilinear, shapes=None, iters: int = 50, library: bool = True):
    """K7 (``bilinear``'s multiview launcher) in bf16, zeros mode, at each
    (shape, launches per forward) of ``shapes`` (MULTIVIEW_TIMING_SHAPES by
    default), the source N(0, 1) and the coordinates the output grid plus
    N(0, 1) px (TrajGRU's flows; at the bridge plus the 3x3 taps'
    displacements): ms by CUDA events over back-to-back calls, queued ms
    (device time, no host gap), the profiler's device ms and device
    launches per call, beside the bound and, with ``library``,
    ``F.grid_sample``'s on the source broadcast into the batch (a copy made
    before timing). Each shape's output is first held to the plain version
    on the same inputs in fp32, within 1e-5 abs + one bf16 ulp (the timed
    launches' chunks are the main paths' own); raises where it is not. At the bridge also the nine K5 calls and the
    ``torch.cat`` that the deformable conv ran before K7 took its taps;
    K5 alone at the bridge shape (``BRIDGE``, zeros), held to the plain
    version the same way, beside ``zero_`` of its output; and K4 at
    DySample's dec3 (``DEC3``, border), which K7's redesign leaves as it
    was."""
    import torch.nn.functional as tF

    def numbers(fn, prefix=""):
        device, launches, _ = device_ms(torch, fn, iters)
        return {prefix + "ms": cuda_ms(torch, fn, 2 * iters, 10),
                prefix + "queued_ms": queued_ms(torch, fn, iters)[0],
                prefix + "device_ms": device, prefix + "device_launches_per_call": launches}

    out = {}
    for name, (shape, per_forward) in (shapes or MULTIVIEW_TIMING_SHAPES).items():
        B, H, W, C, G, Ho, Wo = shape
        img = torch.randn(B, H, W, C, device="cuda").to(torch.bfloat16)
        ii = torch.arange(Ho, device="cuda", dtype=torch.float32).view(1, 1, Ho, 1)
        jj = torch.arange(Wo, device="cuda", dtype=torch.float32).view(1, 1, 1, Wo)
        if name == "bridge":
            tap = torch.arange(G, device="cuda")
            ii = ii + (tap // 3 - 1).view(1, G, 1, 1)
            jj = jj + (tap % 3 - 1).view(1, G, 1, 1)
        y = (ii + torch.randn(B, G, Ho, Wo, device="cuda")).contiguous()
        x = (jj + torch.randn(B, G, Ho, Wo, device="cuda")).contiguous()
        bound, bound_by, _, _ = gather_bound(torch, img, x, B * Ho * Wo * G * C, False)
        fn = lambda: bilinear.bilinear_gather_multiview_forward(img, x, y, "zeros")  # noqa: E731
        want = bilinear.bilinear_gather_multiview_plain(img.float(), x, y, "zeros")
        err = check_close(f"K7 {name} bfloat16", fn(), want,
                          1e-5 + ulp_tolerance(torch, want, torch.bfloat16))
        del want
        out[name] = {"shape": list(shape), "launches_per_forward": per_forward, **numbers(fn),
                     "bound_ms": bound, "bound_by": bound_by, "max_abs_err": err}
        if library:
            img_lib = img.permute(0, 3, 1, 2)[:, None].expand(B, G, C, H, W).reshape(
                B * G, C, H, W)
            grid = torch.stack([x / (W - 1) * 2 - 1, y / (H - 1) * 2 - 1], dim=-1).reshape(
                B * G, Ho, Wo, 2).to(img.dtype)
            out[name].update(numbers(lambda: tF.grid_sample(
                img_lib, grid, mode="bilinear", padding_mode="zeros", align_corners=True),
                "library_"))
            del img_lib, grid
        if name == "bridge":
            planes = [(x[:, t].contiguous(), y[:, t].contiguous()) for t in range(G)]
            out[name].update(numbers(lambda: torch.cat(
                [bilinear.bilinear_gather_forward(img, a, b, "zeros") for a, b in planes],
                dim=-1), "nine_k5_cat_"))
            del planes
        del img, x, y
    # K5 alone at the bridge shape (a deformable tap's coordinates, grid +
    # N(0, 1) px), held to the plain version first, beside writing its
    # output alone (``zero_``), the floor of a kernel that writes it once.
    B, H, W, C = BRIDGE
    img = torch.randn(B, H, W, C, device="cuda").to(torch.bfloat16)
    y = (torch.arange(H, device="cuda", dtype=torch.float32).view(1, H, 1)
         + torch.randn(B, H, W, device="cuda")).contiguous()
    x = (torch.arange(W, device="cuda", dtype=torch.float32).view(1, 1, W)
         + torch.randn(B, H, W, device="cuda")).contiguous()
    fn = lambda: bilinear.bilinear_gather_forward(img, x, y, "zeros")  # noqa: E731
    want = bilinear.bilinear_gather_plain(img.float(), x, y, "zeros")
    err = check_close("K5 bridge bfloat16", fn(), want,
                      1e-5 + ulp_tolerance(torch, want, torch.bfloat16))
    bound, bound_by, _, _ = gather_bound(torch, img, x, B * H * W * C, False)
    out_k5 = torch.empty_like(img)
    out["k5_bridge"] = {"shape": list(BRIDGE), **numbers(fn), "bound_ms": bound,
                        "bound_by": bound_by, "max_abs_err": err,
                        **numbers(out_k5.zero_, "zero_")}
    del img, x, y, want, out_k5
    B, H, W, C, G, Ho, Wo = DEC3
    img = torch.randn(B, H, W, C, device="cuda").to(torch.bfloat16)
    sub_y = ((torch.arange(Ho, device="cuda") + 0.5) / 2 - 0.5).view(1, 1, Ho, 1)
    sub_x = ((torch.arange(Wo, device="cuda") + 0.5) / 2 - 0.5).view(1, 1, 1, Wo)
    y = (sub_y + 0.5 * torch.randn(B, G, Ho, Wo, device="cuda")).contiguous()
    x = (sub_x + 0.5 * torch.randn(B, G, Ho, Wo, device="cuda")).contiguous()
    bound, bound_by, _, _ = gather_bound(torch, img, x, B * Ho * Wo * C, False)
    out["k4_dec3"] = {"shape": list(DEC3), "bound_ms": bound, "bound_by": bound_by, **numbers(
        lambda: bilinear.bilinear_gather_grouped_forward(img, x, y, "border"))}
    return out


def check_mixer(torch, key, args32, errors_k2, errors_k3):
    """Holds K2 and K3 in fp32, bf16 and fp16 (x and bcdt in the dtype, dt,
    B and C the strided slices of bcdt; A, the weights and D fp32) to the
    plain versions on the same (rounded) inputs, which compute in fp32 and
    round h2 to the dtype before the scatter as K3 does: each output within
    1e-5 abs + 1e-5 of its largest |value|; in bf16 and fp16 plus one ulp of
    the dtype, and for y plus one ulp of each h2 carried through the scatter
    (sum_n ulp(h2[n, c]) |C[n, l]|: an h2 whose fp32 value lies at a rounding
    boundary may round either way). Records the worst errors under
    ``key``/dtype. TF32 must be off."""
    from kmunet_tpu_torch.kernels import ssd

    x32, bcdt32, A, w_hz, w_out, D = args32
    N = A.shape[0]
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        x, bcdt = x32.to(dtype), bcdt32.to(dtype)
        Bm, Cm, dt = bcdt.split(N, dim=1)
        h = ssd.hsmssd_compress_forward(x, dt, Bm, A)
        y, h2 = ssd.hsmssd_mix_forward(x, dt, Bm, Cm, A, w_hz, w_out, D)
        want_h = ssd.hsmssd_compress_plain(x, dt, Bm, A)
        want_y, want_h2 = ssd.hsmssd_mix_plain(x, dt, Bm, Cm, A, w_hz, w_out, D)
        k = f"{key}/{str(dtype)[6:]}"
        errs = []
        for name, got, want in (("h", h, want_h), ("y", y, want_y), ("h2", h2, want_h2)):
            if got.dtype != dtype or got.shape != want.shape:
                raise AssertionError(f"{k} {name}: {got.dtype} {tuple(got.shape)}")
            want = want.float()
            tol = 1e-5 + 1e-5 * want.abs().max()
            if dtype != torch.float32:
                tol = tol + ulp_tolerance(torch, want, dtype)
                if name == "y":
                    tol = tol + torch.einsum("bnc,bnl->bcl",
                                             ulp_tolerance(torch, want_h2.float(), dtype),
                                             Cm.float().abs())
            errs.append(check_close(f"{'K2' if name == 'h' else 'K3'} {k} {name}", got, want,
                                    torch.broadcast_to(tol, want.shape)))
        errors_k2[k] = errs[0]
        errors_k3[k] = max(errs[1:])


def mixer_float64_distance(torch, args32):
    """Per dtype (fp32, bf16) and output (h, y, h2): [the kernels', the plain
    version's] largest distance from the same function in float64 on the
    same rounded inputs (the plain version run on float64 copies); y's
    float64 reference scatters that float64 h2 rounded to the dtype, as the
    kernels and the plain version scatter their rounded h2."""
    from kmunet_tpu_torch.kernels import ssd

    x32, bcdt32, A, w_hz, w_out, D = args32
    N = A.shape[0]
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x, bcdt = x32.to(dtype), bcdt32.to(dtype)
        Bm, Cm, dt = bcdt.split(N, dim=1)
        args = (x, dt, Bm, Cm, A, w_hz, w_out, D)
        x64, dt64, B64, C64, *rest = (t.double() for t in args)
        h64 = ssd.hsmssd_compress_plain(x64, dt64, B64, rest[0])
        h2_64 = ssd.hsmssd_mix_plain(x64, dt64, B64, C64, *rest)[1]
        y64 = torch.einsum("bnc,bnl->bcl", h2_64.to(dtype).double(), C64)
        got = (ssd.hsmssd_compress_forward(x, dt, Bm, A), *ssd.hsmssd_mix_forward(*args))
        plain = (ssd.hsmssd_compress_plain(x, dt, Bm, A), *ssd.hsmssd_mix_plain(*args))
        for name, k, p, ref in zip(("h", "y", "h2"), got, plain, (h64, y64, h2_64)):
            out[f"{str(dtype)[6:]}/{name}"] = [float((k.double() - ref).abs().max()),
                                               float((p.double() - ref).abs().max())]
    return out


def mixer_timing(torch, ssd, shapes=None, iters: int = 20):
    """K2 and K3 (``ssd``'s launchers) in bf16 at each (B, C, L, N) of
    ``shapes`` (MIXER_TIMING_SHAPES by default), dt, B and C the slices of
    one bcdt: ms by CUDA events over back-to-back calls, queued ms (device
    time, no host gap), the profiler's device ms, device launches per call
    and device ms per call by kernel (the passes), beside the bound."""
    out = {}
    for name, shape in (shapes or MIXER_TIMING_SHAPES).items():
        B, C, L, N = shape
        x = torch.randn(B, C, L, device="cuda").to(torch.bfloat16)
        bcdt = torch.randn(B, 3 * N, L, device="cuda").to(torch.bfloat16)
        Bm, Cm, dt = bcdt.split(N, dim=1)
        A = 1.0 + 15.0 * torch.rand(N, device="cuda")
        w_hz = torch.randn(2 * C, C, device="cuda") / C ** 0.5
        w_out = torch.randn(C, C, device="cuda") / C ** 0.5
        Dp = torch.ones(1, device="cuda")
        out[name] = {"shape": list(shape)}
        for key, fn, fused in (
                ("hsmssd_compress", lambda: ssd.hsmssd_compress_forward(x, dt, Bm, A), False),
                ("hsmssd_mix", lambda: ssd.hsmssd_mix_forward(x, dt, Bm, Cm, A, w_hz, w_out, Dp),
                 True)):
            bound, bound_by, _, _ = mixer_bound(shape, 2, fused)
            device, launches, by_kernel = device_ms(torch, fn, iters)
            out[name][key] = {
                "ms": cuda_ms(torch, fn, iters, 5), "queued_ms": queued_ms(torch, fn, iters)[0],
                "device_ms": device, "device_launches_per_call": launches,
                "device_ms_by_kernel": by_kernel, "bound_ms": bound, "bound_by": bound_by}
        del x, bcdt, Bm, Cm, dt
    return out


def ablate_inputs(torch, shape, seed, device):
    """K3a's inputs on ``device``, bf16, as the TPU script draws them: xt,
    dt, Bm, Cm N(0, 1) and A U(1, 16), from a generator seeded ``seed``."""
    B, C, L, N, _ = shape
    g = torch.Generator(device=device).manual_seed(seed)
    normal = [torch.randn(s, generator=g, device=device) for s in ((B, C, L), (B, L, N),
                                                                   (B, L, N), (B, L, N))]
    A = 1.0 + 15.0 * torch.rand(N, generator=g, device=device)
    return [t.to(torch.bfloat16) for t in (*normal, A)]


def ablate_timing(torch, ablate_mix, shape=None, iters: int = 20):
    """K3a (``ablate_mix``'s launcher) in each mode at ``shape`` (the TPU
    script's, ``ABLATE_SHAPES["script"]``, by default), each mode's output
    first held to the plain version (``check_ablate``): ms by CUDA events
    over back-to-back calls, queued ms (device time, no host gap), the
    profiler's device ms, device launches per call and device ms per call
    by kernel (the passes: tile max, compress, merge, scatter), beside
    ``ablate_bound``."""
    shape = shape or ABLATE_SHAPES["script"]
    args = ablate_inputs(torch, shape, len(ABLATE_SHAPES), "cuda")
    errors = {}
    check_ablate(torch, "script", args, shape[4], errors)
    out = {"shape": list(shape)}
    for mode in ablate_mix.MODES:
        fn = lambda mode=mode: ablate_mix.ablate_mix_forward(mode, *args, shape[4])  # noqa: E731
        bound, bound_by, _, _ = ablate_bound(shape, mode)
        device, launches, by_kernel = device_ms(torch, fn, iters)
        out[mode] = {"ms": cuda_ms(torch, fn, iters, 5), "queued_ms": queued_ms(torch, fn, iters)[0],
                     "device_ms": device, "device_launches_per_call": launches,
                     "device_ms_by_kernel": by_kernel, "bound_ms": bound, "bound_by": bound_by,
                     "max_abs_err": errors[f"script/{mode}/bfloat16"]}
    return out


def check_ablate(torch, key, args, tile, errors):
    """Holds K3a in each mode to its plain version on the same bf16 inputs,
    within one bf16 ulp of the output's scale (2^(floor(log2 max|y|) - 7):
    the kernel sums in another order, so an h / (den + 1) at a rounding
    boundary may round the other way). Records the worst error under
    ``key``/mode/bfloat16."""
    from kmunet_tpu_torch.kernels import ablate_mix

    for mode in ablate_mix.MODES:
        got = ablate_mix.ablate_mix_forward(mode, *args, tile)
        want = ablate_mix.ablate_mix_plain(mode, *args, tile).float()
        if got.dtype != torch.bfloat16 or got.shape != want.shape:
            raise AssertionError(f"K3a {key} {mode}: {got.dtype} {tuple(got.shape)}")
        ulp = 2.0 ** (torch.floor(torch.log2(want.abs().max())) - 7)
        errors[f"{key}/{mode}/bfloat16"] = check_close(f"K3a {key} {mode}", got, want,
                                                       torch.broadcast_to(ulp, want.shape))


def ablate_bound(shape, mode):
    """(bound_ms, bound_by, bytes, ops) of K3a at (B, C, L, N, tile), bf16:
    xt, dt, Bm, Cm read once and y written once over the HBM rate, against
    the products (2 operations per (b, l, n, c) each for h and y) over the
    bf16 rate of the tensor cores that run them; dma_only's one addition
    per value it loads over the fp32 rate. The second read of dt by full's
    and bf16_e's tile-max pass is work of the kernel's, not of the
    function's: it belongs to the gap to the bound, not to the bound."""
    B, C, L, N, _ = shape
    moved = (2 * B * C * L + 3 * B * L * N) * 2 + N * 4
    if mode == "dma_only":
        ops = B * C * L + 3 * B * L * N
        ops_ms = ops / H100_FP32_FLOPS * 1e3
    else:
        ops = 4 * B * L * N * C
        ops_ms = ops / H100_BF16_FLOPS * 1e3
    bytes_ms = moved / H100_BYTES_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), moved, ops


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


def kan_inputs(torch, rng, shape, case, device):
    """K1's inputs on ``device``, fp32: xp (B, C, H+2, W+2), x by ``case``
    with a zero border, as KANConv2d pads it; base (F, C, 3, 3) and the
    c-major spline (F, 8C, 3, 3), N(0, 0.3)."""
    import numpy as np

    B, C, F, H, W = shape
    if case == "unit":
        x = rng.uniform(-1.2, 1.2, (B, C, H, W))
    elif case == "wide":
        x = rng.uniform(-3.0, 3.0, (B, C, H, W))
    else:
        x = rng.choice(-1.0 + 0.4 * np.arange(-3, 9), (B, C, H, W))
    xp = np.pad(x, ((0, 0), (0, 0), (1, 1), (1, 1)))
    base = 0.3 * rng.normal(size=(F, C, 3, 3))
    spline = 0.3 * rng.normal(size=(F, 8 * C, 3, 3))
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in (xp, base, spline)]


def kan_bound(torch, xp, F):
    """(bound_ms, bound_by, bytes, ops) of K1 on these inputs (B, C, H+2,
    W+2) -> (B, F, H, W): xp read once and the output written once over the
    HBM rate, against the operations these inputs need over the tensor cores'
    rate for their type: 2 (a MAC) per (pixel, f, c, tap) for the base branch
    and per nonzero basis there for the spline branch (4 inside [-1, 1],
    fewer past it). Also the dense count (all 8 bases), as the TPU kernel
    does it."""
    import torch.nn.functional as tF

    from kmunet_tpu_torch.ops.spline import cardinal_bspline_basis_flat

    B, C, Hp, Wp = xp.shape
    H, W = Hp - 2, Wp - 2
    nnz = (cardinal_bspline_basis_flat(xp.float()) != 0).view(B, C, 8, Hp, Wp).sum(2)
    taps = float(tF.avg_pool2d(nnz.float(), 3, 1).sum()) * 9  # nonzero bases over the 9 taps
    ops = 2 * F * (taps + 9 * B * C * H * W)
    moved = (xp.numel() + B * F * H * W) * xp.element_size()
    bytes_ms = moved / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_BF16_FLOPS * 1e3
    dense = 2 * F * 9 * 9 * B * C * H * W
    return (max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), moved,
            ops, dense)


def mixer_inputs(torch, rng, shape, dt_case, device):
    """K2's and K3's inputs on ``device``, fp32: x (B, C, L) N(0, 1); bcdt
    (B, 3N, L) N(0, 1), its dt rows times 40 in the "large" case, to be split
    into B, C, dt as the mixer splits it; A U(1, 16) as HSMSSD's init; w_hz
    (2C, C) and w_out (C, C) N(0, 1/C); D U(0.5, 1.5)."""
    import numpy as np

    B, C, L, N = shape
    bcdt = rng.normal(size=(B, 3 * N, L))
    if dt_case == "large":
        bcdt[:, 2 * N:] *= 40.0
    arrays = (rng.normal(size=(B, C, L)), bcdt, rng.uniform(1.0, 16.0, N),
              rng.normal(size=(2 * C, C)) / np.sqrt(C), rng.normal(size=(C, C)) / np.sqrt(C),
              rng.uniform(0.5, 1.5, 1))
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]


def mixer_bound(shape, esz, fused: bool):
    """(bound_ms, bound_by, bytes, ops) of K2 (``fused`` False) or K3 at
    (B, C, L, N) with x, dt, B, C and the outputs of ``esz`` bytes: x, dt, B
    (and C) read once, h (or y and h2) written once, A (and the MLP's
    weights) fp32, over the HBM rate; against the products, 2 operations per
    (b, l, n, c) for the compress (and as many for the scatter, plus the
    MLP's 6 per (b, n, c, c')), over the tensor cores' rate for the type."""
    B, C, L, N = shape
    moved = (B * C * L + 2 * B * N * L + B * N * C) * esz + N * 4
    ops = 2 * B * L * N * C
    if fused:
        moved += (B * N * L + B * C * L) * esz + (3 * C * C + 1) * 4
        ops += 2 * B * L * N * C + 6 * B * N * C * C
    bytes_ms = moved / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_BF16_FLOPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), moved, ops


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


def trainer_config(tmp):
    """The trainer phase's SH run: ``sh_config`` at TRAIN_BATCH (bf16, drop path 0.1) on
    TRAINER_LENGTH synthetic items for TRAINER_EPOCHS epochs, checkpoints
    and results.json under ``tmp``, no PNG strips."""
    cfg = sh_config(TRAIN_BATCH, "bfloat16")
    cfg.data.name = "synthetic"
    cfg.data.synthetic_length = TRAINER_LENGTH
    cfg.train.epochs = TRAINER_EPOCHS
    cfg.train.ckpt_dir = os.path.join(tmp, "ckpt")
    cfg.train.out_dir = os.path.join(tmp, "out")
    cfg.train.vis_batches = 0
    return cfg


def same_results(got, want, rtol=0.0, path="results"):
    """Raises unless two results trees have the same keys and values, their
    floats within ``rtol`` relative (0: equal), NaN equal to NaN; returns
    the worst relative gap."""
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"{path}: keys {sorted(got)} != {sorted(want)}")
        return max([same_results(got[k], want[k], rtol, f"{path}/{k}") for k in want] + [0.0])
    if isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise AssertionError(f"{path}: {len(got)} values, want {len(want)}")
        return max([same_results(a, b, rtol, f"{path}/{i}")
                    for i, (a, b) in enumerate(zip(got, want))] + [0.0])
    if isinstance(want, float) and isinstance(got, float):
        if want != want and got != got:
            return 0.0
        gap = 0.0 if got == want else abs(got - want) / max(abs(want), 1e-30)
        if not gap <= rtol:
            raise AssertionError(f"{path}: {got!r} != {want!r} (relative {gap} > {rtol})")
        return gap
    if got != want:
        raise AssertionError(f"{path}: {got!r} != {want!r}")
    return 0.0


def time_calls(torch, owner, name, seconds, deterministic=False):
    """Replaces ``owner.name`` by a wrapper that appends each call's seconds
    (the device synchronized before and after) to ``seconds``, under
    ``cudnn.deterministic`` if asked; returns the original."""
    original = getattr(owner, name)

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.backends.cudnn.deterministic = deterministic
        try:
            return original(*args, **kwargs)
        finally:
            torch.backends.cudnn.deterministic = False
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)

    setattr(owner, name, timed)
    return original


def trainer_phase(torch, np, card, reset_counts, read_counts, launches_per, path_launches):
    """The trainer phase (the module docstring): the SH loop, its best
    checkpoint's test pass, the Evaluator card vs CPU, the LAPS loop; returns
    the phase's fields."""
    import csv
    import tempfile

    from kmunet_tpu_torch.metrics import Evaluator
    from kmunet_tpu_torch.train import checkpoint, engine

    torch.backends.cudnn.allow_tf32 = True  # PyTorch's defaults, as a user trains
    torch.backends.cuda.matmul.allow_tf32 = False
    seconds = {"test_pass": [], "checkpoint_save": []}
    evaluate = time_calls(torch, engine, "evaluate_model", seconds["test_pass"],
                          deterministic=True)
    save = time_calls(torch, checkpoint.CheckpointManager, "save", seconds["checkpoint_save"])
    fields = {"nvidia_smi": card}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            cfg = trainer_config(tmp)
            steps = TRAINER_EPOCHS * TRAINER_LENGTH // TRAIN_BATCH
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            results = engine.train_and_evaluate(cfg, log_csv=os.path.join(tmp, "epochs.csv"))
            wall = time.perf_counter() - t0
            launches = path_launches["trainer"] = read_counts()
            peak = torch.cuda.max_memory_allocated() / 2**30
            # K7 in every forward: the train steps', the val batches' and the test batch's.
            expect_launches("trainer", launches, launches_per(
                k7=DEFORM_CONVS * (steps + TRAINER_EPOCHS + 1), k6s=DEFORM_CONVS * steps))
            history = results["history"]
            if results["steps"] != steps or not np.isfinite(
                    history["train_loss"] + history["val_loss"] + [results["test_loss"]]).all():
                raise AssertionError(f"trainer: {results['steps']} steps, history {history}")
            with open(os.path.join(cfg.train.out_dir, "results.json")) as fh:
                written = json.load(fh)
            scores = [written[k] for k in ("FAR", "RMSE", "SSIM")] + [
                v for m in written["threshold_metrics"].values() for v in m.values()]
            if not all(isinstance(v, float) and np.isfinite(v) for v in scores):
                raise AssertionError(f"trainer: results.json scores {scores}")
            with open(os.path.join(tmp, "epochs.csv")) as fh:
                ends = [float(r["time"]) for r in csv.DictReader(fh)]
            best = checkpoint.CheckpointManager(cfg.train.ckpt_dir).best_step()
            if best != steps:
                raise AssertionError(f"trainer: the best checkpoint is step {best}, not the "
                                     f"last epoch's {steps} (val losses {history['val_loss']})")
            restored = engine.evaluate_checkpoint(cfg, cfg.train.ckpt_dir, which="best")
            if restored["checkpoint_step"] != steps:
                raise AssertionError(f"trainer: restored step {restored['checkpoint_step']}")
            same_results({k: v for k, v in restored.items() if k != "checkpoint_step"},
                         {k: v for k, v in results.items() if k not in ("history", "steps")})
            fields.update(
                batch=TRAIN_BATCH, compute="bfloat16", epochs=TRAINER_EPOCHS, steps=steps,
                synthetic_length=TRAINER_LENGTH, launches=launches, history=history,
                test_loss=results["test_loss"], FAR=results["FAR"], RMSE=results["RMSE"],
                SSIM=results["SSIM"], threshold_metrics=written["threshold_metrics"],
                epoch_seconds=[b - a for a, b in zip([0.0] + ends, ends)],
                loop_seconds=wall, test_pass_seconds=seconds["test_pass"],
                checkpoint_save_seconds=seconds["checkpoint_save"], peak_gib=peak,
                best_checkpoint=best, restored_equals_in_memory=True)

            # The Evaluator on the card and on the CPU, on the same inputs.
            rng = np.random.default_rng(18)
            shape = (TRAIN_BATCH, 20, 128, 128)
            evaluators = {dev: Evaluator(seq_len=20, value_scale=90.0) for dev in ("cuda", "cpu")}
            for _ in range(2):
                true = rng.random(shape, dtype=np.float32)
                pred = np.clip(true + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
                pred[..., :16] = rng.integers(0, 91, (*shape[:3], 16)) / np.float32(90.0)
                for dev, ev in evaluators.items():
                    ev.evaluate(torch.from_numpy(true).to(dev), torch.from_numpy(pred).to(dev))
            on_card, on_cpu = evaluators["cuda"], evaluators["cpu"]
            if not np.array_equal(on_card._cont_t, on_cpu._cont_t):
                raise AssertionError("Evaluator: the card's contingency counts differ")
            done_card, done_cpu = on_card.done(), on_cpu.done()
            rel = {k: abs(done_card[k] - done_cpu[k]) / abs(done_cpu[k]) for k in ("RMSE", "SSIM")}
            if max(rel.values()) > EVALUATOR_RTOL:
                raise AssertionError(f"Evaluator card vs CPU: {rel} > {EVALUATOR_RTOL}")
            fields["evaluator_card_vs_cpu"] = {"counts_equal": True, "relative_error": rel,
                                               "tf32_matmul": False}

            # The LAPS recipe with the scatter metrics: no kernel on its path.
            cfg = laps_config(1, "float32")
            cfg.data.name = "synthetic"
            cfg.data.synthetic_length = LAPS_TRAINER_LENGTH
            cfg.train.epochs = 1
            cfg.train.out_dir = os.path.join(tmp, "laps")
            cfg.train.vis_batches = 0
            reset_counts()
            t0 = time.perf_counter()
            laps = engine.train_and_evaluate(cfg)
            laps_wall = time.perf_counter() - t0
            launches = path_launches["trainer_laps"] = read_counts()
            expect_launches("trainer_laps", launches, launches_per())
            scatter = laps["scatter"]
            if laps["steps"] != LAPS_TRAINER_LENGTH or set(scatter) != set(cfg.data.thresholds) \
                    or not all(np.isfinite(list(row.values())).all() for row in scatter.values()):
                raise AssertionError(f"LAPS loop: {laps['steps']} steps, scatter {scatter}")
            fields["laps"] = {"batch": 1, "size": LAPS_SIZE, "compute": "float32",
                              "steps": laps["steps"], "history": laps["history"],
                              "loop_seconds": laps_wall, "scatter": scatter}
    finally:
        engine.evaluate_model = evaluate
        checkpoint.CheckpointManager.save = save
    return fields


def _kernel_counters():
    """{name: the launch counter's owner} of the kernels on the data-parallel
    path: K7, K6's shared-source entry, K8 and its backward."""
    from kmunet_tpu_torch.kernels import bilinear, scan

    return {"bilinear_gather_multiview": bilinear.bilinear_gather_multiview,
            "bilinear_gather_multiview_backward": bilinear.bilinear_gather_multiview_backward,
            "selective_scan": scan.selective_scan, "selective_scan_backward": scan.selective_scan_backward}


def _counts(torch, reset=False):
    torch.cuda.synchronize()
    counters = _kernel_counters()
    if reset:
        for k in counters.values():
            k.launches = 0
    return {name: k.launches for name, k in counters.items()}


def _dp_rank(rank, world, port, job, args, out_dir):
    """One rank of the data_parallel phase: joins the NCCL group on
    cuda:rank, runs ``job(rank, world, *args)`` and saves what it returns."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, device_id=torch.device("cuda", rank))
    try:
        torch.save(job(rank, world, *args), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(torch, world, job, *args):
    """``job(rank, world, *args)`` in ``world`` processes, one per card, over
    NCCL (a store on a free localhost port); their results by rank. A rank
    that fails raises here; ranks alive at the deadline are killed."""
    import socket
    import tempfile

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as out:
        ctx = torch.multiprocessing.start_processes(
            _dp_rank, args=(world, port, job, args, out), nprocs=world, join=False,
            start_method="spawn")
        deadline = time.monotonic() + DP_SECONDS
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"data_parallel: {job.__name__} on {world} cards ran past "
                                   f"{DP_SECONDS} s")
        return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]


def mesh_step_readings(cfg, mesh, batch, generator):
    """``step_readings`` through the mesh path: the engine's step on this
    rank's rows of ``batch`` from weights made from seed 0 (the sharded
    leaves' blocks), the gradients where the optimizer takes them and the
    state after the step gathered whole, on the CPU."""
    from kmunet_tpu_torch.parallel import batch_sharding
    from kmunet_tpu_torch.parallel.collectives import gather
    from kmunet_tpu_torch.train import engine

    model = engine.build_model(cfg)
    tx = engine.build_optimizer(cfg, steps_per_epoch=100)
    state = engine.init_state(cfg, model, tx, seed=0, device=batch.device, mesh=mesh)
    step = engine.make_train_step(model, engine.build_loss(cfg, mesh), tx, cfg)
    seen = []
    update = tx.update
    tx.update = lambda grads, *a, **k: seen.append(list(grads)) or update(grads, *a, **k)
    state, m = step(state, batch_sharding(mesh, batch), generator)

    def whole(key, t):
        dim = state.shards.get(key)
        return (t if dim is None else gather(t.contiguous(), mesh.axis("model"), dim=dim)).cpu()

    grads = {k: whole(k, g) for k, g in zip(state.params, seen[0])}
    after = {k: whole(k, p.detach()) for k, p in state.params.items()}
    after.update({k: b.cpu() for k, b in state.batch_stats.items()})
    return (float(m["loss"]), float(m["grad_norm"]), grads), after, len(state.shards)


def dp_world1_job(rank, world):
    """World 1 through the mesh path: the SH B=16 bf16 step with drop path
    0.1 from a CUDA generator, plain and through a 1 x 1 x 1 mesh over NCCL
    (its collectives run on a group of one), from the same weights, batch
    and generator state, under ``cudnn.deterministic``: the loss, the grad
    norm and every parameter and buffer after the step, bit for bit; then
    the mesh step's ``dp_bf16_step``."""
    import numpy as np
    import torch

    from kmunet_tpu_torch.parallel import MeshSpec, make_mesh
    from kmunet_tpu_torch.parallel.mesh import REPLICA
    from kmunet_tpu_torch.train import engine

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    dev = torch.device("cuda", rank)
    cfg = sh_config(TRAIN_BATCH, "bfloat16")
    batch = torch.from_numpy(synthetic_batch(np, TRAIN_BATCH, seed=0)).to(dev)
    mesh = make_mesh(MeshSpec(cfg.mesh.data, cfg.mesh.spatial, cfg.mesh.model))
    runs = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        model = engine.build_model(cfg)
        tx = engine.build_optimizer(cfg, steps_per_epoch=100)
        state = engine.init_state(cfg, model, tx, seed=0, device=dev, mesh=m)
        step = engine.make_train_step(model, engine.build_loss(cfg, m), tx, cfg)
        gen = torch.Generator(device=dev).manual_seed(0)
        _counts(torch, reset=True)
        state, metrics = step(state, batch, gen)
        launches = _counts(torch)
        runs[name] = (float(metrics["loss"]), float(metrics["grad_norm"]),
                      {k: v.detach().clone() for k, v in model.state_dict().items()}, launches,
                      state.distributed)
    (loss, gn, after, _, _), (loss_m, gn_m, after_m, launches, through) = runs["plain"], runs["mesh"]
    equal = loss == loss_m and gn == gn_m and all(torch.equal(after[k], after_m[k]) for k in after)
    torch.backends.cudnn.deterministic = False
    return {"bit_equal": equal, "collectives": through and mesh.axis(REPLICA).group is not None,
            "loss": [loss, loss_m], "grad_norm": [gn, gn_m], "launches": launches,
            "bf16_step": dp_bf16_step(torch, batch, mesh)}


def dp_multi_job(rank, world, tmp):
    """The multi-card checks on ``world`` cards (the module docstring's
    data_parallel): the fp32 dp = world step and the FSDP step (data =
    world / 2 x model 2) as ``mesh_step_readings``, the dp trainer, the bf16
    dp step's ms and peak memory and the sharded scan, each rank's."""
    import numpy as np
    import torch

    from kmunet_tpu_torch.ops.scan import selective_scan_sharded
    from kmunet_tpu_torch.parallel import MeshSpec, make_mesh
    from kmunet_tpu_torch.train import engine

    dev = torch.device("cuda", rank)
    out = {}
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    batch = torch.from_numpy(synthetic_batch(np, TRAIN_BATCH, seed=0)).to(dev)
    cfg = sh_config(TRAIN_BATCH, "float32")
    for name, spec, fsdp in (("dp", (world, 1, 1), False), ("fsdp", (world // 2, 1, 2), True)):
        cfg.mesh.fsdp = fsdp
        readings, after, shards = mesh_step_readings(
            cfg, make_mesh(MeshSpec(*spec)), batch, torch.Generator(device=dev).manual_seed(0))
        out[name] = {"readings": readings, "after": after, "mesh": list(spec), "shards": shards}
    cfg.mesh.fsdp = False
    out["trainer"] = engine.train_and_evaluate(dp_trainer_config(tmp))
    torch.backends.cudnn.deterministic = False

    out["bf16_step"] = dp_bf16_step(torch, batch, make_mesh(MeshSpec(world, 1, 1)))

    # The sequence-parallel scan over every card.
    args, g = scan_inputs(np, np.random.default_rng(19), DP_SCAN_SHAPE, "mamba")
    args = [torch.from_numpy(a).to(dev).requires_grad_() for a in args]
    _counts(torch, reset=True)
    y = selective_scan_sharded(*args, make_mesh(MeshSpec(1, world, 1)), axis="spatial")
    grads = torch.autograd.grad((y * torch.from_numpy(g).to(dev)).sum(), args)
    out["scan"] = {"outputs": [t.detach().cpu() for t in (y, *grads)], "launches": _counts(torch)}
    return out


def dp_bf16_step(torch, batch, mesh=None):
    """The SH recipe's bf16 step on the global ``batch`` (B=16; this rank's
    rows under a ``mesh``), PyTorch's default TF32 settings: ms by CUDA
    events over DP_TIMED_STEPS steps after 2 warm-up steps, the peak
    ``max_memory_allocated``, K7 and K6 shared launches per step, the
    losses."""
    from kmunet_tpu_torch.parallel import batch_sharding
    from kmunet_tpu_torch.train import engine

    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    dev = batch.device
    cfg = sh_config(TRAIN_BATCH, "bfloat16")
    model = engine.build_model(cfg)
    tx = engine.build_optimizer(cfg, steps_per_epoch=100)
    state = engine.init_state(cfg, model, tx, seed=0, device=dev, mesh=mesh)
    step = engine.make_train_step(model, engine.build_loss(cfg, mesh), tx, cfg)
    rows = batch if mesh is None else batch_sharding(mesh, batch)
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(2):
        state, _ = step(state, rows, gen)
    torch.cuda.reset_peak_memory_stats(dev)
    _counts(torch, reset=True)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    losses = [step(state, rows, gen)[1]["loss"] for _ in range(DP_TIMED_STEPS)]
    end.record()
    launches = _counts(torch)
    return {"rows": rows.shape[0], "ms": start.elapsed_time(end) / DP_TIMED_STEPS,
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
            "launches_per_step": {k: v / DP_TIMED_STEPS for k, v in launches.items()},
            "losses": [float(v) for v in losses]}


def dp_trainer_config(tmp):
    """``trainer_config`` in fp32 with SGD (AdamW's first update is about lr
    whatever |g|, so it would amplify rounding noise; ROADMAP's rules), so
    that the loop across cards can be held to one card's."""
    cfg = trainer_config(tmp)
    cfg.train.compute_dtype, cfg.train.optimizer = "float32", "sgd"
    return cfg


def data_parallel_phase(torch, np, card, path_launches, launches_per):
    """The data_parallel phase (the module docstring); returns its fields."""
    import tempfile

    from kmunet_tpu_torch.kernels import scan
    from kmunet_tpu_torch.train import engine

    visible = torch.cuda.device_count()
    cards = max(c for c in (1, 2, DP_MAX_CARDS) if c <= visible)  # the FSDP mesh is data x 2
    torch.cuda.empty_cache()
    fields = {"nvidia_smi": card, "cards": cards}
    print(f"data_parallel: cards: {cards}", flush=True)
    world1 = spawn_ranks(torch, 1, dp_world1_job)[0]
    if not (world1["bit_equal"] and world1["collectives"]):
        raise AssertionError(f"data_parallel: the world-1 mesh step differs from the plain "
                             f"step: {world1}")
    path_launches["data_parallel"] = {**launches_per(), **world1["launches"]}
    fields["world1"] = world1
    if cards == 1:
        fields["multi_card"] = ("not run (cards: 1): dp = N and FSDP steps against one card, "
                                "the dp trainer, the sharded scan")
        print(f"data_parallel: multi-card checks {fields['multi_card']}", flush=True)
        return fields

    # One card's references, on card 0, before the ranks start.
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda", 0)
    cfg = sh_config(TRAIN_BATCH, "float32")
    batch = synthetic_batch(np, TRAIN_BATCH, seed=0)
    reference = step_readings(cfg, "cuda", batch, generator=torch.Generator(
        device=dev).manual_seed(0))
    lr = engine.build_optimizer(cfg, steps_per_epoch=100).lr(0)
    with tempfile.TemporaryDirectory() as tmp:
        one_card = engine.train_and_evaluate(dp_trainer_config(tmp))
    torch.backends.cudnn.deterministic = False
    one_card_bf16 = dp_bf16_step(torch, torch.from_numpy(batch).to(dev))
    args, g = scan_inputs(np, np.random.default_rng(19), DP_SCAN_SHAPE, "mamba")
    args, g = [torch.from_numpy(a).to(dev) for a in args], torch.from_numpy(g).to(dev)
    ref, tols, _ = scan_reference(torch, args, g)
    unsharded = (scan.selective_scan_forward(*args), *scan.selective_scan_backward(*args, g))
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_ranks(torch, cards, dp_multi_job, tmp)
    checks = {}
    for name in ("dp", "fsdp"):
        checks[name] = []
        for rank in ranks:
            r = rank[name]
            got = (r["readings"], r["after"])
            checks[name].append({**compare_steps(r["readings"], reference[0]),
                                 **compare_states(got, reference, lr, float("inf"))})
        for rank in ranks[1:]:  # every rank holds the same state
            for k, v in rank[name]["after"].items():
                if not torch.equal(v, ranks[0][name]["after"][k]):
                    raise AssertionError(f"data_parallel {name}: rank states differ at {k}")
        checks[name] = {"mesh": ranks[0][name]["mesh"], "sharded_leaves": ranks[0][name]["shards"],
                        "ranks": checks[name]}
    trainer_gap = max(same_results(rank["trainer"], one_card, DP_RESULTS_RTOL)
                      for rank in ranks)
    scan_errors = []
    for rank in ranks:
        errs = {}
        for name, got, want, tol, k8 in zip(SCAN_OUTPUTS, rank["scan"]["outputs"], ref, tols,
                                            unsharded):
            errs[name] = check_close(f"sharded scan {name}", got.to(dev), want,
                                     torch.full_like(want, tol))
            errs[f"{name}_vs_k8"] = float((got.to(dev) - k8).abs().max())
        scan_errors.append(errs)
        if rank["scan"]["launches"]["selective_scan"] != 1 or \
                rank["scan"]["launches"]["selective_scan_backward"] != 1:
            raise AssertionError(f"sharded scan launches {rank['scan']['launches']}")
    fields.update(
        fp32_steps=checks, trainer={"one_card": {k: v for k, v in one_card.items()
                                                 if k != "history"},
                                    "history_one_card": one_card["history"],
                                    "history_ranks": [r["trainer"]["history"] for r in ranks],
                                    "worst_relative_gap": trainer_gap,
                                    "rtol": DP_RESULTS_RTOL},
        bf16_step=[r["bf16_step"] for r in ranks], bf16_step_one_card=one_card_bf16,
        scan={"shape": list(DP_SCAN_SHAPE), "tolerances": dict(zip(SCAN_OUTPUTS, tols)),
              "ranks": scan_errors, "launches": [r["scan"]["launches"] for r in ranks]})
    for r, rank in enumerate(ranks):
        per_step = rank["bf16_step"]["launches_per_step"]
        if per_step["bilinear_gather_multiview"] != DEFORM_CONVS or \
                per_step["bilinear_gather_multiview_backward"] != DEFORM_CONVS:
            raise AssertionError(f"data_parallel rank {r}: launches per step {per_step}")
    return fields


def data_parallel_only(torch, np) -> int:
    """``python3 chip_smoke.py --phase data_parallel``: the card's line, the
    build of K7's, K6's and K8's sources (one nvcc each, together) and the
    data_parallel phase alone, on every visible card up to DP_MAX_CARDS."""
    from concurrent.futures import ThreadPoolExecutor

    from kmunet_tpu_torch.kernels import bilinear, build, scan

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=30,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    with Phase("build") as f:
        sources = (bilinear.MULTIVIEW_SOURCE, bilinear.BACKWARD_SOURCE, scan.SOURCE)
        with ThreadPoolExecutor(len(sources)) as pool:
            builds = list(pool.map(build.build, sources))
        f.update(nvcc_seconds=[round(b.seconds, 3) for b in builds])
    names = list(_kernel_counters())
    path_launches = {}
    with Phase("data_parallel") as f:
        f.update(data_parallel_phase(torch, np, card, path_launches,
                                     lambda: dict.fromkeys(names, 0)))
    faulthandler.cancel_dump_traceback_later()
    emit({"ok": True, "phases": ["data_parallel"],
          "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()}})
    return 0


def main() -> int:
    faulthandler.dump_traceback_later(DEADLINE_S, exit=True)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    if sys.argv[1:] == ["--phase", "data_parallel"]:
        return data_parallel_only(torch, np)
    from concurrent.futures import ThreadPoolExecutor

    import torch.nn.functional as F

    from kmunet_tpu_torch import serve
    from kmunet_tpu_torch.kernels import ablate_mix, bilinear, build, kanconv, scan, ssd

    kernels = {"bilinear_gather": bilinear.bilinear_gather,
               "bilinear_gather_backward": bilinear.bilinear_gather_backward,
               "bilinear_gather_grouped": bilinear.bilinear_gather_grouped,
               "bilinear_gather_grouped_backward": bilinear.bilinear_gather_grouped_backward,
               "bilinear_gather_multiview": bilinear.bilinear_gather_multiview,
               "bilinear_gather_multiview_backward": bilinear.bilinear_gather_multiview_backward,
               "selective_scan": scan.selective_scan,
               "selective_scan_backward": scan.selective_scan_backward,
               "fused_kanconv": kanconv.fused_kanconv,
               "hsmssd_compress": ssd.hsmssd_compress,
               "hsmssd_mix": ssd.hsmssd_mix,
               "ablate_mix": ablate_mix.ablate_mix}

    def launches_per(k5=0, k6=0, k4=0, k6g=0, k7=0, k6s=0, k8=0, k8b=0, k1=0, k2=0, k3=0,
                     k3a=0):
        return {"bilinear_gather": k5, "bilinear_gather_backward": k6,
                "bilinear_gather_grouped": k4, "bilinear_gather_grouped_backward": k6g,
                "bilinear_gather_multiview": k7, "bilinear_gather_multiview_backward": k6s,
                "selective_scan": k8, "selective_scan_backward": k8b,
                "fused_kanconv": k1, "hsmssd_compress": k2, "hsmssd_mix": k3,
                "ablate_mix": k3a}

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
    nvidia_smi = card  # ``card`` names the card's step in the phases below

    with Phase("build") as f:
        sources = (bilinear.SOURCE, bilinear.MULTIVIEW_SOURCE, bilinear.BACKWARD_SOURCE,
                   scan.SOURCE, kanconv.SOURCE, ssd.SOURCE, ablate_mix.SOURCE)
        with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc each, started together
            builds = list(pool.map(build.build, sources))
        for entry in (bilinear.backward_kernel,
                      bilinear.grouped_kernel, bilinear.grouped_backward_kernel,
                      bilinear.multiview_kernel, bilinear.multiview_backward_kernel,
                      scan.forward_kernel, scan.backward_kernel, kanconv.kernel,
                      ssd.compress_kernel, ssd.mix_kernel, ablate_mix.kernel):
            entry()
        f.update(sources=[K4_SOURCE, K7_SOURCE, K6_SOURCE, K8_SOURCE, K1_SOURCE, K2_SOURCE,
                          K3A_SOURCE],
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
            # The backward: its owner pass and warp sums add in another
            # order than the plain version, the same order on every call.
            got_b = backward(img, x, y, g, mode)
            again = backward(img, x, y, g, mode)
            for name, a, b in zip(("d_img", "d_x", "d_y"), got_b, again):
                if not torch.equal(a, b):
                    raise AssertionError(f"{names[1]} {k} {name}: two calls differ")
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
    k8_errors, k8b_errors, k8_tolerances, k8_float64 = {}, {}, {}, {}
    k1_errors, k2_errors, k3_errors, k3a_errors, k3_float64 = {}, {}, {}, {}, {}
    with Phase("kernel") as f:
        rng = np.random.default_rng(0)
        plain_ops = (bilinear.bilinear_gather_forward, bilinear.bilinear_gather_backward,
                     bilinear.bilinear_gather_plain, bilinear.bilinear_gather_backward_plain)
        for shape_name, (B, H, W, C), (Ho, Wo) in (("bridge", BRIDGE, BRIDGE[1:3]),
                                                   ("ragged", RAGGED, (RAGGED[1] + 1, RAGGED[2] - 2)),
                                                   ("odd", ODD, (ODD[1] - 1, ODD[2] + 2)),
                                                   ("unstaged", (1, 16, 16, 8), (160, 160))):
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
        # K8 and its backward: y and the six gradients.
        for shape_name, (shape, dt_cases) in SCAN_SHAPES.items():
            for dt_case in dt_cases:
                args, g = scan_inputs(np, rng, shape, dt_case)
                args = [torch.from_numpy(a).to(dev) for a in args]
                g = torch.from_numpy(g).to(dev)
                ref, tols, exact = scan_reference(torch, args, g)
                key = f"{shape_name}/{dt_case}"
                k8_tolerances[key] = dict(zip(SCAN_OUTPUTS, tols))
                for dtype in (torch.float32, torch.bfloat16, torch.float16):
                    check_scan(torch, key, args, g, ref, tols, dtype, k8_errors, k8b_errors,
                               k8_float64, exact)
                del args, g, ref, exact
        # K1, K2 and K3 against their plain versions, which run cuDNN convs
        # and cuBLAS products here: TF32 off.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        for shape_name, shape in KAN_SHAPES.items():
            for case in KAN_X_CASES:
                check_kanconv(torch, f"{shape_name}/{case}",
                              *kan_inputs(torch, rng, shape, case, dev), k1_errors)
        mixer_slices = {}  # the compress pass's slices per batch element, merged by K2 and K3
        for shape_name, (shape, dt_cases) in MIXER_SHAPES.items():
            for dt_case in dt_cases:
                args32 = mixer_inputs(torch, rng, shape, dt_case, dev)
                mixer_slices[shape_name] = ssd._slices(args32[0])[0]
                check_mixer(torch, f"{shape_name}/{dt_case}", args32, k2_errors, k3_errors)
                if f"{shape_name}/{dt_case}" in MIXER_FLOAT64_CASES:
                    k3_float64[f"{shape_name}/{dt_case}"] = mixer_float64_distance(torch, args32)
        for i, (shape_name, shape) in enumerate(ABLATE_SHAPES.items()):
            check_ablate(torch, shape_name, ablate_inputs(torch, shape, i, dev), shape[4],
                         k3a_errors)
        torch.cuda.synchronize()
        f.update(cases=len(errors) + len(k4_errors) + len(k7_errors) + len(k8_errors)
                 + len(k1_errors) + len(k2_errors) + len(k3a_errors),
                 k5_max_abs_err=errors, k6_max_abs_err=k6_errors, k4_max_abs_err=k4_errors,
                 k6_grouped_max_abs_err=k6g_errors, k7_max_abs_err=k7_errors,
                 k6_shared_max_abs_err=k6s_errors, k7_layout="exact",
                 k8_max_abs_err=k8_errors, k8_backward_max_abs_err=k8b_errors,
                 k8_tolerance="fp32: 4 x the plain version's largest distance from float64 on "
                              "the same inputs + 1e-6 x the largest |value|; bf16, fp16: that "
                              "+ one ulp of the dtype, against the plain version on the same "
                              "rounded inputs",
                 k8_tolerances_fp32=k8_tolerances,
                 k8_float64_distance={"per_output": "[kernels, plain version]", **k8_float64},
                 k1_max_abs_err=k1_errors,
                 k2_max_abs_err=k2_errors, k3_max_abs_err=k3_errors, mixer_slices=mixer_slices,
                 k3_float64_distance={"per_output": "[kernels, plain version]", **k3_float64},
                 k1_k3_tolerance="fp32: 1e-5 + 1e-5 x the largest |value| of the plain version; "
                                 "bf16, fp16: that + one ulp of the dtype against the plain "
                                 "version in fp32 on the same rounded inputs (K3's y also + "
                                 "sum_n ulp(h2) |C|)",
                 k3a_max_abs_err=k3a_errors,
                 k3a_tolerance="one bf16 ulp of the output's scale, 2^(floor(log2 max|y|) - 7), "
                               "against the plain version on the same bf16 inputs")

    with Phase("k1_float64_distance") as f:
        torch.backends.cudnn.allow_tf32 = False
        f1 = np.random.default_rng(14)
        distances = {}
        for key in KAN_FLOAT64_CASES:
            shape_name, case = key.split("/")
            distances[key] = kan_float64_distance(
                torch, *kan_inputs(torch, f1, KAN_SHAPES[shape_name], case, dev))
        f.update(per_dtype="[K1, plain version]", **distances)

    def serve_path(path, window, f, kan_fused=False, ssd_mixer="einsum"):
        """Serves REQUESTS fp32 requests of B=2 on the card with
        ``dysample_window=window``, ``kan_fused`` and ``ssd_mixer``, counting
        launches, and holds the answers to the same weights on the CPU."""
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        options = dict(dysample_window=window, kan_fused=kan_fused, ssd_mixer=ssd_mixer)
        model = serve.build_km_unet_v3_sh(device="cuda", dtype=torch.float32, seed=0, **options)
        requests = [rng.uniform(size=(REQUEST_BATCH, 128, 128, 5)).astype(np.float32)
                    for _ in range(REQUESTS)]
        if not window:  # seeded offsets are ~1e-3 px: make them reach OFFSET_REACH_PX
            offsets = reach_offsets(torch, model, torch.from_numpy(requests[0]).to(dev),
                                    OFFSET_REACH_PX)
            f.update(largest_offset_px_seeded=offsets[0], largest_offset_px=offsets[1])
        reset_counts()
        answers = [serve.predict(model, frames) for frames in requests]
        launches = path_launches[path] = read_counts()
        expect_launches(path, launches, launches_per(
            k7=DEFORM_CONVS * REQUESTS, k4=0 if window else DYSAMPLES * REQUESTS,
            k1=KAN_CONVS * REQUESTS if kan_fused else 0,
            k2=SSD_MIXERS * REQUESTS if ssd_mixer == "compress" else 0,
            k3=SSD_MIXERS * REQUESTS if ssd_mixer == "fused" else 0))
        model_cpu = serve.build_km_unet_v3_sh(device="cpu", dtype=torch.float32, seed=0, **options)
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
                 max_abs_err_vs_cpu=slice_err, tf32=False, **options)

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
            k7=DEFORM_CONVS * TRAIN_STEPS, k6s=DEFORM_CONVS * TRAIN_STEPS, k4=grouped,
            k6g=grouped))
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

    # KM_UNetV3-SH with its KAN convs through K1 and its HSM-SSD mixers
    # through K3 (or K2): the same weights' answers on the CPU take the plain
    # versions.
    with Phase("serve_fused") as f:
        serve_path("serve_fused", True, f, kan_fused=True, ssd_mixer="fused")
    with Phase("serve_compress") as f:
        serve_path("serve_compress", True, f, ssd_mixer="compress")
    with Phase("train_fused") as f:
        # One fp32 SH step at B=2 through K1 and K3 (their backward the
        # plain versions' autograd) on the card, TF32 off, against the same
        # step on the CPU, with no stochastic depth.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        batch = synthetic_batch(np, CHECK_BATCH, seed=6)
        cfg = sh_config(CHECK_BATCH, "float32", drop_path=0.0)
        options = dict(kan_fused=True, ssd_mixer="fused")
        reset_counts()
        card = step_gradients(cfg, "cuda", batch, **options)
        launches = path_launches["train_fused"] = read_counts()
        expect_launches("train_fused", launches, launches_per(
            k7=DEFORM_CONVS, k6s=DEFORM_CONVS, k1=KAN_CONVS, k3=SSD_MIXERS))
        check = compare_steps(card, step_gradients(cfg, "cpu", batch, **options))
        f.update(batch=CHECK_BATCH, compute="float32", launches=launches, check=check,
                 tf32=False, **options)

    with Phase("train_options") as f:
        # The SH step through K1 and K3 with every option that changes its
        # function: the KAN regularizer, the clip, the masked decay, and
        # remat, with stochastic depth from the caller's generator. fp32,
        # TF32 off: the remat step against the step without remat from the
        # same weights, batch and generator state; then the remat step
        # without stochastic depth against the CPU's (the two devices'
        # generators draw differently).
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        fused = dict(kan_fused=True, ssd_mixer="fused")
        batch = synthetic_batch(np, CHECK_BATCH, seed=8)
        runs, gens = {}, {}
        for remat in (False, True):
            gen = torch.Generator(device=dev).manual_seed(5)
            reset_counts()
            runs[remat] = step_readings(options_config(CHECK_BATCH, "float32", remat), "cuda",
                                        batch, generator=gen, **fused)
            launches = read_counts()
            gens[remat] = gen.get_state()
            if remat:  # the recompute runs every forward kernel again
                path_launches["train_options"] = launches
            expect_launches(f"train_options remat={remat}", launches, launches_per(
                k7=DEFORM_CONVS * (1 + remat), k6s=DEFORM_CONVS, k1=KAN_CONVS * (1 + remat),
                k3=SSD_MIXERS * (1 + remat)))
        if not torch.equal(gens[True], gens[False]):
            raise AssertionError("train_options: the remat step left the generator elsewhere")
        remat_check = compare_steps(runs[True][0], runs[False][0])
        lr = float(options_config(CHECK_BATCH, "float32", True).train.lr)  # cosine at epoch 0
        remat_check.update(compare_states(runs[True], runs[False], lr, OPTIONS_GRAD_CLIP))
        remat_check["grads_bit_equal"] = all(
            torch.equal(g, runs[False][0][2][k]) for k, g in runs[True][0][2].items())
        cfg = options_config(CHECK_BATCH, "float32", True, drop_path=0.0)
        cpu_check = compare_steps(step_gradients(cfg, "cuda", batch, **fused),
                                  step_gradients(cfg, "cpu", batch, **fused))

        # The bench's bf16 step (B=16 and B=32) with the same options, remat
        # off and on, PyTorch's default TF32 settings as in the timing phase.
        torch.backends.cudnn.allow_tf32 = True
        timed = {}
        for B in OPTIONS_BATCHES:
            for remat in (False, True):
                _, state, step, _ = train_setup(options_config(B, "bfloat16", remat), "cuda",
                                                **fused)
                frames = torch.rand(B, 25, 128, 128, device=dev)
                gen = torch.Generator(device=dev).manual_seed(1)
                torch.cuda.reset_peak_memory_stats()
                ms = cuda_ms(torch, lambda: step(state, frames, gen), 5)
                timed[f"B{B}_bfloat16" + ("_remat" if remat else "")] = {
                    "ms": ms, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
                del state, step, frames

        # The optimizers: three updates of seeded parameters on the card and
        # on the CPU.
        rng = np.random.default_rng(9)
        params = [rng.normal(size=s).astype(np.float32) for s in OPTIMIZER_SHAPES]
        grads = [[np.asarray(rng.normal(size=s), np.float32) for s in OPTIMIZER_SHAPES]
                 for _ in range(3)]
        optimizer_errors = {}
        for name, make in optimizer_cases().items():
            got = run_optimizer(torch, make, params, grads, dev)
            want = run_optimizer(torch, make, params, grads, "cpu")
            if name == "rprop":
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError("rprop: the card's updates differ from the CPU's")
            share = max(float((a - b).abs().max()) / (OPTIMIZER_RTOL * float(b.abs().max()))
                        for a, b in zip(got, want))
            if share > 1.0:
                raise AssertionError(f"{name}: card vs CPU {share} of the tolerance")
            optimizer_errors[name] = share
        f.update(batch=CHECK_BATCH, compute="float32", tf32=False, drop_path=0.1,
                 kan_reg_weight=OPTIONS_KAN_REG, grad_clip=OPTIONS_GRAD_CLIP, wd_mask_norms=True,
                 launches=path_launches["train_options"], remat_vs_plain=remat_check,
                 remat_vs_cpu=cpu_check, step_timing=timed,
                 optimizer_share_of_tol=optimizer_errors, **fused)

    with Phase("grid_sample") as f:
        # The port's F.grid_sample-style op on the card, forward and
        # backward: K5 and K6, the single-set entries, which no model path
        # runs since the deformable conv's taps are K7's views; each call
        # held to the same call on the CPU.
        from kmunet_tpu_torch.ops import sample

        B, H, W, C = REQUEST_BATCH, *BRIDGE[1:]
        calls = []
        for _ in range(REQUESTS):
            img = rng.normal(size=(B, H, W, C)).astype(np.float32)
            grid = rng.uniform(-1.1, 1.1, size=(B, H, W, 2)).astype(np.float32)
            g = rng.normal(size=(B, H, W, C)).astype(np.float32)
            calls.append((img, grid, g))

        def grid_sample(device, img, grid, g):
            img, grid = (torch.from_numpy(a).to(device).requires_grad_() for a in (img, grid))
            out = sample.grid_sample_bilinear(img, grid, padding_mode="zeros")
            out.backward(torch.from_numpy(g).to(device))
            return [t.detach().cpu() for t in (out, img.grad, grid.grad)]

        reset_counts()
        card = [grid_sample(dev, *call) for call in calls]
        launches = path_launches["grid_sample"] = read_counts()
        expect_launches("grid_sample", launches, launches_per(k5=REQUESTS, k6=REQUESTS))
        # d_grid is K6's coordinate gradient times d(pixel)/d(grid) = W/2
        # or H/2 (align_corners=False): its bound scales with it.
        scales = (1.0, 1.0, max(H, W) / 2)
        err = 0.0
        for got, call in zip(card, calls):
            for a, b, scale in zip(got, grid_sample(torch.device("cpu"), *call), scales):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * scale)
                err = max(err, float((a - b).abs().max()))
        f.update(calls=REQUESTS, shape=[B, H, W, C], padding_mode="zeros", launches=launches,
                 max_abs_err_vs_cpu=err)

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
        cfg = zoo_config("trajgru", CHECK_BATCH, "float32")
        reset_counts()
        card = step_gradients(cfg, "cuda", batch, flow_scale=FLOW_SCALE)
        launches = path_launches["train_trajgru"] = read_counts()
        expect_launches("train_trajgru", launches,
                        launches_per(k7=TRAJGRU_WARPS, k6s=TRAJGRU_WARPS))
        check = compare_steps(card, float64_gradients(cfg, batch, flow_scale=FLOW_SCALE))
        f.update(batch=CHECK_BATCH, compute="float32", reference="float64 on the CPU",
                 flow_scale=FLOW_SCALE, launches=launches, check=check, tf32=False)

    with Phase("serve_mamba") as f:
        # REQUESTS fp32 requests of B=2 on the card, TF32 off, held to the
        # same weights on the CPU.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        model = serve.build_zoo_model("mamba_unet", device="cuda", dtype=torch.float32, seed=0)
        requests = [rng.uniform(size=(REQUEST_BATCH, 128, 128, 5)).astype(np.float32)
                    for _ in range(REQUESTS)]
        reset_counts()
        answers = [serve.predict(model, frames) for frames in requests]
        launches = path_launches["serve_mamba"] = read_counts()
        expect_launches("serve_mamba", launches, launches_per(k8=MAMBA_SCANS * REQUESTS))
        model_cpu = serve.build_zoo_model("mamba_unet", device="cpu", dtype=torch.float32, seed=0)
        model_cpu.load_state_dict(model.state_dict())
        err, scale = 0.0, 0.0
        for frames, answer in zip(requests, answers):
            if tuple(answer.shape) != (REQUEST_BATCH, 128, 128, 20):
                raise AssertionError(f"mamba_unet answer shape {tuple(answer.shape)}")
            if not bool(torch.isfinite(answer).all()):
                raise AssertionError("mamba_unet answer has non-finite values")
            err = max(err, float((answer.cpu() - serve.predict(model_cpu, frames)).abs().max()))
            scale = max(scale, float(answer.abs().max()))
        if err > 1e-4:
            raise AssertionError(f"serve_mamba: card vs CPU forward: max abs err {err} > 1e-4")
        f.update(requests=REQUESTS, batch=REQUEST_BATCH, launches=launches,
                 max_abs_err_vs_cpu=err, answer_max_abs=scale, tf32=False)
        del model, model_cpu, answers

    with Phase("train_mamba") as f:
        # One fp32 step of the recipe on the card, TF32 off, against the
        # same gradient in float64 on the CPU.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        batch = synthetic_batch(np, CHECK_BATCH, seed=4)
        cfg = zoo_config("mamba_unet", CHECK_BATCH, "float32")
        reset_counts()
        card = step_gradients(cfg, "cuda", batch)
        launches = path_launches["train_mamba"] = read_counts()
        expect_launches("train_mamba", launches, launches_per(k8=MAMBA_SCANS, k8b=MAMBA_SCANS))
        check = compare_steps(card, float64_gradients(cfg, batch))
        f.update(batch=CHECK_BATCH, compute="float32", size=128,
                 reference="float64 on the CPU", launches=launches, check=check, tf32=False)

    with Phase("ablate_mix") as f:
        # The K3a script's path, as a user runs it: every mode at the TPU
        # script's shape, then K2 on the same tokens.
        import importlib.util

        spec = importlib.util.spec_from_file_location("torch_ablate_mix_kernel",
                                                      os.path.join(REPO, K3A_SCRIPT))
        script = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(script)
        reset_counts()
        ablate_chained = script.run(iters=ABLATE_ITERS)
        launches = path_launches["ablate_mix"] = read_counts()
        calls = 2 + ABLATE_ITERS  # chained_time_ms's warm-up calls and the timed ones
        expect_launches("ablate_mix", launches,
                        launches_per(k3a=len(ablate_mix.MODES) * calls, k2=calls))
        f.update(script=K3A_SCRIPT, shape=list(ABLATE_SHAPES["script"]), launches=launches,
                 chained_ms={m: r[0] for m, r in ablate_chained.items()},
                 bound_ms={m: r[1] for m, r in ablate_chained.items()})

    def serve_laps(path, **options):
        """Serves REQUESTS fp32 requests of B=1 at 256^2 through
        ``build_km_unet_v3_laps(**options)`` on the card, counting launches,
        and holds the answers to the same weights on the CPU."""
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        model = serve.build_km_unet_v3_laps(device="cuda", dtype=torch.float32, seed=0, **options)
        requests = [rng.uniform(size=(1, LAPS_SIZE, LAPS_SIZE, 5)).astype(np.float32)
                    for _ in range(REQUESTS)]
        reset_counts()
        answers = [serve.predict(model, frames) for frames in requests]
        launches = path_launches[path] = read_counts()
        mixer = options.get("ssd_mixer", "einsum")
        expect_launches(path, launches, launches_per(
            k1=KAN_CONVS * REQUESTS if options.get("kan_fused") else 0,
            k2=SSD_MIXERS * REQUESTS if mixer == "compress" else 0,
            k3=SSD_MIXERS * REQUESTS if mixer == "fused" else 0))
        model_cpu = serve.build_km_unet_v3_laps(device="cpu", dtype=torch.float32, seed=0,
                                                **options)
        model_cpu.load_state_dict(model.state_dict())
        err = 0.0
        for frames, answer in zip(requests, answers):
            if tuple(answer.shape) != (1, LAPS_SIZE, LAPS_SIZE, LAPS_FRAMES):
                raise AssertionError(f"{path}: answer shape {tuple(answer.shape)}")
            if not bool(torch.isfinite(answer).all()):
                raise AssertionError(f"{path}: answer has non-finite values")
            err = max(err, float((answer.cpu() - serve.predict(model_cpu, frames)).abs().max()))
        if err > 1e-4:
            raise AssertionError(f"{path}: card vs CPU forward: max abs err {err} > 1e-4")
        return {"launches_per_forward": {k: v / REQUESTS for k, v in launches.items() if v},
                "max_abs_err_vs_cpu": err, **options}

    with Phase("serve_laps") as f:
        f.update(requests=REQUESTS, batch=1, size=LAPS_SIZE, tf32=False, paths={
            "serve_laps": serve_laps("serve_laps"),
            "serve_laps_head_norm_off": serve_laps("serve_laps_head_norm_off", head_norm=False),
            "serve_laps_fused": serve_laps("serve_laps_fused", kan_fused=True,
                                           ssd_mixer="fused"),
            "serve_laps_compress": serve_laps("serve_laps_compress", ssd_mixer="compress")})

    with Phase("train_laps") as f:
        # One fp32 laps_km_unet() step at B=1, 256^2, through K1 and K3 on
        # the card, TF32 off, against the same step on the CPU, with no
        # stochastic depth.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        batch = synthetic_batch(np, 1, seed=7, img_size=LAPS_SIZE, seq_len=LAPS_SEQ)
        cfg = laps_config(1, "float32", drop_path=0.0)
        options = dict(kan_fused=True, ssd_mixer="fused")
        reset_counts()
        card = step_gradients(cfg, "cuda", batch, **options)
        launches = path_launches["train_laps"] = read_counts()
        expect_launches("train_laps", launches, launches_per(k1=KAN_CONVS, k3=SSD_MIXERS))
        check = compare_steps(card, step_gradients(cfg, "cpu", batch, **options))
        f.update(batch=1, size=LAPS_SIZE, compute="float32", launches=launches, check=check,
                 tf32=False, **options)

    with Phase("trainer") as f:
        f.update(trainer_phase(torch, np, nvidia_smi, reset_counts, read_counts, launches_per,
                               path_launches))

    with Phase("data_parallel") as f:
        f.update(data_parallel_phase(torch, np, nvidia_smi, path_launches, launches_per))

    def time_kernel(kernel, plain, library, bound, iters, plain_iters):
        """A kernel's numbers beside its ``bound`` ((bound_ms, bound_by,
        bytes, ops)), its plain version and the library call (None where no
        one PyTorch call computes the function) on the same inputs: ms by
        CUDA events over back-to-back calls, queued ms by CUDA events over
        calls queued behind a spin, device ms by the profiler."""
        bound, bound_by, moved, ops = bound
        queued = queued_ms(torch, kernel, min(iters, 50))
        library_queued = queued_ms(torch, library, min(iters, 50)) if library else [None] * 3
        device, device_launches, by_kernel = device_ms(torch, kernel, min(iters, 50))
        return {"ms": cuda_ms(torch, kernel, iters, 10),
                "queued_ms": queued[0], "library_queued_ms": library_queued[0],
                "queued_issue_ms": [queued[1], library_queued[1]],
                "queued_spin_ms": [queued[2], library_queued[2]],
                "plain_ms": cuda_ms(torch, plain, plain_iters),
                "library_ms": cuda_ms(torch, library, iters, 10) if library else None,
                "device_ms": device, "device_launches_per_call": device_launches,
                "device_ms_by_kernel": by_kernel,
                "plain_device_ms": device_ms(torch, plain, plain_iters)[0],
                "library_device_ms": (device_ms(torch, library, min(iters, 50))[0] if library
                                      else None),
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
            gather_bound(torch, img, x, B * H * W * C, False), 200, 20)}
        timed["bilinear_gather"]["library_max_abs_diff"] = float((F.grid_sample(
            img_nchw, grid, mode="bilinear", padding_mode="zeros", align_corners=True).permute(
                0, 2, 3, 1).float() - k5().float()).abs().max())
        timed["bilinear_gather_backward"] = time_kernel(
            lambda: bilinear.bilinear_gather_backward(img, x, y, g, "zeros"),
            lambda: bilinear.bilinear_gather_backward_plain(img, x, y, g, "zeros"),
            # bilinear (0), zeros padding (0), align_corners
            lambda: torch.ops.aten.grid_sampler_2d_backward(g_nchw, img_nchw, grid, 0, 0, True,
                                                            [True, True]),
            gather_bound(torch, img, x, B * H * W * C, True), 200, 20)
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
            library_grouped, gather_bound(torch, img, x, B * Ho * Wo * C, False), 100, 5)
        timed["bilinear_gather_grouped"]["library_max_abs_diff"] = float((
            library_grouped().view(B, G, Cg, Ho, Wo).permute(0, 3, 4, 1, 2).reshape(
                B, Ho, Wo, C).float() - k4().float()).abs().max())
        timed["bilinear_gather_grouped_backward"] = time_kernel(
            lambda: bilinear.bilinear_gather_grouped_backward(img, x, y, g, "border"),
            lambda: bilinear.bilinear_gather_grouped_backward_plain(img, x, y, g, "border"),
            # bilinear (0), border padding (1), align_corners=False
            lambda: torch.ops.aten.grid_sampler_2d_backward(g_lib, img_lib, grid, 0, 1, False,
                                                            [True, True]),
            gather_bound(torch, img, x, B * Ho * Wo * C, True), 20, 3)
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
        model, state, step, _ = train_setup(zoo_config("trajgru", TRAJGRU_BATCH, "bfloat16"),
                                              "cuda")
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
            library_multiview, gather_bound(torch, img, x, B * Ho * Wo * G * C, False), 100, 5)
        timed["bilinear_gather_multiview"]["library_max_abs_diff"] = float((
            library_multiview().view(B, G, C, Ho, Wo).permute(0, 3, 4, 1, 2).reshape(
                B, Ho, Wo, G * C).float() - k7().float()).abs().max())
        timed["bilinear_gather_multiview_backward"] = time_kernel(
            lambda: bilinear.bilinear_gather_multiview_backward(img, x, y, g, "zeros"),
            lambda: bilinear.bilinear_gather_multiview_backward_plain(img, x, y, g, "zeros"),
            library_multiview_backward,
            gather_bound(torch, img, x, B * Ho * Wo * G * C, True), 20, 3)
        del img, x, y, g, grid, img_lib, g_lib

        # Mamba-UNet: the forward and the recipe's step at B=16 bf16.
        model = serve.build_zoo_model("mamba_unet", device="cuda", dtype=torch.bfloat16, seed=0)
        frames = torch.rand(MAMBA_BATCH, 128, 128, 5, device=dev).to(torch.bfloat16)
        out = serve.predict(model, frames)
        if not bool(torch.isfinite(out).all()):
            raise AssertionError("Mamba-UNet B=16 bf16 forward has non-finite values")
        ms = cuda_ms(torch, lambda: serve.predict(model, frames), 5)
        forward[f"mamba_unet_B{MAMBA_BATCH}_bfloat16"] = {
            "ms": ms, "frames_per_s": MAMBA_BATCH * 20 / (ms / 1e3)}
        del model, frames, out
        model, state, step, _ = train_setup(zoo_config("mamba_unet", MAMBA_BATCH, "bfloat16"),
                                              "cuda")
        batch = torch.from_numpy(synthetic_batch(np, MAMBA_BATCH, seed=5)).to(dev)
        torch.cuda.reset_peak_memory_stats()
        losses = []
        ms = cuda_ms(torch, lambda: losses.append(step(state, batch)[1]["loss"]), 5)
        if not all(bool(torch.isfinite(v)) for v in losses):
            raise AssertionError("Mamba-UNet B=16 bf16 step has a non-finite loss")
        train[f"mamba_unet_B{MAMBA_BATCH}_bfloat16"] = {
            "ms": ms, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del model, state, step, batch

        # K8 and its backward at refine3's shape, bf16, the seeded block's dt.
        args, g = scan_inputs(np, rng, REFINE3, "mamba")
        args = [torch.from_numpy(a).to(dev) for a in args]
        args = [a.to(torch.bfloat16) if i in (0, 1, 3, 4) else a for i, a in enumerate(args)]
        g = torch.from_numpy(g).to(dev).to(torch.bfloat16)
        timed["selective_scan"] = time_kernel(
            lambda: scan.selective_scan_forward(*args),
            lambda: scan.selective_scan_plain(*args), None, scan_bound(REFINE3, 2, False),
            20, 1)
        timed["selective_scan_backward"] = time_kernel(
            lambda: scan.selective_scan_backward(*args, g),
            lambda: scan.selective_scan_backward_plain(*args, g), None,
            scan_bound(REFINE3, 2, True), 10, 1)
        del args, g
        scan_timing = {}
        for name, shape in SCAN_TIMING_SHAPES.items():
            args, g = scan_inputs(np, rng, shape, "mamba")
            args = [torch.from_numpy(a).to(dev) for a in args]
            args = [a.to(torch.bfloat16) if i in (0, 1, 3, 4) else a for i, a in enumerate(args)]
            g = torch.from_numpy(g).to(dev).to(torch.bfloat16)
            scan_timing[name] = {"shape": list(shape)}
            for key, fn, backward in (
                    ("selective_scan", lambda: scan.selective_scan_forward(*args), False),
                    ("selective_scan_backward", lambda: scan.selective_scan_backward(*args, g),
                     True)):
                bound, bound_by, _, _ = scan_bound(shape, 2, backward)
                device, launches, by_kernel = device_ms(torch, fn, 20)
                scan_timing[name][key] = {
                    "ms": cuda_ms(torch, fn, 20, 5), "queued_ms": queued_ms(torch, fn, 20)[0],
                    "device_ms": device, "device_launches_per_call": launches,
                    "device_ms_by_kernel": by_kernel, "bound_ms": bound, "bound_by": bound_by}
            del args, g

        # KM_UNetV3-SH through K1 and K3: the forward at B=128 bf16, beside
        # the default path's B128_bfloat16 above, and the bf16 step at B=16.
        fused = dict(kan_fused=True, ssd_mixer="fused")
        model = serve.build_km_unet_v3_sh(device="cuda", dtype=torch.bfloat16, seed=0, **fused)
        frames = torch.rand(128, 128, 128, 5, device=dev).to(torch.bfloat16)
        out = serve.predict(model, frames)
        if not bool(torch.isfinite(out).all()):
            raise AssertionError("B=128 bf16 forward through K1 and K3 has non-finite values")
        ms = cuda_ms(torch, lambda: serve.predict(model, frames), 5)
        forward["B128_bfloat16_fused"] = {"ms": ms, "frames_per_s": 128 * 20 / (ms / 1e3)}
        del model, frames, out
        model, state, step, _ = train_setup(sh_config(16, "bfloat16"), "cuda", **fused)
        batch = torch.rand(16, 25, 128, 128, device=dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(torch, lambda: step(state, batch, gen), 5)
        train["B16_bfloat16_fused"] = {"ms": ms,
                                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del model, state, step, batch

        # K1 at enc1 (B=128, 16 -> 16 at 128^2, bf16), x N(0, 1) as the
        # GroupNorm before it makes it, zero padded.
        B, C, Fo, H, W = ENC1_KAN
        xp = F.pad(torch.randn(B, C, H, W, device=dev), (1, 1, 1, 1)).to(torch.bfloat16)
        base = (0.3 * torch.randn(Fo, C, 3, 3, device=dev)).to(torch.bfloat16)
        spline = (0.3 * torch.randn(Fo, 8 * C, 3, 3, device=dev)).to(torch.bfloat16)
        *bound, dense_ops = kan_bound(torch, xp, Fo)
        timed["fused_kanconv"] = time_kernel(
            lambda: kanconv.kanconv_forward(xp, base, spline),
            lambda: kanconv.kanconv_plain(xp, base, spline), None, bound, 20, 5)
        timed["fused_kanconv"].update(dense_ops=dense_ops,
                                      ops_ms_fp32=bound[3] / H100_FP32_FLOPS * 1e3)
        del xp, base, spline

        # K2 and K3 at enc1_vim's mixer (B=128, C=16, L=16384, N=64, bf16),
        # dt, B and C the slices of one bcdt.
        B, C, L, N = ENC1_MIX
        x = torch.randn(B, C, L, device=dev).to(torch.bfloat16)
        bcdt = torch.randn(B, 3 * N, L, device=dev).to(torch.bfloat16)
        Bm, Cm, dt = bcdt.split(N, dim=1)
        A = 1.0 + 15.0 * torch.rand(N, device=dev)
        w_hz = torch.randn(2 * C, C, device=dev) / C ** 0.5
        w_out = torch.randn(C, C, device=dev) / C ** 0.5
        Dp = torch.ones(1, device=dev)
        timed["hsmssd_compress"] = time_kernel(
            lambda: ssd.hsmssd_compress_forward(x, dt, Bm, A),
            lambda: ssd.hsmssd_compress_plain(x, dt, Bm, A), None,
            mixer_bound(ENC1_MIX, 2, False), 50, 5)
        timed["hsmssd_mix"] = time_kernel(
            lambda: ssd.hsmssd_mix_forward(x, dt, Bm, Cm, A, w_hz, w_out, Dp),
            lambda: ssd.hsmssd_mix_plain(x, dt, Bm, Cm, A, w_hz, w_out, Dp), None,
            mixer_bound(ENC1_MIX, 2, True), 50, 5)
        del x, bcdt, Bm, Cm, dt
        mixers = mixer_timing(torch, ssd)

        # K3a in each mode at the TPU script's shape; the line carries full's.
        shape = ABLATE_SHAPES["script"]
        args = ablate_inputs(torch, shape, len(ABLATE_SHAPES), dev)
        modes = {mode: time_kernel(
            lambda mode=mode: ablate_mix.ablate_mix_forward(mode, *args, shape[4]),
            lambda mode=mode: ablate_mix.ablate_mix_plain(mode, *args, shape[4]), None,
            ablate_bound(shape, mode), 50, 3) for mode in ablate_mix.MODES}
        for mode, t in modes.items():
            t["chained_ms"] = ablate_chained[mode][0]
        timed["ablate_mix"] = {**modes["full"], "modes": modes}
        del args

        # KM_UNetV3-LAPS at 256^2: the forward at B=1 and B=32 and the
        # laps_km_unet() step at B=1, bf16, on the plain and the K1 + K3 path.
        for fused in (False, True):
            options = dict(kan_fused=True, ssd_mixer="fused") if fused else {}
            suffix = "_fused" if fused else ""
            for B in LAPS_BATCHES:
                model = serve.build_km_unet_v3_laps(device="cuda", dtype=torch.bfloat16, seed=0,
                                                    **options)
                frames = torch.rand(B, LAPS_SIZE, LAPS_SIZE, 5, device=dev).to(torch.bfloat16)
                out = serve.predict(model, frames)
                if not bool(torch.isfinite(out).all()):
                    raise AssertionError(f"LAPS B={B} bf16 forward{suffix} has non-finite values")
                ms = cuda_ms(torch, lambda: serve.predict(model, frames), 5)
                forward[f"laps_B{B}_bfloat16{suffix}"] = {
                    "ms": ms, "frames_per_s": B * LAPS_FRAMES / (ms / 1e3)}
                del model, frames, out
            model, state, step, _ = train_setup(laps_config(1, "bfloat16"), "cuda", **options)
            batch = torch.from_numpy(synthetic_batch(np, 1, seed=8, img_size=LAPS_SIZE,
                                                     seq_len=LAPS_SEQ)).to(dev)
            gen = torch.Generator(device=dev).manual_seed(1)
            torch.cuda.reset_peak_memory_stats()
            losses = []
            ms = cuda_ms(torch, lambda: losses.append(step(state, batch, gen)[1]["loss"]), 5)
            if not all(bool(torch.isfinite(v)) for v in losses):
                raise AssertionError(f"LAPS B=1 bf16 step{suffix} has a non-finite loss")
            train[f"laps_B1_bfloat16{suffix}"] = {
                "ms": ms, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
            del model, state, step, batch
        f.update(forward=forward, train_step=train, tf32_conv=True, scan_timing=scan_timing,
                 mixer_timing=mixers,
                 shapes={"bilinear_gather": list(BRIDGE), "bilinear_gather_backward": list(BRIDGE),
                         "bilinear_gather_grouped": list(DEC3),
                         "bilinear_gather_grouped_backward": list(DEC3),
                         "bilinear_gather_multiview": list(RNN1),
                         "bilinear_gather_multiview_backward": list(RNN1),
                         "selective_scan": list(REFINE3),
                         "selective_scan_backward": list(REFINE3),
                         "fused_kanconv": list(ENC1_KAN), "hsmssd_compress": list(ENC1_MIX),
                         "hsmssd_mix": list(ENC1_MIX),
                         "ablate_mix": list(ABLATE_SHAPES["script"])},
                 dtype="bfloat16", kernels=timed)

    with Phase("kan_timing") as f:
        f.update(kan_timing(torch, kanconv))

    with Phase("multiview_timing") as f:
        f.update(multiview_timing(torch, bilinear))

    def by_path(name):
        return {path: counts[name] for path, counts in path_launches.items()}

    def worst(errs, dtype):
        return max((v for k, v in errs.items() if k.endswith(dtype)), default=None)

    line = []
    for name, source, replaces, errs in (
            ("bilinear_gather", K5_SOURCE, K5_REPLACES, errors),
            ("bilinear_gather_backward", K6_SOURCE, K6_REPLACES, k6_errors),
            ("bilinear_gather_grouped", K4_SOURCE, K4_REPLACES, k4_errors),
            ("bilinear_gather_grouped_backward", K6G_SOURCE, K6G_REPLACES, k6g_errors),
            ("bilinear_gather_multiview", K7_SOURCE, K7_REPLACES, k7_errors),
            ("bilinear_gather_multiview_backward", K6S_SOURCE, K6S_REPLACES, k6s_errors),
            ("selective_scan", K8_SOURCE, K8_REPLACES, k8_errors),
            ("selective_scan_backward", K8B_SOURCE, K8B_REPLACES, k8b_errors),
            ("fused_kanconv", K1_SOURCE, K1_REPLACES, k1_errors),
            ("hsmssd_compress", K2_SOURCE, K2_REPLACES, k2_errors),
            ("hsmssd_mix", K3_SOURCE, K3_REPLACES, k3_errors),
            ("ablate_mix", K3A_SOURCE, K3A_REPLACES, k3a_errors)):
        t = timed[name]
        max_abs_err = worst(errs, "float32")
        line.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": sum(by_path(name).values()),
                     "launches_by_path": by_path(name),
                     # K3a takes bf16 only.
                     "max_abs_err": worst(errs, "bfloat16") if max_abs_err is None else max_abs_err,
                     "max_abs_err_bfloat16": worst(errs, "bfloat16"),
                     "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                     "device_ms": t["device_ms"], "plain_device_ms": t["plain_device_ms"],
                     "library_device_ms": t["library_device_ms"], "queued_ms": t["queued_ms"],
                     "device_launches_per_call": t["device_launches_per_call"],
                     "library_queued_ms": t["library_queued_ms"]})
    line[-1]["modes"] = {mode: {k: t[k] for k in ("ms", "queued_ms", "device_ms", "chained_ms",
                                                  "plain_ms", "bound_ms", "bound_by",
                                                  "device_ms_by_kernel")}
                         for mode, t in timed["ablate_mix"]["modes"].items()}
    emit({"kernels": line})
    faulthandler.cancel_dump_traceback_later()
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
