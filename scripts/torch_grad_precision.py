#!/usr/bin/env python3
"""How far the fp32 gradients of the port's SH train step (or, with
``--model trajgru``, its TrajGRU recipe step) lie from its float64
gradient, on the card and on the CPU, and (``--jax``) how far the JAX
package's fp32 and float64 gradients lie from the same one.

    python3 scripts/torch_grad_precision.py [--device cuda] [--size 32]
    python3 scripts/torch_grad_precision.py --device cpu --jax   # needs JAX
    python3 scripts/torch_grad_precision.py --device cpu --jax --seed 0 --jax-steps 1
    python3 scripts/torch_grad_precision.py --model trajgru --size 128

The step is ``chip_smoke.py``'s fp32 card-vs-CPU check: the SH recipe at
B=2 with no stochastic depth, at 32^2 (seq_len 9, 5 -> 4; the config of
tests/test_torch_gpu.py) or at 128^2 (seq_len 25, 5 -> 20). Weights come
from ``--seed``: the port's own initialisation, or with ``--jax`` the JAX
package's ``init_state`` from ``PRNGKey(seed)``, converted, and moved on by
``--jax-steps`` steps of the JAX engine on the same batch (the state from
which tests/test_torch_train.py takes the port's second step, with
``--seed 0 --jax-steps 1``). The batch is
``np.random.default_rng(--batch-seed).random``. TF32 is off. The float64
reference is the port's model and loss in float64 on the CPU (the gather
still takes fp32 coordinates, as the kernels do).

Prints JSON lines: for each fp32 (or float64) gradient, its error against
the reference per leaf, relative to the leaf's largest |reference|, for the
worst leaves; the grad norms; and the leaves that move the global grad norm
most between the card and the CPU. The leaves whose exact gradient is 0 (a
bias right before a normalisation, HSMSSD's ``A``) are listed apart, by
their largest |gradient| relative to the largest of all.

``--model trajgru`` takes ``chip_smoke.py``'s train_trajgru check instead:
the ("trajgru", "pic") recipe (Adam, weighted_mse_mae) at B=2, the flow
convs scaled by its FLOW_SCALE, on ``SyntheticNowcastDataset`` items at
128^2 (the phase's batch, ``--batch-seed`` as its seed) or on the random
batch at 32^2; ``--jax`` is for the SH step only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import (  # noqa: E402
    FLOW_SCALE,
    scale_flows,
    sh_config,
    synthetic_batch,
    zoo_config,
)
from kmunet_tpu_torch import convert  # noqa: E402
from kmunet_tpu_torch.train import engine  # noqa: E402

TOP = 6


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def port_gradients(cfg, params, batch, device, dtype, seed, flow_scale=1.0):
    """(loss, {name: gradient as float64 on the CPU}) of the port's loss in
    ``dtype`` on ``device``, from ``params`` (flax layout) or, if None, the
    port's initialisation from ``seed`` (a TrajGRU's flows scaled by
    ``flow_scale``)."""
    model = engine.build_model(cfg)
    tx = engine.build_optimizer(cfg, steps_per_epoch=100)
    engine.init_state(cfg, model, tx, seed=seed, device="cpu")
    if params is not None:
        convert.load_flax(model, params["params"], params["batch_stats"])
    if flow_scale != 1.0:
        scale_flows(model, flow_scale)
    model.to(device=device, dtype=dtype).train()
    layout = engine._model_layout(cfg)
    inp, tgt = engine._split_batch(torch.as_tensor(batch, device=device, dtype=dtype),
                                   cfg.data.in_frames, cfg.data.out_frames, layout)
    loss = engine.build_loss(cfg)(engine._to_btHW(model(inp), layout), tgt)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True,
                                materialize_grads=True)
    return float(loss.detach()), {k: g.detach().cpu().double() for k, g in zip(named, grads)}


def jax_gradients(cfg_args, seed, batch, steps=0):
    """The JAX package's weights from ``PRNGKey(seed)``, after ``steps``
    steps of its engine on ``batch``, and its gradients there in fp32 (XLA's
    default optimisation level) and float64, mapped to the port's names."""
    import jax
    import jax.numpy as jnp

    import kmunet_tpu.configs as configs_jax
    import kmunet_tpu.nn.resample as resample_jax
    import kmunet_tpu.ops.sample as sample_jax
    import kmunet_tpu.train.engine as engine_jax

    jax.config.update("jax_platforms", "cpu")
    resample_jax.DYSAMPLE_WINDOW = True  # the port's DySample
    sample_jax.USE_PALLAS_GATHER = None  # the XLA gather on the CPU
    cfg = configs_jax.shanghai_km_unet()
    cfg.data.img_size, cfg.data.batch_size, cfg.data.seq_len, cfg.data.out_frames = cfg_args
    cfg.model.num_classes = cfg.data.out_frames
    cfg.model.extra["drop_path"] = 0.0
    cfg.train.compute_dtype = "float32"
    model = engine_jax.build_model(cfg)
    tx = engine_jax.build_optimizer(cfg, 10)
    state = engine_jax.init_state(cfg, model, tx, jax.random.PRNGKey(seed))
    if steps:
        step = jax.jit(engine_jax._make_train_body(model, engine_jax.build_loss(cfg), tx, cfg),
                       compiler_options={"xla_backend_optimization_level": 3})
        for i in range(steps):
            state, _ = step(state, jnp.asarray(batch), jax.random.fold_in(jax.random.PRNGKey(3), i))
    loss_of = engine_jax.make_loss_of(model, engine_jax.build_loss(cfg), cfg)
    variables = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})

    def grad(dtype):
        cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, dtype), t)  # noqa: E731
        fn = jax.jit(jax.value_and_grad(lambda p, s, b: loss_of(p, s, b, jax.random.PRNGKey(0))[0]),
                     compiler_options={"xla_backend_optimization_level": 3})
        loss, g = fn(cast(variables["params"]), cast(variables["batch_stats"]),
                     jnp.asarray(batch, dtype))
        return float(loss), jax.device_get(g)

    out = {"jax_fp32": grad(jnp.float32)}
    with jax.enable_x64(True):
        out["jax_fp64"] = grad(jnp.float64)
    return variables, out


def to_port_names(cfg, flax_grads, batch_stats):
    model = engine.build_model(cfg).double()
    sd = convert.to_state_dict(model, flax_grads, batch_stats)
    return {k: sd[k].double() for k, _ in model.named_parameters()}


def report(name, loss, grads, ref, zero_leaves):
    rows, zero = [], {}
    gmax = max(float(g.abs().max()) for g in ref.values())
    for k, want in ref.items():
        if k in zero_leaves:
            zero[k] = float(grads[k].abs().max()) / gmax
            continue
        scale = float(want.abs().max())
        if scale > 0.0:
            rows.append((float((grads[k] - want).abs().max()) / scale, k, scale))
    rows.sort(reverse=True)
    norm = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in grads.values()])))
    emit({"grads": name, "loss": loss, "grad_norm": norm,
          "max_leaf_rel_err": rows[0][0] if rows else 0.0,
          "worst_leaves": [{"leaf": k, "rel_err": e, "leaf_max": s} for e, k, s in rows[:TOP]],
          "zero_gradient_leaves_max_share_of_largest": max(zero.values()) if zero else None})
    return norm


def norm_movers(a, b):
    """Leaves by their share of ||a|| - ||b||: (|a_k|^2 - |b_k|^2) / (|a| + |b|)."""
    na = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in a.values()])))
    nb = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in b.values()])))
    parts = {k: (float(a[k].norm()) ** 2 - float(b[k].norm()) ** 2) / (na + nb) for k in a}
    top = sorted(parts.items(), key=lambda kv: -abs(kv[1]))[:TOP]
    return {"norm_rel_diff": (na - nb) / nb,
            "movers": [{"leaf": k, "share_of_norm_diff": v / (na - nb) if na != nb else 0.0,
                        "leaf_norm": float(b[k].norm()),
                        "leaf_rel_err": float((a[k] - b[k]).norm() / b[k].norm())
                        if float(b[k].norm()) > 0 else 0.0} for k, v in top]}


def port_vs_jax(port, jax32, jax64, ref, zero_leaves, rtol=2e-3):
    """Leaves, but the zero-gradient ones, whose fp32 gradients, the port's
    and JAX's, lie more than ``rtol`` of the leaf's largest |JAX gradient|
    apart (tests/test_torch_train.py's GRAD_RTOL), with each side's distance
    from the port's float64 gradient and JAX's float64 from it, all relative
    to the leaf's largest."""
    largest = max(float(g.abs().max()) for g in jax32.values())
    rows = []
    for k, want in jax32.items():
        scale = float(want.abs().max())
        gap = float((port[k] - want).abs().max())
        if k not in zero_leaves and scale > 0.0 and gap > rtol * scale:
            r = max(float(ref[k].abs().max()), 1e-300)
            rows.append({"leaf": k, "gap": gap / scale, "gap_share_of_largest": gap / largest,
                         "leaf_share_of_largest": scale / largest,
                         "port_fp32_vs_fp64": float((port[k] - ref[k]).abs().max()) / r,
                         "jax_fp32_vs_fp64": float((want - ref[k]).abs().max()) / r,
                         "jax_fp64_vs_port_fp64": float((jax64[k] - ref[k]).abs().max()) / r})
    rows.sort(key=lambda r: -r["gap"])
    return {"leaves": len(jax32), "largest": largest, "over_rtol": rows}


def first_update_gap(a, b, ref, lr=1e-3, eps=1e-8, atol=1e-4):
    """Elements whose AdamW first updates, lr * g / (|g| + eps), from the
    gradients ``a`` and ``b`` differ by more than ``atol``, and the worst."""
    n, worst = 0, (0.0, None)
    for k in ref:
        gap = lr * (a[k] / (a[k].abs() + eps) - b[k] / (b[k].abs() + eps)).abs().flatten()
        n += int((gap > atol).sum())
        i = int(gap.argmax()) if gap.numel() else 0
        if gap.numel() and float(gap[i]) > worst[0]:
            worst = (float(gap[i]), {"leaf": k, "a": float(a[k].flatten()[i]),
                                     "b": float(b[k].flatten()[i]),
                                     "float64": float(ref[k].flatten()[i])})
    return {"elements_over_atol": n, "elements": sum(g.numel() for g in ref.values()),
            "worst_gap": worst[0], "worst": worst[1]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, choices=(32, 128), default=32)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--batch-seed", type=int, default=7)
    ap.add_argument("--jax", action="store_true")
    ap.add_argument("--jax-steps", type=int, default=0)
    ap.add_argument("--model", choices=("km_unet_v3", "trajgru"), default="km_unet_v3")
    args = ap.parse_args()
    if args.jax and args.model != "km_unet_v3":
        ap.error("--jax compares the SH step only")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.device != "cpu":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        emit({"card": smi.stdout.strip(), "torch": torch.__version__})
    seq, out = (9, 4) if args.size == 32 else (25, 20)
    flow_scale = 1.0
    if args.model == "trajgru":
        cfg = zoo_config("trajgru", 2, "float32", img_size=args.size, seq_len=seq,
                         out_frames=out)
        flow_scale = FLOW_SCALE
    else:
        cfg = sh_config(2, "float32", drop_path=0.0, img_size=args.size, seq_len=seq,
                        out_frames=out)
    if args.model == "trajgru" and args.size == 128:
        batch = synthetic_batch(np, 2, seed=args.batch_seed)
    else:
        batch = np.random.default_rng(args.batch_seed).random((2, seq, args.size, args.size),
                                                             dtype=np.float32)
    params, runs = None, {}
    if args.jax:
        params, jax_runs = jax_gradients((args.size, 2, seq, out), args.seed, batch,
                                         args.jax_steps)
        for name, (loss, g) in jax_runs.items():
            runs[name] = (loss, to_port_names(cfg, g, params["batch_stats"]))
    ref_loss, ref = port_gradients(cfg, params, batch, "cpu", torch.float64, args.seed,
                                   flow_scale)
    zero_leaves = {k for k in ref if k.endswith(".mixer.A") or k == "bridge.deform_conv.bias"
                   or (k.startswith("bridge.") and k.endswith(".Dense_0.bias"))}
    devices = ["cpu"] if args.device == "cpu" else [args.device, "cpu"]
    for device in devices:
        runs[f"port_fp32_{device}"] = port_gradients(cfg, params, batch, device, torch.float32,
                                                     args.seed, flow_scale)
    ref_norm = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in ref.values()])))
    emit({"reference": "port_fp64_cpu", "size": args.size, "loss": ref_loss,
          "grad_norm": ref_norm, "zero_gradient_leaves": len(zero_leaves)})
    for name, (loss, grads) in runs.items():
        report(name, loss, grads, ref, zero_leaves)
    if args.device != "cpu":
        emit({"card_vs_cpu": norm_movers(runs[f"port_fp32_{args.device}"][1],
                                         runs["port_fp32_cpu"][1])})
    if args.jax:
        emit({"jax_fp32_vs_port_fp32_cpu": norm_movers(runs["jax_fp32"][1],
                                                       runs["port_fp32_cpu"][1])})
        emit({"adamw_first_update_gap": first_update_gap(runs["jax_fp32"][1],
                                                         runs["port_fp32_cpu"][1], ref)})
        emit({"port_vs_jax_fp32": port_vs_jax(runs["port_fp32_cpu"][1], runs["jax_fp32"][1],
                                              runs["jax_fp64"][1], ref, zero_leaves)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
