"""K2 and K3, the HSM-SSD mixer's online-softmax compress and the fused
mixer: the port's plain versions, their autograd functions' backward,
``HSMSSD(mixer=...)`` and the whole KM_UNetV3-SH on its new paths against
the JAX package, on the CPU.

The plain versions against ``hsmssd_compress_op`` (the Pallas kernel, which
runs interpreted off the TPU) within 1e-4 (tests/test_kernels.py's bound) and
``hsmssd_mix(..., interpret=True)`` within 1e-5 relative and absolute
(tests/test_ssd_mix.py's), at (B=2, C=16, L=256, N=64), (C=32, L=64, N=64), a
ragged L=100 with N=8, and dt large enough that one token takes most of a
softmax. ``HSMSSDCompress``'s and ``HSMSSDMix``'s gradients (their backward
is the plain version's autograd; their forward, K2 or K3, runs on the card
only, so the plain version stands in for it here) against ``jax.vjp`` of
the ``_op``s for every input within 1e-4 of each one's largest |value|, A's
held to zero, which it is exactly (the softmax is shift-invariant per n).
``HSMSSD`` with each ``mixer`` against the JAX module with converted,
perturbed params: forward, the returned h and every gradient. The whole model at 32^2, 5 -> 20 frames, in fp32 on
``kan_fused=True, ssd_mixer="fused"`` and on ``ssd_mixer="compress"``
against one JAX forward within 1e-4 abs. The dispatch: on the CPU no counter
moves, and the launchers refuse a CPU tensor, an unsupported dtype and bad
shapes. Each JAX function is jitted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kmunet_tpu.nn.resample as resample_jax
import kmunet_tpu.ops.sample as sample_jax
from kmunet_tpu.kernels.ssd_mix_pallas import hsmssd_mix as hsmssd_mix_jax
from kmunet_tpu.kernels.ssd_mix_pallas import hsmssd_mix_op
from kmunet_tpu.kernels.ssd_pallas import hsmssd_compress_op
from kmunet_tpu.models.km_unet import KM_UNetV3_SH as KM_UNetV3_SH_jax
from kmunet_tpu.nn import ssd as ssd_jax
from kmunet_tpu_torch import convert, serve
from kmunet_tpu_torch.kernels import bilinear, kanconv, ssd
from kmunet_tpu_torch.models.km_unet import KM_UNetV3_SH
from kmunet_tpu_torch.nn import ssd as ssd_nn
from tests.torch_parity import init_perturbed, port

# (B, C, L, N, dt scale)
SHAPES = {
    "c16_l256": (2, 16, 256, 64, 1.0),
    "c32_l64": (2, 32, 64, 64, 1.0),
    "ragged_l100_n8": (2, 16, 100, 8, 1.0),
    "large_dt": (2, 16, 128, 16, 40.0),
}
MIX_NAMES = ("x", "dt", "B", "C", "A", "w_hz", "w_out", "D")


def _inputs(shape, seed=0):
    """The mixer's inputs in the JAX kernels' layout, numpy fp32: xt (B, C,
    L); dt, B, C (B, L, N); A (N,); w_hz (C, 2C) and w_out (C, C) as flax
    stores them; D a scalar."""
    Bsz, C, L, N, dt_scale = shape
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return dict(xt=r(Bsz, C, L), dt=(dt_scale * r(Bsz, L, N)).astype(np.float32), Bm=r(Bsz, L, N),
                Cm=r(Bsz, L, N), A=rng.uniform(1.0, 16.0, N).astype(np.float32),
                w_hz=r(C, 2 * C) / np.sqrt(C), w_out=r(C, C) / np.sqrt(C),
                D=np.float32(0.37))


def _port_args(kw):
    """The same inputs in the port's layout: dt, B, C (B, N, L) as the
    slices of one (B, 3N, L) tensor; the Linear weights (out, in); D (1,)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    bcdt = t(np.concatenate([kw[k].transpose(0, 2, 1) for k in ("Bm", "Cm", "dt")], axis=1))
    Bm, Cm, dt = bcdt.split(kw["dt"].shape[2], dim=1)
    return [t(kw["xt"]), dt, Bm, Cm, t(kw["A"]), t(kw["w_hz"].T), t(kw["w_out"].T),
            t(np.reshape(kw["D"], (1,)))]


@pytest.mark.parametrize("shape", list(SHAPES))
def test_plain_versions_match_jax_kernels(shape):
    kw = _inputs(SHAPES[shape], seed=1)
    x, dt, Bm, Cm, A, w_hz, w_out, D = _port_args(kw)
    want_h = jax.jit(hsmssd_compress_op)(kw["xt"].transpose(0, 2, 1), kw["dt"], kw["Bm"], kw["A"])
    got_h = ssd.hsmssd_compress_plain(x, dt, Bm, A)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=0, atol=1e-4)
    want_y, want_h2 = jax.jit(hsmssd_mix_jax, static_argnums=8)(*kw.values(), True)
    got_y, got_h2 = ssd.hsmssd_mix_plain(x, dt, Bm, Cm, A, w_hz, w_out, D)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_h2.numpy(), np.asarray(want_h2).transpose(0, 2, 1),
                               rtol=1e-5, atol=1e-5)


def _assert_grad(name, got, want):
    """A's exact gradient is 0 (shift invariance): both sides' within 1e-4
    of 0, as tests/test_ssd_mix.py holds it; the others within 1e-4 of the
    leaf's largest |gradient| (the softmax's gradient cancels in fp32: at
    dt ~ 40 single elements of d_dt lie 1.5e-5 apart where the largest is
    4.2)."""
    got, want = got.detach().numpy(), np.asarray(want)
    if name == "A":
        np.testing.assert_allclose(got, 0, atol=1e-4, err_msg=name)
        np.testing.assert_allclose(want, 0, atol=1e-4, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("shape", ["c16_l256", "ragged_l100_n8", "large_dt"])
def test_mix_backward_matches_jax_vjp(shape, monkeypatch):
    """``HSMSSDMix.apply`` with the plain version in place of K3's launcher:
    its backward against ``jax.vjp(hsmssd_mix_op)`` for all eight inputs,
    through y and h2 at once."""
    kw = _inputs(SHAPES[shape], seed=2)
    rng = np.random.default_rng(3)
    gy = rng.normal(size=kw["xt"].shape).astype(np.float32)
    gh2 = rng.normal(size=(kw["xt"].shape[0], kw["xt"].shape[1], kw["A"].shape[0]))
    gh2 = gh2.astype(np.float32)

    def run(*args):
        out, vjp = jax.vjp(lambda *a: hsmssd_mix_op(*a, True), *args)
        return out, vjp((jnp.asarray(gy), jnp.asarray(gh2)))

    _, want = jax.jit(run)(*kw.values())
    monkeypatch.setattr(ssd, "hsmssd_mix_forward", ssd.hsmssd_mix_plain)
    args = _port_args(kw)
    bcdt = torch.cat([args[2], args[3], args[1]], dim=1).requires_grad_()
    Bm, Cm, dt = bcdt.split(args[1].shape[1], dim=1)
    leaves = [a.clone().requires_grad_() for a in (args[0], *args[4:])]
    y, h2 = ssd.HSMSSDMix.apply(leaves[0], dt, Bm, Cm, *leaves[1:])
    torch.autograd.backward((y, h2), (torch.from_numpy(gy), torch.from_numpy(gh2).transpose(1, 2)))
    d_b, d_c, d_dt = (g.transpose(1, 2) for g in bcdt.grad.split(args[1].shape[1], dim=1))
    got = dict(zip(MIX_NAMES, (leaves[0].grad, d_dt, d_b, d_c, leaves[1].grad,
                               leaves[2].grad.T, leaves[3].grad.T, leaves[4].grad.reshape(()))))
    for name, w in zip(MIX_NAMES, want):
        _assert_grad(name, got[name], w)


@pytest.mark.parametrize("shape", ["c16_l256", "ragged_l100_n8"])
def test_compress_backward_matches_jax_vjp(shape, monkeypatch):
    """``HSMSSDCompress.apply`` with the plain version in place of K2's
    launcher: its backward against ``jax.vjp(hsmssd_compress_op)`` for x,
    dt, B and A."""
    kw = _inputs(SHAPES[shape], seed=4)
    x_blc = kw["xt"].transpose(0, 2, 1)
    g = np.random.default_rng(5).normal(size=(x_blc.shape[0], kw["A"].shape[0], x_blc.shape[2]))
    g = g.astype(np.float32)

    def run(*args):
        out, vjp = jax.vjp(hsmssd_compress_op, *args)
        return out, vjp(jnp.asarray(g))

    _, want = jax.jit(run)(x_blc, kw["dt"], kw["Bm"], kw["A"])
    monkeypatch.setattr(ssd, "hsmssd_compress_forward", ssd.hsmssd_compress_plain)
    x, dt, Bm, _, A = (a.clone().requires_grad_() for a in _port_args(kw)[:5])
    ssd.HSMSSDCompress.apply(x, dt, Bm, A).backward(torch.from_numpy(g))
    for name, t, w in (("x", x.grad.transpose(1, 2), want[0]),
                       ("dt", dt.grad.transpose(1, 2), want[1]),
                       ("B", Bm.grad.transpose(1, 2), want[2]), ("A", A.grad, want[3])):
        _assert_grad(name, t, w)


@pytest.mark.parametrize("mixer", ssd_nn.MIXERS)
def test_hsmssd_mixers_match_jax_module(mixer):
    """``HSMSSD(mixer=...)`` with converted, perturbed params: y, h and the
    tokens' gradient within 1e-4 abs, every parameter's gradient within 1e-4
    of its largest |value| (A's within 1e-4 of 0)."""
    Bsz, side, C, N = 2, 8, 16, 64
    rng = np.random.default_rng(6)
    tokens = rng.normal(size=(Bsz, side * side, C)).astype(np.float32)
    gy = rng.normal(size=(Bsz, side, side, C)).astype(np.float32)
    gh = rng.normal(size=(Bsz, N, C)).astype(np.float32)
    m = ssd_jax.HSMSSD(d_model=C, state_dim=N)
    variables = init_perturbed(m, jnp.asarray(tokens))

    def run(params, t):
        out, vjp = jax.vjp(lambda p, a: m.apply({"params": p}, a), params, t)
        return out, vjp((jnp.asarray(gy), jnp.asarray(gh)))

    (want_y, want_h), (d_params, d_tokens) = jax.jit(run)(variables["params"], jnp.asarray(tokens))
    tm = port(ssd_nn.HSMSSD(C, state_dim=N, mixer=mixer), variables)
    x = torch.from_numpy(tokens.transpose(0, 2, 1).reshape(Bsz, C, side, side).copy())
    x.requires_grad_()
    y, h = tm(x)
    torch.autograd.backward((y, h), (torch.from_numpy(gy).permute(0, 3, 1, 2),
                                     torch.from_numpy(gh)))
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want_y),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(want_h), rtol=0, atol=1e-4)
    np.testing.assert_allclose(x.grad.reshape(Bsz, C, -1).transpose(1, 2).numpy(),
                               np.asarray(d_tokens), rtol=0, atol=1e-4)
    want = convert.to_state_dict(tm, d_params)
    for key, p in tm.named_parameters():
        if key == "A":
            np.testing.assert_allclose(p.grad.numpy(), 0, atol=1e-4, err_msg=key)
            continue
        np.testing.assert_allclose(p.grad.numpy(), want[key].numpy(), rtol=0,
                                   atol=1e-4 * float(want[key].abs().max()), err_msg=key)


@pytest.fixture(scope="module")
def jax_forward():
    """One JAX forward of the SH model at 32^2 (window DySample, XLA gather)
    with perturbed weights: (variables, frames, output)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(resample_jax, "DYSAMPLE_WINDOW", True)
    mp.setattr(sample_jax, "USE_PALLAS_GATHER", None)
    model = KM_UNetV3_SH_jax(num_classes=20, embed_dims=(16, 32, 64))
    x = np.random.default_rng(0).uniform(size=(2, 32, 32, 5)).astype(np.float32)
    variables = init_perturbed(model, jnp.asarray(x), seed=3)
    want = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x)))
    yield variables, x, want
    mp.undo()


@pytest.mark.parametrize("kan_fused,ssd_mixer", [(True, "fused"), (False, "compress")])
def test_full_model_on_the_kernel_paths_matches_jax(jax_forward, kan_fused, ssd_mixer):
    variables, x, want = jax_forward
    model = port(KM_UNetV3_SH(num_classes=20, embed_dims=(16, 32, 64), kan_fused=kan_fused,
                              ssd_mixer=ssd_mixer), variables)
    counters = (bilinear.bilinear_gather, kanconv.fused_kanconv, ssd.hsmssd_compress,
                ssd.hsmssd_mix)
    before = [c.launches for c in counters]
    got = serve.predict(model, x).numpy()
    assert [c.launches for c in counters] == before  # CPU: the plain versions
    assert got.shape == (2, 32, 32, 20) and np.isfinite(got).all()
    assert want.std() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_entry_points_take_the_new_arguments_and_other_models_refuse_them():
    from kmunet_tpu_torch.configs import ModelConfig
    from kmunet_tpu_torch.models import zoo

    model = serve.build_km_unet_v3_sh(device="cpu", kan_fused=True, ssd_mixer="compress")
    assert model.enc1_kan.kanconv.fused and model.dec1_kan.kanconv.fused
    assert {m.path for m in model.modules() if isinstance(m, ssd_nn.HSMSSD)} == {"compress"}
    assert sum(isinstance(m, ssd_nn.HSMSSD) for m in model.modules()) == 15
    for name in ("trajgru", "mamba_unet"):
        with pytest.raises(ValueError, match="kan_fused"):
            zoo.build(ModelConfig(name=name), kan_fused=True)
        with pytest.raises(ValueError, match="ssd_mixer"):
            zoo.build(ModelConfig(name=name), ssd_mixer="fused")
    with pytest.raises(ValueError, match="mixer"):
        ssd_nn.HSMSSD(8, mixer="scan")


def test_cpu_dispatch_takes_the_plain_versions_and_counts_nothing():
    args = _port_args(_inputs(SHAPES["ragged_l100_n8"], seed=7))
    before = (ssd.hsmssd_compress.launches, ssd.hsmssd_mix.launches)
    h = ssd.hsmssd_compress(*args[:3], args[4])
    y, h2 = ssd.hsmssd_mix(*args)
    assert (ssd.hsmssd_compress.launches, ssd.hsmssd_mix.launches) == before
    assert torch.equal(h, ssd.hsmssd_compress_plain(*args[:3], args[4]))
    assert torch.equal(y, ssd.hsmssd_mix_plain(*args)[0])


def test_launchers_refuse_what_the_kernels_do_not_take():
    x, dt, Bm, Cm, A, w_hz, w_out, D = _port_args(_inputs(SHAPES["c32_l64"], seed=8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssd.hsmssd_compress_forward(x, dt, Bm, A)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssd.hsmssd_mix_forward(x, dt, Bm, Cm, A, w_hz, w_out, D)
    with pytest.raises(TypeError, match="dtype"):
        ssd.hsmssd_mix_forward(x.double(), dt, Bm, Cm, A, w_hz, w_out, D)
    with pytest.raises(TypeError, match="dt must be"):
        ssd.hsmssd_mix_forward(x, dt.half(), Bm, Cm, A, w_hz, w_out, D)
    with pytest.raises(ValueError, match="state size"):
        ssd.hsmssd_compress_forward(x, dt[:, :3], Bm[:, :3], A[:3])
    with pytest.raises(ValueError, match="rows of L"):
        ssd.hsmssd_compress_forward(x, dt.transpose(1, 2).contiguous().transpose(1, 2), Bm, A)
    with pytest.raises(ValueError, match="want w_hz"):
        ssd.hsmssd_mix_forward(x, dt, Bm, Cm, A, w_hz.T, w_out, D)
    with pytest.raises(ValueError, match="want C"):
        ssd.hsmssd_mix_forward(x, dt, Bm, Cm[:, :, :5], A, w_hz, w_out, D)
    with pytest.raises(ValueError, match="contiguous"):
        ssd.hsmssd_compress_forward(x.transpose(0, 1).contiguous().transpose(0, 1), dt, Bm, A)
    with pytest.raises(ValueError, match="C <= 64"):
        wide = torch.zeros(2, 65, 64)
        ssd.hsmssd_compress_forward(wide, dt, Bm, A)
