"""The zoo's checkpoint paths against the JAX package, on the CPU: the ViT
``.npz`` loader and the Swin ``.pth`` surgery on synthetic files written
under ``tmp_path`` (the same reports as JAX's loaders, and the loaded
models' forwards within 1e-4 of JAX's), the trained SmaAt-UNet checkpoint
(``outputs/quality_table/smaat_unet/ckpt/1168``, restored from a copy under
``tmp_path``) forwarding within 1e-4 of JAX at 64^2, B=2, and
``scripts/torch_train_baseline.py`` for one tiny epoch on the CPU.
"""

import copy
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmunet_tpu.configs import ModelConfig as ModelConfigJax
from kmunet_tpu.models import zoo as zoo_jax
from kmunet_tpu.models.swin_ckpt import load_swin_checkpoint as load_swin_checkpoint_jax
from kmunet_tpu.models.transunet_ckpt import load_vit_npz as load_vit_npz_jax
from kmunet_tpu_torch import configs, convert, serve
from kmunet_tpu_torch.models import smaat_unet, zoo
from kmunet_tpu_torch.models.swin_ckpt import load_swin_checkpoint, translate
from kmunet_tpu_torch.models.transunet_ckpt import load_vit_npz
from tests.test_torch_trained_ckpt import _restore
from tests.test_torch_zoo import extras
from tests.torch_parity import init_perturbed, one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
SMAAT = "outputs/quality_table/smaat_unet/ckpt/1168"
ATOL = 1e-4
SIZE = 64


def _models(name, seed):
    """The JAX model, its perturbed variables, and the port's model with
    them loaded."""
    jm = zoo_jax.build(ModelConfigJax(name=name, num_classes=4, extra=extras(name)))
    variables = init_perturbed(jm, jnp.zeros((1, SIZE, SIZE, 5)), seed=seed)
    tm = zoo.build(configs.ModelConfig(name=name, num_classes=4, extra=extras(name)),
                   img_size=SIZE)
    convert.load_flax(tm, variables["params"], variables.get("batch_stats"))
    return jm, variables, tm.eval()


def _assert_forward_matches(jm, variables, tm, seed):
    x = np.random.default_rng(seed).uniform(size=(2, SIZE, SIZE, 5)).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(jax.tree.map(jnp.asarray, variables), jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _vit_npz(path, rng, hidden=64, heads=4, mlp=128, layers=2, grid=7, token=False):
    """A synthetic R50 + ViT checkpoint with the official key names at the
    narrow TransUNet's widths, its position embeddings a grid x grid grid
    (the model's is 4 x 4 at 64^2: zoomed where it differs), after a class
    token where ``token``."""
    hd = hidden // heads
    w = {"embedding/kernel": (1, 1, 1024, hidden), "embedding/bias": (hidden,),
         "Transformer/encoder_norm/scale": (hidden,), "Transformer/encoder_norm/bias": (hidden,),
         "Transformer/posembed_input/pos_embedding": (1, grid * grid + token, hidden)}
    for i in range(layers):
        root = f"Transformer/encoderblock_{i}"
        att = f"{root}/MultiHeadDotProductAttention_1"
        for name in ("query", "key", "value"):
            w[f"{att}/{name}/kernel"], w[f"{att}/{name}/bias"] = (hidden, heads, hd), (heads, hd)
        w[f"{att}/out/kernel"], w[f"{att}/out/bias"] = (heads, hd, hidden), (hidden,)
        for dense, shape in (("Dense_0", (hidden, mlp)), ("Dense_1", (mlp, hidden))):
            w[f"{root}/MlpBlock_3/{dense}/kernel"] = shape
            w[f"{root}/MlpBlock_3/{dense}/bias"] = shape[1:]
        for norm in ("LayerNorm_0", "LayerNorm_2"):
            w[f"{root}/{norm}/scale"] = w[f"{root}/{norm}/bias"] = (hidden,)
    w["conv_root/kernel"] = (7, 7, 5, 64)
    w["gn_root/scale"] = w["gn_root/bias"] = (1, 1, 1, 64)
    cin = 64
    for b, (units, cout, cmid) in {1: (3, 256, 64), 2: (4, 512, 128), 3: (9, 1024, 256)}.items():
        for u in range(1, units + 1):
            src = f"block{b}/unit{u}"
            w[f"{src}/conv1/kernel"] = (1, 1, cin if u == 1 else cout, cmid)
            w[f"{src}/conv2/kernel"] = (3, 3, cmid, cmid)
            w[f"{src}/conv3/kernel"] = (1, 1, cmid, cout)
            for gn, c in (("gn1", cmid), ("gn2", cmid), ("gn3", cout)):
                w[f"{src}/{gn}/scale"] = w[f"{src}/{gn}/bias"] = (1, 1, 1, c)
            if u == 1:
                w[f"{src}/conv_proj/kernel"] = (1, 1, cin, cout)
                w[f"{src}/gn_proj/scale"] = w[f"{src}/gn_proj/bias"] = (1, 1, 1, cout)
        cin = cout
    arrays = {k: (0.1 * rng.normal(size=s)).astype(np.float32) for k, s in w.items()}
    np.savez(path, **arrays)


@pytest.mark.parametrize("grid,token", [(7, False), (4, True)], ids=["zoomed", "class_token"])
def test_load_vit_npz_matches_jax(grid, token, tmp_path):
    """The same file into both models: every loaded leaf equal to JAX's
    (the zoomed position embeddings within 1e-6), the decoder untouched,
    and the forwards within 1e-4."""
    path = tmp_path / "R50+ViT-B_16.npz"
    _vit_npz(path, np.random.default_rng(80), grid=grid, token=token)
    jm, variables, tm = _models("transunet", seed=81)
    decoder = tm.dec0_conv1.Conv_0.weight.detach().clone()
    params = load_vit_npz_jax(copy.deepcopy(variables["params"]), str(path), n_layers=2)
    assert load_vit_npz(tm, str(path), n_layers=2) is tm
    want = convert.to_state_dict(tm, jax.device_get(params), variables["batch_stats"])
    for key, value in tm.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[key].numpy(), rtol=0,
                                   atol=1e-6 if key == "position_embeddings" else 0, err_msg=key)
    assert torch.equal(tm.dec0_conv1.Conv_0.weight, decoder)
    assert not torch.equal(tm.position_embeddings, torch.zeros_like(tm.position_embeddings))
    _assert_forward_matches(jm, {"params": params, "batch_stats": variables["batch_stats"]},
                            tm, seed=82)
    small = tmp_path / "wrong.npz"
    _vit_npz(small, np.random.default_rng(83), mlp=96)
    with pytest.raises(ValueError, match="block0.fc1.weight"):
        load_vit_npz(tm, str(small), n_layers=2)


def _reference_key(key):
    """The reference SwinTransformerSys key of the port's key."""
    renames = [("patch_embed.weight", "patch_embed.proj.weight"),
               ("patch_embed.bias", "patch_embed.proj.bias"), ("patch_norm.", "patch_embed.norm."),
               ("final_expand.", "up."), ("up0.", "layers_up.0.")]
    for ours, theirs in renames:
        if key.startswith(ours):
            return theirs + key[len(ours):]
    head, _, rest = key.partition(".")
    rest = rest.replace("fc1.", "mlp.fc1.").replace("fc2.", "mlp.fc2.")
    if head.startswith("merge"):
        return f"layers.{head[5:]}.downsample.{rest}"
    if head.startswith("up"):
        return f"layers_up.{head[2:]}.upsample.{rest}"
    if head.startswith("concat_back_dim"):
        return f"concat_back_dim.{head[15:]}.{rest}"
    if "_blk" in head:
        level, block = head[3:].split("_blk")
        stack = "layers" if head.startswith("enc") else "layers_up"
        return f"{stack}.{level}.blocks.{block}.{rest}"
    return key


def _swin_files(tm, tmp_path, rng):
    """A full-model dump (prefixed keys, an output head, a buffer, a
    3-channel patch_embed and a window-7 table that do not fit) and an
    encoder-only ImageNet file (a "model" entry) built from ``tm``'s keys."""
    state = {_reference_key(k): torch.from_numpy(
        (0.1 * rng.normal(size=v.shape)).astype(np.float32)) for k, v in tm.state_dict().items()}
    assert all(translate(k)[0] in tm.state_dict() for k in state)
    state["patch_embed.proj.weight"] = torch.zeros(24, 3, 4, 4)
    state["layers.1.blocks.0.attn.relative_position_bias_table"] = torch.zeros(169, 4)
    state["layers.0.blocks.0.attn.relative_position_index"] = torch.zeros(64, 64, dtype=torch.long)
    state["head.weight"] = torch.zeros(4, 192)
    full = tmp_path / "swin_full.pth"
    torch.save({"module.swin_unet." + k: v for k, v in state.items()}, full)
    encoder = {k: v for k, v in state.items()
               if k.startswith(("layers.", "patch_embed.", "norm.", "head."))}
    imagenet = tmp_path / "swin_tiny_patch4_window7_224.pth"
    torch.save({"model": encoder}, imagenet)
    return full, imagenet


@pytest.mark.parametrize("which", ["full", "imagenet"])
def test_load_swin_checkpoint_matches_jax(which, tmp_path):
    jm, variables, tm = _models("swin_unet", seed=84)
    files = dict(zip(("full", "imagenet"), _swin_files(tm, tmp_path, np.random.default_rng(85))))
    params, want_report = load_swin_checkpoint_jax(copy.deepcopy(variables["params"]),
                                                   str(files[which]))
    model, report = load_swin_checkpoint(tm, str(files[which]))
    assert model is tm
    assert report == want_report
    # the 3-channel stem and the window-7 table, mirrored into the decoder too
    assert len(report["loaded"]) > 50
    assert len(report["shape_mismatch"]) == (2 if which == "full" else 3)
    assert "head.weight" in report["unmatched"]
    want = convert.to_state_dict(tm, jax.device_get(params))
    for key, value in tm.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), want[key].numpy(), err_msg=key)
    _assert_forward_matches(jm, {"params": params}, tm, seed=86)


def test_trained_smaat_checkpoint_forward_matches_jax(tmp_path):
    """The trained SmaAt-UNet (20 frames), restored with the JAX package's
    manager from a copy, converted strictly, at 64^2, B=2, fp32."""
    variables = _restore(REPO / SMAAT, tmp_path)
    x = np.random.default_rng(87).uniform(size=(2, SIZE, SIZE, 5)).astype(np.float32)
    jm = zoo_jax.build(ModelConfigJax(name="smaat_unet", num_classes=20))
    want = np.asarray(jax.jit(jm.apply)(jax.tree.map(jnp.asarray, variables), jnp.asarray(x)))
    model = smaat_unet.SmaAt_UNet(n_classes=20)
    convert.load_flax(model, variables["params"], variables["batch_stats"])
    got = serve.predict(model.eval(), x).numpy()
    assert got.shape == want.shape == (2, SIZE, SIZE, 20) and np.isfinite(got).all()
    assert want.std() > 1e-3  # the trained model's answer is not constant
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_train_baseline_script_runs_one_tiny_epoch(tmp_path, monkeypatch):
    """``torch_train_baseline.main`` on the CPU when asked: the recipe, then
    the overrides, synthetic data without ``--data.path``; on the card by
    default (refused here)."""
    spec = importlib.util.spec_from_file_location(
        "torch_train_baseline", REPO / "scripts" / "torch_train_baseline.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.chdir(tmp_path)
    args = ["--model.name=smaat_unet", "--recipe=pic", "--data.img_size=32",
            "--data.batch_size=2", "--data.synthetic_length=8", "--data.seq_len=9",
            "--data.out_frames=4", "--train.epochs=1", "--train.vis_batches=0",
            "--train.compute_dtype=float32", f"--train.ckpt_dir={tmp_path / 'ckpt'}"]
    results = script.main(["--device=cpu"] + args)
    assert results["steps"] >= 1 and len(results["history"]["train_loss"]) == 1
    assert np.isfinite(results["history"]["train_loss"][0])
    assert any((tmp_path / "ckpt").iterdir())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        script.main(args)
