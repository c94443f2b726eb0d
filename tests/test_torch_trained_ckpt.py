"""The port on the repo's trained KM_UNetV3 and ConvLSTM checkpoints,
against the JAX package, on the CPU.

Each checkpoint is copied under ``tmp_path`` (the JAX package's manager
creates and manages its directory; the repo's copy is never written),
restored with ``kmunet_tpu/train/checkpoint.py``, converted strictly, and
its forward held to the JAX model's at 32^2, B2, fp32, within 1e-4 abs (the
per-layer bound of BASELINE.json). The model is read from the param tree:
the variant from the DAGEM bridge (SH) or its absence (LAPS), ``head_norm``
from the head's GroupNorm, the output frames from the head's kernel. The
JAX SH model takes the window DySample and the XLA gather, as on the CPU.
The trained ConvLSTM (``ConvLSTM_EF(out_frames=20)``) is held the same way
at 64^2, B=2, fp32.
"""

import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import kmunet_tpu.models.ef as ef_jax
import kmunet_tpu.nn.resample as resample_jax
import kmunet_tpu.ops.sample as sample_jax
from kmunet_tpu.models.km_unet import KM_UNetV3 as KM_UNetV3_jax
from kmunet_tpu.train.checkpoint import CheckpointManager
from kmunet_tpu_torch import serve
from kmunet_tpu_torch.models import ef
from kmunet_tpu_torch.models.km_unet import KM_UNetV3
from tests.torch_parity import port
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = pathlib.Path(__file__).resolve().parent.parent
# name -> (checkpoint step directory, the model it holds: variant, head_norm, frames)
CHECKPOINTS = {
    "laps": ("outputs/laps/ckpt/1856", ("laps", True, 3)),
    "sh_head_norm_off": ("outputs/round5_headnorm/km_unet_v3/ckpt/1088", ("sh", False, 20)),
    "sh_group_norm_head": ("outputs/quality_table/km_unet_v3/ckpt/1264", ("sh", True, 20)),
}
CONVLSTM = "outputs/quality_table/convlstm/ckpt/1120"
ATOL = 1e-4


def _restore(src, tmp_path):
    """The params and batch_stats of the checkpoint at ``src``, copied under
    ``tmp_path`` and restored with orbax, as float32 numpy trees."""
    directory = tmp_path / "ckpt"
    shutil.copytree(src, directory / src.name)
    manager = CheckpointManager(str(directory))
    try:
        step, state = manager.restore_latest(None)
    finally:
        manager.close()
    assert step == int(src.name)
    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        {"params": state["params"], "batch_stats": state.get("batch_stats", {})})


def restore(name, tmp_path):
    """The checkpoint's params and batch_stats as float32 numpy trees, and
    the model read from them (variant, head_norm, output frames)."""
    variables = _restore(REPO / CHECKPOINTS[name][0], tmp_path)
    params = variables["params"]
    read = ("sh" if "bridge" in params else "laps", "output_norm" in params,
            params["head"]["kernel"].shape[-1])
    return variables, read


@pytest.mark.parametrize("name", list(CHECKPOINTS))
def test_trained_checkpoint_forward_matches_jax(name, tmp_path):
    variables, (variant, head_norm, frames) = restore(name, tmp_path)
    assert (variant, head_norm, frames) == CHECKPOINTS[name][1]
    x = np.random.default_rng(list(CHECKPOINTS).index(name)).uniform(
        size=(2, 32, 32, 5)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(resample_jax, "DYSAMPLE_WINDOW", True)
        mp.setattr(sample_jax, "USE_PALLAS_GATHER", None)
        jm = KM_UNetV3_jax(num_classes=frames, variant=variant, head_norm=head_norm)
        want = np.asarray(jax.jit(jm.apply)(jax.tree.map(jnp.asarray, variables), jnp.asarray(x)))
    model = port(KM_UNetV3(num_classes=frames, variant=variant, head_norm=head_norm), variables)
    got = serve.predict(model, x).numpy()
    assert got.shape == (2, 32, 32, frames) and np.isfinite(got).all()
    assert want.std() > 1e-3  # the trained model's answer is not constant
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_trained_convlstm_checkpoint_forward_matches_jax(tmp_path):
    variables = _restore(REPO / CONVLSTM, tmp_path)
    x = np.random.default_rng(len(CHECKPOINTS)).uniform(size=(2, 5, 64, 64)).astype(np.float32)
    jm = ef_jax.ConvLSTM_EF(out_frames=20)
    want = np.asarray(jax.jit(jm.apply)(jax.tree.map(jnp.asarray, variables), jnp.asarray(x)))
    model = port(ef.ConvLSTM_EF(out_frames=20), variables)
    got = serve.predict(model, x).numpy()
    assert got.shape == want.shape == (2, 20, 64, 64) and np.isfinite(got).all()
    assert want.std() > 1e-3  # the trained model's answer is not constant
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
