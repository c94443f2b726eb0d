"""Writes a trained JAX checkpoint of the repo as the port's state_dict, for
a machine that has no orbax (the card's): the checkpoint is copied to a
temporary directory, restored with the JAX package's manager
(``tests/test_torch_trained_ckpt.py::_restore``), converted strictly into
the port's model and saved with ``torch.save``.

    python -m tests.torch_export OUT.pt [CHECKPOINT_STEP_DIR]

The default checkpoint is the trained SmaAt-UNet,
``outputs/quality_table/smaat_unet/ckpt/1168`` (20 frames);
``chip_smoke.py``'s zoo phase holds its forward on the card to the CPU
when ``KMUNET_TRAINED_SMAAT`` names the export.
"""

from __future__ import annotations

import pathlib
import sys
import tempfile

import torch

from kmunet_tpu_torch import convert
from kmunet_tpu_torch.models.smaat_unet import SmaAt_UNet
from tests.test_torch_trained_ckpt import REPO, _restore

SMAAT = "outputs/quality_table/smaat_unet/ckpt/1168"


def export_smaat(out: str, checkpoint: str = SMAAT) -> dict:
    """The trained SmaAt-UNet's state_dict, also saved to ``out``."""
    with tempfile.TemporaryDirectory() as tmp:
        variables = _restore(REPO / checkpoint, pathlib.Path(tmp))
    frames = variables["params"]["outc"]["kernel"].shape[-1]
    model = SmaAt_UNet(n_classes=frames)
    state = convert.to_state_dict(model, variables["params"], variables["batch_stats"])
    torch.save(state, out)
    return state


if __name__ == "__main__":
    import tests.conftest  # noqa: F401  (JAX on the CPU, as the tests run it)

    export_smaat(*sys.argv[1:])
    print(f"wrote {sys.argv[1]}")
