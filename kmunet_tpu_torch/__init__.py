"""PyTorch/CUDA port of kmunet_tpu: serving, training and scoring the
KM_UNetV3 nowcaster and the zoo's ported baselines on an NVIDIA GPU.

Mirrors the JAX package's layout (``ops/``, ``nn/``, ``models/``,
``kernels/``, ``losses/``, ``metrics/``, ``data/``, ``train/``,
``configs/``, ``utils/``); public functions keep its NHWC layout. The entry
points are ``kmunet_tpu_torch.serve`` (the forward) and
``kmunet_tpu_torch.train.engine`` (the train step, and the loop that
trains, checkpoints and scores a model). Imports ``torch`` and numpy only.
"""

from kmunet_tpu_torch.version import __version__

__all__ = ["__version__"]
