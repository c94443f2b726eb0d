"""PyTorch/CUDA port of kmunet_tpu: the KM_UNetV3-SH forward and training
step on an NVIDIA GPU.

Mirrors the JAX package's layout (``ops/``, ``nn/``, ``models/``,
``kernels/``, ``losses/``, ``train/``, ``configs/``, ``data/``); public
functions keep its NHWC layout. The entry points are
``kmunet_tpu_torch.serve`` (the forward) and ``kmunet_tpu_torch.train.engine``
(the train step). Imports ``torch`` and numpy only.
"""
