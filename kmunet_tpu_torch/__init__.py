"""PyTorch/CUDA port of kmunet_tpu: the KM_UNetV3-SH forward on an NVIDIA GPU.

Mirrors the JAX package's layout (``ops/``, ``nn/``, ``models/``,
``kernels/``); public functions keep its NHWC layout. The entry point is
``kmunet_tpu_torch.serve``. Imports ``torch`` and numpy only.
"""
