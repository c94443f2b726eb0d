"""Hand-written CUDA kernels of the port, each beside its plain version.

| Kernel | Module | Source | Replaces |
| --- | --- | --- | --- |
| K5 bilinear gather (``grid_sample_bilinear``): K7's kernel at G = 1 | ``bilinear`` | ``csrc/multiview_gather.cu`` | ``kmunet_tpu/kernels/bilinear_pallas.py::gather_bilinear_{zeros,border}`` |
| K4 grouped bilinear gather | ``bilinear`` | ``csrc/bilinear_gather.cu`` | ``kmunet_tpu/kernels/bilinear_pallas.py::gather_bilinear_grouped`` |
| K7 multiview bilinear gather (TrajGRU's warp; the deformable conv's 9 taps) | ``bilinear`` | ``csrc/multiview_gather.cu`` | ``kmunet_tpu/kernels/bilinear_pallas.py::gather_bilinear_multiview`` |
| K6 the backward of K5, K4 (``shared=False``) and K7 (``shared=True``) | ``bilinear`` | ``csrc/bilinear_gather_backward.cu`` | ``kmunet_tpu/kernels/bilinear_pallas.py::_backward_impl`` |
| K8 selective scan and its backward | ``scan`` | ``csrc/selective_scan.cu`` | ``kmunet_tpu/kernels/scan_pallas.py::selective_scan_pallas`` (``_forward``, ``_backward``) |
| K1 fused KAN conv | ``kanconv`` | ``csrc/kanconv.cu`` | ``kmunet_tpu/kernels/kanconv_pallas.py::fused_kanconv`` |
| K2 HSM-SSD online-softmax compress | ``ssd`` | ``csrc/hsmssd.cu`` | ``kmunet_tpu/kernels/ssd_pallas.py::hsmssd_compress`` |
| K3 fused HSM-SSD mixer | ``ssd`` | ``csrc/hsmssd.cu`` | ``kmunet_tpu/kernels/ssd_mix_pallas.py::hsmssd_mix`` |
| K3a HSM-SSD mixer ablation (five modes) | ``ablate_mix`` | ``csrc/hsmssd_ablate.cu`` | ``scripts/ablate_mix_kernel.py::run`` (``make_kernel``) |
"""

import functools

import torch


@functools.cache
def sm_count(index: int) -> int:
    """The SMs of CUDA device ``index``, which the kernels' launch
    geometries fill."""
    return torch.cuda.get_device_properties(index).multi_processor_count
