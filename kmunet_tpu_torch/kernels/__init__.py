"""Hand-written CUDA kernels of the port, each beside its plain version.

| Kernel | Module | Source | Replaces |
| --- | --- | --- | --- |
| K5 bilinear gather | ``bilinear`` | ``csrc/bilinear_gather.cu`` | ``kmunet_tpu/kernels/bilinear_pallas.py::gather_bilinear_{zeros,border}`` |
| K4 grouped bilinear gather | ``bilinear`` | ``csrc/bilinear_gather.cu`` | ``kmunet_tpu/kernels/bilinear_pallas.py::gather_bilinear_grouped`` |
| K7 multiview bilinear gather | ``bilinear`` | ``csrc/bilinear_gather.cu`` | ``kmunet_tpu/kernels/bilinear_pallas.py::gather_bilinear_multiview`` |
| K6 the backward of K5, K4 (``shared=False``) and K7 (``shared=True``) | ``bilinear`` | ``csrc/bilinear_gather_backward.cu`` | ``kmunet_tpu/kernels/bilinear_pallas.py::_backward_impl`` |
| K8 selective scan and its backward | ``scan`` | ``csrc/selective_scan.cu`` | ``kmunet_tpu/kernels/scan_pallas.py::selective_scan_pallas`` (``_forward``, ``_backward``) |
"""
