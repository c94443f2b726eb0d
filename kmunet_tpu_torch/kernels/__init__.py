"""Hand-written CUDA kernels of the port, each beside its plain version.

| Kernel | Module | Source | Replaces |
| --- | --- | --- | --- |
| K5 bilinear gather | ``bilinear`` | ``csrc/bilinear_gather.cu`` | ``kmunet_tpu/kernels/bilinear_pallas.py::gather_bilinear_{zeros,border}`` |
| K6 its backward (one coordinate set) | ``bilinear`` | ``csrc/bilinear_gather_backward.cu`` | ``kmunet_tpu/kernels/bilinear_pallas.py::_backward_impl`` |
"""
