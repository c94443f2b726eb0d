"""Selective SSM scan (port of ``kmunet_tpu/ops/scan.py``).

``selective_scan`` runs Mamba's S6 recurrence with an fp32 state and its
gradient to all six inputs: K8 and its backward (``kernels/scan.py``) on a
CUDA tensor, their plain versions on a CPU tensor. The JAX package's
sequence-parallel ``selective_scan_sharded`` needs a device mesh and is not
ported yet (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

from kmunet_tpu_torch.kernels.scan import selective_scan, selective_scan_plain

__all__ = ["selective_scan", "selective_scan_plain"]
