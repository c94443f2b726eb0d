"""Utilities of the port (its own copies of ``kmunet_tpu/utils``)."""

from kmunet_tpu_torch.utils.profiler import chained_time_ms

__all__ = ["chained_time_ms"]
