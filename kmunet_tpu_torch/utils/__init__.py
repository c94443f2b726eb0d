"""Utilities of the port (its own copies of ``kmunet_tpu/utils``): seeding,
logging, the NaN guard, FLOP counts, profiling and timing, and the radar
strips (``utils.vis``, imported on its own: it draws with matplotlib)."""

from kmunet_tpu_torch.utils.flops import (flops_of, lowered_flops, record_custom_flops,
                                          tally_custom_flops)
from kmunet_tpu_torch.utils.logging import CSVLogger, get_logger
from kmunet_tpu_torch.utils.nan_guard import assert_finite, guard, nan_hooks
from kmunet_tpu_torch.utils.profiler import chained_time_ms, trace
from kmunet_tpu_torch.utils.seed import set_seed

__all__ = ["set_seed", "get_logger", "CSVLogger", "flops_of", "lowered_flops",
           "record_custom_flops", "tally_custom_flops", "assert_finite", "nan_hooks", "guard",
           "trace", "chained_time_ms"]
