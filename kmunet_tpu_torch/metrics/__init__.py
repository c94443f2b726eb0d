"""Evaluation metrics of the port."""

from kmunet_tpu_torch.metrics.evaluator import Evaluator, batch_metrics
from kmunet_tpu_torch.metrics.lpips import make_lpips_fn
from kmunet_tpu_torch.metrics.scatter_eval import scatter_evaluate

__all__ = ["Evaluator", "batch_metrics", "make_lpips_fn", "scatter_evaluate"]
