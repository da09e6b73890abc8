"""FID and precision/recall of a generator or of dumped augmented
batches (counterpart: latentaugment_tpu/metrics)."""

from .metric_main_mi_multimodal import (  # noqa: F401
    calc_metric, is_valid_metric, list_valid_metrics, register_metric,
    report_metric,
)
from .metric_utils import FeatureStats, MetricOptions, ProgressMonitor  # noqa: F401
