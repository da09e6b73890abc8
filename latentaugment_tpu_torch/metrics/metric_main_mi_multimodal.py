"""Metric registry and reporting (counterpart:
latentaugment_tpu/metrics/metric_main_mi_multimodal.py): the
@register_metric dict, calc_metric with timing, report_metric to a
per-mode jsonl, and the registered fid50k_full / pr50k3_full.
"""

import json
import os
import time

from ..utils.util_easydict import EasyDict
from . import frechet_inception_distance, metric_utils, precision_recall

_metric_dict = {}


def register_metric(fn):
    if not callable(fn):
        raise TypeError(f"register_metric needs a callable, got {fn!r}")
    _metric_dict[fn.__name__] = fn
    return fn


def is_valid_metric(metric):
    return metric in _metric_dict


def list_valid_metrics():
    return list(_metric_dict.keys())


def calc_metric(metric, **kwargs):
    """Compute a registered metric; see MetricOptions for kwargs."""
    if not is_valid_metric(metric):
        raise ValueError(f"unknown metric {metric!r}; valid: {list_valid_metrics()}")
    opts = metric_utils.MetricOptions(**kwargs)

    start_time = time.time()
    results = _metric_dict[metric](opts)
    total_time = time.time() - start_time

    return EasyDict(
        results=EasyDict(results),
        metric=metric,
        total_time=total_time,
        total_time_str=metric_utils.format_time(total_time),
        num_gpus=opts.num_gpus,
    )


def report_metric(result_dict, mode, run_dir=None, snapshot_pkl=None):
    metric = result_dict["metric"]
    result_dict["mode"] = mode
    if not is_valid_metric(metric):
        raise ValueError(f"unknown metric {metric!r}")
    if run_dir is not None and snapshot_pkl is not None:
        snapshot_pkl = os.path.relpath(snapshot_pkl, run_dir)

    jsonl_line = json.dumps(dict(result_dict, snapshot_pkl=snapshot_pkl,
                                 timestamp=time.time()))
    print(jsonl_line)
    if run_dir is not None and os.path.isdir(run_dir):
        with open(os.path.join(run_dir, f"metric-{mode}-{metric}.jsonl"), "at") as f:
            f.write(jsonl_line + "\n")


# ----------------------------------------------------------------------------
# Recommended metrics.

@register_metric
def fid50k_full(opts):
    fid = frechet_inception_distance.compute_fid(opts, max_real=None, num_gen=50000)
    return dict(fid50k_full=fid)


@register_metric
def pr50k3_full(opts):
    precision, recall = precision_recall.compute_pr(
        opts, max_real=200000, num_gen=50000, nhood_size=3,
        row_batch_size=10000, col_batch_size=10000)
    return dict(pr50k3_full_precision=precision, pr50k3_full_recall=recall)
