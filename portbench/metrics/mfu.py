"""mfu: model FLOPs of the window's untraced batches (harness/flops.py,
from the configuration's shapes) over their wall time, as a share of one
H100's 989 TFLOP/s dense bf16 peak, in %."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from harness.flops import PEAK_BF16_FLOPS  # noqa: E402


def read(ctx):
    t = ctx["times"]
    if not t:
        return None
    wall = t[-1][3] - t[0][0]
    return 100.0 * ctx["flops_per_sample"] * ctx["batch"] * len(t) / wall / PEAK_BF16_FLOPS
