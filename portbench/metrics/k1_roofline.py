"""k1_roofline: the least time of every launch of kernel K1 in the traced
batches (harness/kernels.py, from each launch's recorded arguments: the
larger of bytes over 3.35 TB/s and float32 operations over 67 TFLOP/s)
over the device time of K1's kernels there, in %."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from harness.trace import roofline  # noqa: E402


def read(ctx):
    return None if ctx["trace"] is None else roofline(ctx["trace"], "k1")
