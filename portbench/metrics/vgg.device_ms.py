"""vgg.device_ms: device ms a batch of the kernels launched under the
program's vgg16.features span, with their backward (the walk's LPIPS
embedding, K times a batch), in the timeline trace of the traced batches
(harness/spans.py)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from harness import spans  # noqa: E402


def read(ctx):
    if not spans.walks(ctx) or float(ctx["traffic"]["w_lpips"]) <= 0:
        return None
    att = spans.read(ctx, ("vgg16.features",))
    if att is None:
        return None
    return spans.kernel_ms(att, lambda st, name: spans.outer_model(st) == "vgg16.features")
