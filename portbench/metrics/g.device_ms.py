"""g.device_ms: device ms a batch of the kernels launched under the
program's G.mapping and G.synthesis spans, with their backward (the walk's
K steps and its final synthesis; the sampling path's z to image), in the
timeline trace of the traced batches (harness/spans.py)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from harness import spans  # noqa: E402


def read(ctx):
    need = ("G.synthesis",) if spans.walks(ctx) else spans.G_SPANS
    att = spans.read(ctx, need)
    if att is None:
        return None
    return spans.kernel_ms(att, lambda st, name: spans.outer_model(st) in spans.G_SPANS)
