"""engine.idle_ms: device-idle ms a batch while the host was inside the
program's engine.forward (the walk) or engine.ganrand (sampling) span and
in no latent_aug.* span nested in it, over the traced window of the
timeline trace (harness/spans.py)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from harness import spans  # noqa: E402


def read(ctx):
    att = spans.read(ctx, ("engine.forward",) if spans.walks(ctx) else ("engine.ganrand",))
    if att is None:
        return None
    return spans.idle_ms(att, lambda st: any(n in spans.ENGINE_SPANS for n in st)
                         and not any(n in spans.POLICY_SPANS for n in st))
