"""policy.idle_ms: device-idle ms a batch while the host was inside one
of the program's latent_aug.* spans (set_input, get_output, the inversion
read or the z draw, the device-to-host copies), over the traced window of
the timeline trace (harness/spans.py)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from harness import spans  # noqa: E402


def read(ctx):
    first = "latent_aug.read_inversion" if spans.walks(ctx) else "latent_aug.sample_z"
    att = spans.read(ctx, ("latent_aug.set_input", first, "latent_aug.to_host",
                           "latent_aug.get_output"))
    if att is None:
        return None
    return spans.idle_ms(att, lambda st: any(n in spans.POLICY_SPANS for n in st))
