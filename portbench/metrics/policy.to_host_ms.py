"""policy.to_host_ms: device ms a batch of the device-to-host copies
(Memcpy kernels) launched under the program's latent_aug.to_host span:
the batch's image and codes copied back to the host, in the timeline
trace of the traced batches (harness/spans.py)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from harness import spans  # noqa: E402


def read(ctx):
    att = spans.read(ctx, ("latent_aug.to_host",))
    if att is None:
        return None
    return spans.kernel_ms(att, lambda st, name: "latent_aug.to_host" in st
                           and "Memcpy" in name)
