"""policy.host_copy_mb: MB (10^6 bytes) a batch of the host arrays the
policy builds from other host arrays (the program's counter
latent_aug.counters['host_copy_bytes']: the A/B concatenation, dtype
conversions that copy, the lower-bound clip). ctx['counters'] where the
harness passes the window's per-batch delta; else the counter's total
over every batch this process ran (warm-up, traced and timed; each
batch builds the same arrays) over their count."""

import sys


def read(ctx):
    if ctx.get("counters") is not None:
        return ctx["counters"]["host_copy_bytes"] / 1e6
    mod = sys.modules.get("latentaugment_tpu_torch.augments.latent_aug")
    counters = getattr(mod, "counters", None)
    tr = ctx.get("trace")
    if counters is None or tr is None:
        return None
    n = ctx["traffic"]["warmup_batches"] + tr["n_batches"] + tr["timeline_batches"] \
        + len(ctx["times"])
    return counters["host_copy_bytes"] / n / 1e6
