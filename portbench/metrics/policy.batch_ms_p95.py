"""policy.batch_ms_p95: the 95th percentile of the window's whole-batch
wall times (set_input to get_latent_output), untraced batches, in ms."""

import statistics


def read(ctx):
    t = [td - ta for ta, _, _, td in ctx["times"]]
    if len(t) < 20:
        return None
    return 1e3 * statistics.quantiles(t, n=20)[18]
