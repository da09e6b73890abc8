"""policy.host_ms_per_batch: host milliseconds a batch spends in the
policy's set_input, get_output and get_latent_output (host clock around
each call, summed over the untraced batches of the window, over their
count)."""


def read(ctx):
    t = ctx["times"]
    if not t:
        return None
    return 1e3 * sum((tb - ta) + (td - tc) for ta, tb, tc, td in t) / len(t)
