"""engine.forward_ms: host milliseconds of the policy's forward() a batch
(the walk engine or the sampling path, ending in the policy's own copy of
the batch to the host), over the untraced batches of the window."""


def read(ctx):
    t = ctx["times"]
    if not t:
        return None
    return 1e3 * sum(tc - tb for _, tb, tc, _ in t) / len(t)
