"""device.launches_per_batch: kernels in the profiler's trace of the
traced batches (copies and fills of memory left out), over those
batches."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["n_batches"]:
        return None
    return tr["launches"] / tr["n_batches"]
