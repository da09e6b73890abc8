"""device.idle_share: 100 * (1 - the union of kernel intervals over the
traced window / the traced window), the window spanning the traced
batches' first set_input to their last get_latent_output, in %."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
