"""Bias-corrected Adam step for w-space descent
(counterpart: latentaugment_tpu/ops/adam.py:18-25)."""

import torch

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


def adam_step(w, m, v, g, t, lr, b1=ADAM_B1, b2=ADAM_B2, eps=ADAM_EPS):
    """One bias-corrected Adam update; `t` is the 0-based step index (a
    Python int, so nothing syncs with the device). Returns (w, m, v)."""
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * g.square()
    m_hat = m / (1.0 - b1 ** (t + 1))
    v_hat = v / (1.0 - b2 ** (t + 1))
    return w - lr * m_hat / (torch.sqrt(v_hat) + eps), m, v
