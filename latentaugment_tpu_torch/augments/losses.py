"""Latent-walk loss functions, mean form
(counterpart: latentaugment_tpu/augments/losses.py:54-74).

Every manifold loss of the walk is the mean over all pairs of
||y_n - x_m||^2, which equals
    mean_n ||y_n||^2 + mean_m ||x_m||^2 - 2 mean_n <y_n, mean_m x_m>,
so a manifold enters only through its mean vector and mean squared norm.
"""

import torch
import torch.nn.functional as F


def manifold_summary(X):
    """(mean vector, mean squared norm) of manifold X [m, ...]."""
    Xf = X.reshape(X.shape[0], -1).float()
    return Xf.mean(dim=0), Xf.square().sum(dim=1).mean()


def l2_mean_loss(Y, x_mean, x_msq, normalize=True):
    """mean_{n,m} ||y_n - x_m||^2 (optionally / feature size) from summary."""
    Yf = Y.reshape(Y.shape[0], -1).float()
    val = Yf.square().sum(dim=1).mean() + x_msq - 2.0 * (Yf @ x_mean).mean()
    if normalize:
        val = val / Yf.shape[1]
    return val


def disc_softplus_loss(logits):
    """Realism term: mean softplus(-D(x))."""
    return F.softplus(-logits).mean()
