"""Batched W-space projection (latent inversion) of paired images
(counterpart: latentaugment_tpu/models/stylegan2/projector.py).

The optimization of NVIDIA's StyleGAN2 projector (Adam on one w per
image, cosine learning-rate ramp-down with a linear warm-up, decaying
Gaussian w-noise for exploration, perceptual feature distance), batched
over images:

  * The descent is a Python loop that never synchronises with the device:
    the per-step distances stay tensors and come back stacked.
  * The perceptual distance is the LPIPS VGG16 embedding the policy
    walks on (`vgg.lpips_features`, [0,255] input), per modality.
  * G runs with noise_mode='const', as in the walk, so no noise buffers
    are optimized. `pix_weight` adds a pixel-MSE term (off by default).

Works for both generator families (`networks_for`); every FIR resample
and bias + activation of G runs through the kernels on a CUDA device.
"""

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import vgg
from ...ops.adam import adam_step


def w_stats_from_z(G, z, c=None):
    """(w_avg [1,1,w_dim], w_std scalar tensor) over the mapped `z`
    [N, z_dim] (with labels `c` [N, c_dim] for a conditional G). w_std is
    the root of the total squared deviation per sample (summed over
    w_dim, not per coordinate), NVIDIA's convention."""
    with torch.no_grad():
        w = G.mapping(z, c, broadcast=False)  # [N, w_dim]
        w_avg = w.mean(dim=0)
        w_std = torch.sqrt((w - w_avg).square().sum() / z.shape[0])
    return w_avg.reshape(1, 1, -1), w_std


def w_stats(G, generator, n_samples=10000):
    """w_stats_from_z over z ~ N(0, I) drawn from `generator` on G's
    device; a conditional G averages over uniform one-hot labels, drawn
    from the same generator after z."""
    device = next(G.parameters()).device
    z = torch.randn([n_samples, G.cfg.z_dim], generator=generator, device=device)
    c = None
    if G.cfg.c_dim > 0:
        idx = torch.randint(0, G.cfg.c_dim, [n_samples], generator=generator, device=device)
        c = torch.nn.functional.one_hot(idx, G.cfg.c_dim).float()
    return w_stats_from_z(G, z, c)


def schedule(t, num_steps, initial_lr=0.1, initial_noise_factor=0.05,
             lr_rampdown_length=0.25, lr_rampup_length=0.05, noise_ramp_length=0.75):
    """(lr, noise factor) of 0-based step `t` of `num_steps`: cosine
    ramp-down of lr over the last quarter, linear warm-up over the first
    5%; the noise factor (times w_std it is the noise scale) decays
    quadratically to 0 at three quarters of the run."""
    t_frac = t / num_steps
    noise = initial_noise_factor * max(0.0, 1.0 - t_frac / noise_ramp_length) ** 2
    lr_ramp = min(1.0, (1.0 - t_frac) / lr_rampdown_length)
    lr_ramp = 0.5 - 0.5 * math.cos(lr_ramp * math.pi)
    lr_ramp = lr_ramp * min(1.0, t_frac / lr_rampup_length)
    return initial_lr * lr_ramp, noise


def make_project_fn(g_cfg, num_steps=1000, initial_lr=0.1, initial_noise_factor=0.05,
                    lr_rampdown_length=0.25, lr_rampup_length=0.05,
                    noise_ramp_length=0.75, pix_weight=0.0, remat=False,
                    checkpoint_feats=False):
    """Returns project(G, vgg_params, target, w_avg, w_std, generator, rows=None)
    -> (w_opt [B,1,w_dim], dists [num_steps]).

    target: [B, n_modes, res, res] in [-1, 1] on G's device. `generator`
    draws the exploration noise (a torch.Generator on that device; it may
    be None when initial_noise_factor is 0). Under data parallelism
    `rows` (parallel.mesh.Rows) says which rows of the global batch
    `target` holds: the noise is drawn for the global batch, each rank's
    distance is its share of the global mean (so each w descends as in
    one process), and `dists` are the global batch's."""
    num_ws = g_cfg.num_ws
    n_modes = g_cfg.img_channels
    num_steps = int(num_steps)

    def perceptual(vgg_params, x):
        # Modalities fold into the batch (one VGG pass), as in the walk.
        b = x.shape[0]
        xm = x.reshape(b * n_modes, 1, *x.shape[2:]).repeat(1, 3, 1, 1)
        return vgg.lpips_features(vgg_params, (xm + 1.0) * 127.5).reshape(b, -1)

    def feats_of(vgg_params, x):
        if checkpoint_feats:
            # Recompute the VGG activations in the backward pass instead of
            # storing them.
            return checkpoint(perceptual, vgg_params, x, use_reentrant=False)
        return perceptual(vgg_params, x)

    def batch_mean(x, rows):
        return x.mean() if rows is None else rows.mean(x)

    def project(G, vgg_params, target, w_avg, w_std, generator=None, rows=None):
        batch = target.shape[0]
        with torch.no_grad():
            target_feats = perceptual(vgg_params, target)
        w = w_avg.reshape(1, 1, -1).float().repeat(batch, 1, 1)
        m, v = torch.zeros_like(w), torch.zeros_like(w)
        dists = []
        for t in range(num_steps):
            lr, noise = schedule(t, num_steps, initial_lr, initial_noise_factor,
                                 lr_rampdown_length, lr_rampup_length, noise_ramp_length)
            with torch.enable_grad():
                w_leaf = w.detach().requires_grad_(True)
                wn = w_leaf
                if noise > 0.0:
                    draw = torch.randn if rows is None else rows.randn
                    wn = w_leaf + draw(w.shape, generator=generator,
                                       device=w.device) * (w_std * noise)
                x = G.synthesis(wn.repeat(1, num_ws, 1), noise_mode="const", remat=remat)
                f = feats_of(vgg_params, x.float())
                dist = batch_mean((f - target_feats).square().reshape(batch, -1).sum(dim=-1),
                                  rows)
                if pix_weight > 0.0:
                    sq = (x.float() - target).square()
                    dist = dist + pix_weight * (sq.mean() if rows is None else
                                                rows.mean(sq.reshape(batch, -1).mean(dim=1)))
                g, = torch.autograd.grad(dist, w_leaf)
            w, m, v = adam_step(w, m, v, g, t, lr)
            dists.append(dist.detach())
        dists = torch.stack(dists)
        return w, (dists if rows is None else rows.sum(dists))

    return project


def broadcast_rows(w_opt, num_ws):
    """[B, 1, w_dim] -> list of [num_ws, w_dim] numpy arrays, the per-slice
    pickle payload of the inversion zip (all rows equal, so the policy's
    reverse_broadcasting recovers w)."""
    w = np.asarray(torch.as_tensor(w_opt).detach().float().cpu().numpy(), dtype=np.float32)
    return [np.repeat(w[i], num_ws, axis=0) for i in range(w.shape[0])]
