"""Adaptive discriminator augmentation (ADA) for the trainer
(counterpart: latentaugment_tpu/models/stylegan2/ada.py).

`apply_ada(imgs, gen, p, cfg)` augments a batch with overall probability
`p`, a tensor (or float) on the images' device, so changing p never
changes what runs and never syncs with the host. It is two steps that
the tests can take apart:

  * `draw_ada` draws every random number of the pipe from one
    `torch.Generator` on the device: per op a gate (bernoulli at
    min(p * multiplier, 1)) and the op's own draws, each as the JAX
    package's `jax.random` call returns it (`xint` uniform in
    [-xint_max, xint_max], the log2-scales standard normal, angles
    uniform in [-pi, pi], ...).
  * `apply_ada_draws` applies them: the geometric ops (xflip, 90-degree
    rotations, integer and fractional translation, isotropic and
    anisotropic scaling, rotation) compose one inverse 3x3 matrix per
    sample and one bilinear `F.grid_sample` with reflection padding and
    align_corners=False; then the colour ops (brightness, contrast, and
    for 3-channel images lumaflip, hue, saturation), noise and cutout.

As in the JAX package there is no wavelet anti-aliasing and no image
filter group. Everything is differentiable with respect to the image
(Gmain differentiates through it); nothing differentiates it twice: R1
sees the augmented reals as constants, and path length has no
augmentation. `AdaController` adapts p on the host from
r_t = E[sign(D(real))].
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

_OP_NAMES = ('xflip', 'rotate90', 'xint', 'scale', 'rotate', 'aniso',
             'xfrac', 'brightness', 'contrast', 'lumaflip', 'hue',
             'saturation', 'noise', 'cutout')
_GEOM_OPS = ('xflip', 'rotate90', 'xint', 'scale', 'rotate', 'aniso', 'xfrac')

PRESETS = {
    'blit':  dict(xflip=1, rotate90=1, xint=1),
    'geom':  dict(scale=1, rotate=1, aniso=1, xfrac=1),
    'color': dict(brightness=1, contrast=1, lumaflip=1, hue=1, saturation=1),
    'filter': dict(),   # no image-filter group, as in the JAX package
    'noise': dict(noise=1),
    'cutout': dict(cutout=1),
}
PRESETS['bg'] = {**PRESETS['blit'], **PRESETS['geom']}
PRESETS['bgc'] = {**PRESETS['bg'], **PRESETS['color']}
PRESETS['bgcfnc'] = {**PRESETS['bgc'], **PRESETS['noise'], **PRESETS['cutout']}

# The pipe's strengths (the JAX apply_ada's keyword defaults, which no
# caller changes).
STRENGTHS = dict(xint_max=0.125, scale_std=0.2, rotate_max=1.0, aniso_std=0.2,
                 xfrac_std=0.125, brightness_std=0.2, contrast_std=0.5, hue_max=1.0,
                 saturation_std=1.0, noise_std=0.1, cutout_size=0.5)


def pipe_config(spec='bgc', **overrides):
    """Op-multiplier dict from a preset name and/or explicit multipliers."""
    cfg = {k: 0.0 for k in _OP_NAMES}
    if spec:
        cfg.update(PRESETS[spec])
    cfg.update({k: float(v) for k, v in overrides.items()})
    unknown = set(cfg) - set(_OP_NAMES)
    if unknown:
        raise ValueError(f'unknown ADA ops: {sorted(unknown)}')
    return cfg


def draw_ada(gen, shape, p, cfg):
    """Every random draw of the pipe for images of `shape` [N, C, H, W]:
    a dict from op name to a tuple whose first entry is the per-sample
    gate. `p` is a scalar tensor or float; draws land on gen.device."""
    s = STRENGTHS
    n, c = shape[0], shape[1]
    dev = gen.device
    p = torch.as_tensor(p, dtype=torch.float32, device=dev)

    def uniform(size, lo, hi):
        return torch.rand(size, generator=gen, device=dev) * (hi - lo) + lo

    def normal(size):
        return torch.randn(size, generator=gen, device=dev)

    def gate(prob):
        return torch.rand([n], generator=gen, device=dev) < prob

    def gate_op(op):
        return gate((p * cfg[op]).clamp(0.0, 1.0))

    def rotate_draws():
        # Applied before and after aniso with p_rot = 1 - sqrt(1 - p), so
        # that the compound hits p.
        p_rot = 1.0 - torch.sqrt((1.0 - p * cfg['rotate']).clamp(0.0, 1.0))
        return gate(p_rot), uniform([n], -math.pi, math.pi)

    d = {}
    if cfg['xflip']:
        d['xflip'] = (gate_op('xflip'),)
    if cfg['rotate90']:
        d['rotate90'] = (gate_op('rotate90'),
                         torch.randint(0, 4, [n], generator=gen, device=dev))
    if cfg['xint']:
        d['xint'] = (gate_op('xint'), uniform([n, 2], -s['xint_max'], s['xint_max']))
    if cfg['scale']:
        d['scale'] = (gate_op('scale'), normal([n]))
    if cfg['rotate']:
        d['rotate'] = rotate_draws()
    if cfg['aniso']:
        d['aniso'] = (gate_op('aniso'), uniform([n], -math.pi, math.pi), normal([n]))
    if cfg['rotate']:
        d['rotate2'] = rotate_draws()
    if cfg['xfrac']:
        d['xfrac'] = (gate_op('xfrac'), normal([n, 2]))
    if cfg['brightness']:
        d['brightness'] = (gate_op('brightness'), normal([n]))
    if cfg['contrast']:
        d['contrast'] = (gate_op('contrast'), normal([n]))
    if c == 3:
        if cfg['lumaflip']:
            d['lumaflip'] = (gate_op('lumaflip'),)
        if cfg['hue']:
            d['hue'] = (gate_op('hue'), uniform([n], -math.pi, math.pi))
        if cfg['saturation']:
            d['saturation'] = (gate_op('saturation'), normal([n]))
    if cfg['noise']:
        d['noise'] = (gate_op('noise'), normal([n]), normal(list(shape)))
    if cfg['cutout']:
        d['cutout'] = (gate_op('cutout'), torch.rand([n, 2], generator=gen, device=dev))
    return d


def _rot2(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, z], -1),
                        torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def _translate2(tx, ty):
    z, o = torch.zeros_like(tx), torch.ones_like(tx)
    return torch.stack([torch.stack([o, z, tx], -1),
                        torch.stack([z, o, ty], -1),
                        torch.stack([z, z, o], -1)], -2)


def _scale2(sx, sy):
    z, o = torch.zeros_like(sx), torch.ones_like(sx)
    return torch.stack([torch.stack([sx, z, z], -1),
                        torch.stack([z, sy, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def _where(g, a, b):
    """Per-sample choice: g [N] bool, a a tensor or scalar, b likewise."""
    a = torch.as_tensor(a, dtype=torch.float32, device=g.device)
    b = torch.as_tensor(b, dtype=torch.float32, device=g.device)
    return torch.where(g.reshape(g.shape + (1,) * (max(a.ndim, b.ndim) - 1)), a, b)


def apply_ada_draws(imgs, d, cfg):
    """Apply the draws `d` of `draw_ada` to imgs [N, C, H, W] (square).
    Returns images of the same shape and dtype."""
    s = STRENGTHS
    n, c, h, w = imgs.shape
    if h != w:
        raise ValueError(f'the ADA pipe takes square images, got {h}x{w}')
    dev = imgs.device
    x = imgs.float()

    # Geometric: accumulate the per-sample INVERSE transform M, so that the
    # sampling grid is src = M @ dst (ops T1..Tk in forward order give
    # M = T1^-1 @ ... @ Tk^-1, accumulated by right-multiplication).
    if any(cfg[k] for k in _GEOM_OPS):
        m = torch.eye(3, device=dev).expand(n, 3, 3)
        if 'xflip' in d:
            g, = d['xflip']
            sx = _where(g, -1.0, 1.0)
            m = m @ _scale2(sx, torch.ones_like(sx))      # self-inverse
        if 'rotate90' in d:
            g, k90 = d['rotate90']
            theta = _where(g, k90.float(), 0.0) * (np.pi / 2)
            m = m @ _rot2(-theta)
        if 'xint' in d:
            g, t = d['xint']
            # Whole pixels, in normalized [-1, 1] units (2 / size a pixel).
            size = torch.tensor([w, h], dtype=torch.float32, device=dev)
            t = _where(g, torch.round(t * size), 0.0) * (2.0 / size)
            m = m @ _translate2(-t[:, 0], -t[:, 1])
        if 'scale' in d:
            g, r = d['scale']
            sc = _where(g, torch.exp2(r * s['scale_std']), 1.0)
            m = m @ _scale2(1.0 / sc, 1.0 / sc)
        if 'rotate' in d:
            g, theta = d['rotate']
            m = m @ _rot2(-_where(g, theta * s['rotate_max'], 0.0))
        if 'aniso' in d:
            g, phi, r = d['aniso']
            r = _where(g, torch.exp2(r * s['aniso_std']), 1.0)
            # forward T = R(phi) S(r, 1/r) R(-phi): the inverse swaps r.
            m = m @ (_rot2(phi) @ _scale2(1.0 / r, r) @ _rot2(-phi))
        if 'rotate2' in d:
            g, theta = d['rotate2']
            m = m @ _rot2(-_where(g, theta * s['rotate_max'], 0.0))
        if 'xfrac' in d:
            g, t = d['xfrac']
            t = _where(g, t * s['xfrac_std'] * 2.0, 0.0)
            m = m @ _translate2(-t[:, 0], -t[:, 1])

        # Destination pixel centres in [-1, 1] (align_corners=False).
        xs = (2.0 * torch.arange(w, dtype=torch.float32, device=dev) + 1.0) / w - 1.0
        ys = (2.0 * torch.arange(h, dtype=torch.float32, device=dev) + 1.0) / h - 1.0
        gy, gx = torch.meshgrid(ys, xs, indexing='ij')               # [H, W]
        dst = torch.stack([gx, gy, torch.ones_like(gx)], -1)         # [H, W, 3]
        src = torch.einsum('nij,hwj->nhwi', m, dst)                  # [N, H, W, 3]
        x = F.grid_sample(x, src[..., :2], mode='bilinear', padding_mode='reflection',
                          align_corners=False)

    # Colour.
    if 'brightness' in d:
        g, b = d['brightness']
        x = x + _where(g, b * s['brightness_std'], 0.0)[:, None, None, None]
    if 'contrast' in d:
        g, r = d['contrast']
        x = x * _where(g, torch.exp2(r * s['contrast_std']), 1.0)[:, None, None, None]
    if c == 3 and any(k in d for k in ('lumaflip', 'hue', 'saturation')):
        v = torch.full([3], 1.0 / np.sqrt(3.0), device=dev)          # luma axis
        flat = x.reshape(n, 3, -1)
        if 'lumaflip' in d:
            g, = d['lumaflip']
            proj = torch.einsum('c,ncs->ns', v, flat)
            refl = flat - 2.0 * v[None, :, None] * proj[:, None, :]
            flat = torch.where(g[:, None, None], refl, flat)
        if 'hue' in d:
            g, theta = d['hue']
            theta = _where(g, theta * s['hue_max'], 0.0)
            # Rodrigues rotation of the colour vector around the luma axis.
            a = 1.0 / np.sqrt(3.0)
            kx = torch.tensor([[0.0, -a, a], [a, 0.0, -a], [-a, a, 0.0]], dtype=torch.float32,
                              device=dev)
            cos, sin = torch.cos(theta), torch.sin(theta)
            rot = (cos[:, None, None] * torch.eye(3, device=dev)
                   + sin[:, None, None] * kx[None]
                   + (1 - cos)[:, None, None] * torch.outer(v, v)[None])
            flat = torch.einsum('nij,njs->nis', rot, flat)
        if 'saturation' in d:
            g, r = d['saturation']
            sat = _where(g, torch.exp2(r * s['saturation_std']), 1.0)
            proj = torch.einsum('c,ncs->ns', v, flat)[:, None, :] * v[None, :, None]
            flat = proj + (flat - proj) * sat[:, None, None]
        x = flat.reshape(n, 3, h, w)

    # Corruptions.
    if 'noise' in d:
        g, sigma, noise = d['noise']
        sigma = _where(g, sigma.abs() * s['noise_std'], 0.0)
        x = x + sigma[:, None, None, None] * noise
    if 'cutout' in d:
        g, center = d['cutout']
        size = s['cutout_size'] / 2.0
        cx = center[:, 0][:, None] - (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        cy = center[:, 1][:, None] - (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        mask = (cx.abs()[:, None, :] >= size) | (cy.abs()[:, :, None] >= size)   # [N, H, W]
        mask = mask | ~g[:, None, None]
        x = x * mask[:, None].to(x.dtype)
    return x.to(imgs.dtype)


def apply_ada(imgs, gen, p, cfg):
    """Augment imgs [N, C, H, W] with overall probability p, every draw
    from `gen` (a torch.Generator on the images' device)."""
    return apply_ada_draws(imgs, draw_ada(gen, imgs.shape, p, cfg), cfg)


class AdaController:
    """Host-side p adaptation: r_t = E[sign(D(real))] drives p toward
    keeping r_t at `target` (ADA section 3: the overfitting heuristic)."""

    def __init__(self, target=0.6, interval=4, ada_kimg=500, p_init=0.0):
        self.target = float(target)
        self.interval = int(interval)
        self.ada_kimg = float(ada_kimg)
        self.p = float(p_init)
        self._sign_sum = 0.0
        self._n_seen = 0
        self._ticks = 0

    def state_dict(self):
        """The evolving state (the hyperparameters come from the config)."""
        return dict(p=self.p, sign_sum=self._sign_sum, n_seen=self._n_seen,
                    ticks=self._ticks)

    def load_state_dict(self, sd):
        self.p = float(sd['p'])
        self._sign_sum = float(sd['sign_sum'])
        self._n_seen = int(sd['n_seen'])
        self._ticks = int(sd['ticks'])

    def will_tick(self, n_pending):
        """True iff feeding `n_pending` more steps reaches a tick: the loop
        fetches the per-step r_t from the device only then (p changes only
        at ticks, so deferring the fetch changes nothing)."""
        return self._ticks + int(n_pending) >= self.interval

    def update(self, real_sign_mean, batch_size):
        """Feed mean(sign(D(real logits))) of one step; returns p."""
        self._sign_sum += float(real_sign_mean) * batch_size
        self._n_seen += batch_size
        self._ticks += 1
        if self._ticks >= self.interval and self._n_seen > 0:
            rt = self._sign_sum / self._n_seen
            adjust = np.sign(rt - self.target) * self._n_seen / (self.ada_kimg * 1000.0)
            self.p = float(np.clip(self.p + adjust, 0.0, 1.0))
            self._sign_sum = 0.0
            self._n_seen = 0
            self._ticks = 0
        return self.p
