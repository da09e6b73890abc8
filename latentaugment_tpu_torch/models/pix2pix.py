"""Downstream pix2pix-style paired-translation model: a U-Net G and a
PatchGAN D (counterpart: latentaugment_tpu/models/pix2pix.py).

LatentAugment's augmented (A, B) pairs exist to train an image-to-image
model; this is that consumer. The architecture follows Isola et al.'s
pix2pix: a U-Net generator with skip connections, nearest x2 up-sampling,
lrelu 0.2 and a tanh output, and a PatchGAN discriminator on the
concatenated (condition, image) pair, trained with the LSGAN loss plus
lambda * L1. Norm-free, as in the JAX package. Plain PyTorch (cuDNN
convolutions): the JAX file has no Pallas kernel, only `lax.conv`.

`make_train_step` keeps the JAX step's semantics: both losses and both
gradients come from the pre-update G and D, then both are updated, with
Adam in the JAX file's form p - lr·sqrt(1-β2^t)/(1-β1^t)·m/(sqrt(v)+ε)
(`torch.optim.Adam` puts ε inside the bias correction and would not
match). Parameters are `nn.Module`s; `params_from_jax` carries a JAX
parameter tree (numpy leaves) into them.
"""

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.util_easydict import EasyDict


def pix2pix_config(in_channels=1, out_channels=1, base_channels=32,
                   depth=3, d_layers=3, lambda_l1=100.0, lr=2e-4,
                   beta1=0.5):
    return EasyDict(in_channels=in_channels, out_channels=out_channels,
                    base_channels=base_channels, depth=depth,
                    d_layers=d_layers, lambda_l1=float(lambda_l1),
                    lr=float(lr), beta1=float(beta1))


class Conv(nn.Module):
    """A k x k convolution with bias: weight [out, in, k, k] (OIHW, as the
    JAX tree's 'w'), bias [out] ('b'); init normal * 0.02, bias 0."""

    def __init__(self, gen, in_ch, out_ch, k, stride=1, padding=1):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.randn([out_ch, in_ch, k, k], generator=gen) * 0.02)
        self.bias = nn.Parameter(torch.zeros([out_ch]))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, stride=self.stride, padding=self.padding)


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


class UNetGenerator(nn.Module):
    """x [N, in_ch, H, W] in [-1,1] -> y [N, out_ch, H, W] in (-1,1)."""

    def __init__(self, cfg, gen):
        super().__init__()
        ch = [cfg.base_channels * (2 ** i) for i in range(cfg.depth)]
        prev, enc = cfg.in_channels, []
        for i in range(cfg.depth):
            enc.append(Conv(gen, prev, ch[i], 4, stride=2, padding=1))
            prev = ch[i]
        self.enc = nn.ModuleList(enc)
        self.mid = Conv(gen, prev, prev, 3)
        dec = []
        for i in reversed(range(cfg.depth)):
            out_ch = ch[i - 1] if i > 0 else cfg.base_channels
            dec.append(Conv(gen, prev + ch[i], out_ch, 3))
            prev = out_ch
        self.dec = nn.ModuleList(dec)
        self.out = Conv(gen, prev, cfg.out_channels, 3)

    def forward(self, x):
        skips = []
        h = x
        for conv in self.enc:
            h = _lrelu(conv(h))  # H -> H/2
            skips.append(h)
        h = _lrelu(self.mid(h))
        for conv in self.dec:
            h = torch.cat([h, skips.pop()], dim=1)
            h = F.interpolate(h, scale_factor=2, mode="nearest")
            h = _lrelu(conv(h))
        return torch.tanh(self.out(h))


class PatchDiscriminator(nn.Module):
    """Patch logits map for the (condition, image) pair."""

    def __init__(self, cfg, gen):
        super().__init__()
        prev, layers = cfg.in_channels + cfg.out_channels, []
        for i in range(cfg.d_layers):
            out = cfg.base_channels * (2 ** i)
            layers.append(Conv(gen, prev, out, 4, stride=2, padding=1))
            prev = out
        self.layers = nn.ModuleList(layers)
        self.out = Conv(gen, prev, 1, 4, stride=1, padding=1)

    def forward(self, a, b):
        h = torch.cat([a, b], dim=1)
        for conv in self.layers:
            h = _lrelu(conv(h))
        return self.out(h)


def init_all(seed, cfg, device="cpu"):
    """{'G': UNetGenerator, 'D': PatchDiscriminator} from a seeded CPU
    generator, on `device`."""
    gen = torch.Generator().manual_seed(int(seed))
    nets = nn.ModuleDict({"G": UNetGenerator(cfg, gen), "D": PatchDiscriminator(cfg, gen)})
    return nets.to(device)


def _jax_state_dict(tree, prefix=""):
    """JAX pix2pix tree -> {state_dict key: float32 tensor}: lists index
    the ModuleLists, 'w' / 'b' are weight / bias."""
    out = {}
    items = enumerate(tree) if isinstance(tree, (list, tuple)) else tree.items()
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(_jax_state_dict(v, f"{prefix}{k}."))
        else:
            name = {"w": "weight", "b": "bias"}[k]
            out[f"{prefix}{name}"] = torch.tensor(np.array(v, np.float32))
    return out


def params_from_jax(tree, cfg, device="cpu"):
    """The modules of `init_all` holding the JAX tree's values
    ({'G': {'enc', 'mid', 'dec', 'out'}, 'D': {'layers', 'out'}}, numpy
    leaves); every parameter must be present."""
    nets = init_all(0, cfg)
    nets.load_state_dict(_jax_state_dict(tree), strict=True)
    return nets.to(device)


def opt_init(nets):
    """Adam state per network: first and second moments and the step."""
    return {name: {"m": [torch.zeros_like(p) for p in nets[name].parameters()],
                   "v": [torch.zeros_like(p) for p in nets[name].parameters()], "t": 0}
            for name in ("G", "D")}


@torch.no_grad()
def _adam_update(params, grads, state, lr, beta1, beta2=0.999, eps=1e-8):
    """In place, the JAX file's `_adam_update`; the scale in float32 as
    there."""
    state["t"] += 1
    tf = torch.tensor(float(state["t"]), dtype=torch.float32)
    scale = (lr * torch.sqrt(1 - torch.tensor(beta2, dtype=torch.float32) ** tf)
             / (1 - torch.tensor(beta1, dtype=torch.float32) ** tf)).item()
    for p, g, m, v in zip(params, grads, state["m"], state["v"]):
        m.mul_(beta1).add_(g, alpha=1 - beta1)
        v.mul_(beta2).add_(g * g, alpha=1 - beta2)
        p.sub_(scale * m / (v.sqrt() + eps))


def _mse(x, target):
    return ((x - target) ** 2).mean()


def losses_and_grads(cfg, nets, a, b):
    """Both losses and both gradients at the current G and D: (metrics
    {'loss_G', 'loss_D', 'loss_L1'} as detached scalars, G's gradients,
    D's gradients), in the parameters' order."""
    G, D = nets["G"], nets["D"]
    fake = G(a)
    real_logits = D(a, b)
    fake_logits = D(a, fake.detach())
    d_loss = 0.5 * (_mse(real_logits, 1.0) + _mse(fake_logits, 0.0))
    d_grads = torch.autograd.grad(d_loss, list(D.parameters()))
    l1 = (fake - b).abs().mean()
    g_loss = _mse(D(a, fake), 1.0) + cfg.lambda_l1 * l1
    g_grads = torch.autograd.grad(g_loss, list(G.parameters()))
    metrics = {"loss_G": g_loss.detach(), "loss_D": d_loss.detach(), "loss_L1": l1.detach()}
    return metrics, g_grads, d_grads


def make_train_step(cfg):
    """The pix2pix update `step(nets, opt_state, a, b) -> metrics`: both
    losses and gradients from the pre-update G and D, then D's and G's
    Adam steps, in place on `nets` and `opt_state`."""
    def step(nets, opt_state, a, b):
        metrics, g_grads, d_grads = losses_and_grads(cfg, nets, a, b)
        _adam_update(list(nets["D"].parameters()), d_grads, opt_state["D"], cfg.lr, cfg.beta1)
        _adam_update(list(nets["G"].parameters()), g_grads, opt_state["G"], cfg.lr, cfg.beta1)
        return metrics
    return step


def count_params(nets):
    return int(sum(math.prod(p.shape) for p in nets.parameters()))
