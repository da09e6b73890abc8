"""LPIPS perceptual criterion, local variant (counterpart:
latentaugment_tpu/augments/criteria/lpips.py).

A backbone's tap activations, unit-normalized over channels, weighted by
frozen per-channel 'lin' weights over a layer subset: `forward` (x vs y)
and `forward_tr` (x vs a manifold of precomputed target features). The
VGG16 backbone taps conv3_3, conv4_3, conv5_3 (torchvision indices
[16, 23, 30]) by default; 'alex' and 'squeeze' use models/lpips_backbones.
Weights are a param tree given by the caller or a seeded init. A
criterion lives on one device, the card unless the caller names another,
and takes host arrays or tensors that already lie there.
"""

import numpy as np
import torch

from ...models import lpips_backbones as bb
from ...models import vgg
from ...utils.util_general import float_input, resolve_device

DEFAULT_TARGET_LAYERS = ["conv3_3", "conv4_3", "conv5_3"]


def _normalize_act(a, eps=1e-10):
    # eps inside the root, as the JAX package has it.
    return a * torch.rsqrt(a.square().sum(dim=1, keepdim=True) + eps)


def _scaled(fx, w):
    """Normalized activation [N,C,H,W] -> [N, C*H*W] rows whose squared L2
    is the layer's LPIPS term: sqrt(max(w, 0) / (H*W)) per channel."""
    hw = fx.shape[2] * fx.shape[3]
    a = fx * torch.sqrt(w.clamp(min=0.0))[None, :, None, None] / np.sqrt(float(hw))
    return a.reshape(fx.shape[0], -1)


def embedding_from_params(vgg_params, lin, x, target_layers=None):
    """Function form of LPIPS.embedding for the VGG16 backbone (what the
    walk differentiates). x in [-1, 1], [N, 3, H, W]; lin: {tap: [C]}."""
    target_layers = list(target_layers or DEFAULT_TARGET_LAYERS)
    acts = vgg.vgg_features(vgg_params, (x + 1.0) * 127.5, taps=target_layers)
    return torch.cat([_scaled(_normalize_act(acts[tap].float()), lin[tap])
                      for tap in target_layers], dim=1)


def default_lin(params, taps=None, channels=None, device=None):
    """{tap: [C]} lin weights for `taps`: the param tree's own 'lin' entry
    where it has one, else ones."""
    taps = list(taps or DEFAULT_TARGET_LAYERS)
    channels = channels or vgg.LPIPS_CHANNELS
    base = params.get("lin", {})
    return {t: base[t] if t in base else torch.ones([channels[t]], device=device)
            for t in taps}


class LPIPS:
    """Learned perceptual distance over a backbone layer subset, on images
    in [-1, 1]. net_type: 'vgg' (VGG16 taps [16,23,30]), 'alex' or
    'squeeze'. `params` / `lin` default to a seeded init / unit weights
    (for 'vgg', the tree's own 'lin' where it has one). `device`: where the
    criterion computes, 'cuda' unless given (cuda without CUDA raises);
    params and lin handed in must lie there, as must tensor inputs."""

    def __init__(self, net_type="vgg", params=None, lin=None, target_layers=None,
                 device="cuda"):
        self.device = resolve_device(device)
        if net_type == "vgg":
            taps, channels = DEFAULT_TARGET_LAYERS, vgg.LPIPS_CHANNELS
            init = vgg.init_vgg
            self._taps_fn = lambda p, x: vgg.vgg_features(
                p, (x + 1.0) * 127.5, taps=self.target_layers, input_range="0_255")
        elif net_type == "alex":
            taps, channels = bb.ALEX_TAPS, bb.ALEX_CHANNELS
            init, self._taps_fn = bb.init_alexnet, bb.alexnet_taps
        elif net_type == "squeeze":
            taps, channels = bb.SQUEEZE_TAPS, bb.SQUEEZE_CHANNELS
            init, self._taps_fn = bb.init_squeezenet, bb.squeezenet_taps
        else:
            raise NotImplementedError("choose net_type from [alex, squeeze, vgg].")
        self.net_type = net_type
        self.target_layers = list(target_layers or taps)
        self.params = params if params is not None else init(0, self.device)
        self.lin = lin if lin is not None else default_lin(
            self.params if net_type == "vgg" else {}, self.target_layers, channels,
            self.device)

    def extract_features(self, x):
        """[N,3,H,W] in [-1,1] -> list of unit-normalized activations."""
        x = float_input(x, self.device, "LPIPS input")
        acts = self._taps_fn(self.params, x)
        return [_normalize_act(acts[t].float()) for t in self.target_layers]

    def forward(self, x, y):
        """Per-pair LPIPS distance [N] between same-shape batches."""
        total = 0.0
        for tap, fx, fy in zip(self.target_layers, self.extract_features(x),
                               self.extract_features(y)):
            w = self.lin[tap].clamp(min=0.0)[None, :, None, None]
            total = total + (w * (fx - fy).square()).sum(dim=1).mean(dim=(1, 2))
        return total

    __call__ = forward

    def embedding(self, x):
        """Per-image embedding whose squared L2 is the LPIPS distance over
        this criterion's layers: what `--lpips_script lpips_tr` walks on.
        x in [-1, 1], [N,3,H,W]."""
        return torch.cat([_scaled(fx, self.lin[tap]) for tap, fx in
                          zip(self.target_layers, self.extract_features(x))], dim=1)

    def forward_tr(self, x, feat):
        """Mean distance of batch x to a manifold of precomputed feature
        lists (one [M,C,H,W] of unit-normalized activations per layer): the
        mean over all (sample, target) pairs of the layer distances, by the
        sum-of-squares decomposition."""
        total = 0.0
        for tap, fx, ft in zip(self.target_layers, self.extract_features(x), feat):
            sw = torch.sqrt(self.lin[tap].clamp(min=0.0))[None, :, None, None]
            a = (fx * sw).reshape(fx.shape[0], -1)
            b = (float_input(ft, self.device, "LPIPS target features") * sw) \
                .reshape(ft.shape[0], -1)
            pair = a.square().sum(dim=1)[:, None] + b.square().sum(dim=1)[None, :] \
                - 2.0 * (a @ b.T)  # [N, M]
            total = total + pair.mean() / (fx.shape[2] * fx.shape[3])
        return total
