"""Neural style transfer criterion (counterpart:
latentaugment_tpu/augments/criteria/nst.py): VGG19 split into style
layers (conv1_1..conv5_1) and a content layer (conv4_2), gram-matrix
style loss plus MSE content loss.
"""

import torch

from ...models import vgg
from ...utils.util_general import float_input, resolve_device

STYLE_LAYERS = ["conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv5_1"]
CONTENT_LAYER = "conv4_2"


def gram_matrix(x):
    """[N, C, H, W] -> normalized gram [N, C, C]."""
    n, c, h, w = x.shape
    f = x.reshape(n, c, h * w)
    return torch.einsum("ncx,ndx->ncd", f, f) / (c * h * w)


class VGG19Net:
    """VGG19 feature splitter for style/content activations, on `device`
    ('cuda' unless given; cuda without CUDA raises). Tensor inputs must lie
    there; host arrays are placed there."""

    def __init__(self, params=None, seed=0, device="cuda"):
        self.device = resolve_device(device)
        self.params = params if params is not None else vgg.init_vgg(
            seed, self.device, plan=vgg.VGG19_PLAN, lpips_lin=False)

    def __call__(self, x):
        """[N,3,H,W] in [0,255] -> (style_acts list, content_act)."""
        x = float_input(x, self.device, "VGG19Net input")
        acts = vgg.vgg_features(self.params, x, plan=vgg.VGG19_PLAN,
                                taps=STYLE_LAYERS + [CONTENT_LAYER])
        return [acts[t] for t in STYLE_LAYERS], acts[CONTENT_LAYER]


class NSTLoss:
    """style_weight * gram-MSE + content_weight * feature-MSE. Without a
    `net`, a seeded VGG19Net is built on `device`."""

    def __init__(self, net=None, style_weight=1e6, content_weight=1.0, device="cuda"):
        self.net = net if net is not None else VGG19Net(device=device)
        self.style_weight = style_weight
        self.content_weight = content_weight

    def __call__(self, x, style_target, content_target):
        style_x, content_x = self.net(x)
        style_t, _ = self.net(style_target)
        _, content_ref = self.net(content_target)
        style_loss = 0.0
        for sx, st in zip(style_x, style_t):
            style_loss = style_loss + (gram_matrix(sx) - gram_matrix(st)).square().mean()
        content_loss = (content_x - content_ref).square().mean()
        return self.style_weight * style_loss + self.content_weight * content_loss
