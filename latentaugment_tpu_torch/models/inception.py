"""InceptionV3 feature detector for FID, functional over a dict of tensors
(counterpart: latentaugment_tpu/models/inception.py).

The torchvision InceptionV3 graph (BasicConv2d = conv + batchnorm with
eps 1e-3, folded to inference arithmetic, + relu) up to the 2048-d pooled
features. The param tree has the JAX package's layout, whose paths are
the torchvision state-dict keys: `convert_torchvision_state` maps such a
state dict onto it, `vgg.params_from_numpy` carries a JAX tree across,
and without weights a seeded He init gives a self-consistent detector.

Inputs are [N, 3, H, W] in [0, 255]; they are resized bilinearly (with
anti-aliasing when shrinking) to 299x299 and scaled to [-1, 1].
"""

import pickle
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from .stylegan2.checkpoint import load_pickle
from .vgg import params_from_numpy, params_to_numpy


# ----------------------------------------------------------------------------
# Primitives

def _basic_conv_init(seed, tags, c_in, c_out, kh, kw, device):
    """One BasicConv2d's params. Its generator is seeded from (seed, tags)
    through crc32, so a layer's weights depend on nothing but its path."""
    gen = torch.Generator().manual_seed(
        zlib.crc32(("/".join(tags) + f"#{seed}").encode()) % (2 ** 31))
    w = torch.randn([c_out, c_in, kh, kw], generator=gen) * np.sqrt(2.0 / (c_in * kh * kw))
    return {
        "conv": {"weight": w.to(device)},
        "bn": {"weight": torch.ones([c_out], device=device),
               "bias": torch.zeros([c_out], device=device),
               "running_mean": torch.zeros([c_out], device=device),
               "running_var": torch.ones([c_out], device=device)},
    }


def _basic_conv(p, x, stride=1, padding=(0, 0)):
    """conv + inference batchnorm (eps 1e-3) + relu; padding: int or (h, w)."""
    x = F.conv2d(x, p["conv"]["weight"].to(x.dtype), stride=stride, padding=padding)
    bn = p["bn"]
    inv = torch.rsqrt(bn["running_var"].to(x.dtype) + 1e-3)
    x = (x - bn["running_mean"].to(x.dtype)[None, :, None, None]) \
        * (inv * bn["weight"].to(x.dtype))[None, :, None, None] \
        + bn["bias"].to(x.dtype)[None, :, None, None]
    return F.relu(x)


def _maxpool(x):
    return F.max_pool2d(x, 3, 2)


def _avgpool(x):
    # Divides by the count of real pixels, not by the window size.
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


# ----------------------------------------------------------------------------
# Blocks: (name, c_in, c_out, kh, kw) tables for init, functions to apply.

def _inception_a_convs(c_in, pool_features):
    return [("branch1x1", c_in, 64, 1, 1), ("branch5x5_1", c_in, 48, 1, 1),
            ("branch5x5_2", 48, 64, 5, 5), ("branch3x3dbl_1", c_in, 64, 1, 1),
            ("branch3x3dbl_2", 64, 96, 3, 3), ("branch3x3dbl_3", 96, 96, 3, 3),
            ("branch_pool", c_in, pool_features, 1, 1)]


def _inception_a(p, x):
    b1 = _basic_conv(p["branch1x1"], x)
    b5 = _basic_conv(p["branch5x5_2"], _basic_conv(p["branch5x5_1"], x), padding=2)
    b3 = _basic_conv(p["branch3x3dbl_1"], x)
    b3 = _basic_conv(p["branch3x3dbl_2"], b3, padding=1)
    b3 = _basic_conv(p["branch3x3dbl_3"], b3, padding=1)
    bp = _basic_conv(p["branch_pool"], _avgpool(x))
    return torch.cat([b1, b5, b3, bp], dim=1)


def _inception_b_convs(c_in):
    return [("branch3x3", c_in, 384, 3, 3), ("branch3x3dbl_1", c_in, 64, 1, 1),
            ("branch3x3dbl_2", 64, 96, 3, 3), ("branch3x3dbl_3", 96, 96, 3, 3)]


def _inception_b(p, x):
    b3 = _basic_conv(p["branch3x3"], x, stride=2)
    bd = _basic_conv(p["branch3x3dbl_1"], x)
    bd = _basic_conv(p["branch3x3dbl_2"], bd, padding=1)
    bd = _basic_conv(p["branch3x3dbl_3"], bd, stride=2)
    return torch.cat([b3, bd, _maxpool(x)], dim=1)


def _inception_c_convs(c_in, c7):
    return [("branch1x1", c_in, 192, 1, 1), ("branch7x7_1", c_in, c7, 1, 1),
            ("branch7x7_2", c7, c7, 1, 7), ("branch7x7_3", c7, 192, 7, 1),
            ("branch7x7dbl_1", c_in, c7, 1, 1), ("branch7x7dbl_2", c7, c7, 7, 1),
            ("branch7x7dbl_3", c7, c7, 1, 7), ("branch7x7dbl_4", c7, c7, 7, 1),
            ("branch7x7dbl_5", c7, 192, 1, 7), ("branch_pool", c_in, 192, 1, 1)]


def _inception_c(p, x):
    b1 = _basic_conv(p["branch1x1"], x)
    b7 = _basic_conv(p["branch7x7_1"], x)
    b7 = _basic_conv(p["branch7x7_2"], b7, padding=(0, 3))
    b7 = _basic_conv(p["branch7x7_3"], b7, padding=(3, 0))
    bd = _basic_conv(p["branch7x7dbl_1"], x)
    bd = _basic_conv(p["branch7x7dbl_2"], bd, padding=(3, 0))
    bd = _basic_conv(p["branch7x7dbl_3"], bd, padding=(0, 3))
    bd = _basic_conv(p["branch7x7dbl_4"], bd, padding=(3, 0))
    bd = _basic_conv(p["branch7x7dbl_5"], bd, padding=(0, 3))
    bp = _basic_conv(p["branch_pool"], _avgpool(x))
    return torch.cat([b1, b7, bd, bp], dim=1)


def _inception_d_convs(c_in):
    return [("branch3x3_1", c_in, 192, 1, 1), ("branch3x3_2", 192, 320, 3, 3),
            ("branch7x7x3_1", c_in, 192, 1, 1), ("branch7x7x3_2", 192, 192, 1, 7),
            ("branch7x7x3_3", 192, 192, 7, 1), ("branch7x7x3_4", 192, 192, 3, 3)]


def _inception_d(p, x):
    b3 = _basic_conv(p["branch3x3_1"], x)
    b3 = _basic_conv(p["branch3x3_2"], b3, stride=2)
    b7 = _basic_conv(p["branch7x7x3_1"], x)
    b7 = _basic_conv(p["branch7x7x3_2"], b7, padding=(0, 3))
    b7 = _basic_conv(p["branch7x7x3_3"], b7, padding=(3, 0))
    b7 = _basic_conv(p["branch7x7x3_4"], b7, stride=2)
    return torch.cat([b3, b7, _maxpool(x)], dim=1)


def _inception_e_convs(c_in):
    return [("branch1x1", c_in, 320, 1, 1), ("branch3x3_1", c_in, 384, 1, 1),
            ("branch3x3_2a", 384, 384, 1, 3), ("branch3x3_2b", 384, 384, 3, 1),
            ("branch3x3dbl_1", c_in, 448, 1, 1), ("branch3x3dbl_2", 448, 384, 3, 3),
            ("branch3x3dbl_3a", 384, 384, 1, 3), ("branch3x3dbl_3b", 384, 384, 3, 1),
            ("branch_pool", c_in, 192, 1, 1)]


def _inception_e(p, x):
    b1 = _basic_conv(p["branch1x1"], x)
    b3 = _basic_conv(p["branch3x3_1"], x)
    b3 = torch.cat([_basic_conv(p["branch3x3_2a"], b3, padding=(0, 1)),
                    _basic_conv(p["branch3x3_2b"], b3, padding=(1, 0))], dim=1)
    bd = _basic_conv(p["branch3x3dbl_1"], x)
    bd = _basic_conv(p["branch3x3dbl_2"], bd, padding=1)
    bd = torch.cat([_basic_conv(p["branch3x3dbl_3a"], bd, padding=(0, 1)),
                    _basic_conv(p["branch3x3dbl_3b"], bd, padding=(1, 0))], dim=1)
    bp = _basic_conv(p["branch_pool"], _avgpool(x))
    return torch.cat([b1, b3, bd, bp], dim=1)


_STEM = [("Conv2d_1a_3x3", 3, 32, 3, 3), ("Conv2d_2a_3x3", 32, 32, 3, 3),
         ("Conv2d_2b_3x3", 32, 64, 3, 3), ("Conv2d_3b_1x1", 64, 80, 1, 1),
         ("Conv2d_4a_3x3", 80, 192, 3, 3)]
# (block name, its conv table, the function that applies it)
_MIXED = [
    ("Mixed_5b", _inception_a_convs(192, 32), _inception_a),
    ("Mixed_5c", _inception_a_convs(256, 64), _inception_a),
    ("Mixed_5d", _inception_a_convs(288, 64), _inception_a),
    ("Mixed_6a", _inception_b_convs(288), _inception_b),
    ("Mixed_6b", _inception_c_convs(768, 128), _inception_c),
    ("Mixed_6c", _inception_c_convs(768, 160), _inception_c),
    ("Mixed_6d", _inception_c_convs(768, 160), _inception_c),
    ("Mixed_6e", _inception_c_convs(768, 192), _inception_c),
    ("Mixed_7a", _inception_d_convs(768), _inception_d),
    ("Mixed_7b", _inception_e_convs(1280), _inception_e),
    ("Mixed_7c", _inception_e_convs(2048), _inception_e),
]


# ----------------------------------------------------------------------------
# Full network

def init_inception(seed=0, device=torch.device("cpu")):
    p = {name: _basic_conv_init(seed, (name,), c_in, c_out, kh, kw, device)
         for name, c_in, c_out, kh, kw in _STEM}
    for block, convs, _ in _MIXED:
        p[block] = {name: _basic_conv_init(seed, (block, name), c_in, c_out, kh, kw, device)
                    for name, c_in, c_out, kh, kw in convs}
    return p


def _resize_bilinear(x, size):
    """Bilinear resize to size x size with half-pixel centres; a reduction
    is anti-aliased (the triangle kernel widens by the scale)."""
    return F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                         antialias=True)


def inception_features(params, x):
    """[N, 3, H, W] in [0, 255] -> 2048-d pooled FID features [N, 2048]."""
    x = _resize_bilinear(x.float(), 299)
    x = x / 127.5 - 1.0
    x = _basic_conv(params["Conv2d_1a_3x3"], x, stride=2)
    x = _basic_conv(params["Conv2d_2a_3x3"], x)
    x = _basic_conv(params["Conv2d_2b_3x3"], x, padding=1)
    x = _maxpool(x)
    x = _basic_conv(params["Conv2d_3b_1x1"], x)
    x = _basic_conv(params["Conv2d_4a_3x3"], x)
    x = _maxpool(x)
    for block, _, apply in _MIXED:
        x = apply(params[block], x)
    return x.mean(dim=(2, 3))  # global average pool -> [N, 2048]


# ----------------------------------------------------------------------------
# Weight IO

def convert_torchvision_state(state_dict, out_path=None, strict=False,
                              device=torch.device("cpu")):
    """Map a torchvision inception_v3 state_dict onto the param tree.

    strict=True raises if any state key (other than the classifier heads,
    which are dropped) fails to land on a tree leaf; a shape mismatch
    always raises."""
    tree = init_inception(device=device)

    def set_leaf(name, path, arr):
        node = tree
        for k in path:
            if not isinstance(node, dict) or k not in node:
                if strict:
                    raise KeyError(f"torchvision key {name!r} has no slot in "
                                   f"the param tree (missing {k!r})")
                return
            parent, node = node, node[k]
        arr = np.asarray(arr, np.float32)
        if tuple(node.shape) != tuple(arr.shape):
            raise ValueError(f"shape mismatch for {name!r}: tree {tuple(node.shape)} "
                             f"vs state {tuple(arr.shape)}")
        parent[path[-1]] = torch.tensor(arr, device=device)

    for name, tensor in state_dict.items():
        parts = name.split(".")
        if parts[0] in ("AuxLogits", "fc") or parts[-1] == "num_batches_tracked":
            continue
        # <Block>[.<branch>].conv.weight / .bn.{weight,bias,running_*}
        arr = tensor.detach().cpu().numpy() if hasattr(tensor, "detach") else tensor
        if len(parts) in (3, 4):
            set_leaf(name, tuple(parts), arr)
        elif strict:
            raise KeyError(f"unrecognized torchvision key {name!r}")
    if out_path:
        with open(out_path, "wb") as f:
            pickle.dump(params_to_numpy(tree), f, pickle.HIGHEST_PROTOCOL)
    return tree


def get_inception(path=None, seed=0, device=torch.device("cpu")):
    """Converted weights from `path` (a pickle of the nested numpy tree,
    read through the numpy-only unpickler) if they load, else the seeded
    init."""
    if path is not None:
        try:
            obj = load_pickle(path)
            if not isinstance(obj, dict) or "Conv2d_1a_3x3" not in obj:
                raise ValueError("not a converted inception param tree")
            return params_from_numpy(obj, device)
        except (OSError, pickle.UnpicklingError, ValueError, KeyError, TypeError) as e:
            print(f"[inception] could not load {path} ({e}); using seeded init")
    return init_inception(seed, device)
