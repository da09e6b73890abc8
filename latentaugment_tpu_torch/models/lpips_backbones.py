"""AlexNet / SqueezeNet-1.1 LPIPS feature backbones, functional over a
dict of tensors (counterpart: latentaugment_tpu/models/lpips_backbones.py).

The torchvision `alexnet().features` / `squeezenet1_1().features` trunks
with the richzhang tap layers:

  AlexNet:    taps after relu1..relu5 (torchvision indices [2,5,8,10,12]),
              channels [64, 192, 384, 256, 256]
  SqueezeNet: taps at indices [2,5,8,10,11,12,13],
              channels [64, 128, 256, 384, 384, 512, 512]

Both take images in [-1, 1] and z-score them with the LPIPS shift and
scale, as models/vgg.py does. Weights come from converted torchvision
state dicts (convert_torchvision_*) or a seeded He init. Param trees
have the JAX package's layout, so `vgg.params_from_numpy` carries one
across.
"""

import numpy as np
import torch
import torch.nn.functional as F

from .vgg import _LPIPS_SCALE, _LPIPS_SHIFT

ALEX_TAPS = ["relu1", "relu2", "relu3", "relu4", "relu5"]
ALEX_CHANNELS = {"relu1": 64, "relu2": 192, "relu3": 384, "relu4": 256,
                 "relu5": 256}
SQUEEZE_TAPS = [f"relu{i}" for i in range(1, 8)]
SQUEEZE_CHANNELS = {"relu1": 64, "relu2": 128, "relu3": 256, "relu4": 384,
                    "relu5": 384, "relu6": 512, "relu7": 512}

# (name, out_ch, kernel, stride, padding) of torchvision alexnet().features.
_ALEX_CONVS = [
    ("conv1", 64, 11, 4, 2),
    ("conv2", 192, 5, 1, 2),
    ("conv3", 384, 3, 1, 1),
    ("conv4", 256, 3, 1, 1),
    ("conv5", 256, 3, 1, 1),
]

# squeezenet1_1 fire configs: (name, squeeze_ch, expand_ch each branch).
_SQUEEZE_FIRES = [
    ("fire2", 16, 64), ("fire3", 16, 64),
    ("fire4", 32, 128), ("fire5", 32, 128),
    ("fire6", 48, 192), ("fire7", 48, 192),
    ("fire8", 64, 256), ("fire9", 64, 256),
]


def _he_conv(gen, c_out, c_in, k, device):
    w = torch.randn([c_out, c_in, k, k], generator=gen) * np.sqrt(2.0 / (c_in * k * k))
    return {"weight": w.to(device), "bias": torch.zeros([c_out], device=device)}


def _conv(x, p, stride=1, padding=0):
    return F.conv2d(x, p["weight"].to(x.dtype), p["bias"].to(x.dtype),
                    stride=stride, padding=padding)


def _maxpool(x, k=3, s=2, ceil_mode=False):
    """MaxPool2d(k, s); ceil_mode pads right and bottom with -inf up to a
    whole last window (squeezenet1_1)."""
    h, w = x.shape[2], x.shape[3]
    if ceil_mode:
        pad_h = max(0, -(-(h - k) // s) * s + k - h)
        pad_w = max(0, -(-(w - k) // s) * s + k - w)
        if pad_h or pad_w:
            x = F.pad(x, (0, pad_w, 0, pad_h), value=float("-inf"))
    return F.max_pool2d(x, k, s)


def _z_score(x):
    """[-1,1] images -> z-scored input. Per-channel Python scalars: a
    constant tensor would be a host to device copy on every call."""
    return torch.cat([(x[:, i:i + 1] - _LPIPS_SHIFT[i]) / _LPIPS_SCALE[i]
                      for i in range(3)], dim=1)


# ----------------------------------------------------------------------------
# AlexNet

def init_alexnet(seed=0, device=torch.device("cpu")):
    gen = torch.Generator().manual_seed(seed)
    params = {}
    c_in = 3
    for name, c_out, k, _, _ in _ALEX_CONVS:
        params[name] = _he_conv(gen, c_out, c_in, k, device)
        c_in = c_out
    return params


def alexnet_taps(params, x):
    """x in [-1,1] -> {relu1..relu5: activation} (trunk order:
    conv-relu-pool, conv-relu-pool, conv-relu, conv-relu, conv-relu)."""
    x = _z_score(x)
    out = {}
    for i, (name, _, _, stride, padding) in enumerate(_ALEX_CONVS):
        x = F.relu(_conv(x, params[name], stride=stride, padding=padding))
        out[f"relu{i + 1}"] = x
        if i < 2:
            x = _maxpool(x)
    return out


def _set_leaf(slot, leaf, name, arr):
    arr = np.asarray(arr.detach().cpu().numpy() if hasattr(arr, "detach") else arr,
                     np.float32)
    if tuple(slot[leaf].shape) != arr.shape:
        raise ValueError(f"shape mismatch for {name!r}")
    slot[leaf] = torch.tensor(arr, device=slot[leaf].device)


def convert_torchvision_alexnet(state_dict, device=torch.device("cpu")):
    """torchvision alexnet state dict (features.{0,3,6,8,10}.*) -> tree."""
    idx = {0: "conv1", 3: "conv2", 6: "conv3", 8: "conv4", 10: "conv5"}
    params = init_alexnet(device=device)
    for name, arr in state_dict.items():
        parts = name.split(".")
        if parts[0] != "features":
            continue
        layer = idx.get(int(parts[1]))
        if layer is None:
            raise KeyError(f"unexpected alexnet key {name!r}")
        _set_leaf(params[layer], parts[2], name, arr)
    return params


# ----------------------------------------------------------------------------
# SqueezeNet 1.1

def init_squeezenet(seed=0, device=torch.device("cpu")):
    gen = torch.Generator().manual_seed(seed)
    params = {"conv1": _he_conv(gen, 64, 3, 3, device)}
    c_in = 64
    for name, sq, ex in _SQUEEZE_FIRES:
        params[name] = {
            "squeeze": _he_conv(gen, sq, c_in, 1, device),
            "expand1x1": _he_conv(gen, ex, sq, 1, device),
            "expand3x3": _he_conv(gen, ex, sq, 3, device),
        }
        c_in = 2 * ex
    return params


def _fire(x, p):
    s = F.relu(_conv(x, p["squeeze"]))
    e1 = F.relu(_conv(s, p["expand1x1"]))
    e3 = F.relu(_conv(s, p["expand3x3"], padding=1))
    return torch.cat([e1, e3], dim=1)


def squeezenet_taps(params, x):
    """x in [-1,1] -> {relu1..relu7} at torchvision indices
    [2,5,8,10,11,12,13] of squeezenet1_1().features."""
    x = _z_score(x)
    out = {}
    x = F.relu(_conv(x, params["conv1"], stride=2))          # idx 2
    out["relu1"] = x
    x = _maxpool(x, ceil_mode=True)                           # idx 3
    x = _fire(x, params["fire2"])                             # idx 4
    x = _fire(x, params["fire3"])                             # idx 5
    out["relu2"] = x
    x = _maxpool(x, ceil_mode=True)                           # idx 6
    x = _fire(x, params["fire4"])                             # idx 7
    x = _fire(x, params["fire5"])                             # idx 8
    out["relu3"] = x
    x = _maxpool(x, ceil_mode=True)                           # idx 9
    for i, name in enumerate(("fire6", "fire7", "fire8", "fire9")):  # idx 10-13
        x = _fire(x, params[name])
        out[f"relu{i + 4}"] = x
    return out


def convert_torchvision_squeezenet(state_dict, device=torch.device("cpu")):
    """torchvision squeezenet1_1 state dict -> tree. Keys:
    features.0.* (conv1), features.{3,4,6,7,9,10,11,12}.{squeeze,
    expand1x1,expand3x3}.*"""
    idx = {3: "fire2", 4: "fire3", 6: "fire4", 7: "fire5", 9: "fire6",
           10: "fire7", 11: "fire8", 12: "fire9"}
    params = init_squeezenet(device=device)
    for name, arr in state_dict.items():
        parts = name.split(".")
        if parts[0] != "features":
            continue
        if parts[1] == "0":
            _set_leaf(params["conv1"], parts[2], name, arr)
            continue
        fire = idx.get(int(parts[1]))
        if fire is None:
            raise KeyError(f"unexpected squeezenet key {name!r}")
        _set_leaf(params[fire][parts[2]], parts[3], name, arr)
    return params
