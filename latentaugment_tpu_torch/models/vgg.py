"""VGG16 LPIPS feature extractor, functional over a dict of tensors
(counterpart: latentaugment_tpu/models/vgg.py:35-141).

Params: {'convX_Y': {'weight', 'bias'}, 'lin': {tap: [C]}} — the same
nested layout the JAX package pickles, so one numpy pickle feeds both.

`lpips_features` returns, per image, the concatenation over the tap
layers of channel-unit-normalized activations scaled by
sqrt(lin / (H*W)), so a squared-L2 distance between two embeddings is
the LPIPS distance.
"""

import pickle

import numpy as np
import torch
import torch.nn.functional as F

from .stylegan2.checkpoint import load_pickle

# VGG16 conv plan: (name, out_channels); 'M' = 2x2 max pool.
VGG16_PLAN = [
    ("conv1_1", 64), ("conv1_2", 64), "M",
    ("conv2_1", 128), ("conv2_2", 128), "M",
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), "M",
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), "M",
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512), "M",
]

# LPIPS tap layers for VGG16 (richzhang convention).
LPIPS_TAPS = ["conv1_2", "conv2_2", "conv3_3", "conv4_3", "conv5_3"]
LPIPS_CHANNELS = {"conv1_2": 64, "conv2_2": 128, "conv3_3": 256,
                  "conv4_3": 512, "conv5_3": 512}

# Input pre-scaling of the LPIPS VGG (applied to [0,255] RGB):
# [0,255] -> [-1,1] -> richzhang shift/scale normalization.
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)


def init_vgg(seed=0, device=torch.device("cpu")):
    """He-initialized VGG16 params (with unit LPIPS `lin` weights) drawn
    from an explicit torch.Generator."""
    gen = torch.Generator().manual_seed(seed)
    params = {}
    c_in = 3
    for item in VGG16_PLAN:
        if item == "M":
            continue
        name, c_out = item
        w = torch.randn([c_out, c_in, 3, 3], generator=gen) * np.sqrt(2.0 / (c_in * 9))
        params[name] = {"weight": w.to(device),
                        "bias": torch.zeros([c_out], device=device)}
        c_in = c_out
    params["lin"] = {tap: torch.ones([LPIPS_CHANNELS[tap]], device=device)
                     for tap in LPIPS_TAPS}
    return params


def params_from_numpy(tree, device=torch.device("cpu")):
    """Nested dict of arrays -> the same nesting of float32 tensors."""
    return {k: (params_from_numpy(v, device) if isinstance(v, dict)
                else torch.tensor(np.asarray(v, np.float32), device=device))
            for k, v in tree.items()}


def vgg_features(params, x, taps=None, input_range="0_255"):
    """Run the VGG16 trunk; return {tap_name: activation} for requested taps.

    x: [N, 3, H, W]. input_range '0_255' applies the LPIPS pre-scaling;
    'unit' assumes already-normalized inputs."""
    taps = list(taps) if taps is not None else [LPIPS_TAPS[-1]]
    want = set(taps)
    if input_range == "0_255":
        # Per-channel Python scalars: a constant tensor would be a host
        # to device copy on every call.
        x = torch.cat([(x[:, i:i + 1] / 127.5 - 1.0 - _LPIPS_SHIFT[i]) / _LPIPS_SCALE[i]
                       for i in range(3)], dim=1)
    out = {}
    for item in VGG16_PLAN:
        if item == "M":
            x = F.max_pool2d(x, 2)
            continue
        name, _ = item
        p = params[name]
        x = F.relu(F.conv2d(x, p["weight"].to(x.dtype), p["bias"].to(x.dtype), padding=1))
        if name in want:
            out[name] = x
            if len(out) == len(want):
                break
    return out


def lpips_features(params, x, input_range="0_255"):
    """Per-image LPIPS embedding vector. [N, D]."""
    acts = vgg_features(params, x, taps=LPIPS_TAPS, input_range=input_range)
    feats = []
    n = x.shape[0]
    for tap in LPIPS_TAPS:
        a = acts[tap].float()
        a = a * torch.rsqrt(a.square().sum(dim=1, keepdim=True) + 1e-10)
        h, w = a.shape[2], a.shape[3]
        lin = params.get("lin", {}).get(tap)
        if lin is not None:
            a = a * torch.sqrt(lin.clamp(min=0.0))[None, :, None, None]
        a = a / np.sqrt(h * w)
        feats.append(a.reshape(n, -1))
    return torch.cat(feats, dim=1)


def load_params(path, device=torch.device("cpu"), require=()):
    """Load a converted VGG checkpoint (pickle of {name: {'weight','bias'}})
    through the numpy-only unpickler; ValueError on a wrong tree."""
    obj = load_pickle(path)
    if not isinstance(obj, dict):
        raise ValueError(f"not a param dict: {type(obj).__name__}")
    missing = [k for k in require if k not in obj]
    if missing:
        raise ValueError(f"param tree lacks required keys {missing}")
    return params_from_numpy(obj, device)


def get_vgg16(path=None, seed=0, device=torch.device("cpu")):
    """Converted weights if available, seeded random init otherwise."""
    if path is not None:
        try:
            return load_params(path, device, require=("conv1_1", "conv5_3"))
        except (OSError, pickle.UnpicklingError, ValueError, KeyError) as e:
            print(f"[vgg] could not load {path} ({e}); using seeded random init")
    return init_vgg(seed, device)
