"""VGG16 / VGG19 feature extractors, functional over a dict of tensors
(counterpart: latentaugment_tpu/models/vgg.py).

Params: {'convX_Y': {'weight', 'bias'}, 'lin': {tap: [C]}, and for the
metric detector 'fc6' / 'fc7': {'weight', 'bias'}} — the same nested
layout the JAX package pickles, so one numpy pickle feeds both. Under
tensor parallelism a conv's entry holds this rank's output channels and
its `ModelShard` under 'tp' (parallel/tensor.py `shard_params`).

`lpips_features` returns, per image, the concatenation over the tap
layers of channel-unit-normalized activations scaled by
sqrt(lin / (H*W)), so a squared-L2 distance between two embeddings is
the LPIPS distance. `detector_features` is the VGG16 trunk with the
fc6 / fc7 head, the 4096-d features precision/recall reads.
`convert_torchscript` turns NVIDIA's TorchScript `vgg16.pt` into that
tree.
"""

import pickle

import numpy as np
import torch
import torch.nn.functional as F

from .stylegan2.checkpoint import load_pickle
from ..utils.util_misc import span

# VGG16 conv plan: (name, out_channels); 'M' = 2x2 max pool.
VGG16_PLAN = [
    ("conv1_1", 64), ("conv1_2", 64), "M",
    ("conv2_1", 128), ("conv2_2", 128), "M",
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), "M",
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), "M",
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512), "M",
]

VGG19_PLAN = [
    ("conv1_1", 64), ("conv1_2", 64), "M",
    ("conv2_1", 128), ("conv2_2", 128), "M",
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("conv3_4", 256), "M",
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("conv4_4", 512), "M",
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512), ("conv5_4", 512), "M",
]

# LPIPS tap layers for VGG16 (richzhang convention).
LPIPS_TAPS = ["conv1_2", "conv2_2", "conv3_3", "conv4_3", "conv5_3"]
LPIPS_CHANNELS = {"conv1_2": 64, "conv2_2": 128, "conv3_3": 256,
                  "conv4_3": 512, "conv5_3": 512}

# Input pre-scaling of the LPIPS VGG (applied to [0,255] RGB):
# [0,255] -> [-1,1] -> richzhang shift/scale normalization.
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)


def _he(gen, shape, fan_in, device):
    return (torch.randn(shape, generator=gen) * np.sqrt(2.0 / fan_in)).to(device)


def init_vgg(seed=0, device=torch.device("cpu"), plan=VGG16_PLAN, lpips_lin=True, gen=None):
    """He-initialized VGG params (VGG16 with unit LPIPS `lin` weights unless
    lpips_lin is False) drawn from an explicit torch.Generator: `gen`, or
    a new one seeded with `seed`."""
    gen = gen if gen is not None else torch.Generator().manual_seed(seed)
    params = {}
    c_in = 3
    for item in plan:
        if item == "M":
            continue
        name, c_out = item
        params[name] = {"weight": _he(gen, [c_out, c_in, 3, 3], c_in * 9, device),
                        "bias": torch.zeros([c_out], device=device)}
        c_in = c_out
    if lpips_lin and plan is VGG16_PLAN:
        params["lin"] = {tap: torch.ones([LPIPS_CHANNELS[tap]], device=device)
                         for tap in LPIPS_TAPS}
    return params


def params_from_numpy(tree, device=torch.device("cpu")):
    """Nested dict of arrays -> the same nesting of float32 tensors."""
    return {k: (params_from_numpy(v, device) if isinstance(v, dict)
                else torch.tensor(np.asarray(v, np.float32), device=device))
            for k, v in tree.items()}


def vgg_features(params, x, plan=VGG16_PLAN, taps=None, input_range="0_255"):
    """Run the VGG trunk; return {tap_name: activation} for requested taps.

    x: [N, 3, H, W]. input_range '0_255' applies the LPIPS pre-scaling;
    'unit' assumes already-normalized inputs."""
    with span("vgg16.features"):
        taps = list(taps) if taps is not None else [LPIPS_TAPS[-1]]
        want = set(taps)
        if input_range == "0_255":
            # Per-channel Python scalars: a constant tensor would be a host
            # to device copy on every call.
            x = torch.cat([(x[:, i:i + 1] / 127.5 - 1.0 - _LPIPS_SHIFT[i]) / _LPIPS_SCALE[i]
                           for i in range(3)], dim=1)
        out = {}
        for item in plan:
            if item == "M":
                x = F.max_pool2d(x, 2)
                continue
            name, _ = item
            p = params[name]
            tp = p.get("tp")  # a layer split over a model axis (parallel/tensor.py)
            x_in = x if tp is None else tp.enter(x)
            x = F.relu(F.conv2d(x_in, p["weight"].to(x.dtype), p["bias"].to(x.dtype), padding=1))
            if tp is not None:
                x = tp.gather(x)
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


def lpips_distance(params, x, y, input_range="0_255"):
    """LPIPS distance via the embedding property: ||f(x) - f(y)||^2. [N]."""
    fx = lpips_features(params, x, input_range)
    fy = lpips_features(params, y, input_range)
    return (fx - fy).square().sum(dim=1)


# ----------------------------------------------------------------------------
# Metric-detector head: 4096-d fc features, what precision/recall reads.

def init_vgg_detector(seed=0, device=torch.device("cpu")):
    """VGG16 trunk + fc6/fc7 head, He-initialized from one seeded generator."""
    gen = torch.Generator().manual_seed(seed)
    params = init_vgg(device=device, lpips_lin=False, gen=gen)
    for name, n_out, n_in in (("fc6", 4096, 512 * 7 * 7), ("fc7", 4096, 4096)):
        params[name] = {"weight": _he(gen, [n_out, n_in], n_in, device),
                        "bias": torch.zeros([n_out], device=device)}
    return params


def _adaptive_avg_pool(x, out_hw=7):
    """Average-pool NCHW x to [N, C, out_hw, out_hw] for any input size:
    a smaller map is nearest-upsampled first, a larger one pooled over
    integer bins (the remainder rows and columns are dropped)."""
    n, c, h, w = x.shape
    if h == out_hw and w == out_hw:
        return x
    if h < out_hw or w < out_hw:
        x = x.repeat_interleave(-(-out_hw // h), dim=2) \
             .repeat_interleave(-(-out_hw // w), dim=3)
        n, c, h, w = x.shape
    kh, kw = h // out_hw, w // out_hw
    x = x[:, :, :kh * out_hw, :kw * out_hw]
    return x.reshape(n, c, out_hw, kh, out_hw, kw).mean(dim=(3, 5))


def detector_features(params, x, input_range="0_255"):
    """[N, 3, H, W] (uint8-scale) -> 4096-d pre-softmax features [N, 4096]."""
    acts = vgg_features(params, x, taps=["conv5_3"], input_range=input_range)
    y = _adaptive_avg_pool(F.max_pool2d(acts["conv5_3"], 2), 7)
    y = y.reshape(y.shape[0], -1)
    y = F.relu(F.linear(y, params["fc6"]["weight"], params["fc6"]["bias"]))
    return F.linear(y, params["fc7"]["weight"], params["fc7"]["bias"])


# ----------------------------------------------------------------------------
# Weight IO

def params_to_numpy(tree):
    """Nested dict of tensors -> the same nesting of float32 arrays."""
    return {k: (params_to_numpy(v) if isinstance(v, dict)
                else v.detach().cpu().float().numpy()) for k, v in tree.items()}


def save_params(params, path):
    """Pickle a param tree as nested numpy arrays (what load_params reads)."""
    with open(path, "wb") as f:
        pickle.dump(params_to_numpy(params), f, pickle.HIGHEST_PROTOCOL)


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


def convert_torchscript(ts_path, out_path=None):
    """NVIDIA's TorchScript vgg16.pt -> {convX_Y: {weight, bias}, lin: {tap:
    [C]}} as nested numpy arrays, pickled to `out_path` when given (what
    load_params reads). The script module's 3x3 conv weights map in
    definition order onto VGG16_PLAN, its LPIPS linear weights (|.|) in
    order onto LPIPS_TAPS (counterpart:
    latentaugment_tpu/models/vgg.py:237-269)."""
    state = dict(torch.jit.load(ts_path, map_location="cpu").state_dict())
    convs = [(k, v) for k, v in state.items()
             if k.endswith("weight") and v.ndim == 4 and v.shape[-1] == 3]
    lins = [(k, v) for k, v in state.items()
            if v.ndim in (2, 4) and (v.ndim == 2 or v.shape[-1] == 1) and "lin" in k.lower()]
    plan_names = [it[0] for it in VGG16_PLAN if it != "M"]
    params = {name: {"weight": w.detach().float().numpy(),
                     "bias": state[k[:-len("weight")] + "bias"].detach().float().numpy()}
              for (k, w), name in zip(convs, plan_names)}
    if lins:
        params["lin"] = {tap: np.abs(v.detach().float().numpy()).reshape(-1)
                         for (_, v), tap in zip(lins, LPIPS_TAPS)}
    if out_path:
        with open(out_path, "wb") as f:
            pickle.dump(params, f, pickle.HIGHEST_PROTOCOL)
    return params


def get_vgg16(path=None, seed=0, device=torch.device("cpu")):
    """Converted weights if available, seeded random init otherwise."""
    if path is not None:
        try:
            return load_params(path, device, require=("conv1_1", "conv5_3"))
        except (OSError, pickle.UnpicklingError, ValueError, KeyError) as e:
            print(f"[vgg] could not load {path} ({e}); using seeded random init")
    return init_vgg(seed, device)
