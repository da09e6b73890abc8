"""Native checkpoints: the nested-numpy pickle the JAX package writes
(counterpart: the native half of latentaugment_tpu/models/stylegan2/
convert.py — `save_checkpoint` and the native branch of `load_stylegan`;
for the alias-free family, latentaugment_tpu/models/stylegan3/convert.py's
`cfg_kwargs`).

File layout: {'G': {'cfg': {...}, 'params': nested dict}, 'D': {...}}.
The nested dict's joined paths are the modules' state_dict keys, so the
bridge is a flatten / unflatten. The G cfg of an alias-free (StyleGAN3)
generator carries the tag arch='stylegan3', which picks the generator
module on load; D is always the StyleGAN2 one. The NVIDIA and TF pickle
converters (and the StyleGAN3 pickle ingestion) are not ported.
"""

import io
import pickle

import numpy as np
import torch

from ..stylegan3 import networks as networks_sg3
from . import networks

_G_CFG_KEYS = ("z_dim", "c_dim", "w_dim", "img_resolution", "img_channels",
               "channel_base", "channel_max", "num_mapping_layers", "conv_clamp",
               "num_fp16_res", "mapping_lr_multiplier", "embed_features")
_SG3_G_CFG_KEYS = ("z_dim", "c_dim", "w_dim", "img_resolution", "img_channels",
                   "channel_base", "channel_max", "num_mapping_layers",
                   "mapping_lr_multiplier", "embed_features", "num_layers",
                   "num_critical", "first_cutoff", "first_stopband",
                   "last_stopband_rel", "margin_size", "output_scale",
                   "num_fp16_res", "conv_clamp", "conv_kernel", "filter_size",
                   "lrelu_upsampling", "use_radial_filters")
_D_CFG_KEYS = ("c_dim", "img_resolution", "img_channels", "channel_base",
               "channel_max", "conv_clamp", "num_fp16_res", "mbstd_group_size",
               "mbstd_num_channels", "cmap_dim", "num_mapping_layers",
               "mapping_lr_multiplier")


def params_to_state_dict(params, prefix=""):
    """Nested dict of arrays -> flat {dotted key: float32 tensor}."""
    out = {}
    for k, v in params.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(params_to_state_dict(v, key + "."))
        else:
            out[key] = torch.tensor(np.asarray(v, dtype=np.float32))
    return out


def state_dict_to_params(state_dict):
    """Flat {dotted key: tensor} -> nested dict of float32 numpy arrays."""
    tree = {}
    for key, v in state_dict.items():
        node = tree
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v.detach().cpu().float().numpy()
    return tree


def _g_cfg_kwargs(cfg):
    """Round-trippable generator_config kwargs (a plain dict: the
    restricted unpickler admits only builtin containers)."""
    if cfg.get("arch") == "stylegan3":
        return {"arch": "stylegan3", **{k: cfg[k] for k in _SG3_G_CFG_KEYS}}
    return {k: cfg[k] for k in _G_CFG_KEYS}


def save_checkpoint(path, G=None, D=None):
    """Write a native checkpoint from Generator / Discriminator modules."""
    obj = {}
    if G is not None:
        obj["G"] = {"cfg": _g_cfg_kwargs(G.cfg),
                    "params": state_dict_to_params(G.state_dict())}
    if D is not None:
        obj["D"] = {"cfg": {k: D.cfg[k] for k in _D_CFG_KEYS},
                    "params": state_dict_to_params(D.state_dict())}
    with open(path, "wb") as f:
        pickle.dump(obj, f, pickle.HIGHEST_PROTOCOL)


class _NumpyUnpickler(pickle.Unpickler):
    """Resolve only what a nested-numpy pickle needs; any other global
    raises instead of running."""

    _ALLOWED = {
        ("numpy", "ndarray"), ("numpy", "dtype"),
        ("numpy.core.multiarray", "_reconstruct"), ("numpy.core.multiarray", "scalar"),
        ("numpy._core.multiarray", "_reconstruct"), ("numpy._core.multiarray", "scalar"),
        ("numpy.core.numeric", "_frombuffer"), ("numpy._core.numeric", "_frombuffer"),
        ("collections", "OrderedDict"), ("_codecs", "encode"),
    }

    def find_class(self, module, name):
        if (module, name) not in self._ALLOWED:
            raise pickle.UnpicklingError(f"blocked unpickle of {module}.{name}")
        if module.startswith("numpy.core"):
            # numpy >= 2 names it numpy._core; old pickles carry numpy.core.
            module = module.replace("numpy.core", "numpy._core", 1) \
                if hasattr(np, "_core") else module
        return super().find_class(module, name)


def load_pickle(path):
    with open(path, "rb") as f:
        return _NumpyUnpickler(io.BytesIO(f.read())).load()


def load_stylegan(path):
    """Native checkpoint -> (G_params, G_cfg, D_params, D_cfg), params as
    nested numpy dicts (D_* None when the file has no D)."""
    obj = load_pickle(path)
    if not (isinstance(obj, dict) and isinstance(obj.get("G"), dict)
            and "params" in obj["G"]):
        raise ValueError(f"{path} is not a native checkpoint; the NVIDIA / TF "
                         "pickle converters are not ported (they wait for such "
                         "files in the repository)")
    g_kw = dict(obj["G"]["cfg"])
    arch = g_kw.pop("arch", "stylegan2")
    if arch not in ("stylegan2", "stylegan3"):
        raise NotImplementedError(f"arch {arch!r} is not ported")
    g_cfg = (networks_sg3 if arch == "stylegan3" else networks).generator_config(**g_kw)
    d_cfg = networks.discriminator_config(**obj["D"]["cfg"]) if "D" in obj else None
    return obj["G"]["params"], g_cfg, obj.get("D", {}).get("params"), d_cfg
