"""Ingest alias-free (StyleGAN3) generators from NVIDIA pickles onto the
port's nested tree (counterpart: latentaugment_tpu/models/stylegan3/
convert.py:19-87).

The restricted unpickling is ../stylegan2/convert.py's; this module maps
an extracted flat state dict and the payload's init kwargs. State-dict
names join to the modules' own: synthesis.input.{weight,affine.*,
transform,freqs,phases}, synthesis.L{i}_{size}_{ch}.{affine.*,weight,bias,
magnitude_ema,up_filter,down_filter}, mapping.* as in StyleGAN2. A filter
missing from the stored buffers is designed from the config's plan (the
designer regenerates it); a stored one wins.
"""

import numpy as np

from ..stylegan2.convert import _payload_init_kwargs, _set_path
from . import networks


def infer_generator_config(payload, img_resolution=None, img_channels=None):
    """The alias-free generator_config from the persistence init kwargs.
    NVIDIA's Generator takes **synthesis_kwargs, so the synthesis knobs sit
    at the top level of the stored kwargs; the mapping depth under
    mapping_kwargs.num_layers. bf16 layers are a run-time choice."""
    kwargs = _payload_init_kwargs(payload)
    mapping = kwargs.get("mapping_kwargs", {}) or {}
    picked = {k: kwargs[k] for k in (
        "num_layers", "num_critical", "first_cutoff", "first_stopband", "last_stopband_rel",
        "margin_size", "output_scale", "conv_clamp", "conv_kernel", "filter_size",
        "lrelu_upsampling", "use_radial_filters", "channel_base", "channel_max") if k in kwargs}
    return networks.generator_config(
        z_dim=kwargs.get("z_dim", 512), c_dim=kwargs.get("c_dim", 0),
        w_dim=kwargs.get("w_dim", 512),
        img_resolution=img_resolution or kwargs.get("img_resolution", 256),
        img_channels=img_channels or kwargs.get("img_channels", 2),
        num_mapping_layers=mapping.get("num_layers", 2),
        embed_features=mapping.get("embed_features"), num_fp16_res=0, **picked)


def generator_tree_from_state(state, cfg):
    """Torch SG3 G state-dict names onto the nested tree: `transform` to
    [3,3], `magnitude_ema` to a scalar (1 where absent), missing filters
    designed from the plan."""
    tree = {"mapping": {}, "synthesis": {}}
    for name, value in state.items():
        if name.startswith("mapping."):
            _set_path(tree["mapping"], name[len("mapping."):], value)
        elif name.startswith("synthesis."):
            _set_path(tree["synthesis"], name[len("synthesis."):], value)
        else:
            _set_path(tree, name, value)

    syn = tree["synthesis"]
    if "input" in syn and "transform" in syn["input"]:
        syn["input"]["transform"] = np.asarray(syn["input"]["transform"],
                                               np.float32).reshape(3, 3)
    for layer in cfg.layers:
        lp = syn.get(layer.name)
        if lp is None:
            raise ValueError(f"SG3 checkpoint is missing layer '{layer.name}': the config "
                             "plan (resolution / channels) does not match the stored state dict")
        lp["magnitude_ema"] = (np.asarray(lp["magnitude_ema"], np.float32).reshape(())
                               if "magnitude_ema" in lp else np.ones((), np.float32))
        fu, fd = networks._layer_filters(layer)
        if "up_filter" not in lp and fu is not None:
            lp["up_filter"] = fu
        if "down_filter" not in lp and fd is not None:
            lp["down_filter"] = fd
    return tree
