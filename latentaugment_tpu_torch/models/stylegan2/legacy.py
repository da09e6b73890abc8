"""Convert TF-era (StyleGAN2 TensorFlow) network pickles to the port's
nested numpy trees (counterpart: latentaugment_tpu/models/stylegan2/
legacy.py:22-269).

convert.py's allow-list unpickler reads `dnnlib.tflib.network.Network` as
TFNetworkStub (no TensorFlow needed), whose variables are collected; the TF -> torch
name and layout table then applies: dense weights transposed, conv
weights [kh,kw,I,O] -> [O,I,kh,kw], up-conv weights also flipped in
space, `mod_bias + 1`, noise buffers squeezed, `dlatent_avg` -> w_avg,
and for a conditional pair the `LabelEmbed` / `Mapping{i}` heads.
"""

import math

import numpy as np

from ...ops.upfirdn2d import setup_filter
from ...utils.util_easydict import EasyDict
from . import networks
from .convert import _RestrictedUnpickler, load_network_pickle


class TFNetworkStub(EasyDict):
    """Stands in for dnnlib.tflib.network.Network during unpickling."""

    def __setstate__(self, state):
        self.update(state)


# TF-era pickles go through the one exact-name allow-list unpickler of
# convert.py, which maps the dnnlib Network to TFNetworkStub.
_LegacyUnpickler = _RestrictedUnpickler


def load_network_pkl(f):
    """A TF-era pickle (path or binary file object) -> its networks, each
    TF one converted to (params, cfg): {'G_ema': .., 'D': ..} for the
    (G, D, Gs) tuple, else the dict with its TF entries converted."""
    return convert_tf_networks(load_network_pickle(f))


def convert_tf_networks(data):
    """The unpickled object of a TF-era pickle -> its networks, as
    load_network_pkl returns them."""
    if isinstance(data, tuple) and len(data) == 3 and \
            all(isinstance(net, TFNetworkStub) for net in data):
        _, tf_D, tf_Gs = data
        return dict(G_ema=convert_tf_generator(tf_Gs), D=convert_tf_discriminator(tf_D))
    out = {}
    for key, val in (data.items() if isinstance(data, dict) else []):
        if isinstance(val, TFNetworkStub):
            if key in ("G", "G_ema", "Gs"):
                out[key] = convert_tf_generator(val)
            elif key == "D":
                out[key] = convert_tf_discriminator(val)
        else:
            out[key] = val
    return out or data


def _collect_tf_params(tf_net):
    tf_params = {}

    def recurse(prefix, net):
        for name, value in net.get("variables", []):
            tf_params[prefix + name] = np.asarray(value)
        for name, comp in net.get("components", {}).items():
            recurse(prefix + name + "/", comp)

    recurse("", tf_net)
    return tf_params


def _f32(v):
    return np.asarray(v, np.float32)


def _conv(v):
    return _f32(v).transpose(3, 2, 0, 1)  # kh kw I O -> O I kh kw


def _conv_up(v):
    return np.ascontiguousarray(_f32(v)[::-1, ::-1].transpose(3, 2, 0, 1))


def _dense(v):
    return _f32(v).transpose()


def _resample_filter(kw):
    return setup_filter(kw.get("resample_kernel", [1, 3, 3, 1]), separable=True).numpy()


def convert_tf_generator(tf_G):
    if tf_G.get("version", 0) < 4:
        raise ValueError("TensorFlow pickle version too low")
    kw = tf_G.get("static_kwargs", {})
    cfg = networks.generator_config(
        z_dim=kw.get("latent_size", 512), c_dim=kw.get("label_size", 0),
        w_dim=kw.get("dlatent_size", 512), img_resolution=kw.get("resolution", 1024),
        img_channels=kw.get("num_channels", 3),
        channel_base=kw.get("fmap_base", 16384) * 2, channel_max=kw.get("fmap_max", 512),
        num_mapping_layers=kw.get("mapping_layers", 8), conv_clamp=kw.get("conv_clamp", None),
        mapping_lr_multiplier=kw.get("mapping_lrmul", 0.01))
    p = _collect_tf_params(tf_G)

    mapping = {"w_avg": _f32(p["dlatent_avg"])}
    for i in range(cfg.num_mapping_layers):
        mapping[f"fc{i}"] = {"weight": _dense(p[f"mapping/Dense{i}/weight"]),
                             "bias": _f32(p[f"mapping/Dense{i}/bias"])}
    if cfg.c_dim > 0:
        # A conditional generator embeds the label (LabelEmbed -> embed).
        if "mapping/LabelEmbed/weight" not in p:
            raise ValueError("conditional TF generator (label_size > 0) has no "
                             "mapping/LabelEmbed variables: unsupported pickle layout")
        embed_w = _dense(p["mapping/LabelEmbed/weight"])
        mapping["embed"] = {"weight": embed_w, "bias": _f32(p["mapping/LabelEmbed/bias"])}
        cfg.embed_features = int(embed_w.shape[0])

    def conv_layer(prefix, noise_idx, up=False):
        return {
            "weight": (_conv_up if up else _conv)(p[f"{prefix}/weight"]),
            "bias": _f32(p[f"{prefix}/bias"]),
            "noise_const": _f32(p[f"synthesis/noise{noise_idx}"])[0, 0],
            "noise_strength": _f32(p[f"{prefix}/noise_strength"]).reshape(()),
            "affine": {"weight": _dense(p[f"{prefix}/mod_weight"]),
                       "bias": _f32(p[f"{prefix}/mod_bias"]) + 1.0},
        }

    def torgb_layer(prefix):
        return {
            "weight": _conv(p[f"{prefix}/weight"]),
            "bias": _f32(p[f"{prefix}/bias"]),
            "affine": {"weight": _dense(p[f"{prefix}/mod_weight"]),
                       "bias": _f32(p[f"{prefix}/mod_bias"]) + 1.0},
        }

    synthesis = {}
    for res in cfg.block_resolutions:
        block = {}
        if res == 4:
            block["const"] = _f32(p["synthesis/4x4/Const/const"])[0]
            block["conv1"] = conv_layer("synthesis/4x4/Conv", 0)
        else:
            lg = int(math.log2(res))
            block["conv0"] = conv_layer(f"synthesis/{res}x{res}/Conv0_up", lg * 2 - 5, up=True)
            block["conv1"] = conv_layer(f"synthesis/{res}x{res}/Conv1", lg * 2 - 4)
        block["torgb"] = torgb_layer(f"synthesis/{res}x{res}/ToRGB")
        synthesis[f"b{res}"] = block
    synthesis["resample_filter"] = _resample_filter(kw)
    return {"mapping": mapping, "synthesis": synthesis}, cfg


def convert_tf_discriminator(tf_D):
    if tf_D.get("version", 0) < 4:
        raise ValueError("TensorFlow pickle version too low")
    kw = tf_D.get("static_kwargs", {})
    cfg = networks.discriminator_config(
        c_dim=kw.get("label_size", 0), img_resolution=kw.get("resolution", 1024),
        img_channels=kw.get("num_channels", 3),
        channel_base=kw.get("fmap_base", 16384) * 2, channel_max=kw.get("fmap_max", 512),
        conv_clamp=kw.get("conv_clamp", None),
        mbstd_group_size=kw.get("mbstd_group_size", 4) or 4,
        mbstd_num_channels=kw.get("mbstd_num_features", 1),
        cmap_dim=kw.get("mapping_fmaps", None),
        mapping_lr_multiplier=kw.get("mapping_lrmul", 0.1))
    p = _collect_tf_params(tf_D)

    def conv(prefix, bias=True):
        out = {"weight": _conv(p[f"{prefix}/weight"])}
        if bias:
            out["bias"] = _f32(p[f"{prefix}/bias"])
        return out

    tree = {}
    for i, res in enumerate(cfg.block_resolutions):
        block = {"fromrgb": conv(f"{res}x{res}/FromRGB")} if i == 0 else {}
        block["conv0"] = conv(f"{res}x{res}/Conv0")
        block["conv1"] = conv(f"{res}x{res}/Conv1_down")
        block["skip"] = conv(f"{res}x{res}/Skip", bias=False)
        tree[f"b{res}"] = block
    tree["b4"] = {
        "conv": conv("4x4/Conv"),
        "fc": {"weight": _dense(p["4x4/Dense0/weight"]), "bias": _f32(p["4x4/Dense0/bias"])},
        "out": {"weight": _dense(p["Output/weight"]), "bias": _f32(p["Output/bias"])},
    }
    if cfg.c_dim > 0:
        # A conditional discriminator projects on a mapping of the label:
        # LabelEmbed + Mapping{i} become its label-mapping network.
        if "LabelEmbed/weight" not in p:
            raise ValueError(
                "conditional TF discriminator (label_size > 0) has no LabelEmbed "
                "variables: pre-projection conditional layouts (per-label Output "
                "columns) are unsupported")
        embed_w = _dense(p["LabelEmbed/weight"])
        cmap = {"embed": {"weight": embed_w, "bias": _f32(p["LabelEmbed/bias"])}}
        n_map = 0
        while f"Mapping{n_map}/weight" in p:
            cmap[f"fc{n_map}"] = {"weight": _dense(p[f"Mapping{n_map}/weight"]),
                                  "bias": _f32(p[f"Mapping{n_map}/bias"])}
            n_map += 1
        cfg.num_mapping_layers = n_map
        tree["mapping"] = cmap
        if n_map == 0 and int(embed_w.shape[0]) != cfg.cmap_dim:
            raise ValueError(
                f"conditional TF discriminator LabelEmbed width {int(embed_w.shape[0])} "
                f"!= cmap_dim {cfg.cmap_dim} with no Mapping layers: projection shapes "
                "inconsistent")
        out_dim = int(tree["b4"]["out"]["weight"].shape[0])
        if out_dim != cfg.cmap_dim:
            raise ValueError(f"conditional TF discriminator Output width {out_dim} != "
                             f"cmap_dim {cfg.cmap_dim}: not a projection head")
    tree["resample_filter"] = _resample_filter(kw)
    return tree, cfg
