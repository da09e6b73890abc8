"""The seeded workspace a cell's policy runs on: weights made on the device
from the seed, written as the native checkpoint and the VGG16 pickle the
port reads; the image zip and the inversion zip of the pelvis layout; the
AugOptions argv; the host batches the window cycles through.

The argv and the zip layout follow latentaugment_tpu_torch/benchmark.py's
`build_policy_workspace`; the weights are made here and not by the port,
so the reference and the program read one raw file.
"""

import io
import math
import os
import pickle
import zipfile

import numpy as np
import torch

from reference import nets

MODALITIES = ["MR_nonrigid_CT", "MR_MR_T2"]
DATASET = "PolicyBench"


# ----------------------------------------------------------------------------
# Parameter layout: (name, shape, init) with init one of
#   ("randn", scale)   standard normal times scale
#   ("const", value)   filled
#   ("array", ndarray) given
#   ("freqs",)/("phases",)  the StyleGAN3 input plane's draws

def _fc(name, n_in, n_out, lr_multiplier=1.0, bias_init=0.0, weight_scale=1.0):
    return [(f"{name}.weight", (n_out, n_in), ("randn", weight_scale / lr_multiplier)),
            (f"{name}.bias", (n_out,), ("const", bias_init / lr_multiplier))]


def _mapping(cfg):
    specs = []
    for i in range(cfg["num_mapping_layers"]):
        n_in = cfg["z_dim"] if i == 0 else cfg["w_dim"]
        specs += _fc(f"mapping.fc{i}", n_in, cfg["w_dim"], cfg["mapping_lr_multiplier"])
    return specs + [("mapping.w_avg", (cfg["w_dim"],), ("const", 0.0))]


RESAMPLE = np.array([1, 3, 3, 1], np.float32) / 8


def g_specs(cfg):
    """Every leaf of the generator's state, in the port's state_dict order."""
    specs = _mapping(cfg)
    w_dim, ns = cfg["w_dim"], cfg["noise_strength_std"] if "noise_strength_std" in cfg else 0.0
    if cfg["arch"] == "stylegan2":
        for res in nets.block_resolutions(cfg["resolution"]):
            pre = f"synthesis.b{res}"
            out_ch = nets.sg2_channels(cfg, res)
            in_ch = nets.sg2_channels(cfg, res // 2) if res > 4 else 0
            if res == 4:
                specs.append((f"{pre}.const", (out_ch, 4, 4), ("randn", 1.0)))
            convs = [("conv1", out_ch)] if res == 4 else [("conv0", in_ch), ("conv1", out_ch)]
            for name, ci in convs:
                specs += _fc(f"{pre}.{name}.affine", w_dim, ci, bias_init=1.0)
                specs += [(f"{pre}.{name}.weight", (out_ch, ci, 3, 3), ("randn", 1.0)),
                          (f"{pre}.{name}.bias", (out_ch,), ("const", 0.0)),
                          (f"{pre}.{name}.noise_const", (res, res), ("randn", 1.0)),
                          (f"{pre}.{name}.noise_strength", (), ("randn", ns))]
            specs += _fc(f"{pre}.torgb.affine", w_dim, out_ch, bias_init=1.0)
            specs += [(f"{pre}.torgb.weight", (cfg["img_channels"], out_ch, 1, 1), ("randn", 1.0)),
                      (f"{pre}.torgb.bias", (cfg["img_channels"],), ("const", 0.0))]
        return specs + [("synthesis.resample_filter", (4,), ("array", RESAMPLE))]
    layers, inp = nets.sg3_layers(cfg)
    c0 = inp["channels"]
    specs += [("synthesis.input.weight", (c0, c0), ("randn", 1.0))]
    specs += _fc("synthesis.input.affine", w_dim, 4, weight_scale=cfg["input_affine_std"])
    specs[-1] = ("synthesis.input.affine.bias", (4,), ("array", np.array([1, 0, 0, 0],
                                                                          np.float32)))
    specs += [("synthesis.input.transform", (3, 3), ("array", np.eye(3, dtype=np.float32))),
              ("synthesis.input.freqs", (c0, 2), ("freqs", inp["bandwidth"])),
              ("synthesis.input.phases", (c0,), ("phases",))]
    for layer in layers:
        pre = f"synthesis.{layer['name']}"
        k = layer["conv_kernel"]
        specs += _fc(f"{pre}.affine", w_dim, layer["in_channels"], bias_init=1.0)
        specs += [(f"{pre}.weight", (layer["out_channels"], layer["in_channels"], k, k),
                   ("randn", 1.0)),
                  (f"{pre}.bias", (layer["out_channels"],), ("const", 0.0)),
                  (f"{pre}.magnitude_ema", (), ("const", 1.0))]
        for key, f in (("up_filter", layer["fu"]), ("down_filter", layer["fd"])):
            if f is not None:
                specs.append((f"{pre}.{key}", f.shape, ("array", f)))
    return specs


def d_specs(dcfg):
    """Every leaf of the StyleGAN2 resnet discriminator's state."""
    specs = []
    res_top = dcfg["resolution"]

    def ch(r):
        return min(dcfg["channel_base"] // r, dcfg["channel_max"])

    def conv(name, ci, co, k, bias=True):
        out = [(f"{name}.weight", (co, ci, k, k), ("randn", 1.0))]
        return out + ([(f"{name}.bias", (co,), ("const", 0.0))] if bias else [])

    for i, res in enumerate([2 ** j for j in range(int(math.log2(res_top)), 2, -1)]):
        pre = f"b{res}"
        if i == 0:
            specs += conv(f"{pre}.fromrgb", dcfg["img_channels"], ch(res), 1)
        specs += conv(f"{pre}.conv0", ch(res), ch(res), 3)
        specs += conv(f"{pre}.conv1", ch(res), ch(res // 2), 3)
        specs += conv(f"{pre}.skip", ch(res), ch(res // 2), 1, bias=False)
    c4 = ch(4)
    specs += conv("b4.conv", c4 + dcfg["mbstd_num_channels"], c4, 3)
    specs += _fc("b4.fc", c4 * 16, c4) + _fc("b4.out", c4, 1)
    return specs + [("resample_filter", (4,), ("array", RESAMPLE))]


def vgg_specs():
    specs, c_in = [], 3
    for item in nets.VGG16_PLAN:
        if item == "M":
            continue
        name, c_out = item
        specs += [(f"{name}.weight", (c_out, c_in, 3, 3), ("randn", math.sqrt(2.0 / (c_in * 9)))),
                  (f"{name}.bias", (c_out,), ("const", 0.0))]
        c_in = c_out
    widths = dict(item for item in nets.VGG16_PLAN if item != "M")
    return specs + [(f"lin.{tap}", (widths[tap],), ("const", 1.0)) for tap in nets.LPIPS_TAPS]


def make_params(specs, gen, device):
    """{name: float32 tensor on `device`}: one normal draw for every randn
    leaf, one uniform draw for the phases, from `gen`."""
    n_randn = sum(int(np.prod(s)) for _, s, init in specs if init[0] in ("randn", "freqs"))
    flat = torch.randn([n_randn], generator=gen, device=device)
    n_rand = sum(int(np.prod(s)) for _, s, init in specs if init[0] == "phases")
    flat_u = torch.rand([max(n_rand, 1)], generator=gen, device=device)
    out, at, at_u = {}, 0, 0
    for name, shape, init in specs:
        n = int(np.prod(shape))
        kind = init[0]
        if kind == "randn":
            t = flat[at:at + n].reshape(shape) * init[1]
            at += n
        elif kind == "freqs":
            f = flat[at:at + n].reshape(shape)
            at += n
            radii = f.square().sum(dim=1, keepdim=True).sqrt()
            t = f / (radii * radii.square().exp() ** 0.25) * init[1]
        elif kind == "phases":
            t = flat_u[at_u:at_u + n].reshape(shape) - 0.5
            at_u += n
        elif kind == "const":
            t = torch.full(shape, float(init[1]), device=device)
        else:
            t = torch.as_tensor(init[1], device=device).reshape(shape).clone()
        out[name] = t
    return out


def nested_numpy(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = v.detach().cpu().numpy().astype(np.float32)
    return tree


# ----------------------------------------------------------------------------
# The native checkpoint's config dicts (models/stylegan2/checkpoint.py keys).

def g_cfg_kwargs(cfg):
    common = dict(z_dim=cfg["z_dim"], c_dim=0, w_dim=cfg["w_dim"],
                  img_resolution=cfg["resolution"], img_channels=cfg["img_channels"],
                  channel_base=cfg["channel_base"], channel_max=cfg["channel_max"],
                  num_mapping_layers=cfg["num_mapping_layers"], conv_clamp=cfg["conv_clamp"],
                  num_fp16_res=cfg["num_fp16_res"],
                  mapping_lr_multiplier=cfg["mapping_lr_multiplier"], embed_features=0)
    if cfg["arch"] == "stylegan2":
        return common
    return dict(common, arch="stylegan3", **{k: cfg[k] for k in (
        "num_layers", "num_critical", "first_cutoff", "first_stopband", "last_stopband_rel",
        "margin_size", "output_scale", "conv_kernel", "filter_size", "lrelu_upsampling",
        "use_radial_filters")})


def d_cfg(cfg):
    d = cfg["discriminator"]
    return dict(resolution=cfg["resolution"], img_channels=cfg["img_channels"], **d)


def d_cfg_kwargs(cfg):
    d = d_cfg(cfg)
    return dict(c_dim=0, img_resolution=d["resolution"], img_channels=d["img_channels"],
                channel_base=d["channel_base"], channel_max=d["channel_max"],
                conv_clamp=d["conv_clamp"], num_fp16_res=d["num_fp16_res"],
                mbstd_group_size=d["mbstd_group_size"],
                mbstd_num_channels=d["mbstd_num_channels"], cmap_dim=0,
                num_mapping_layers=8, mapping_lr_multiplier=0.01)


# ----------------------------------------------------------------------------
# Files.

def slice_names(ws):
    """Zip member names, patient-major; slice ids 00010, 00015, ..."""
    return [f"train/patient{p:03d}/train_patient{p:03d}_{10 + s * 5:05d}.pickle"
            for p in range(ws["n_patients"]) for s in range(ws["slices_per_patient"])]


def write_workspace(root, cfg, traffic, seed, device):
    """Write the checkpoint, the VGG16 pickle and the two zips under `root`
    and return (argv, env, files): the AugOptions argv, the environment
    entries the policy reads, and the paths the reference reads."""
    res, ws = cfg["resolution"], cfg["workspace"]
    gen = torch.Generator(device=device).manual_seed(seed)
    g = make_params(g_specs(cfg), gen, device)
    obj = {"G": {"cfg": g_cfg_kwargs(cfg), "params": nested_numpy(g)}}
    if traffic["kind"] == "walk":
        d = make_params(d_specs(d_cfg(cfg)), gen, device)
        obj["D"] = {"cfg": d_cfg_kwargs(cfg), "params": nested_numpy(d)}
    os.makedirs(root, exist_ok=True)
    ckpt = os.path.join(root, "policy_ckpt.pkl")
    with open(ckpt, "wb") as f:
        pickle.dump(obj, f, pickle.HIGHEST_PROTOCOL)
    del obj
    vgg_path = None
    if traffic["kind"] == "walk":
        vgg_path = os.path.join(root, "vgg16_lpips.pkl")
        with open(vgg_path, "wb") as f:
            pickle.dump(nested_numpy(make_params(vgg_specs(), gen, device)), f,
                        pickle.HIGHEST_PROTOCOL)

    dataset_name, w_name = f"{DATASET}-images-{res}", f"{DATASET}-inv-{res}"
    ddir = os.path.join(root, "interim", DATASET)
    os.makedirs(ddir, exist_ok=True)
    rng = np.random.default_rng(seed)
    names = slice_names(ws)
    imgs = rng.random((len(names), len(MODALITIES), res, res), dtype=np.float32) * 255.0
    img_zip = os.path.join(ddir, dataset_name + ".zip")
    with zipfile.ZipFile(img_zip, "w") as zf:
        for name, img in zip(names, imgs):
            buf = io.BytesIO()
            pickle.dump({m: img[i] for i, m in enumerate(MODALITIES)}, buf)
            zf.writestr(name, buf.getvalue())
    n_ws = nets.num_ws(cfg)
    codes = rng.standard_normal((len(names), n_ws, cfg["w_dim"]), dtype=np.float32) * 0.1
    w_zip = os.path.join(ddir, w_name + ".zip")
    with zipfile.ZipFile(w_zip, "w") as zf:
        for name, w in zip(names, codes):
            buf = io.BytesIO()
            pickle.dump(w, buf)
            zf.writestr(name, buf.getvalue())

    argv = ["--dataroot", img_zip, "--checkpoints_dir", os.path.join(root, "checkpoints"),
            "--dataset_mode", "pelvis", "--load_size", str(res),
            "--batch_size", str(traffic["batch"]), "--aug", "latent", "--model_dir", ckpt,
            "--interim_dir", os.path.join(root, "interim"), "--dataset_aug", DATASET,
            "--dataset_name_aug", dataset_name, "--dataset_w_name", w_name,
            "--img_resolution", str(res), "--num_fp16_res", str(cfg["num_fp16_res"]),
            "--name", "policy_bench", "--seed", str(traffic_seed(seed))]
    env = {"LATENTAUGMENT_VGG16": vgg_path} if vgg_path else {}
    files = dict(ckpt=ckpt, vgg=vgg_path, img_zip=img_zip, w_zip=w_zip,
                 dataset_name=dataset_name, w_name=w_name)
    return argv, env, files, (names, imgs)


def traffic_seed(seed):
    """The policy's own --seed (its crop, noise and z streams)."""
    return int(seed) % (2 ** 31 - 1)


def stage_batches(names, imgs, batch, n_batches):
    """The host batches the window cycles through: the dicts the port's
    pelvis loader yields (A, B [B, 1, H, W] float32 in [-1, 1], paths),
    consecutive slices, wrapping round the dataset."""
    out = []
    n = len(names)
    for b in range(n_batches):
        idx = [(b * batch + i) % n for i in range(batch)]
        ab = (imgs[idx] - 127.5) / 127.5
        paths = [names[i] for i in idx]
        out.append({"A": np.ascontiguousarray(ab[:, 0:1]), "B": np.ascontiguousarray(ab[:, 1:2]),
                    "A_paths": paths, "B_paths": list(paths)})
    return out
