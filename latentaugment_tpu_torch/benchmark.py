"""Synthetic set-ups at the walk's operating point, from seeded weights
(counterpart: latentaugment_tpu/benchmark.py:40-230).

  * `build_synthetic_setup`: real-size G/D + LPIPS VGG16 with seeded
    random weights and synthetic manifold summaries, and the walk
    functions the engine runs — no datasets.
  * `build_policy_workspace`: an on-disk workspace (native checkpoint,
    image zip, inversion zip) and the AugOptions argv that runs the whole
    LatentAugment policy on it.

`arch` picks the generator: "stylegan2" (default) or "stylegan3" (the
alias-free SG3-T, whose generator_config takes further keyword
overrides through **g_over; `SG3R` holds those of StyleGAN3-R, whose G
is twice as wide as D); D is always the StyleGAN2 one. `c_dim` > 0
builds a conditional pair (label-embedding mapping, projection D), whose
walk takes labels.

Defaults are the operating point: 256x256, 2 modalities, channel_base
32768, channel_max 512, bf16 in the top 4 blocks, LPIPS on 64x64 crops,
K=10 Adam steps at lr 0.01, weights w_lpips 10, w_pix 0.1, w_latent
0.001, w_disc 0.01, batch 32.
"""

import io
import os
import pickle
import zipfile

import numpy as np
import torch

from .augments import engine as engine_mod
from .augments import losses, manifold
from .models import networks_for, vgg
from .models.stylegan2 import checkpoint, networks

MODALITIES = ["MR_nonrigid_CT", "MR_MR_T2"]
# StyleGAN3-R (arch="stylegan3"): 1x1 convs, radial down filters, and G's
# channel_base / channel_max at twice D's
# (latentaugment_tpu/models/stylegan3/networks.py:57-59).
SG3R = dict(use_radial_filters=True, conv_kernel=1, g_width_factor=2)


def make_gd_configs(res, img_channels, channel_base, channel_max, num_fp16_res,
                    mbstd_group_size=4, c_dim=0, arch="stylegan2", g_width_factor=1,
                    **g_over):
    """The operating point's G/D configs; bf16 only from 64x64 up. G's
    widths are D's times `g_width_factor`."""
    n16 = num_fp16_res if res >= 64 else 0
    g_cfg = networks_for({"arch": arch}).generator_config(
        c_dim=c_dim, img_resolution=res, img_channels=img_channels,
        channel_base=channel_base * g_width_factor, channel_max=channel_max * g_width_factor,
        num_fp16_res=n16, **g_over)
    d_cfg = networks.discriminator_config(
        c_dim=c_dim, img_resolution=res, img_channels=img_channels, channel_base=channel_base,
        channel_max=channel_max, mbstd_group_size=mbstd_group_size, num_fp16_res=n16)
    return g_cfg, d_cfg


def build_synthetic_setup(device, res=256, img_channels=2, channel_base=32768,
                          channel_max=512, num_epochs=10, opt_lr=0.01,
                          crop_size=64, w_pix=0.1, w_lpips=10.0, w_latent=0.001,
                          w_disc=0.01, manifold_items=64, num_fp16_res=4,
                          remat=False, seed=0, impl='auto', c_dim=0, arch="stylegan2",
                          **g_over):
    """Returns (fns, bundle, g_cfg): the walk functions (taking the bundle
    as first argument) and the device state, on seeded synthetic weights."""
    g_cfg, d_cfg = make_gd_configs(res, img_channels, channel_base, channel_max,
                                   num_fp16_res, c_dim=c_dim, arch=arch, **g_over)
    G = networks_for(g_cfg).Generator(g_cfg, seed=seed, impl=impl).to(device).eval() \
        .requires_grad_(False)
    D = networks.Discriminator(d_cfg, seed=seed + 1, impl=impl).to(device).eval() \
        .requires_grad_(False)
    vgg_params = vgg.init_vgg(seed + 2, device) if w_lpips > 0 else None

    gen = torch.Generator().manual_seed(seed + 3)
    cc = manifold.center_crop_size(res)
    W_summary = X_cc_summaries = fea_summaries = None
    if w_latent > 0:
        W = torch.randn([manifold_items, g_cfg.num_ws, g_cfg.w_dim], generator=gen) * 0.1
        W_summary = losses.manifold_summary(W.to(device))
    if w_pix > 0:
        X_cc_summaries = [
            losses.manifold_summary(
                (torch.rand([manifold_items, 1, cc, cc], generator=gen) * 2 - 1).to(device))
            for _ in range(img_channels)]
    if w_lpips > 0:
        with torch.no_grad():
            probe = torch.zeros([1, 3, crop_size, crop_size], device=device)
            fdim = vgg.lpips_features(vgg_params, probe).shape[1]
        fea_summaries = [
            losses.manifold_summary(
                (torch.randn([manifold_items, fdim], generator=gen) * 0.01).to(device))
            for _ in range(img_channels)]

    fns = engine_mod.make_walk_fns(
        g_cfg, n_modes=img_channels, w_pix=w_pix, w_lpips=w_lpips,
        w_latent=w_latent, w_disc=w_disc, num_epochs=num_epochs, opt_lr=opt_lr,
        crop_size=crop_size, remat=remat)
    bundle = engine_mod.make_bundle(G, D, vgg_params, W_summary=W_summary,
                                    X_cc_summaries=X_cc_summaries,
                                    fea_summaries=fea_summaries)
    return fns, bundle, g_cfg


def build_policy_workspace(root, res=256, batch_size=32, num_epochs=10,
                           opt_lr=0.01, crop_size=64, channel_base=32768,
                           channel_max=512, num_fp16_res=4, n_patients=4,
                           slices_per_patient=24, step=10, seed=0, c_dim=0,
                           arch="stylegan2", **g_over):
    """Write a synthetic workspace under `root` (native checkpoint from
    seeded weights, image zip, inversion zip) and return the AugOptions
    argv that runs the LatentAugment policy on it (without --device,
    which defaults to cuda). Images and codes come from
    np.random.RandomState(seed), as the JAX package's does; with
    arch="stylegan3" the checkpoint holds an alias-free G."""
    dataset = "PolicyBench"
    dataset_name = f"PolicyBench-images-{res}"
    w_name = f"PolicyBench-inv-{res}"
    interim = os.path.join(root, "interim")
    ddir = os.path.join(interim, dataset)
    os.makedirs(ddir, exist_ok=True)

    g_cfg, d_cfg = make_gd_configs(res, len(MODALITIES), channel_base, channel_max,
                                   num_fp16_res, c_dim=c_dim, arch=arch, **g_over)
    ckpt = os.path.join(root, "policy_ckpt.pkl")
    checkpoint.save_checkpoint(ckpt, networks_for(g_cfg).Generator(g_cfg, seed=seed),
                               networks.Discriminator(d_cfg, seed=seed + 1))

    rng = np.random.RandomState(seed)
    img_zip = os.path.join(ddir, dataset_name + ".zip")
    fnames = []
    with zipfile.ZipFile(img_zip, "w") as zf:
        for p in range(n_patients):
            for s in range(slices_per_patient):
                slice_id = 10 + s * 5  # ids 00010.. (schedule-compatible)
                name = (f"train/patient{p:03d}/"
                        f"train_patient{p:03d}_{slice_id:05d}.pickle")
                img = {m: rng.rand(res, res).astype(np.float32) * 255.0
                       for m in MODALITIES}
                buf = io.BytesIO()
                pickle.dump(img, buf)
                zf.writestr(name, buf.getvalue())
                fnames.append(name)

    w_zip = os.path.join(ddir, w_name + ".zip")
    with zipfile.ZipFile(w_zip, "w") as zf:
        for name in fnames:
            w = rng.randn(g_cfg.num_ws, g_cfg.w_dim).astype(np.float32) * 0.1
            buf = io.BytesIO()
            pickle.dump(w, buf)
            zf.writestr(name, buf.getvalue())

    return [
        "--dataroot", img_zip,
        "--checkpoints_dir", os.path.join(root, "checkpoints"),
        "--dataset_mode", "pelvis",
        "--load_size", str(res),
        "--batch_size", str(batch_size),
        "--aug", "latent",
        "--model_dir", ckpt,
        "--interim_dir", interim,
        "--dataset_aug", dataset,
        "--dataset_name_aug", dataset_name,
        "--dataset_w_name", w_name,
        "--img_resolution", str(res),
        "--crop_size_aug", str(crop_size),
        "--init_w", "inv",
        "--step_img", str(step),
        "--step_w", str(step),
        "--opt_num_epochs", str(num_epochs),
        "--opt_lr", str(opt_lr),
        # Tuned operating point; p_thres 0 augments every batch.
        "--w_lpips", "10", "--w_pix", "0.1", "--w_latent", "0.001",
        "--w_disc", "0.01", "--p_thres", "0.0",
        "--num_fp16_res", str(num_fp16_res),
        "--name", "policy_bench",
    ]
