"""The LatentAugment policy's answers worked out again in plain PyTorch:
the manifold summaries from the workspace's zips, the walk (K Adam steps
on w through G, D, the pixel, latent and LPIPS terms) and the sampling
path (z -> mapping -> synthesis).

It reads the raw files the program reads and the policy's documented
seeded streams (from the `--seed` the harness gives the policy): the
engine's crop stream `random.Random(seed + 1)` (two draws a walk), the
final synthesis's noise from a device generator seeded `seed + 3` (one
draw per StyleGAN2 conv layer and batch, in the layer's dtype), the
sampling path's z from a CPU generator seeded `seed` and the manifold
crops from `random.Random(f"{seed}-{cache tag}")`. It imports nothing of
the program.
"""

import io
import math
import pickle
import random
import zipfile

import numpy as np
import torch
import torch.nn.functional as F

from . import nets

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def zip_items(path):
    """[(name, object)] of the zip's train pickles, by name."""
    out = []
    with zipfile.ZipFile(path) as zf:
        for name in sorted(n for n in zf.namelist() if n.endswith(".pickle") and "train" in n):
            out.append((name, pickle.load(io.BytesIO(zf.read(name)))))
    return out


def admitted(name, step):
    """The policy's per-patient slice schedule: ids 00010..00120, every `step`."""
    sid = name.rsplit("/", 1)[-1].rsplit(".", 1)[0][-5:]
    return sid in {f"{i:05d}" for i in range(10, 121, step)}


def summary(x):
    """(mean vector, mean squared norm) of the rows of x [m, ...]."""
    x = x.reshape(x.shape[0], -1).float()
    return x.mean(dim=0), x.square().sum(dim=1).mean()


def center_crop_size(res):
    return int(np.sqrt(res * res / 2))


def center_crop(x):
    h = x.shape[-1]
    size = center_crop_size(h)
    top = int(round((h - size) / 2.0))
    return x[..., top:top + size, top:top + size]


def crop_draw(rng, res, crop):
    hi = max(0, center_crop_size(res) - crop)
    return rng.randint(0, hi), rng.randint(0, hi)


def lpips_crop(x, pos, crop):
    x = center_crop(x)
    px, py = pos
    return x[..., py:py + crop, px:px + crop]


def manifolds(files, cfg, traffic, vgg, policy_seed, device, prec):
    """The walk's three manifold summaries, from the zips: latent codes,
    centre-cropped images per modality, LPIPS features per modality."""
    out = {}
    codes = zip_items(files["w_zip"])
    items = [np.asarray(w, np.float32)[None] for n, w in codes if admitted(n, traffic["step_w"])]
    out["latent"] = summary(torch.as_tensor(np.concatenate(items), device=device))
    imgs = zip_items(files["img_zip"])
    modalities = cfg["modalities"]
    stack = [np.stack([np.asarray(d[m], np.float32) for m in modalities]) for _, d in imgs]
    keep = [i for i, (n, _) in enumerate(imgs) if admitted(n, traffic["step_img"])]
    x = torch.as_tensor(np.stack([stack[i] for i in keep]), device=device) / 127.5 - 1.0
    xc = center_crop(x)
    out["pix"] = [summary(xc[:, m:m + 1]) for m in range(len(modalities))]
    out["lpips"] = []
    crop, res = traffic["crop_size"], cfg["resolution"]
    for mode_id, mode in enumerate(modalities):
        tag = (f"{files['dataset_name']}-train-{mode}-{crop}-{traffic['preprocess']}-script"
               f"-features_jit-step_{traffic['step_img']}-maxitems_{len(imgs)}")
        rng = random.Random(f"{policy_seed}-{tag}")
        feats = []
        for i, (name, _) in enumerate(imgs):
            pos = crop_draw(rng, res, crop)
            if not admitted(name, traffic["step_img"]):
                continue
            xi = torch.as_tensor(stack[i][mode_id][None, None], device=device)
            xi = lpips_crop(xi, pos, crop).repeat(1, 3, 1, 1)
            with torch.no_grad():
                feats.append(nets.lpips_features(vgg, xi, prec))
        out["lpips"].append(summary(torch.cat(feats)))
    return out


# What the check's own tests plant in the reference walk in the program's
# place: faults, and "g_bf16", each step's gradient rounded to bfloat16 (the
# rounding a sound program's bfloat16 layers make, to read what it moves).
FAULTS = ("half", "d_zero", "d_nograd", "g_bf16")
# The batch's loss and the terms of it that the walk's traces give.
TRACED = ("loss", "latent", "disc")


def row_losses(p_g, p_d, vgg, cfg, dcfg, traffic, man, w, pos, prec, fault=None):
    """Each row's walk terms, w [n, 1, w_dim] -> {term: [n]}: latent, pix,
    lpips, disc; the row's loss is -latent - pix - lpips + disc (the
    batch's loss is their mean). `fault` plants a fault in D for the
    check's own tests: "d_zero" zeroes D's logits, "d_nograd" keeps their
    value and drops D's gradient."""
    n_ws = nets.num_ws(cfg)
    ws = w.repeat(1, n_ws, 1)
    x = nets.synthesis(p_g, cfg, ws, prec)
    n_modes = len(cfg["modalities"])

    def l2_rows(y, mean, msq, normalize=True):
        y = y.reshape(y.shape[0], -1)
        val = y.square().sum(dim=1) + msq - 2.0 * (y @ mean)
        return val / y.shape[1] if normalize else val

    logits = nets.discriminator(p_d, dcfg, x.detach() if fault == "d_nograd" else x, prec)
    if fault == "d_zero":
        logits = torch.zeros_like(logits)
    out = dict(latent=traffic["w_latent"] * l2_rows(ws, *man["latent"]),
               disc=traffic["w_disc"] * F.softplus(-logits)[:, 0])
    xc = center_crop(x)
    out["pix"] = sum(traffic["w_pix"] * l2_rows(xc[:, m:m + 1], *man["pix"][m])
                     for m in range(n_modes)) / n_modes
    xcrop = lpips_crop(x, pos, traffic["crop_size"])
    b = xcrop.shape[0]
    xm = xcrop.reshape(b * n_modes, 1, *xcrop.shape[2:]).repeat(1, 3, 1, 1)
    feats = nets.lpips_features(vgg, (xm + 1.0) * 127.5, prec).reshape(b, n_modes, -1)
    out["lpips"] = sum(traffic["w_lpips"] * l2_rows(feats[:, m], *man["lpips"][m],
                                                    normalize=False)
                       for m in range(n_modes)) / n_modes
    return out


def walk(p_g, p_d, vgg, cfg, dcfg, traffic, man, w0, pos, weights, prec, fault=None):
    """K Adam steps on rows w0 [n, 1, w_dim] (whole minibatch-stddev
    groups of a batch); row r's loss counts `weights[r]` in the batch's
    loss (1 / batch in the walk). Returns (walked w, {name in TRACED: [K]
    share of the batch's trace of the loss, its latent term and D's term},
    each step's taken before its update)."""
    w = w0.clone()
    m = torch.zeros_like(w)
    v = torch.zeros_like(w)
    lr = traffic["lr"]
    trace = {k: [] for k in TRACED}
    for t in range(traffic["num_epochs"]):
        leaf = w.detach().requires_grad_(True)
        with torch.enable_grad():
            terms = row_losses(p_g, p_d, vgg, cfg, dcfg, traffic, man, leaf, pos, prec, fault)
            rows = -terms["latent"] - terms["pix"] - terms["lpips"] + terms["disc"]
            loss = (rows * weights).sum()
            g, = torch.autograd.grad(loss, leaf)
        if fault == "g_bf16":
            g = g.bfloat16().float()
        trace["loss"].append(loss.item())
        for k in TRACED[1:]:
            trace[k].append((terms[k].detach() * weights).sum().item())
        m = ADAM_B1 * m + (1 - ADAM_B1) * g
        v = ADAM_B2 * v + (1 - ADAM_B2) * g.square()
        m_hat = m / (1 - ADAM_B1 ** (t + 1))
        v_hat = v / (1 - ADAM_B2 ** (t + 1))
        w = w - lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS)
    return w.detach(), trace


# ----------------------------------------------------------------------------
# The policy's seeded streams, replayed.

def crop_positions(policy_seed, n_calls, res, crop):
    """The crop position of each of the first `n_calls` walks."""
    rng = random.Random(policy_seed + 1)
    return [crop_draw(rng, res, crop) for _ in range(n_calls)]


def noise_draws(cfg, policy_seed, batch, calls, device):
    """{call: [noise of each conv layer]} for the final synthesis of the
    given forward calls (StyleGAN2 only; StyleGAN3 draws none)."""
    if cfg["arch"] != "stylegan2" or not calls:
        return {c: None for c in calls}
    gen = torch.Generator(device=device).manual_seed(policy_seed + 3)
    out = {}
    shapes = nets.sg2_noise_shapes(cfg, batch)
    for c in range(max(calls) + 1):
        draws = [torch.randn(s, generator=gen, device=device,
                             dtype=torch.bfloat16 if lo else torch.float32)
                 for s, lo in shapes]
        if c in calls:
            out[c] = draws
    return out


def z_draws(cfg, policy_seed, batch, calls):
    """{call: z [batch, z_dim]} of the sampling path's forward calls."""
    gen = torch.Generator().manual_seed(policy_seed)
    out = {}
    for c in range(max(calls) + 1):
        z = torch.randn((batch, cfg["z_dim"]), generator=gen)
        if c in calls:
            out[c] = z
    return out


def group_rows(batch, group, groups):
    """Rows of the minibatch-stddev groups `groups` (row n is in group
    n % (batch / group)), group-major within each position."""
    per = batch // group
    return [j + k * per for k in range(group) for j in groups]
