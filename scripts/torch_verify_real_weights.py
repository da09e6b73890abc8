#!/usr/bin/env python3
"""Verify real pretrained weights against their torch artifacts, with the
PyTorch port (counterpart: scripts/verify_real_weights.py).

    python scripts/torch_verify_real_weights.py \
        [--vgg16 vgg16.pt] [--inception inception-2015-12-05.pkl] \
        [--network_pkl network-snapshot.pkl] [--sg_repo stylegan2-ada-pytorch] \
        [--outdir converted_weights] [--tol 1e-3] [--fid_tol 0.01] [--device cuda]

Lanes, one per artifact given:
  * vgg16: convert the TorchScript LPIPS VGG16, then hold the port's tap
    activations and LPIPS distance against the script module's own.
  * inception: convert a torchvision state dict (or take a TorchScript
    detector as the oracle only) and compare FIDs of two synthetic image
    sets scored by the artifact and by the port's InceptionV3.
  * network_pkl: ingest a StyleGAN2 / StyleGAN3 pickle through the
    restricted unpickler, synthesize, and run D when there is one. With
    --sg_repo, also hold the image against NVIDIA's own modules rebuilt
    from the pickle: that executes third-party code, so it never runs by
    default (the lane `torch_golden` is then reported as skipped).

Prints one JSON line per check and a final `verdict` line; exits 0 iff
every check of every artifact given passed. Artifacts not given are
reported as skipped, not failed; giving none is a failure. The port runs
on --device (default cuda, which raises without CUDA); the script
modules run on the CPU.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


class Report:
    """The JSON lines of one run."""

    def __init__(self):
        self.rows = []

    def __call__(self, artifact, check, status, **info):
        row = {"artifact": artifact, "check": check, "status": status, **info}
        self.rows.append(row)
        print(json.dumps(row), flush=True)


def _script_taps(mod, x, plan_names, taps):
    """The script VGG16's activations after each ReLU named in `taps`,
    walking its `layers` sequential in definition order."""
    import torch

    try:
        layers = list(mod.layers)
    except NotImplementedError:  # a loaded script Sequential has no __iter__
        layers = list(mod.layers.children())
    out, conv_i = {}, 0
    with torch.no_grad():
        h = torch.from_numpy(x)
        for layer in layers:
            h = layer(h)
            if getattr(layer, "original_name", type(layer).__name__) == "ReLU":
                if plan_names[conv_i] in taps:
                    out[plan_names[conv_i]] = h.clone()
                conv_i += 1
    return out


def verify_vgg16(report, path, outdir, tol, device):
    import torch

    from latentaugment_tpu_torch.models import vgg

    out_path = os.path.join(outdir, "vgg16_lpips.pkl")
    params = vgg.convert_torchscript(path, out_path)
    n_convs = sum(1 for k in params if k.startswith("conv"))
    report("vgg16", "convert", "pass" if n_convs == 13 else "fail", mapped_convs=n_convs,
           out=out_path, has_lin="lin" in params)
    mod = torch.jit.load(path, map_location="cpu").eval()
    if not hasattr(mod, "layers"):
        report("vgg16", "forward_parity", "skipped",
               reason="module has no .layers sequential to walk")
        return
    plan_names = [it[0] for it in vgg.VGG16_PLAN if it != "M"]
    rs = np.random.RandomState(0)
    x, y = (rs.randn(2, 3, 64, 64).astype(np.float32) for _ in range(2))
    taps_x = _script_taps(mod, x, plan_names, vgg.LPIPS_TAPS)
    taps_y = _script_taps(mod, y, plan_names, vgg.LPIPS_TAPS)
    p_dev = vgg.params_from_numpy(params, device)
    with torch.no_grad():
        acts = vgg.vgg_features(p_dev, torch.from_numpy(x).to(device), taps=vgg.LPIPS_TAPS,
                                input_range="unit")
        dist = vgg.lpips_distance(p_dev, torch.from_numpy(x).to(device),
                                  torch.from_numpy(y).to(device), input_range="unit")
    worst = max(rel_err(acts[t].cpu().numpy(), taps_x[t].numpy()) for t in vgg.LPIPS_TAPS)
    report("vgg16", "forward_parity", "pass" if worst < tol else "fail", max_rel_err=worst,
           tol=tol, taps=len(taps_x))
    # LPIPS through the embedding against richzhang's formula on the
    # script module's activations and the same converted lin weights.
    dist_t = np.zeros(2, np.float64)
    for tap in vgg.LPIPS_TAPS:
        ta, tb = taps_x[tap], taps_y[tap]
        na = ta / (ta.square().sum(1, keepdim=True) + 1e-10).sqrt()
        nb = tb / (tb.square().sum(1, keepdim=True) + 1e-10).sqrt()
        lin = torch.from_numpy(params["lin"][tap]) if "lin" in params else torch.ones(ta.shape[1])
        dist_t += (lin.reshape(1, -1, 1, 1) * (na - nb).square()).sum(1).mean(dim=(1, 2)).numpy()
    err = rel_err(dist.cpu().numpy(), dist_t)
    report("vgg16", "lpips_distance_parity", "pass" if err < tol else "fail", max_rel_err=err,
           tol=tol)


def _fid(fa, fb):
    from latentaugment_tpu_torch.metrics.frechet_inception_distance import fid_from_moments

    return fid_from_moments(fa.mean(0), np.cov(fa, rowvar=False),
                            fb.mean(0), np.cov(fb, rowvar=False))


def verify_inception(report, path, outdir, tol, fid_tol, device):
    import torch

    from latentaugment_tpu_torch.models import inception

    # A TorchScript detector (NVIDIA's pickle: also the executable oracle)
    # or a torchvision state dict (conversion source only).
    mod = None
    try:
        mod = torch.jit.load(path, map_location="cpu").eval()
        state = dict(mod.state_dict())
    except RuntimeError:
        obj = torch.load(path, map_location="cpu", weights_only=True)
        state = dict(obj.get("state_dict", obj))
    out_path = os.path.join(outdir, "inception_fid.pkl")
    try:
        params = inception.convert_torchvision_state(state, out_path, strict=True, device=device)
        report("inception", "convert", "pass", out=out_path)
    except (KeyError, ValueError) as e:
        params = None
        report("inception", "convert", "skipped",
               reason=f"state dict is not torchvision-shaped ({e}); oracle-only artifact")
    if mod is None:
        report("inception", "fid_agreement", "skipped",
               reason="state dict only: no executable torch oracle")
        return
    det = params if params is not None else inception.init_inception(device=device)
    rs = np.random.RandomState(0)
    set_a = (rs.rand(32, 3, 128, 128) * 255).astype(np.uint8)
    set_b = np.clip(set_a.astype(np.int16) + rs.randint(-40, 40, set_a.shape), 0,
                    255).astype(np.uint8)

    def torch_feats(x):
        t = torch.from_numpy(x)
        with torch.no_grad():
            try:
                return mod(t, return_features=True).numpy().astype(np.float64)
            except (RuntimeError, TypeError):
                out = mod(t.float())
                out = out[0] if isinstance(out, (tuple, list)) else out
                return out.numpy().astype(np.float64)

    def port_feats(x):
        with torch.no_grad():
            return inception.inception_features(
                det, torch.from_numpy(x).float().to(device)).cpu().numpy().astype(np.float64)

    ft = _fid(torch_feats(set_a), torch_feats(set_b))
    fp = _fid(port_feats(set_a), port_feats(set_b))
    rel = abs(ft - fp) / (abs(ft) + 1e-12)
    # Without converted weights the port's detector is the seeded init: an
    # agreement there would be a coincidence, so it is only reported.
    status = "info" if params is None else ("pass" if rel < fid_tol else "fail")
    report("inception", "fid_agreement", status, fid_torch=ft, fid_port=fp, rel_diff=rel,
           fid_tol=fid_tol)


def verify_network_pkl(report, path, tol, sg_repo, device):
    import torch

    from latentaugment_tpu_torch.models import networks_for
    from latentaugment_tpu_torch.models.stylegan2 import checkpoint, networks

    g_params, g_cfg, d_params, d_cfg = checkpoint.load_stylegan(path)
    G = networks_for(g_cfg).Generator(g_cfg)  # num_fp16_res 0: float32 comparisons
    G.load_state_dict(checkpoint.params_to_state_dict(g_params))
    G = G.to(device).eval()
    gen = torch.Generator().manual_seed(0)
    z = torch.randn([2, g_cfg.z_dim], generator=gen)
    c = torch.zeros([2, g_cfg.c_dim]) if g_cfg.c_dim else None
    with torch.no_grad():
        img = G(z.to(device), None if c is None else c.to(device), noise_mode="const")
    img = img.cpu().numpy()
    ok = bool(np.isfinite(img).all() and img.std() > 1e-4 and img.shape[1:] == (
        g_cfg.img_channels, g_cfg.img_resolution, g_cfg.img_resolution))
    report("network_pkl", "ingest_and_synthesize", "pass" if ok else "fail",
           arch=g_cfg.get("arch", "stylegan2"), img_shape=list(img.shape),
           img_std=float(img.std()), has_discriminator=d_params is not None)
    if d_params is not None:
        D = networks.Discriminator(d_cfg)
        D.load_state_dict(checkpoint.params_to_state_dict(d_params))
        D = D.to(device).eval()
        with torch.no_grad():
            logits = D(torch.from_numpy(img).to(device),
                       None if c is None else c.to(device)).cpu().numpy()
        report("network_pkl", "discriminator_forward",
               "pass" if np.isfinite(logits).all() else "fail", logits_shape=list(logits.shape))
    if not sg_repo:
        report("network_pkl", "torch_golden", "skipped",
               reason="pass --sg_repo <stylegan2/3 checkout> to opt into executing the "
                      "network pickle's embedded torch modules")
        return
    import pickle

    sys.path.insert(0, sg_repo)
    with open(path, "rb") as f:
        obj = pickle.load(f)  # runs NVIDIA's persistence code: opted in by --sg_repo
    g_t = (obj.get("G_ema") or obj["G"]).eval()
    with torch.no_grad():
        img_t = g_t(z, c, noise_mode="const", force_fp32=True).numpy()
    err = rel_err(img, img_t)
    report("network_pkl", "torch_golden", "pass" if err < tol else "fail", max_rel_err=err,
           tol=tol)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--vgg16", help="NVIDIA vgg16.pt (LPIPS TorchScript)")
    ap.add_argument("--inception", help="FID detector: NVIDIA TorchScript pickle or "
                                        "torchvision inception_v3 state dict")
    ap.add_argument("--network_pkl", help="trained StyleGAN2 / StyleGAN3 pickle")
    ap.add_argument("--sg_repo", help="a stylegan2-ada-pytorch / stylegan3 checkout: opts into "
                                      "executing the network pickle's embedded torch code")
    ap.add_argument("--outdir", default="converted_weights",
                    help="where the converted files are written")
    ap.add_argument("--tol", type=float, default=1e-3,
                    help="max relative error of the forward comparisons")
    ap.add_argument("--fid_tol", type=float, default=0.01,
                    help="max relative FID disagreement")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the port (cuda, cuda:N or cpu); cuda without CUDA raises")
    args = ap.parse_args(argv)

    from latentaugment_tpu_torch.utils.util_general import resolve_device

    device = resolve_device(args.device)
    os.makedirs(args.outdir, exist_ok=True)
    report = Report()
    lanes = (("vgg16", lambda p: verify_vgg16(report, p, args.outdir, args.tol, device)),
             ("inception", lambda p: verify_inception(report, p, args.outdir, args.tol,
                                                      args.fid_tol, device)),
             ("network_pkl", lambda p: verify_network_pkl(report, p, args.tol, args.sg_repo,
                                                          device)))
    any_given = False
    for name, lane in lanes:
        path = getattr(args, name)
        if not path:
            report(name, "all", "skipped", reason="no path given")
            continue
        any_given = True
        if not os.path.isfile(path):
            report(name, "all", "fail", reason=f"file not found: {path}")
            continue
        lane(path)
    failed = [r for r in report.rows if r["status"] == "fail"]
    print(json.dumps({
        "verdict": "fail" if failed or not any_given else "pass",
        "checks_run": len([r for r in report.rows if r["status"] != "skipped"]),
        "failed": len(failed),
        "device": str(device),
        "note": None if any_given else "no artifact paths were given",
    }), flush=True)
    return 1 if failed or not any_given else 0


if __name__ == "__main__":
    raise SystemExit(main())
