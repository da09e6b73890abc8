"""Whether the timed path's answers are right: a seeded sample of the
window's batches, every row of them, compared with the plain reference
(portbench/reference) worked out from the same raw files and seeded
streams, with TF32 off.

Numbers compared, each against its limit in limits/<workload>.json:
  image_rms      RMS of x_prog - x_ref over the checked rows, in the
                 images' own units ([-1, 1] nominal), worst batch: the
                 pairs of get_output against the reference synthesis of
                 the program's own codes with the replayed noise;
  w_gap          sampling: ||w_prog - w_ref|| / ||w_ref||, w_ref the
                 reference mapping of the replayed z (get_latent_output);
  trace_gap      walk: the program's loss trace (each Adam step's loss,
                 the engine's `last_traces`) against the reference walk's
                 of the whole batch, worst step, over the reference's
                 loss change from the first step to the last;
  latent0_gap    walk: the latent term of the batch's loss (`loss_latent`,
                 the mean over the batch of each row's distance from the
                 latent manifold) at the first step, where both sides read
                 it at the same w0 in float32, against the reference's,
                 over the reference's;
  disc0_gap      walk: D's term of the batch's loss (`loss_disc`) at the
                 first step against the reference's, over the reference's.
Printed beside them and not compared (PERF.md gives the readings, which
separate no fault from sound runs): each row's walked distance against
the reference walk's, walk_norm_gap (| ||w_K - w0|| - ||w_ref - w0|| |,
worst row, over that row's or the median row's distance, whichever is
larger) and walk_cos_gap (1 - cos(w_K - w0, w_ref - w0), worst row), and
walk_gap, ||w_K - w_ref|| / ||w_ref - w0|| over the rows.
"""

import pickle

import numpy as np
import torch

from reference import nets
from reference import walk as rwalk


def flat_params(tree, device, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_params(v, device, f"{prefix}{k}."))
        else:
            out[prefix + k] = torch.as_tensor(np.asarray(v, np.float32), device=device)
    return out


def load_params(files, device):
    with open(files["ckpt"], "rb") as f:
        obj = pickle.load(f)
    p_g = flat_params(obj["G"]["params"], device)
    p_d = flat_params(obj["D"]["params"], device) if "D" in obj else None
    vgg = None
    if files.get("vgg"):
        with open(files["vgg"], "rb") as f:
            vgg = flat_params(pickle.load(f), device)
    return p_g, p_d, vgg


def sample_plan(traffic, seed):
    """The window batches to check, drawn from the seed among its first."""
    chk = traffic["check"]
    rng = np.random.default_rng([int(seed), 7])
    return sorted(rng.choice(chk["within"], size=chk["batches"], replace=False).tolist())


class TF32Off:
    """float32 arithmetic for the reference: TF32 off while it runs."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def _sq(a, b=None):
    """Sum of squares of a (- b), in float64."""
    d = a.double() if b is None else a.double() - b.double()
    return d.square().sum().item()


class Candidate:
    """What stands in the program's place: the reference computed in
    `prec` (the control: nets.Precision('control')), or the reference walk
    with a fault planted: "half" leaves half of the batch out (rows in its
    second half get no loss; the mean is taken over the rest), "d_zero"
    zeroes D's logits, "d_nograd" drops D's gradient; or "g_bf16", no
    fault: each gradient rounded to bfloat16."""

    def __init__(self, prec=nets.REF, fault=None):
        if fault is not None and fault not in rwalk.FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.prec, self.fault = prec, fault


def answers(answer, files, cfg, traffic, plan, staged, n_warm, policy_seed, device,
            candidate=None):
    """The compared numbers of the checked rows. `answer(i)` gives the
    program's (w [B, w_dim], image [B, C, H, W], loss trace [K] or None)
    of window batch i as numpy, the traces {"loss", "latent", "disc": [K]}
    or None);
    with `candidate` (a Candidate) the
    reference stands in the program's place."""
    batch = traffic["batch"]
    walk = traffic["kind"] == "walk"
    dcfg = dict(cfg["discriminator"], resolution=cfg["resolution"],
                img_channels=cfg["img_channels"])
    n_ws = nets.num_ws(cfg)
    ref = nets.REF
    calls = [n_warm + i for i in plan]
    noises = rwalk.noise_draws(cfg, policy_seed, batch, calls, device)
    gaps = {"image_rms": 0.0}
    gaps.update(dict(trace_gap=0.0, latent0_gap=0.0, disc0_gap=0.0, walk_norm_gap=0.0,
                     walk_cos_gap=0.0, walk_gap=0.0) if walk else dict(w_gap=0.0))
    with TF32Off(), torch.no_grad():
        p_g, p_d, vgg = load_params(files, device)
        if walk:
            man = rwalk.manifolds(files, cfg, traffic, vgg, policy_seed, device, ref)
            man_c = man
            if candidate is not None and candidate.prec is not ref:
                man_c = rwalk.manifolds(files, cfg, traffic, vgg, policy_seed, device,
                                        candidate.prec)
            codes = dict(rwalk.zip_items(files["w_zip"]))
            pos = rwalk.crop_positions(policy_seed, max(calls) + 1, cfg["resolution"],
                                       traffic["crop_size"])
        else:
            zs = rwalk.z_draws(cfg, policy_seed, batch, calls)
        for i in plan:
            call = n_warm + i
            noise = noises[call]
            if walk:
                # Every row of the batch: its loss trace is the batch's.
                names = staged[i % len(staged)]["A_paths"]
                blocks = [rwalk.group_rows(batch, 4, [j]) for j in range(batch // 4)]
                trace_r = {k: np.zeros(traffic["num_epochs"]) for k in rwalk.TRACED}
                trace_p = {k: np.zeros(traffic["num_epochs"]) for k in rwalk.TRACED}
            else:
                step = traffic["check"]["block"]
                blocks = [list(range(s, min(s + step, batch))) for s in range(0, batch, step)]
            if candidate is None:
                w_all, img_all, trace = answer(i)
                if walk:
                    trace_p = {k: np.asarray(trace[k], np.float64) for k in trace_p}
            acc = dict(img=0.0, n_img=0, w=0.0, w_ref=0.0)
            norms_p, norms_r = [], []
            for rows in blocks:
                nz = None if noise is None else [t[rows] for t in noise]
                if walk:
                    w0 = torch.as_tensor(np.stack([np.asarray(codes[names[r]], np.float32)[:1]
                                                   for r in rows]), device=device)
                    weights = torch.full([len(rows)], 1.0 / batch, device=device)
                    w_ref, tr = rwalk.walk(p_g, p_d, vgg, cfg, dcfg, traffic, man, w0,
                                           pos[call], weights, ref)
                    w_ref = w_ref[:, 0]
                    for k in trace_r:
                        trace_r[k] += tr[k]
                else:
                    z = zs[call][rows].to(device)
                    w_ref = nets.mapping(p_g, cfg, z, ref, traffic["truncation_psi"])[:, 0]
                if candidate is None:
                    w_p = torch.as_tensor(w_all[rows], device=device)
                    ws_p = w_p[:, None].repeat(1, n_ws, 1)
                    img_p = torch.as_tensor(img_all[rows], device=device)
                else:
                    if walk:
                        if candidate.fault == "half":
                            weights = torch.as_tensor([2.0 / batch if r < batch // 2 else 0.0
                                                       for r in rows], device=device)
                        w_p, tr = rwalk.walk(p_g, p_d, vgg, cfg, dcfg, traffic, man_c, w0,
                                             pos[call], weights, candidate.prec,
                                             candidate.fault)
                        w_p = w_p[:, 0]
                        for k in trace_p:
                            trace_p[k] += tr[k]
                    else:
                        w_p = nets.mapping(p_g, cfg, z, candidate.prec,
                                           traffic["truncation_psi"])[:, 0]
                    ws_p = w_p[:, None].repeat(1, n_ws, 1)
                    img_p = nets.synthesis(p_g, cfg, ws_p, candidate.prec, nz)
                img_r = nets.synthesis(p_g, cfg, ws_p, ref, nz)
                acc["img"] += _sq(img_p, img_r)
                acc["n_img"] += img_r.numel()
                acc["w"] += _sq(w_p, w_ref)
                if walk:
                    acc["w_ref"] += _sq(w_ref, w0[:, 0])
                    d_p, d_r = (w_p - w0[:, 0]).double(), (w_ref - w0[:, 0]).double()
                    norms_p.append(d_p.norm(dim=1))
                    norms_r.append(d_r.norm(dim=1))
                    cos = torch.nn.functional.cosine_similarity(d_p, d_r, dim=1)
                    gaps["walk_cos_gap"] = max(gaps["walk_cos_gap"], (1.0 - cos).max().item())
                else:
                    acc["w_ref"] += _sq(w_ref)
            gaps["image_rms"] = max(gaps["image_rms"], (acc["img"] / acc["n_img"]) ** 0.5)
            if walk:
                # Each row's walked distance against the reference's, by the
                # worst row, over that row's or the median row's distance.
                n_p, n_r = torch.cat(norms_p), torch.cat(norms_r)
                scale = torch.maximum(n_r, n_r.median())
                gaps["walk_norm_gap"] = max(gaps["walk_norm_gap"],
                                            ((n_p - n_r).abs() / scale).max().item())
                lp, lr_ = trace_p["loss"], trace_r["loss"]
                gaps["trace_gap"] = max(gaps["trace_gap"], float(
                    np.abs(lp - lr_).max() / abs(lr_[0] - lr_[-1])))
                for term in ("latent", "disc"):
                    first_p, first_r = trace_p[term][0], trace_r[term][0]
                    gap = float(abs(first_p - first_r) / abs(first_r))
                    gaps[term + "0_gap"] = max(gaps[term + "0_gap"], gap)
                gaps["walk_gap"] = max(gaps["walk_gap"], (acc["w"] / acc["w_ref"]) ** 0.5)
            else:
                gaps["w_gap"] = max(gaps["w_gap"], (acc["w"] / acc["w_ref"]) ** 0.5)
    return gaps


def judge(gaps, limits):
    """(correct, [(name, value, limit)]) over the limited numbers; the
    others are listed with limit None."""
    rows, ok = [], True
    for name, value in gaps.items():
        lim = limits.get(name)
        if lim is not None and not value <= lim:
            ok = False
        rows.append((name, value, lim))
    missing = [n for n in limits if n not in gaps]
    if missing:
        ok = False
        rows += [(n, None, limits[n]) for n in missing]
    return ok, rows
