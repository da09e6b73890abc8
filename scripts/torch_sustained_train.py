"""Sustained training-dynamics run of the port's trainer (the port's copy
of scripts/sustained_train.py).

Trains the StyleGAN2-ADA trainer (scripts/torch_train_sg2.py) for a
multi-kimg stretch on a synthetic but learnable phantom dataset, then
checks the dynamics (scripts/torch_check_train_run.py): losses finite,
D's real score improving, ADA's p following rt in the right direction.
It is the at-scale counterpart of the per-phase parity tests of
tests/test_torch_port_train.py.

The card's operating point is 256², batch 32, with R1 over the whole
batch: the JAX run's `--r1_chunks 2` is a workaround for the TPU
compiler's memory at 256² and is not passed here (the port's trainer
peaks at 14.48 GiB unchunked on an H100 80GB HBM3). `--smoke` is the
tiny operating point (32², batch 4, channel_base 1024, channel_max 64,
at most 0.6 kimg) for the CPU.

Artifacts (log.jsonl, dynamics.png, summary.json) are copied to
--artifacts for committing.

    python scripts/torch_sustained_train.py --kimg 10                 # the card
    python scripts/torch_sustained_train.py --smoke --device cpu      # the CPU
"""

import argparse
import io
import json
import os
import pickle
import shutil
import sys
import tempfile
import zipfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

MODALITIES = ["MR_nonrigid_CT", "MR_MR_T2"]


def phantom(rng, res):
    """A learnable two-modality slice: 2-5 soft ellipses on a dark
    background; the second modality shares the geometry with remapped
    intensities (correlated like registered CT/MR). Values in [0,255],
    the dataset tool's output contract. Draws from `rng` in the JAX
    script's order, so one seed gives the same slices."""
    yy, xx = np.mgrid[0:res, 0:res].astype(np.float32) / res
    base = np.zeros((res, res), np.float32)
    for _ in range(rng.randint(2, 6)):
        cy, cx = rng.rand(2) * 0.6 + 0.2
        ry, rx = rng.rand(2) * 0.25 + 0.08
        theta = rng.rand() * np.pi
        dy, dx = yy - cy, xx - cx
        u = dy * np.cos(theta) + dx * np.sin(theta)
        v = -dy * np.sin(theta) + dx * np.cos(theta)
        d2 = (u / ry) ** 2 + (v / rx) ** 2
        base += rng.rand() * np.exp(-3.0 * d2)
    base /= max(base.max(), 1e-6)
    a = base * 255.0
    b = (1.0 - base) * base * 4 * 255.0  # shared geometry, remapped
    return {MODALITIES[0]: a.astype(np.float32),
            MODALITIES[1]: np.clip(b, 0, 255).astype(np.float32)}


def make_phantom_zip(path, res, n_patients=4, slices_per_patient=24,
                     split="train", seed=0):
    rng = np.random.RandomState(seed)
    with zipfile.ZipFile(path, "w") as zf:
        for p in range(n_patients):
            for s in range(slices_per_patient):
                name = (f"{split}/patient{p:03d}/"
                        f"{split}_patient{p:03d}_{10 + s * 5:05d}.pickle")
                buf = io.BytesIO()
                pickle.dump(phantom(rng, res), buf)
                zf.writestr(name, buf.getvalue())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kimg", type=float, default=10.0)
    ap.add_argument("--outdir", default=None)
    ap.add_argument("--artifacts", default=None,
                    help="copy log.jsonl/dynamics.png/summary here")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny operating point (32², batch 4, at most 0.6 kimg)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--res", type=int, default=256,
                    help="training resolution (non-smoke)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N or cpu); cuda without CUDA raises")
    args = ap.parse_args(argv)

    from latentaugment_tpu_torch.utils.util_general import resolve_device
    from scripts import torch_check_train_run
    from scripts.torch_train_sg2 import main as train_main

    resolve_device(args.device)
    if args.smoke:
        res, batch, extra = 32, 4, ["--channel_base", "1024", "--channel_max", "64"]
        kimg = min(args.kimg, 0.6)
        n_pat, spp = 3, 8
    else:
        res, batch, extra = args.res, 32, []
        kimg = args.kimg
        n_pat, spp = 4, 24

    root = tempfile.mkdtemp(prefix="lataug_torch_sustained_")
    try:
        outdir = args.outdir or os.path.join(root, "run")
        data_zip = os.path.join(root, f"phantoms-{res}.zip")
        print(f"[sustained] building phantom dataset {data_zip} "
              f"({n_pat}x{spp} slices at {res}²)", file=sys.stderr)
        make_phantom_zip(data_zip, res, n_patients=n_pat,
                         slices_per_patient=spp, seed=args.seed)

        train_main(["--data", data_zip, "--modalities", ",".join(MODALITIES),
                    "--resolution", str(res), "--batch", str(batch),
                    "--kimg", str(kimg), "--snap", str(max(kimg / 2, 0.001)),
                    "--outdir", outdir, "--seed", str(args.seed),
                    "--device", args.device] + extra)

        summary = torch_check_train_run.main([outdir, "--kimg", str(kimg)])
        if args.artifacts:
            os.makedirs(args.artifacts, exist_ok=True)
            for f in ("log.jsonl", "dynamics.png"):
                shutil.copy(os.path.join(outdir, f), os.path.join(args.artifacts, f))
            with open(os.path.join(args.artifacts, "summary.json"), "w") as f:
                json.dump(summary, f, indent=1)
            print(f"[sustained] artifacts -> {args.artifacts}", file=sys.stderr)
    finally:
        # root holds the phantom zip and, without --outdir, the run (its
        # snapshots and training states); an explicit --outdir lives
        # outside it and is kept.
        shutil.rmtree(root, ignore_errors=True)
    print("[sustained] OK")
    return summary


if __name__ == "__main__":
    main()
