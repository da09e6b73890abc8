#!/usr/bin/env python3
"""Invert a paired-image dataset zip to W latents with the PyTorch port.

One inverted w per slice, written as
``<outdir>/<patient>/<slice>.pickle``; ``--dest_zip`` packages them as
``<split>/<patient>/<slice>.pickle``, member for member the image zip's
names, which is the inversion zip the LatentAugment policy reads with
``--init_w inv``. Projection is batched: every step is one generator and
VGG16 forward and backward over the batch. Native checkpoints only.

    python scripts/torch_project_dataset.py \
        --checkpoint ckpt.pkl --data_zip interim/Pelvis/Pelvis-img.zip \
        --split train --num_steps 1000 --batch_size 16 \
        --outdir interim/Pelvis/temp-projector \
        --dest_zip interim/Pelvis/Pelvis-inv.zip [--device cpu]
"""

import argparse
import os
import pickle
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", required=True, help="native checkpoint holding G")
    p.add_argument("--data_zip", required=True,
                   help="paired-image dataset zip (pickle dicts of modalities)")
    p.add_argument("--split", default="train")
    p.add_argument("--modalities", default="MR_nonrigid_CT,MR_MR_T2",
                   help="comma-separated modality keys (policy default)")
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--num_steps", type=int, default=1000,
                   help="Adam steps per batch (NVIDIA projector default)")
    p.add_argument("--batch_size", type=int, default=16,
                   help="images projected together; a final partial batch is "
                        "padded by repeating its last image")
    p.add_argument("--initial_lr", type=float, default=0.1)
    p.add_argument("--pix_weight", type=float, default=0.0,
                   help="optional pixel-MSE term on top of the perceptual "
                        "distance (off = NVIDIA semantics)")
    p.add_argument("--w_avg_samples", type=int, default=10000)
    p.add_argument("--num_fp16_res", type=int, default=4,
                   help="bf16 top blocks (run-time choice, engine default)")
    p.add_argument("--remat", action="store_true",
                   help="checkpoint synthesis blocks (larger batches)")
    p.add_argument("--vgg", default=None, help="converted LPIPS VGG16 pickle")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N or cpu); cuda without CUDA raises")
    p.add_argument("--impl", default="auto", choices=["auto", "ref"],
                   help="ops: 'auto' runs the hand-written kernels on CUDA, "
                        "'ref' the plain PyTorch versions")
    p.add_argument("--n_devices", type=int, default=1,
                   help="more than 1 needs the data-parallel slice, not ported yet")
    p.add_argument("--outdir", default="temp-projector")
    p.add_argument("--dest_zip", default=None,
                   help="also package outdir into an inversion zip "
                        "(<split>/<patient>/<slice>.pickle)")
    p.add_argument("--max_items", type=int, default=None,
                   help="cap on slices to invert (smoke runs)")
    return p.parse_args(argv)


def main(argv=None):
    """Runs the inversion; returns per-batch records
    [{'n': slices, 'seconds': wall, 'dists': [num_steps] floats}]."""
    args = parse_args(argv)
    if args.n_devices > 1:
        raise NotImplementedError(
            "--n_devices > 1 belongs to the DDP slice, which is not ported yet")

    import torch

    from latentaugment_tpu_torch.augments import engine, manifold
    from latentaugment_tpu_torch.data.write_tozip import write_to_zip
    from latentaugment_tpu_torch.models import networks_for, vgg
    from latentaugment_tpu_torch.models.stylegan2 import checkpoint, projector
    from latentaugment_tpu_torch.utils import util_general

    device = engine.resolve_device(args.device)
    modalities = util_general.parse_comma_separated_list(args.modalities)

    g_params, g_cfg, _, _ = checkpoint.load_stylegan(args.checkpoint)
    if (g_cfg.img_resolution, g_cfg.img_channels) != (args.resolution, len(modalities)):
        raise ValueError(
            f"{args.checkpoint} generates {g_cfg.img_channels} x {g_cfg.img_resolution}^2, "
            f"asked for {len(modalities)} x {args.resolution}^2")
    g_cfg.num_fp16_res = 0 if args.resolution < 64 else args.num_fp16_res
    G = networks_for(g_cfg).Generator(g_cfg, impl=args.impl)
    G.load_state_dict(checkpoint.params_to_state_dict(g_params))
    G = G.to(device).eval().requires_grad_(False)
    # Same resolution chain as the walk engine: explicit --vgg, else
    # LATENTAUGMENT_VGG16, else seeded random features, which is not the
    # perceptual space a policy with converted weights scores in.
    vgg_path = args.vgg or os.environ.get("LATENTAUGMENT_VGG16")
    if not vgg_path:
        print("[project] WARNING: no --vgg / LATENTAUGMENT_VGG16: "
              "using seeded random VGG features (smoke only)")
    vgg_params = vgg.get_vgg16(path=vgg_path, device=device)

    dataset = manifold.ImgDataset(args.data_zip, split=args.split, modalities=modalities,
                                  resolution=args.resolution)
    n_items = len(dataset)
    if args.max_items is not None:
        n_items = min(n_items, args.max_items)
    print(f"[project] {n_items} slices, split={args.split}, "
          f"batch={args.batch_size}, steps={args.num_steps}, device={device}")

    gen = torch.Generator(device=device).manual_seed(args.seed)
    w_avg, w_std = projector.w_stats(G, gen, n_samples=args.w_avg_samples)
    project = projector.make_project_fn(
        g_cfg, num_steps=args.num_steps, initial_lr=args.initial_lr,
        pix_weight=args.pix_weight, remat=args.remat)

    os.makedirs(args.outdir, exist_ok=True)
    records = []
    done = 0
    t_start = time.time()
    while done < n_items:
        imgs, fnames = [], []
        for i in range(done, min(done + args.batch_size, n_items)):
            x, fn = dataset[i]
            imgs.append(x / 127.5 - 1.0)  # the zip stores [0,255]
            fnames.append(fn)
        n_valid = len(imgs)
        # The loss is a mean over the batch, so a partial batch is padded
        # to the full size: its slices then descend as in a full batch.
        imgs += [imgs[-1]] * (args.batch_size - n_valid)
        target = torch.as_tensor(np.stack(imgs), dtype=torch.float32, device=device)

        t0 = time.time()
        w_opt, dists = project(G, vgg_params, target, w_avg, w_std, gen)
        dists = dists.float().cpu().numpy()  # waits for the device
        seconds = time.time() - t0
        for fn, payload in zip(fnames, projector.broadcast_rows(w_opt[:n_valid],
                                                                g_cfg.num_ws)):
            parts = fn.split("/")  # <split>/<patient>/<slice>.pickle
            dest = os.path.join(args.outdir, *(parts[1:] if len(parts) > 1 else parts))
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            with open(dest, "wb") as f:
                pickle.dump(payload, f)
        done += n_valid
        records.append({"n": n_valid, "seconds": seconds, "dists": dists.tolist()})
        print(f"[project] {done}/{n_items} (final dist {dists[-1]:.4f}, "
              f"{seconds:.1f}s/batch)")

    if args.dest_zip:
        patients = sorted(d for d in os.listdir(args.outdir)
                          if os.path.isdir(os.path.join(args.outdir, d)))
        write_to_zip(args.outdir, args.dest_zip,
                     splits_map={p: args.split for p in patients})
    print(f"[project] done: {done} slices in {time.time() - t_start:.1f}s")
    return records


if __name__ == "__main__":
    main()
