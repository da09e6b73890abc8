"""Metric sweep over dumped experiment directories (counterpart:
latentaugment_tpu/analysis/sg2_metrics_analysis.py): FID and
precision/recall per modality for every experiment directory whose name
matches a pattern (the name records the operating point), through the
port's `calc_metric` on `device` ('cuda' unless the caller names the
CPU), appended to `metric-<experiment>.jsonl`.

    python -m latentaugment_tpu_torch.analysis.sg2_metrics_analysis \
        --run_dir <checkpoints_dir> --dataset_zip <zip> [--device cpu]
"""

import json
import os
import re

from ..metrics import calc_metric
from ..utils import util_general


def parse_experiment_name(name):
    """Recover the hyperparameters that options/base_options.py encodes
    in an experiment directory's name."""
    out = {}
    for key in ("n_imgs", "opt_lr", "opt_num_epochs", "w_latent", "w_pix",
                "w_lpips", "w_disc", "p_thres", "truncation_psi",
                "horizontal_flip", "affine", "elastic_deform"):
        # A '-' is part of the value only in scientific notation (right
        # after e/E, e.g. str(3e-05) == '3e-05'); any other '-' separates
        # the next key.
        m = re.search(rf"{key}_((?:[0-9.A-Za-z]|(?<=[0-9][eE])-(?=[0-9]))+)",
                      name)
        if m:
            out[key] = m.group(1)
    return out


def sweep(run_dir, pattern, dataset_zip, modalities, resolution=256,
          split="val", batch_size=1, metrics=("fid50k_full", "pr50k3_full"),
          device="cuda"):
    """Evaluate all experiment dirs under run_dir matching `pattern`."""
    modalities = util_general.parse_comma_separated_list(modalities)
    exp_dirs = sorted(
        d for d in os.listdir(run_dir)
        if os.path.isdir(os.path.join(run_dir, d, "img_aug"))
        and re.search(pattern, d))
    print(f"{len(exp_dirs)} experiment dirs match {pattern!r}")

    results = {}
    for exp in exp_dirs:
        results[exp] = []
        dataset_kwargs = dict(path=dataset_zip, split=split,
                              modalities=modalities, resolution=resolution)
        dataset_kwargs_gen = dict(dataroot=os.path.join(run_dir, exp),
                                  aug_name=exp, batch_size=batch_size)
        for mode_idx, mode in enumerate(modalities):
            mode_dict = dict(mode_name=mode, mode_idx=mode_idx)
            for metric in metrics:
                res = calc_metric(metric, dataset_kwargs=dataset_kwargs,
                                  dataset_kwargs_gen=dataset_kwargs_gen,
                                  mode_dict=mode_dict, device=device)
                entry = dict(metric=metric, mode=mode,
                             value=dict(res.results),
                             params=parse_experiment_name(exp))
                results[exp].append(entry)
                print(json.dumps(entry))

        with open(os.path.join(run_dir, f"metric-{exp}.jsonl"), "at") as f:
            f.write(json.dumps({exp: results[exp]}, indent=3) + "\n")
    return results


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--run_dir", required=True)
    ap.add_argument("--pattern", default=".*")
    ap.add_argument("--dataset_zip", required=True)
    ap.add_argument("--modalities", default="MR_nonrigid_CT,MR_MR_T2")
    ap.add_argument("--resolution", type=int, default=256)
    ap.add_argument("--split", default="val")
    ap.add_argument("--batch_size", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the detectors (cuda, cuda:N or cpu); cuda without "
                         "CUDA raises")
    args = ap.parse_args()
    sweep(args.run_dir, args.pattern, args.dataset_zip, args.modalities,
          args.resolution, args.split, args.batch_size, device=args.device)
