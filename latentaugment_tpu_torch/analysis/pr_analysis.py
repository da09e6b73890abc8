"""Precision-vs-recall plots from metric jsonl files (counterpart:
latentaugment_tpu/analysis/pr_analysis.py): the metric records into a
pandas DataFrame, a precision-vs-recall scatter per experiment, and image
grids of dumped augmented batches. Host-only.

    python -m latentaugment_tpu_torch.analysis.pr_analysis --run_dir <dir>
"""

import json
import os
import pickle

import numpy as np

from ..utils import util_reports


def load_metric_jsonl(run_dir, prefix="metric-"):
    """Collect all metric jsonl records under run_dir into a DataFrame."""
    import pandas as pd

    rows = []
    for fname in sorted(os.listdir(run_dir)):
        if not (fname.startswith(prefix) and fname.endswith(".jsonl")):
            continue
        with open(os.path.join(run_dir, fname)) as f:
            text = f.read()
        # Files may hold one indented json object per write.
        decoder = json.JSONDecoder()
        idx = 0
        while idx < len(text):
            text_rest = text[idx:].lstrip()
            if not text_rest:
                break
            idx = len(text) - len(text_rest)
            # raw_decode returns the absolute end index, not a count.
            obj, idx = decoder.raw_decode(text, idx)
            if isinstance(obj, dict) and "metric" in obj:
                rows.append(obj)
            elif isinstance(obj, dict):
                for exp, entries in obj.items():
                    for e in entries:
                        e = dict(e)
                        e["experiment"] = exp
                        rows.append(e)
    return pd.DataFrame(rows)


def precision_recall_scatter(df, save_path, mode=None, title=None):
    """Scatter of (recall, precision) per experiment for one modality."""
    sub = df[df["metric"] == "pr50k3_full"] if "metric" in df else df
    if mode is not None and "mode" in sub:
        sub = sub[sub["mode"] == mode]
    points = []
    labels = []
    for _, row in sub.iterrows():
        val = row.get("value", {})
        if "pr50k3_full_recall" in val:
            points.append([val["pr50k3_full_recall"],
                           val["pr50k3_full_precision"]])
            labels.append(row.get("experiment", row.get("mode", "")))
    if not points:
        print("[pr_analysis] no PR records found")
        return None
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    points = np.asarray(points)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.scatter(points[:, 0], points[:, 1], alpha=0.7)
    for (x, y), lab in zip(points, labels):
        ax.annotate(str(lab)[:24], (x, y), fontsize=5)
    ax.set_xlabel("recall")
    ax.set_ylabel("precision")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.set_title(title or f"Precision vs Recall ({mode or 'all'})")
    fig.savefig(save_path, dpi=200, bbox_inches="tight")
    plt.close(fig)
    return save_path


def dump_image_grids(exp_dir, save_dir, n_batches=2, modality_key="A"):
    """Render grids of the first dumped augmented batches of an experiment."""
    os.makedirs(save_dir, exist_ok=True)
    img_dir = os.path.join(exp_dir, "img_aug")
    fnames = sorted(os.listdir(img_dir))[:n_batches]
    outs = []
    for fname in fnames:
        with open(os.path.join(img_dir, fname), "rb") as f:
            batch = pickle.load(f)
        imgs = np.asarray(batch[modality_key])
        out = os.path.join(save_dir, f"{fname}_{modality_key}.png")
        util_reports.image_grid(imgs, save_path=out, title=fname)
        outs.append(out)
    return outs


def generate_mapping(n):
    """Index -> letter labels for experiment legends."""
    alphabet = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    return {i: alphabet[i] for i in range(n)}


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--run_dir", required=True)
    ap.add_argument("--mode", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    df = load_metric_jsonl(args.run_dir)
    out = args.out or os.path.join(args.run_dir, "pr_scatter.png")
    precision_recall_scatter(df, out, mode=args.mode)
    print(f"wrote {out}")
