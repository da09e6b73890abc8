"""Latent-manifold coverage analysis, UMAP or PCA projection of w codes
(counterpart: latentaugment_tpu/analysis/umap_analysis.py).

Fits a 2-D embedding on the inverted set's w codes and projects the
real, LatentAugment and random-GAN samples into it: the manifold-coverage
figure. Where umap-learn is not installed the embedding is PCA
(deterministic, numpy only); the comparison holds, since every point set
shares the one projection. Host-only.

    python -m latentaugment_tpu_torch.analysis.umap_analysis \
        --inverted_dir <run>/latent --aug_dir <run>/latent_aug --out coverage.png
"""

import os
import pickle

import numpy as np

from ..utils import util_reports


class _PCAEmbedder:
    def fit(self, X):
        X = np.asarray(X, np.float64)
        self.mean_ = X.mean(0)
        Xc = X - self.mean_
        _, _, vt = np.linalg.svd(Xc, full_matrices=False)
        self.components_ = vt[:2]
        return self

    def transform(self, X):
        return (np.asarray(X, np.float64) - self.mean_) @ self.components_.T

    def fit_transform(self, X):
        return self.fit(X).transform(X)


def make_embedder(n_neighbors=15, min_dist=0.1, seed=42):
    try:
        import umap

        return umap.UMAP(n_neighbors=n_neighbors, min_dist=min_dist,
                         random_state=seed)
    except ImportError:
        print("[umap_analysis] umap-learn not installed; using PCA embedding")
        return _PCAEmbedder()


def flatten_ws(w):
    """[N, num_ws, w_dim] or [N, w_dim] -> [N, D] (w-space points)."""
    w = np.asarray(w, np.float32)
    if w.ndim == 3:
        w = w[:, 0, :]  # all num_ws rows are identical for broadcast codes
    return w


def load_latents_from_dir(latent_dir, max_items=None):
    """Load w codes from a dump dir of get_latent_output pickles."""
    ws = []
    for fname in sorted(os.listdir(latent_dir)):
        with open(os.path.join(latent_dir, fname), "rb") as f:
            obj = pickle.load(f)
        w = np.asarray(obj["w"] if isinstance(obj, dict) else obj)
        if w.ndim == 1:
            w = w[None]
        ws.append(w.reshape(w.shape[0], -1) if w.ndim == 2 else w[:, 0])
        if max_items and sum(x.shape[0] for x in ws) >= max_items:
            break
    return np.concatenate(ws, axis=0)[:max_items]


def manifold_coverage(inverted_ws, sample_sets, save_path, interactive=False,
                      seed=42):
    """Fit the embedding on inverted_ws; project each named sample set.

    sample_sets: dict name -> [N, ...] latent arrays.
    """
    embedder = make_embedder(seed=seed)
    base = flatten_ws(inverted_ws)
    base_2d = embedder.fit_transform(base)

    points = [base_2d]
    labels = ["inverted (real)"] * base_2d.shape[0]
    for name, ws in sample_sets.items():
        proj = embedder.transform(flatten_ws(ws))
        points.append(proj)
        labels += [name] * proj.shape[0]
    points = np.concatenate(points, axis=0)

    if interactive:
        out = util_reports.scatter_plot_interactive(
            points, labels, title="w-space manifold coverage",
            save_path=os.path.splitext(save_path)[0] + ".html")
    else:
        out = util_reports.scatter_plot(points, labels,
                                        title="w-space manifold coverage",
                                        save_path=save_path)
    return out, points, labels


def fromdir_tolist(datadir):
    """Load every (non-hidden, sorted) pickle in a directory into a list."""
    out = []
    for fname in sorted(f for f in os.listdir(datadir)
                        if not f.startswith(".")):
        with open(os.path.join(datadir, fname), "rb") as f:
            out.append(pickle.load(f))
    return out


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--inverted_dir", required=True,
                    help="dir of 'latent' dumps (real inverted codes)")
    ap.add_argument("--aug_dir", default=None,
                    help="dir of 'latent_aug' dumps (LatentAugment codes)")
    ap.add_argument("--rand_dir", default=None,
                    help="dir of rand-GAN latent dumps")
    ap.add_argument("--out", default="umap_coverage.png")
    ap.add_argument("--interactive", action="store_true")
    args = ap.parse_args()

    sets = {}
    if args.aug_dir:
        sets["LatentAugment"] = load_latents_from_dir(args.aug_dir)
    if args.rand_dir:
        sets["random GAN"] = load_latents_from_dir(args.rand_dir)
    inverted = load_latents_from_dir(args.inverted_dir)
    out, _, _ = manifold_coverage(inverted, sets, args.out,
                                  interactive=args.interactive)
    print(f"wrote {out}")
