"""kNN-manifold precision/recall (Kynkaanniemi et al.; counterpart:
latentaugment_tpu/metrics/precision_recall.py): pairwise Euclidean
distances in tiles on the device, the k-th neighbour radius per manifold
row, and a probe accepted if it lies within any manifold row's radius.
The distance tiles are float32 matrix products; this module never turns
TF32 on. Under a mesh each rank computes the tiles of its block of rows
(the rows padded to a multiple of the ranks) and every rank gathers the
whole matrix.
"""

import numpy as np
import torch

from ..parallel import mesh as pmesh
from . import metric_utils

DETECTOR_URL = ('https://api.ngc.nvidia.com/v2/models/nvidia/research/'
                'stylegan3/versions/1/files/metrics/vgg16.pkl')


def _dist_tile(rows, cols):
    """Euclidean distances [r, c] via the (r^2 + c^2 - 2rc) decomposition."""
    rr = rows.square().sum(dim=1, keepdim=True)
    cc = cols.square().sum(dim=1)
    d2 = rr + cc[None, :] - 2.0 * rows @ cols.T
    return torch.sqrt(d2.clamp(min=0.0))


def compute_distances(row_features, col_features, col_batch_size=10000,
                      device="cuda", mesh=None):
    """Chunked distance matrix [rows, cols] of two host arrays: tiles on
    `device` ('cuda' unless given; cuda without CUDA raises), assembled on
    the host. Under a mesh each rank computes its block of rows."""
    mesh = pmesh.check_mesh(mesh)
    device = metric_utils.resolve_device(device)
    rows = torch.as_tensor(np.asarray(row_features, np.float32), device=device)
    n = rows.shape[0]
    shard = None
    if mesh is not None:
        shard = pmesh.shard_rows(n, mesh, pad=True)
        rows = shard.take(rows)
    out = []
    for lo in range(0, col_features.shape[0], col_batch_size):
        cols = torch.as_tensor(np.asarray(col_features[lo:lo + col_batch_size], np.float32),
                               device=device)
        tile = _dist_tile(rows, cols)
        if shard is not None:
            tile = shard.gather(tile)
        out.append(tile.cpu().numpy())
    return np.concatenate(out, axis=1)


def knn_precision_recall(real_features, gen_features, nhood_size=3,
                         row_batch_size=10000, col_batch_size=10000,
                         device="cuda", mesh=None):
    """(precision, recall) of two host feature arrays; the distance tiles
    are computed on `device`."""
    results = {}
    max_nhood = min(real_features.shape[0], gen_features.shape[0]) - 1
    if max_nhood < 1:
        # One item has no neighbour besides itself: the radius is undefined.
        print("[metrics] WARNING: fewer than 2 items in a feature set; "
              "precision/recall are undefined: reporting 0.0/0.0")
        return 0.0, 0.0
    if nhood_size > max_nhood:
        print(f"[metrics] WARNING: nhood_size {nhood_size} > n-1 ({max_nhood}); "
              "clamping: PR values are degenerate at this sample count")
        nhood_size = max_nhood
    for name, manifold, probes in [("precision", real_features, gen_features),
                                   ("recall", gen_features, real_features)]:
        kth = []
        for lo in range(0, manifold.shape[0], row_batch_size):
            dist = compute_distances(manifold[lo:lo + row_batch_size], manifold,
                                     col_batch_size, device=device, mesh=mesh)
            # The k-th smallest besides self: index nhood_size (0-based)
            # of the sorted row.
            kth.append(np.partition(dist, nhood_size, axis=1)[:, nhood_size])
        kth = np.concatenate(kth)
        pred = []
        for lo in range(0, probes.shape[0], row_batch_size):
            dist = compute_distances(probes[lo:lo + row_batch_size], manifold,
                                     col_batch_size, device=device, mesh=mesh)
            pred.append((dist <= kth[None, :]).any(axis=1))
        results[name] = float(np.concatenate(pred).astype(np.float64).mean())
    return results["precision"], results["recall"]


def compute_pr(opts, max_real, num_gen, nhood_size, row_batch_size, col_batch_size):
    real_features = metric_utils.compute_feature_stats_for_dataset(
        opts=opts, detector_url=DETECTOR_URL, mode_dict=opts.mode_dict,
        rel_lo=0, rel_hi=0, capture_all=True, max_items=max_real).get_all()
    gen_features = metric_utils.compute_feature_stats_for_generated(
        opts=opts, detector_url=DETECTOR_URL, mode_dict=opts.mode_dict,
        rel_lo=0, rel_hi=1, capture_all=True, max_items=num_gen).get_all()
    return knn_precision_recall(real_features, gen_features, nhood_size,
                                row_batch_size, col_batch_size,
                                device=opts.device, mesh=opts.mesh)
