"""Frechet Inception Distance (counterpart:
latentaugment_tpu/metrics/frechet_inception_distance.py): mean and
covariance of InceptionV3 features of the real dataset and of generated
images (dumped augmented batches or a live generator), then the Frechet
formula. Features are extracted on the device; the 2048x2048 matrix
square root runs on the host (scipy), once: on rank 0 under a mesh.
"""

import numpy as np
import scipy.linalg
import torch

from . import metric_utils

DETECTOR_URL = ('https://api.ngc.nvidia.com/v2/models/nvidia/research/'
                'stylegan3/versions/1/files/metrics/inception-2015-12-05.pkl')


def fid_from_moments(mu_real, sigma_real, mu_gen, sigma_gen):
    m = np.square(mu_gen - mu_real).sum()
    # No `disp` argument: newer SciPy releases no longer take it.
    s = scipy.linalg.sqrtm(np.dot(sigma_gen, sigma_real))
    return float(np.real(m + np.trace(sigma_gen + sigma_real - s * 2)))


def compute_fid(opts, max_real, num_gen):
    mu_real, sigma_real = metric_utils.compute_feature_stats_for_dataset(
        opts=opts, detector_url=DETECTOR_URL, mode_dict=opts.mode_dict,
        rel_lo=0, rel_hi=0, capture_mean_cov=True, max_items=max_real).get_mean_cov()
    mu_gen, sigma_gen = metric_utils.compute_feature_stats_for_generated(
        opts=opts, detector_url=DETECTOR_URL, mode_dict=opts.mode_dict,
        rel_lo=0, rel_hi=1, capture_mean_cov=True, max_items=num_gen).get_mean_cov()
    if opts.mesh is None:
        return fid_from_moments(mu_real, sigma_real, mu_gen, sigma_gen)
    # Every rank holds the same moments: the host's matrix root runs once,
    # on rank 0, and the others receive its value.
    from ..parallel import mesh as pmesh

    first = pmesh.data_rank(opts.mesh) == 0
    fid = fid_from_moments(mu_real, sigma_real, mu_gen, sigma_gen) if first else 0.0
    return float(pmesh.all_sum(torch.tensor([fid], dtype=torch.float64,
                                            device=opts.device), opts.mesh)[0])
