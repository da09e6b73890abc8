"""Metric utilities: options, feature statistics, progress, stat builders
(counterpart: latentaugment_tpu/metrics/metric_utils.py).

Features are extracted in batches on `MetricOptions.device` under
no_grad; mean and covariance accumulate on the host in float64.
Detectors resolve by URL basename: 'inception-2015-12-05' is the
InceptionV3 of models/inception.py, 'vgg16' the VGG16 detector head of
models/vgg.py. Converted weights load from this package's URL cache
(utils/util_url.py) when present; otherwise a seeded random init keeps
the metric self-consistent. A conditional generator draws its labels
from the training zip's labels (`dataset_kwargs` with `use_labels`) or
uniformly. A device mesh belongs to a later slice and raises.
"""

import hashlib
import os
import pickle
import time
import uuid
import zipfile

import numpy as np
import torch

from ..augments.manifold import ImgDataset
from ..models import inception, vgg
from ..utils import util_url
from ..utils.util_easydict import EasyDict
from ..utils.util_general import resolve_device


def format_time(seconds):
    s = int(round(seconds))
    if s < 60:
        return f"{s}s"
    if s < 3600:
        return f"{s // 60}m {s % 60:02d}s"
    return f"{s // 3600}h {(s // 60) % 60:02d}m"


def require_no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "metrics over a device mesh belong to the DDP slice, which is not ported yet")


class MetricOptions:
    """`G` is a Generator module on `device` (for the live-generator
    metrics); `device` a torch.device or its name, 'cuda' by default (cuda
    without CUDA raises). num_gpus and rank are kept for API
    compatibility."""

    def __init__(self, G=None, G_kwargs=None, dataset_kwargs=None,
                 dataset_kwargs_gen=None, num_gpus=1, rank=0, device="cuda",
                 progress=None, cache=True, mode_dict=None, mesh=None):
        if not 0 <= rank < num_gpus:
            raise ValueError(f"rank {rank} outside [0, {num_gpus})")
        require_no_mesh(mesh)
        self.G = G
        self.G_kwargs = EasyDict(G_kwargs or {})
        self.dataset_kwargs = EasyDict(dataset_kwargs or {})
        self.dataset_kwargs_gen = EasyDict(dataset_kwargs_gen or {})
        self.num_gpus = num_gpus
        self.rank = rank
        self.device = resolve_device(device)
        self.progress = progress.sub() if progress is not None else ProgressMonitor()
        self.cache = cache
        self.mode_dict = mode_dict
        self.mesh = mesh


# ----------------------------------------------------------------------------
# Detector registry

_feature_detector_cache = {}


def get_feature_detector_name(url):
    return os.path.splitext(url.split("/")[-1])[0]


class _Detector:
    """Callable batch [N, 3, H, W] in [0, 255] -> [N, D] features."""

    def __init__(self, fn, params):
        self._fn = fn
        self.params = params

    @torch.no_grad()
    def __call__(self, x):
        return self._fn(self.params, x)


def get_feature_detector(url, device="cuda"):
    """The _Detector for a detector URL on `device` ('cuda' unless given;
    cuda without CUDA raises), made once per process."""
    device = resolve_device(device)
    name = get_feature_detector_name(url)
    key = (name, str(device))
    if key in _feature_detector_cache:
        return _feature_detector_cache[key]

    path = util_url.url_cache_path(url)
    ckpt = path if os.path.isfile(path) else None
    if "inception" in name:
        det = _Detector(inception.inception_features,
                        inception.get_inception(ckpt, device=device))
    elif "vgg" in name:
        params = None
        if ckpt is not None:
            try:
                # The detector needs the classifier head (fc6/fc7) on top of
                # the conv trunk; an LPIPS-only conversion lacks it.
                params = vgg.load_params(ckpt, device, require=("conv1_1", "fc6", "fc7"))
            except (OSError, pickle.UnpicklingError, ValueError, KeyError) as e:
                print(f"[metrics] WARNING: cached VGG detector {ckpt} failed to load "
                      f"({e}); falling back to seeded RANDOM weights: metric values "
                      "will be self-consistent but not comparable to "
                      "reference-detector numbers")
        if params is None:
            params = vgg.init_vgg_detector(0, device)
        det = _Detector(vgg.detector_features, params)
    else:
        raise NotImplementedError(f"Unknown detector {name}")
    _feature_detector_cache[key] = det
    return det


# ----------------------------------------------------------------------------
# Feature statistics

class FeatureStats:
    def __init__(self, capture_all=False, capture_mean_cov=False, max_items=None):
        self.capture_all = capture_all
        self.capture_mean_cov = capture_mean_cov
        self.max_items = max_items
        self.num_items = 0
        self.num_features = None
        self.all_features = None
        self.raw_mean = None
        self.raw_cov = None

    def set_num_features(self, num_features):
        if self.num_features is not None:
            if num_features != self.num_features:
                raise ValueError(f"{num_features} features, expected {self.num_features}")
        else:
            self.num_features = num_features
            self.all_features = []
            self.raw_mean = np.zeros([num_features], dtype=np.float64)
            self.raw_cov = np.zeros([num_features, num_features], dtype=np.float64)

    def is_full(self):
        return self.max_items is not None and self.num_items >= self.max_items

    def append(self, x):
        if isinstance(x, torch.Tensor):
            x = x.detach().float().cpu().numpy()
        x = np.asarray(x, dtype=np.float32)
        if x.ndim != 2:
            raise ValueError(f"features must be [N, D], got {x.shape}")
        if self.max_items is not None and self.num_items + x.shape[0] > self.max_items:
            if self.num_items >= self.max_items:
                return
            x = x[: self.max_items - self.num_items]
        self.set_num_features(x.shape[1])
        self.num_items += x.shape[0]
        if self.capture_all:
            self.all_features.append(x)
        if self.capture_mean_cov:
            x64 = x.astype(np.float64)
            self.raw_mean += x64.sum(axis=0)
            self.raw_cov += x64.T @ x64

    def get_all(self):
        if not self.capture_all:
            raise RuntimeError("these stats were built without capture_all")
        return np.concatenate(self.all_features, axis=0)

    def get_mean_cov(self):
        if not self.capture_mean_cov:
            raise RuntimeError("these stats were built without capture_mean_cov")
        mean = self.raw_mean / self.num_items
        cov = self.raw_cov / self.num_items
        cov = cov - np.outer(mean, mean)
        return mean, cov

    def save(self, pkl_file):
        with open(pkl_file, "wb") as f:
            pickle.dump(self.__dict__, f)

    @staticmethod
    def load(pkl_file):
        # The cache file is one this program wrote (save above).
        with open(pkl_file, "rb") as f:
            s = pickle.load(f)
        obj = FeatureStats(capture_all=s["capture_all"], max_items=s["max_items"])
        obj.__dict__.update(s)
        return obj


# ----------------------------------------------------------------------------
# Progress

class ProgressMonitor:
    def __init__(self, tag=None, num_items=None, flush_interval=1000, verbose=True,
                 progress_fn=None, pfn_lo=0, pfn_hi=1000, pfn_total=1000):
        self.tag = tag
        self.num_items = num_items
        self.verbose = verbose
        self.flush_interval = flush_interval
        self.progress_fn = progress_fn
        self.pfn_lo = pfn_lo
        self.pfn_hi = pfn_hi
        self.pfn_total = pfn_total
        self.start_time = time.time()
        self.batch_time = self.start_time
        self.batch_items = 0
        if self.progress_fn is not None:
            self.progress_fn(self.pfn_lo, self.pfn_total)

    def update(self, cur_items):
        if self.num_items is not None and cur_items > self.num_items:
            raise ValueError(f"{cur_items} items reported of {self.num_items}")
        if cur_items < self.batch_items + self.flush_interval and \
                (self.num_items is None or cur_items < self.num_items):
            return
        cur_time = time.time()
        total_time = cur_time - self.start_time
        time_per_item = (cur_time - self.batch_time) / max(cur_items - self.batch_items, 1)
        if self.verbose and self.tag is not None:
            print(f"{self.tag:<19s} items {cur_items:<7d} time "
                  f"{format_time(total_time):<12s} ms/item {time_per_item * 1e3:.2f}")
        self.batch_time = cur_time
        self.batch_items = cur_items
        if self.progress_fn is not None and self.num_items is not None:
            self.progress_fn(
                self.pfn_lo + (self.pfn_hi - self.pfn_lo) * (cur_items / self.num_items),
                self.pfn_total)

    def sub(self, tag=None, num_items=None, flush_interval=1000, rel_lo=0, rel_hi=1):
        return ProgressMonitor(
            tag=tag, num_items=num_items, flush_interval=flush_interval,
            verbose=self.verbose, progress_fn=self.progress_fn,
            pfn_lo=self.pfn_lo + (self.pfn_hi - self.pfn_lo) * rel_lo,
            pfn_hi=self.pfn_lo + (self.pfn_hi - self.pfn_lo) * rel_hi,
            pfn_total=self.pfn_total)


# ----------------------------------------------------------------------------
# Feature-stat builders

def _select_mode(x, mode_idx):
    """One modality of [N, modes, H, W] as 3 equal channels."""
    if mode_idx is not None and x.shape[1] > 1:
        x = x[:, mode_idx:mode_idx + 1]
    if x.shape[1] == 1:
        x = x.repeat(1, 3, 1, 1)
    return x


def _to_detector_batch(x, mode_idx):
    """Select the modality, make 3 channels, map [-1,1]-style floats to
    [0,255] (x * 127.5 + 128, clipped)."""
    return (_select_mode(x, mode_idx) * 127.5 + 128.0).clamp(0, 255)


def _cache_lookup(opts, kind_kwargs, dataset_name, detector_url, stats_kwargs,
                  max_items=None):
    if not opts.cache:
        return None, None
    # max_items is part of the key: stats over 1k reals are not those of 50k.
    args = dict(dataset_kwargs=kind_kwargs, detector_url=detector_url,
                stats_kwargs=stats_kwargs, max_items=max_items)
    md5 = hashlib.md5(repr(sorted(args.items())).encode("utf-8"))
    mode_name = opts.mode_dict["mode_name"] if opts.mode_dict else "all"
    tag = (f"{dataset_name}-{mode_name}-{get_feature_detector_name(detector_url)}"
           f"-{md5.hexdigest()}")
    cache_file = util_url.make_cache_dir_path("gan-metrics", tag + ".pkl")
    if os.path.isfile(cache_file):
        return FeatureStats.load(cache_file), cache_file
    return None, cache_file


def _cache_store(stats, cache_file):
    if cache_file is None:
        return
    os.makedirs(os.path.dirname(cache_file), exist_ok=True)
    temp = cache_file + "." + uuid.uuid4().hex
    stats.save(temp)
    os.replace(temp, cache_file)


def compute_feature_stats_for_dataset(opts, detector_url, mode_dict=None, rel_lo=0,
                                      rel_hi=1, batch_size=64, max_items=None,
                                      **stats_kwargs):
    """Features of the real dataset. opts.dataset_kwargs describes a zip
    ImgDataset: {path, split, modalities, resolution}. Its images are raw
    [0,255] and go to the detector as they are."""
    require_no_mesh(opts.mesh)
    dk = opts.dataset_kwargs
    dataset = ImgDataset(path=dk["path"], split=dk.get("split", "train"),
                         modalities=dk["modalities"], resolution=dk.get("resolution"))
    dataset_name = os.path.splitext(os.path.basename(dk["path"]))[0]

    cached, cache_file = _cache_lookup(opts, dk, dataset_name, detector_url,
                                       stats_kwargs, max_items=max_items)
    if cached is not None:
        return cached

    num_items = len(dataset)
    if max_items is not None:
        num_items = min(num_items, max_items)
    stats = FeatureStats(max_items=num_items, **stats_kwargs)
    progress = opts.progress.sub(tag="dataset features", num_items=num_items,
                                 rel_lo=rel_lo, rel_hi=rel_hi)
    detector = get_feature_detector(detector_url, opts.device)
    mode_idx = (mode_dict or opts.mode_dict or {}).get("mode_idx")

    for lo in range(0, num_items, batch_size):
        x = np.stack([dataset[i][0] for i in range(lo, min(lo + batch_size, num_items))])
        x = torch.as_tensor(x, dtype=torch.float32, device=opts.device)
        stats.append(detector(_select_mode(x, mode_idx)))
        progress.update(stats.num_items)

    _cache_store(stats, cache_file)
    return stats


def compute_feature_stats_for_aug_dataset(opts, detector_url, mode_dict=None, rel_lo=0,
                                          rel_hi=1, max_items=None, **stats_kwargs):
    """Features of dumped augmented batches: `<dataroot>/img_aug/*` pickles
    of {'A', 'B'} batches in [-1, 1], dumped by this program's augmentation runs."""
    require_no_mesh(opts.mesh)
    dkg = opts.dataset_kwargs_gen
    datadir = dkg["dataroot"]
    dataset_name = dkg.get("aug_name", os.path.basename(datadir))

    cached, cache_file = _cache_lookup(opts, dkg, dataset_name, detector_url,
                                       stats_kwargs, max_items=max_items)
    if cached is not None:
        return cached

    img_dir = os.path.join(datadir, "img_aug")
    fnames = sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir)
                    if not f.startswith("."))
    if "batch_size" in dkg:
        per_file = int(dkg["batch_size"])
    elif fnames:
        # Each dump holds a whole batch: take the count from the first one.
        with open(fnames[0], "rb") as f:
            per_file = int(np.asarray(pickle.load(f)["A"]).shape[0])
    else:
        per_file = 1
    num_items = len(fnames) * per_file
    if max_items is not None:
        num_items = min(num_items, max_items)

    stats = FeatureStats(max_items=num_items, **stats_kwargs)
    progress = opts.progress.sub(tag="dataset features", num_items=num_items,
                                 rel_lo=rel_lo, rel_hi=rel_hi)
    detector = get_feature_detector(detector_url, opts.device)
    mode_name = (mode_dict or opts.mode_dict or {}).get("mode_name")
    if mode_name in ("MR_nonrigid_CT", None):
        key = "A"
    elif mode_name == "MR_MR_T2":
        key = "B"
    else:
        raise NotImplementedError(mode_name)

    for fname in fnames:
        with open(fname, "rb") as f:
            images = pickle.load(f)
        x = torch.as_tensor(np.asarray(images[key], np.float32), device=opts.device)
        stats.append(detector(_to_detector_batch(x, None)))
        progress.update(stats.num_items)
        if stats.is_full():
            break

    _cache_store(stats, cache_file)
    return stats


def _dataset_label_bank(opts, c_dim, max_items=10000):
    """Labels [N, c_dim] of the real dataset when opts.dataset_kwargs
    names a labelled training zip (`use_labels`), else None (uniform
    one-hot labels). Labels asked for and not readable raise: a uniform
    fallback would skew a conditional FID unseen."""
    dk = opts.dataset_kwargs
    if not dk or not dk.get("use_labels"):
        return None
    from ..models.stylegan2.dataset import CustomImageFolderDataset

    try:
        ds = CustomImageFolderDataset(path=dk["path"], modalities=dk.get("modalities", []),
                                      split=dk.get("split", "train"), use_labels=True)
        if not ds.has_labels or ds.label_dim != c_dim:
            raise RuntimeError(f"use_labels=True but the dataset's labels do not match G: "
                               f"label_shape={ds.label_shape} vs c_dim={c_dim} "
                               f"(path={dk.get('path')!r})")
        n = min(len(ds), max_items)
        return np.stack([ds.get_label(i) for i in range(n)]).astype(np.float32)
    except (OSError, KeyError, ValueError, zipfile.BadZipFile) as e:
        raise RuntimeError(f"use_labels=True but the dataset's labels could not be read "
                           f"from {dk.get('path')!r}: {e}") from e


def compute_feature_stats_for_generator(opts, detector_url, mode_dict=None, rel_lo=0,
                                        rel_hi=1, batch_size=64, batch_gen=None,
                                        **stats_kwargs):
    """Features of live generator samples: opts.G(z) with random noise at
    G_kwargs['truncation_psi'], z and noise from one generator seeded with
    G_kwargs['seed'] on G's device."""
    require_no_mesh(opts.mesh)
    G = opts.G
    c_dim = int(G.cfg.get("c_dim", 0) or 0)
    label_bank = _dataset_label_bank(opts, c_dim) if c_dim > 0 else None
    label_rng = np.random.RandomState(int(opts.G_kwargs.get("seed", 0)))
    if batch_gen is None:
        batch_gen = min(batch_size, 16)

    stats = FeatureStats(**stats_kwargs)
    if stats.max_items is None:
        raise ValueError("generator stats need max_items")
    progress = opts.progress.sub(tag="generator features", num_items=stats.max_items,
                                 rel_lo=rel_lo, rel_hi=rel_hi)
    detector = get_feature_detector(detector_url, opts.device)
    mode_idx = (mode_dict or opts.mode_dict or {}).get("mode_idx")
    psi = float(opts.G_kwargs.get("truncation_psi", 1.0))
    device = next(G.parameters()).device
    gen = torch.Generator(device=device).manual_seed(int(opts.G_kwargs.get("seed", 0)))

    while not stats.is_full():
        with torch.no_grad():
            z = torch.randn([batch_gen, G.cfg.z_dim], generator=gen, device=device)
            c = None
            if label_bank is not None:
                idx = label_rng.randint(0, label_bank.shape[0], batch_gen)
                c = torch.as_tensor(label_bank[idx], device=device)
            elif c_dim > 0:
                idx = torch.randint(0, c_dim, [batch_gen], generator=gen, device=device)
                c = torch.nn.functional.one_hot(idx, c_dim).float()
            img = G(z, c, truncation_psi=psi, noise_mode="random", generator=gen)
        stats.append(detector(_to_detector_batch(img.float(), mode_idx)))
        progress.update(stats.num_items)
    return stats


def compute_feature_stats_for_generated(opts, detector_url, **kwargs):
    """The generated side of a metric: dumped augmented batches where
    opts.dataset_kwargs_gen names them, else the live generator."""
    if opts.dataset_kwargs_gen:
        return compute_feature_stats_for_aug_dataset(opts, detector_url, **kwargs)
    return compute_feature_stats_for_generator(opts, detector_url, **kwargs)
