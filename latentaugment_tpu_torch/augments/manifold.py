"""Manifold datasets, statistics and the crop pipeline
(counterpart: latentaugment_tpu/augments/manifold.py).

  * `LatentCodeDataset` / `ImgDataset`: zip-of-pickles readers
    (`<split>/<patient>/<slice>.pickle`), host side, NumPy.
  * `DatasetStats`: accumulator with the per-patient slice-ID schedule
    (ids 00010..00120, step N) and pickle caching.
  * the crop pipeline: centre crop to res/sqrt(2), then a crop of
    crop_size at a position drawn on the host, as tensor slicing.
"""

import os
import pickle
import random
import zipfile

import numpy as np

from ..utils import util_path


# ----------------------------------------------------------------------------
# Stats accumulator

class DatasetStats:
    """Accumulates manifold items (latents / images / features) host-side.
    The schedule keeps one slice every `step` per patient (file ids
    00010..00120)."""

    NDIM = {"latent": 3, "features_jit": 2, "img": 4}

    def __init__(self, manifold, capture_all=False, max_items=None, step=1):
        if manifold not in self.NDIM:
            raise NotImplementedError(f"Unrecognised manifold {manifold!r}")
        self.manifold = manifold
        self.capture_all = capture_all
        self.max_items = max_items
        self.num_items = 0
        self.step = step
        self.all_x = []
        self.schedule = sorted(f"{i:05d}" for i in np.arange(10, 121, step))
        self.ndim = self.NDIM[manifold]

    def is_full(self):
        return self.max_items is not None and self.num_items >= self.max_items

    def admits(self, fname):
        """Whether append() would keep an item of this file name."""
        if self.capture_all:
            return True
        *_, last = util_path.split_dos_path_into_components(fname)
        return util_path.get_filename_without_extension(last)[-5:] in self.schedule

    def append(self, x, fname=None):
        """Add a [1, ...] item; returns #added, 0 if filtered, -1 if full."""
        x = np.asarray(x, dtype=np.float32)
        if x.ndim != self.ndim:
            raise ValueError(f"{self.manifold} item must be {self.ndim}-D, got {x.shape}")
        if self.max_items is not None and self.num_items + x.shape[0] > self.max_items:
            if self.num_items >= self.max_items:
                return -1
            x = x[: self.max_items - self.num_items]
        if fname is not None and not self.admits(fname):
            return 0
        self.all_x.append(x)
        self.num_items += x.shape[0]
        return x.shape[0]

    def get_all(self):
        return np.concatenate(self.all_x, axis=0)

    def save(self, pkl_file):
        with open(pkl_file, "wb") as f:
            pickle.dump(self.__dict__, f, pickle.HIGHEST_PROTOCOL)

    @staticmethod
    def load(pkl_file):
        # The cache file is one this program wrote (save above).
        with open(pkl_file, "rb") as f:
            d = pickle.load(f)
        obj = DatasetStats(manifold=d["manifold"], capture_all=d["capture_all"],
                           max_items=d["max_items"], step=d["step"])
        obj.__dict__.update(d)
        return obj


# ----------------------------------------------------------------------------
# Zip-backed datasets

class _ZipDataset:
    def __init__(self, path, split):
        self._path = path
        self._zipfile = None
        if os.path.splitext(path)[1].lower() != ".zip":
            raise IOError("Path must point to a zip")
        self._fnames = sorted(
            f for f in self._get_zipfile().namelist()
            if os.path.splitext(f)[1].lower() == ".pickle" and split in f)
        if not self._fnames:
            raise IOError("No files found in the specified path")

    def _get_zipfile(self):
        if self._zipfile is None:
            self._zipfile = zipfile.ZipFile(self._path)
        return self._zipfile

    def open_file(self, fname):
        return self._get_zipfile().open(fname, "r")

    def __len__(self):
        return len(self._fnames)


class LatentCodeDataset(_ZipDataset):
    """Inverted w+ codes, one [num_ws, w_dim] pickle per slice."""

    def __init__(self, path, split, w_dim=512, num_ws=14):
        super().__init__(path, split)
        w0, _ = self[0]
        if w_dim is not None and w0.shape[1] != w_dim:
            raise IOError("W does not match the specified latent dimension.")
        if num_ws is not None and w0.shape[0] != num_ws:
            raise IOError("W does not match the specified broadcasting.")

    def __getitem__(self, idx):
        fname = self._fnames[idx]
        with self.open_file(fname) as f:
            w = pickle.load(f)
        return np.asarray(w, dtype=np.float32), fname


class ImgDataset(_ZipDataset):
    """Multimodal images: pickle dict keyed by modality -> [M, H, W] float32."""

    def __init__(self, path, split, modalities, resolution=256):
        self._modalities = list(modalities)
        if not self._modalities:
            raise ValueError("no modalities")
        super().__init__(path, split)
        img0, _ = self[0]
        if resolution is not None and img0.shape[1:] != (resolution, resolution):
            raise IOError("Image files do not match the specified resolution")

    def __getitem__(self, idx):
        fname = self._fnames[idx]
        with self.open_file(fname) as f:
            p = pickle.load(f)
        out = np.stack([np.asarray(p[m], dtype=np.float32) for m in self._modalities])
        return out, fname


# ----------------------------------------------------------------------------
# Crop pipeline

def center_crop_size(load_size):
    """res -> floor(sqrt(res^2 / 2)) (the res/sqrt(2) centre crop)."""
    return int(np.sqrt((load_size * load_size) / 2))


def get_params(load_size, crop_size, preprocess="center_random_crop", rng=None):
    """Draw a crop position on the host. 'center_crop' and 'original' draw
    nothing (fixed (0, 0), which get_transform ignores for them)."""
    if preprocess in ("center_crop", "original"):
        return {"crop_pos": (0, 0)}
    if preprocess not in ("center_random_crop", "random_crop"):
        raise ValueError(f"unknown preprocess {preprocess!r}")
    new = center_crop_size(load_size) if preprocess == "center_random_crop" else load_size
    hi = max(0, new - crop_size)
    r = rng if rng is not None else random
    return {"crop_pos": (r.randint(0, hi), r.randint(0, hi))}


def center_crop(x, load_size=None):
    """Centre crop of NCHW x to center_crop_size(H). The offset rounds
    half to even, torchvision's convention: at 256 the crop is 181 and
    (256 - 181) / 2 = 37.5 gives top = 38."""
    h = x.shape[-2]
    size = center_crop_size(load_size or h)
    top = int(round((h - size) / 2.0))
    left = int(round((x.shape[-1] - size) / 2.0))
    return x[..., top:top + size, left:left + size]


def crop(x, pos, size):
    """Crop NCHW x at (x, y) = pos to size x size (pos: host ints)."""
    px, py = (int(p) for p in pos)
    if x.shape[-1] <= size and x.shape[-2] <= size:
        return x
    return x[..., py:py + size, px:px + size]


def get_transform(load_size, crop_size, preprocess, params=None):
    """Compose the augmentation crop as one callable."""
    def apply(x, crop_pos=None):
        if preprocess in ("center_crop", "center_random_crop"):
            x = center_crop(x, load_size)
        if preprocess in ("random_crop", "center_random_crop"):
            pos = crop_pos if crop_pos is not None else (
                params["crop_pos"] if params else (0, 0))
            x = crop(x, pos, crop_size)
        return x
    return apply
