"""The trainer's multimodal dataset (counterpart:
latentaugment_tpu/models/stylegan2/dataset.py, and InfiniteSampler from
latentaugment_tpu/utils/util_misc.py), the port's own copy: host-only
numpy, no torch.

`Dataset` is the base with max_size / xflip / labels handling;
`CustomImageFolderDataset` reads a zip of per-slice `.pickle` dicts keyed
by modality into float32 CHW multi-channel images, filters file names by
the split substring, subsets each patient to `perc_size`, and reads the
labels of `dataset.json` (an int per file becomes a one-hot vector).
`InfiniteSampler` yields dataset indices forever, shuffled within a
sliding window.
"""

import json
import os
import pickle
import zipfile

import numpy as np


class Dataset:
    """Base dataset: raw_idx management, optional xflip doubling, labels."""

    def __init__(self, name, raw_shape, max_size=None, use_labels=False,
                 xflip=False, random_seed=0):
        self.name = name
        self._raw_shape = list(raw_shape)
        self._use_labels = use_labels
        self._raw_labels = None
        self._label_shape = None

        self._raw_idx = np.arange(self._raw_shape[0], dtype=np.int64)
        if max_size is not None and self._raw_idx.size > max_size:
            np.random.RandomState(random_seed).shuffle(self._raw_idx)
            self._raw_idx = np.sort(self._raw_idx[:max_size])

        self._xflip = np.zeros(self._raw_idx.size, dtype=np.uint8)
        if xflip:
            self._raw_idx = np.tile(self._raw_idx, 2)
            self._xflip = np.concatenate(
                [self._xflip, np.ones_like(self._xflip)])

    def _get_raw_labels(self):
        if self._raw_labels is None:
            self._raw_labels = (self._load_raw_labels()
                                if self._use_labels else None)
            if self._raw_labels is None:
                self._raw_labels = np.zeros([self._raw_shape[0], 0],
                                            dtype=np.float32)
        return self._raw_labels

    def _load_raw_image(self, raw_idx):
        raise NotImplementedError

    def _load_raw_labels(self):
        raise NotImplementedError

    def __len__(self):
        return self._raw_idx.size

    def __getitem__(self, idx):
        image = self._load_raw_image(self._raw_idx[idx])
        if list(image.shape) != self.image_shape:
            raise ValueError(f"image {idx} has shape {list(image.shape)}, the dataset "
                             f"{self.image_shape}")
        if self._xflip[idx]:
            image = image[:, :, ::-1]
        return image.copy(), self.get_label(idx)

    def get_label(self, idx):
        label = self._get_raw_labels()[self._raw_idx[idx]]
        if label.dtype == np.int64:
            onehot = np.zeros(self.label_shape, dtype=np.float32)
            onehot[label] = 1
            label = onehot
        return label.copy()

    @property
    def image_shape(self):
        return list(self._raw_shape[1:])

    @property
    def num_channels(self):
        return self.image_shape[0]

    @property
    def resolution(self):
        if self.image_shape[1] != self.image_shape[2]:
            raise ValueError(f"images of {self.image_shape[1:]} are not square")
        return self.image_shape[1]

    @property
    def label_shape(self):
        if self._label_shape is None:
            raw_labels = self._get_raw_labels()
            if raw_labels.dtype == np.int64:
                self._label_shape = [int(np.max(raw_labels)) + 1]
            else:
                self._label_shape = raw_labels.shape[1:]
        return list(self._label_shape)

    @property
    def label_dim(self):
        if len(self.label_shape) != 1:
            raise ValueError(f"labels of shape {self.label_shape} are not vectors")
        return self.label_shape[0]

    @property
    def has_labels(self):
        return any(x != 0 for x in self.label_shape)


class CustomImageFolderDataset(Dataset):
    """Zip of `<split>/<patient>/<slice>.pickle` modality dicts."""

    def __init__(self, path, modalities, split="train", resolution=None,
                 perc_size=None, **super_kwargs):
        self._path = path
        self._modalities = list(modalities)
        self._split = split
        self._zipfile = None

        if os.path.splitext(path)[1].lower() != ".zip":
            raise IOError("Path must point to a zip")
        self._all_fnames = set(self._get_zipfile().namelist())
        self._image_fnames = sorted(
            f for f in self._all_fnames
            if os.path.splitext(f)[1].lower() == ".pickle" and split in f)
        if len(self._image_fnames) == 0:
            raise IOError("No image files found in the specified path")

        if perc_size is not None and 0 < perc_size < 1:
            self._image_fnames = self._subset_per_patient(self._image_fnames,
                                                          perc_size)

        name = os.path.splitext(os.path.basename(path))[0]
        raw_shape = [len(self._image_fnames)] + \
            list(self._load_raw_image(0).shape)
        if resolution is not None and (raw_shape[2] != resolution
                                       or raw_shape[3] != resolution):
            raise IOError("Image files do not match the specified resolution")
        super().__init__(name=name, raw_shape=raw_shape, **super_kwargs)

    @staticmethod
    def _patient_of(fname):
        parts = fname.replace("\\", "/").split("/")
        return parts[-2] if len(parts) >= 2 else ""

    def _subset_per_patient(self, fnames, perc):
        """Keep the first `perc` fraction of slices of every patient
        (as the JAX package's copy does)."""
        by_patient = {}
        for f in fnames:
            by_patient.setdefault(self._patient_of(f), []).append(f)
        keep = []
        for patient, fs in by_patient.items():
            n = max(1, int(round(len(fs) * perc)))
            keep.extend(sorted(fs)[:n])
        return sorted(keep)

    def _get_zipfile(self):
        if self._zipfile is None:
            self._zipfile = zipfile.ZipFile(self._path)
        return self._zipfile

    def _open_file(self, fname):
        return self._get_zipfile().open(fname, "r")

    def _load_raw_image(self, raw_idx):
        fname = self._image_fnames[raw_idx]
        with self._open_file(fname) as f:
            p = pickle.load(f)
        first = np.asarray(p[self._modalities[0]], dtype=np.float32)
        out = np.zeros((len(self._modalities),) + first.shape, dtype=np.float32)
        for i, mode in enumerate(self._modalities):
            out[i] = np.asarray(p[mode], dtype=np.float32)
        return out

    def _load_raw_labels(self):
        fname = "dataset.json"
        if fname not in self._all_fnames:
            return None
        with self._open_file(fname) as f:
            labels = json.load(f)["labels"]
        if labels is None:
            return None
        labels = dict(labels)
        labels = [labels[f.replace("\\", "/")] for f in self._image_fnames]
        labels = np.array(labels)
        return labels.astype({1: np.int64, 2: np.float32}[labels.ndim])


class InfiniteSampler:
    """Dataset indices forever, shuffled within a sliding window (the
    torch trainer's sampler); `rank` / `num_replicas` stride the stream."""

    def __init__(self, dataset_size, rank=0, num_replicas=1, shuffle=True,
                 seed=0, window_size=0.5):
        if dataset_size <= 0 or not 0 <= rank < num_replicas or not 0 <= window_size <= 1:
            raise ValueError(f"bad sampler arguments: size {dataset_size}, rank {rank} "
                             f"of {num_replicas}, window {window_size}")
        self.dataset_size = dataset_size
        self.rank = rank
        self.num_replicas = num_replicas
        self.shuffle = shuffle
        self.seed = seed
        self.window_size = window_size

    def __iter__(self):
        order = np.arange(self.dataset_size)
        rnd = None
        window = 0
        if self.shuffle:
            rnd = np.random.RandomState(self.seed)
            rnd.shuffle(order)
            window = int(np.rint(order.size * self.window_size))

        idx = 0
        while True:
            i = idx % order.size
            if idx % self.num_replicas == self.rank:
                yield order[i]
            if window >= 2:
                j = (i - rnd.randint(window)) % order.size
                order[i], order[j] = order[j], order[i]
            idx += 1
