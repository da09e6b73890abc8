"""Dataset registry and host-side batch loader (counterpart:
latentaugment_tpu/data/__init__.py).

`create_dataset(opt)` finds the class `<Name>Dataset` in
`data/<name>_dataset.py` and returns a loader that honours batch_size,
serial_batches and max_dataset_size. Batches are dicts of NumPy arrays
(NCHW float32) made on the host; the augment moves them to its device.
"""

import concurrent.futures as cf
import importlib
import math
import random

import numpy as np

from .base_dataset import BaseDataset

# --dataset_mode defaults to 'pelvis2.1', which is not a module name.
_DATASET_ALIASES = {"pelvis2.1": "pelvis", "pelvis2_1": "pelvis"}


def find_dataset_using_name(dataset_name):
    """The BaseDataset subclass of data/<dataset_name>_dataset.py whose
    lowercase name is '<datasetname>dataset'."""
    dataset_name = _DATASET_ALIASES.get(dataset_name, dataset_name)
    dataset_filename = __name__ + "." + dataset_name + "_dataset"
    datasetlib = importlib.import_module(dataset_filename)
    target = dataset_name.replace('_', '') + 'dataset'
    for name, cls in datasetlib.__dict__.items():
        if name.lower() == target and isinstance(cls, type) and issubclass(cls, BaseDataset):
            return cls
    raise NotImplementedError(
        f"In {dataset_filename}.py, there should be a subclass of BaseDataset "
        f"with class name that matches {target} in lowercase.")


def get_option_setter(dataset_name):
    """The <modify_commandline_options> static method of the dataset class."""
    return find_dataset_using_name(dataset_name).modify_commandline_options


def create_dataset(opt):
    """The batch loader for `opt` (main interface of this package)."""
    return CustomDatasetDataLoader(opt)


def _collate(samples):
    """Stack per-item dicts into a batch dict: arrays along a new leading
    axis, scalars into 1-D arrays, anything else (paths) into lists."""
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals, axis=0)
        elif isinstance(vals[0], (int, float, np.integer, np.floating)):
            out[key] = np.asarray(vals)
        else:
            out[key] = list(vals)
    return out


class CustomDatasetDataLoader:
    """Batched host loading. With prefetch > 0 (default 2) a thread pool
    loads and collates the next batches while the device works on the
    current one."""

    def __init__(self, opt):
        self.opt = opt
        self.dataset = find_dataset_using_name(opt.dataset_mode)(opt)
        print("dataset [%s] was created" % type(self.dataset).__name__)
        self.batch_size = opt.batch_size
        self.shuffle = not opt.serial_batches
        self.prefetch = int(getattr(opt, "prefetch_batches", 2))
        self._rng = random.Random(getattr(opt, "seed", 42))

    def __len__(self):
        return int(min(len(self.dataset), self.opt.max_dataset_size))

    def _batch_indices(self):
        """Index lists of the epoch's batches; the last may be partial."""
        order = list(range(len(self.dataset)))
        if self.shuffle:
            self._rng.shuffle(order)
        # max_dataset_size counts whole batches: a started batch is kept full.
        n_batches = math.ceil(min(len(order), self.opt.max_dataset_size) / self.batch_size)
        return [order[i * self.batch_size:(i + 1) * self.batch_size]
                for i in range(n_batches)]

    def _load_batch(self, indices):
        return _collate([self.dataset[i] for i in indices])

    def __iter__(self):
        batches = self._batch_indices()
        if self.prefetch <= 0 or len(batches) <= 1:
            for indices in batches:
                yield self._load_batch(indices)
            return
        with cf.ThreadPoolExecutor(max_workers=self.prefetch) as pool:
            futures = [pool.submit(self._load_batch, b) for b in batches[:self.prefetch]]
            nxt = self.prefetch
            for _ in range(len(batches)):
                batch = futures.pop(0).result()
                if nxt < len(batches):
                    futures.append(pool.submit(self._load_batch, batches[nxt]))
                    nxt += 1
                yield batch
