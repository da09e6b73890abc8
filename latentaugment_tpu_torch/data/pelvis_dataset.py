"""Paired MR/CT pelvis dataset from a zip of per-slice pickle dicts
(counterpart: latentaugment_tpu/data/pelvis_dataset.py).

Each zip member `<split>/<patient>/<slice>.pickle` holds a dict keyed by
modality name with HxW arrays in [0, 255]. An item is the two modalities
MR_nonrigid_CT (A) and MR_MR_T2 (B), each [1, H, W] float32 in [-1, 1].
"""

import os
import pickle
import zipfile

import numpy as np

from ..utils import util_general
from .base_dataset import BaseDataset


def normalize_m11(x):
    """[0,255] -> [-1,1] float32: (x - 127.5) / 127.5."""
    return (np.asarray(x, dtype=np.float32) - 127.5) / 127.5


class PelvisDataset(BaseDataset):
    """Paired medical images (MR_nonrigid_CT / MR_MR_T2)."""

    @staticmethod
    def modify_commandline_options(parser, is_train):
        parser.add_argument('--modalities', help="Dataset modalities", metavar="STRING",
                            type=str, default="MR_nonrigid_CT,MR_MR_T2")
        return parser

    def __init__(self, opt):
        BaseDataset.__init__(self, opt)
        self._path = opt.dataroot
        self._modalities = util_general.parse_comma_separated_list(opt.modalities)
        assert len(self._modalities) > 0
        self._mode_to_idx = {mode: i for i, mode in enumerate(self._modalities)}
        if os.path.splitext(self._path)[1].lower() != ".zip":
            raise IOError("Path must point to a zip")
        self._zipfile = zipfile.ZipFile(self._path)
        # The split is the member's leading path component.
        self.AB_paths = sorted(
            fname for fname in self._zipfile.namelist()
            if os.path.splitext(fname)[1].lower() == ".pickle"
            and fname.replace("\\", "/").split("/")[0] == opt.phase)
        if len(self.AB_paths) == 0:
            raise IOError("No image files found in the specified path")

    def __getitem__(self, index):
        """{'A', 'B', 'A_paths', 'B_paths'}: CHW float32 images in [-1, 1]."""
        AB_path = self.AB_paths[index]
        with self._zipfile.open(AB_path, "r") as f:
            p = pickle.load(f)
        shape = (self.opt.load_size, self.opt.load_size)
        A, B = (np.asarray(p[m], dtype=np.float32) for m in ('MR_nonrigid_CT', 'MR_MR_T2'))
        assert A.shape == shape and B.shape == shape, (A.shape, B.shape, shape)
        for m in self._modalities:
            assert np.asarray(p[m]).shape == shape
        return {'A': normalize_m11(A)[None], 'B': normalize_m11(B)[None],
                'A_paths': AB_path, 'B_paths': AB_path}

    def __len__(self):
        return len(self.AB_paths)
