"""Mayo Clinic low-dose / high-dose CT dataset
(counterpart: latentaugment_tpu/data/mayoclinic_dataset.py).

An annotation CSV (data/create_csv_mayoclinic.py) lists slices with
'domain' (LD / HD) and 'path_slice'. Each slice goes DICOM read -> HU
(slope / intercept) -> clip to [lower, upper] -> [-1, 1] -> bilinear
resize to img_shape. `.npy` slices (already in HU) load with numpy;
DICOM needs pydicom and raises without it.
"""

import numpy as np
from PIL import Image

from ..utils import util_general, util_path
from .base_dataset import BaseDataset
from .table import read_table

try:
    import pydicom
except ImportError:
    pydicom = None


def convert_hu_img(dicom_file):
    img = dicom_file.pixel_array
    intercept = dicom_file.RescaleIntercept
    slope = dicom_file.RescaleSlope
    return slope * img + intercept


def clip_img(hu_img, lower, upper):
    return np.clip(hu_img, lower, upper)


def normalize_img(x, lower, upper, data_range='-11'):
    if lower is None:
        lower = np.min(x)
    if upper is None:
        upper = np.max(x)
    x_norm = (x - lower) / (upper - lower)
    if data_range == '01':
        return x_norm
    return (2 * x_norm) - 1


def resize_img(x, shape):
    """Bilinear resize of an HW float array (cv2.resize's default)."""
    return np.asarray(
        Image.fromarray(np.asarray(x, dtype=np.float32), mode="F")
        .resize((shape, shape), Image.BILINEAR))


class MayoClinicDataset(BaseDataset):
    @staticmethod
    def modify_commandline_options(parser, is_train):
        from ..options.base_options import str2bool

        parser.add_argument('--modalities', help="Dataset modalities", metavar="STRING", type=str, default="HD,LD")
        parser.add_argument('--lower', help="Lower value for hu clip.", type=int, default=-1000)
        parser.add_argument('--upper', help="Upper value for hu clip.", type=int, default=2000)
        parser.add_argument('--img_shape', help="Image shape for resize.", type=int, default=256)
        parser.add_argument('--plot_verbose', help="Plot images.", type=str2bool, default=False)
        parser.add_argument('--model_name', help="Model to use for training.", default='pix2pix')
        return parser

    def __init__(self, opt):
        BaseDataset.__init__(self, opt)
        self._path = opt.dataroot
        self.lower = opt.lower
        self.upper = opt.upper
        self.img_shape = opt.img_shape
        self.model_name = opt.model_name

        rows = read_table(self._path, index_col=True)
        self.paths_ld = [r['path_slice'] for r in rows if r['domain'] == 'LD']
        self.paths_hd = [r['path_slice'] for r in rows if r['domain'] == 'HD']
        if len(self.paths_ld) == 0 or len(self.paths_hd) == 0:
            raise IOError("No image files found in the specified path.")
        if len(self.paths_ld) != len(self.paths_hd):
            raise IOError("Uncoupled dataset.")
        self.len_lw = len(self.paths_ld)

        self._modalities = util_general.parse_comma_separated_list(opt.modalities)
        assert len(self._modalities) > 0

    def __getitem__(self, index):
        A_paths = self.paths_hd[index]  # high dose
        B_paths = self.paths_ld[index]  # low dose
        if not (A_paths.endswith('.npy') and B_paths.endswith('.npy')):
            # DICOM names carry the slice id in their fourth dotted field.
            A_id = util_path.get_filename(A_paths).split('.')[3]
            B_id = util_path.get_filename(B_paths).split('.')[3]
            assert A_id == B_id

        A = self.transforms(self._load_hu(A_paths))
        B = self.transforms(self._load_hu(B_paths))
        if self.model_name == 'pix2pix':
            return {'A': A, 'B': B, 'A_paths': A_paths, 'B_paths': B_paths}
        raise NotImplementedError(self.model_name)

    def __len__(self):
        return self.len_lw

    def _load_hu(self, path):
        """A slice in HU from DICOM (pydicom) or .npy."""
        if path.endswith('.npy'):
            return np.load(path)
        if pydicom is None:
            raise ImportError(
                "pydicom is required to read DICOM slices and is not "
                "installed in this environment; convert slices to .npy (HU "
                "units) or install pydicom.")
        return convert_hu_img(pydicom.dcmread(path))

    def transforms(self, hu_img):
        x = clip_img(hu_img, self.lower, self.upper)
        x = normalize_img(x, self.lower, self.upper)
        x = resize_img(x, self.img_shape)
        return np.asarray(x, dtype=np.float32)[None, :, :]
