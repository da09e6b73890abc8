"""VCE dual-energy mammography dataset, LE / DES pairs
(counterpart: latentaugment_tpu/data/vce_dataset.py).

Rows of an annotation CSV give image file pairs with their window
centre / width. Each pair goes load (nrrd, npy or a grayscale image) ->
pad to square (R / L aware) -> contrast stretch to the window ->
min / max normalize -> bilinear resize -> optional paired augmentation
(shift / zoom / flip / rotate, each with p = 0.3, drawn from `random` in
the JAX package's order). `.nrrd` needs pynrrd and raises without it.
"""

import os
import random

import numpy as np
from PIL import Image

from ..utils import util_general
from .base_dataset import BaseDataset
from .table import read_table

try:
    import nrrd
except ImportError:
    nrrd = None


def load_img(img_path, format):
    if format == "nrrd":
        if nrrd is None:
            raise ImportError(
                "pynrrd is required for .nrrd files and is not installed; "
                "convert images to .npy/.png or install pynrrd.")
        img, _ = nrrd.read(img_path)
        return img
    if format == "npy":
        return np.load(img_path)
    # jpg/png -> grayscale float array
    return np.asarray(Image.open(img_path).convert("L"), dtype=np.float32)


def _format_of(path):
    ext = os.path.splitext(path)[1].lower()
    if ext == ".nrrd":
        return "nrrd"
    if ext == ".npy":
        return "npy"
    return "jpg"


def pad(img, r_l, pad_value=0):
    """Pad to square; R pads on the left, L pads on the right (breast side)."""
    max_size = max(img.shape[1], img.shape[0])
    min_size = min(img.shape[1], img.shape[0])
    num_zeros = max_size - min_size
    if img.shape[0] > img.shape[1]:
        if r_l == "R":
            img = np.pad(img, ((0, 0), (num_zeros, 0)), 'constant',
                         constant_values=pad_value)
        if r_l == "L":
            img = np.pad(img, ((0, 0), (0, num_zeros)), 'constant',
                         constant_values=pad_value)
    if img.shape[1] > img.shape[0]:
        img = np.pad(img, ((0, num_zeros), (0, 0)), 'constant',
                     constant_values=pad_value)
    return img


def _resize(img, wh):
    return np.asarray(Image.fromarray(np.asarray(img, np.float32), mode="F")
                      .resize(wh, Image.BILINEAR))


def clipped_zoom(img, zoom_factor):
    """Center zoom keeping the output size fixed (reference vce_dataset.py)."""
    height, width = img.shape[:2]
    new_height, new_width = int(height * zoom_factor), int(width * zoom_factor)

    y1, x1 = max(0, new_height - height) // 2, max(0, new_width - width) // 2
    y2, x2 = y1 + height, x1 + width
    bbox = (np.array([y1, x1, y2, x2]) / zoom_factor).astype(int)
    y1, x1, y2, x2 = bbox
    cropped = img[y1:y2, x1:x2]

    resize_height = min(new_height, height)
    resize_width = min(new_width, width)
    pad_h1 = (height - resize_height) // 2
    pad_w1 = (width - resize_width) // 2
    pad_h2 = (height - resize_height) - pad_h1
    pad_w2 = (width - resize_width) - pad_w1

    result = _resize(cropped, (resize_width, resize_height))
    result = np.pad(result, [(pad_h1, pad_h2), (pad_w1, pad_w2)],
                    mode='constant')
    assert result.shape[0] == height and result.shape[1] == width
    return result


def _shift(img, offsets):
    """scipy.ndimage.shift(mode='nearest') equivalent via roll + edge fill."""
    dy, dx = int(round(offsets[0])), int(round(offsets[1]))
    out = img
    if dy != 0:
        out = np.roll(out, dy, axis=0)
        if dy > 0:
            out[:dy] = out[dy:dy + 1]
        else:
            out[dy:] = out[dy - 1:dy]
    if dx != 0:
        out = np.roll(out, dx, axis=1)
        if dx > 0:
            out[:, :dx] = out[:, dx:dx + 1]
        else:
            out[:, dx:] = out[:, dx - 1:dx]
    return out


def _rotate(img, angle):
    """imutils.rotate equivalent: rotate about center, same output size."""
    return np.asarray(Image.fromarray(np.asarray(img, np.float32), mode="F")
                      .rotate(angle, resample=Image.BILINEAR))


def augmentation(img_x, img_y):
    """Paired shift/zoom/flip/rotate, each fired with p = 0.3."""
    r = random.randint(0, 100)
    if r > 70:
        shift_perc = 0.1
        r1 = random.randint(-int(shift_perc * img_x.shape[0]),
                            int(shift_perc * img_x.shape[0]))
        r2 = random.randint(-int(shift_perc * img_x.shape[1]),
                            int(shift_perc * img_x.shape[1]))
        img_x = _shift(img_x.copy(), [r1, r2])
        img_y = _shift(img_y.copy(), [r1, r2])
    r = random.randint(0, 100)
    if r > 70:
        zoom_factor = random.uniform(0.9, 1.1)
        img_x = clipped_zoom(img_x, zoom_factor)
        img_y = clipped_zoom(img_y, zoom_factor)
    r = random.randint(0, 100)
    if r > 70:
        img_x = img_x[:, ::-1].copy()
        img_y = img_y[:, ::-1].copy()
    r = random.randint(0, 100)
    if r > 70:
        angle = random.randint(-15, 15)
        img_x = _rotate(img_x, angle)
        img_y = _rotate(img_y, angle)
    return img_x, img_y


def contrast_stretching(img, ww, wc):
    pixel_min = wc - ww / 2
    pixel_max = wc + ww / 2
    img = np.where(img > pixel_min, img, pixel_min)
    img = np.where(img < pixel_max, img, pixel_max)
    return img


def loader(img_x_path, img_y_path, r_l, img_dim, ww_x, wc_x, ww_y, wc_y,
           do_augmentation, step="train"):
    img_x = load_img(img_x_path, _format_of(img_x_path))
    img_y = load_img(img_y_path, _format_of(img_y_path))

    img_x = pad(img_x, r_l)
    img_y = pad(img_y, r_l)

    img_x = contrast_stretching(img_x, ww_x, wc_x)
    img_y = contrast_stretching(img_y, ww_y, wc_y)

    img_x = (img_x - np.amin(img_x)) / max(np.amax(img_x) - np.amin(img_x), 1e-8)
    img_y = (img_y - np.amin(img_y)) / max(np.amax(img_y) - np.amin(img_y), 1e-8)

    img_x = _resize(img_x, (img_dim, img_dim))
    img_y = _resize(img_y, (img_dim, img_dim))

    if do_augmentation and step == "train":
        img_x, img_y = augmentation(img_x, img_y)

    img_x = np.asarray(img_x, np.float32)[None, :, :]
    img_y = np.asarray(img_y, np.float32)[None, :, :]
    return img_x, img_y


class VCEDataset(BaseDataset):
    @staticmethod
    def modify_commandline_options(parser, is_train):
        from ..options.base_options import str2bool

        parser.add_argument('--modalities', help="Dataset modalities", metavar="STRING",
                            type=str, default="LE,DES")
        parser.add_argument('--model_name', help="Model to use for training.",
                            default='pix2pix')
        parser.add_argument('--img_dim', help="Image output size.", type=int,
                            default=256)
        parser.add_argument('--img_dir', help="Image directory.", type=str,
                            default="")
        parser.add_argument('--annotations_csv', help="CSV with rows "
                            "[img_x, img_y, r_l, wc_x, ww_x, wc_y, ww_y].",
                            type=str, default="")
        parser.add_argument('--do_augmentation', help="CPU augmentation.",
                            type=str2bool, default=False)
        return parser

    def __init__(self, opt):
        BaseDataset.__init__(self, opt)
        self.model_name = opt.model_name
        self.step = getattr(opt, 'phase', 'train')
        self.img_dir = opt.img_dir or os.path.dirname(opt.dataroot)
        self.img_dim = opt.img_dim
        self.do_augmentation = opt.do_augmentation

        self.data = read_table(opt.annotations_csv or opt.dataroot)
        self.len_le_des = len(self.data)

        self._modalities = util_general.parse_comma_separated_list(opt.modalities)
        assert len(self._modalities) > 0

    def __getitem__(self, index):
        row = self.data[index]
        img_x_path = os.path.join(self.img_dir, row['img_x']).replace("\\", "/")
        img_y_path = os.path.join(self.img_dir, row['img_y']).replace("\\", "/")
        img_x, img_y = loader(
            img_x_path=img_x_path, img_y_path=img_y_path, r_l=row['r_l'],
            img_dim=self.img_dim, ww_x=row['ww_x'], wc_x=row['wc_x'],
            ww_y=row['ww_y'], wc_y=row['wc_y'],
            do_augmentation=self.do_augmentation, step=self.step)

        if self.model_name == 'pix2pix':
            return {'A': img_x, 'B': img_y,
                    'A_paths': img_x_path, 'B_paths': img_y_path}
        raise NotImplementedError(self.model_name)

    def __len__(self):
        return self.len_le_des
