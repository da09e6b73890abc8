"""Dataset base class and the pix2pix-style host transforms
(counterpart: latentaugment_tpu/data/base_dataset.py).

The transforms work on NumPy HW / HWC arrays (PIL only for resampling),
composed as plain callables, and end in CHW float32 in [-1, 1]. Their
random draws come from the `random` module in the JAX package's order,
so one seed gives both packages the same crops and flips.
"""

import random
from abc import ABC, abstractmethod

import numpy as np
from PIL import Image


class BaseDataset(ABC):
    """Subclasses implement __init__, __len__, __getitem__ and, optionally,
    modify_commandline_options."""

    def __init__(self, opt):
        self.opt = opt
        self.root = getattr(opt, "dataroot", None)

    @staticmethod
    def modify_commandline_options(parser, is_train):
        """Add dataset-specific options and rewrite defaults."""
        return parser

    @abstractmethod
    def __len__(self):
        return 0

    @abstractmethod
    def __getitem__(self, index):
        pass


def get_params(opt, size):
    """Random crop position + flip draw for a (w, h) image under opt.preprocess."""
    w, h = size
    new_h = h
    new_w = w
    if opt.preprocess == 'resize_and_crop':
        new_h = new_w = opt.load_size
    elif opt.preprocess == 'scale_width_and_crop':
        new_w = opt.load_size
        new_h = opt.load_size * h // w

    x = random.randint(0, int(np.maximum(0, new_w - opt.crop_size)))
    y = random.randint(0, int(np.maximum(0, new_h - opt.crop_size)))
    flip = random.random() > 0.5
    return {'crop_pos': (x, y), 'flip': flip}


def _to_pil(img):
    if isinstance(img, Image.Image):
        return img
    arr = np.asarray(img)
    return Image.fromarray(arr)


def _resize(img, size_wh, method=Image.BICUBIC):
    return _to_pil(img).resize(size_wh, method)


def _scale_width(img, target_size, crop_size, method=Image.BICUBIC):
    img = _to_pil(img)
    ow, oh = img.size
    if ow == target_size and oh >= crop_size:
        return img
    w = target_size
    h = int(max(target_size * oh / ow, crop_size))
    return img.resize((w, h), method)


def _crop(img, pos, size):
    img = _to_pil(img)
    ow, oh = img.size
    x1, y1 = pos
    tw = th = size
    if ow > tw or oh > th:
        return img.crop((x1, y1, x1 + tw, y1 + th))
    return img


def _make_power_2(img, base, method=Image.BICUBIC):
    img = _to_pil(img)
    ow, oh = img.size
    h = int(round(oh / base) * base)
    w = int(round(ow / base) * base)
    if h == oh and w == ow:
        return img
    _print_size_warning(ow, oh, w, h)
    return img.resize((w, h), method)


def _flip(img, flip):
    if flip:
        return _to_pil(img).transpose(Image.FLIP_LEFT_RIGHT)
    return img


def _to_chw_normalized(img):
    """HWC/HW uint8-or-float -> CHW float32 in [-1, 1] (ToTensor+Normalize(0.5))."""
    arr = np.asarray(img, dtype=np.float32)
    if arr.ndim == 2:
        arr = arr[None, :, :]
    else:
        arr = arr.transpose(2, 0, 1)
    return arr / 127.5 - 1.0


def get_transform(opt, params=None, grayscale=False, method=Image.BICUBIC, convert=True):
    """Compose resize/scale/crop/flip/normalize steps as one callable."""
    steps = []
    if grayscale:
        steps.append(lambda img: _to_pil(img).convert('L'))
    if 'resize' in opt.preprocess:
        osize = (opt.load_size, opt.load_size)
        steps.append(lambda img: _resize(img, osize, method))
    elif 'scale_width' in opt.preprocess:
        steps.append(lambda img: _scale_width(img, opt.load_size, opt.crop_size, method))

    if 'crop' in opt.preprocess:
        if params is None:
            def _rand_crop(img):
                img = _to_pil(img)
                ow, oh = img.size
                x = random.randint(0, max(0, ow - opt.crop_size))
                y = random.randint(0, max(0, oh - opt.crop_size))
                return _crop(img, (x, y), opt.crop_size)
            steps.append(_rand_crop)
        else:
            steps.append(lambda img: _crop(img, params['crop_pos'], opt.crop_size))

    if opt.preprocess == 'none':
        steps.append(lambda img: _make_power_2(img, base=4, method=method))

    # Without a no_flip option the flip is on: the pix2pix convention.
    if not getattr(opt, 'no_flip', False):
        if params is None:
            steps.append(lambda img: _flip(img, random.random() > 0.5))
        elif params['flip']:
            steps.append(lambda img: _flip(img, True))

    if convert:
        steps.append(_to_chw_normalized)

    def apply(img):
        for step in steps:
            img = step(img)
        return img

    return apply


def _print_size_warning(ow, oh, w, h):
    if not hasattr(_print_size_warning, 'has_printed'):
        print("The image size needs to be a multiple of 4. "
              "The loaded image size was (%d, %d), so it was adjusted to "
              "(%d, %d). This adjustment will be done to all images "
              "whose sizes are not multiples of 4" % (ow, oh, w, h))
        _print_size_warning.has_printed = True
