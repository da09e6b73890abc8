"""pix2pix-style image helpers (counterpart:
latentaugment_tpu/utils/util_pix2pix.py): tensor2im, save_image and the
diagnostics a downstream image-to-image loop uses on the augmented
batches. Arrays or tensors in (tensors are copied to the host), numpy
and files out."""

import os

import numpy as np
import torch
from PIL import Image


def _numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def tensor2im(input_image, imtype=np.uint8):
    """[-1,1] CHW (or NCHW, first item) array -> HWC uint8 image."""
    img = _numpy(input_image)
    if img.ndim == 4:
        img = img[0]
    if img.ndim == 3:
        img = np.transpose(img, (1, 2, 0))
    img = (img + 1) / 2.0 * 255.0
    img = np.clip(img, 0, 255)
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    return img.astype(imtype)


def save_image(image_numpy, image_path, aspect_ratio=1.0):
    """Save an HWC uint8 array to disk (optional aspect-ratio resize)."""
    pil = Image.fromarray(image_numpy)
    h, w = image_numpy.shape[:2]
    if aspect_ratio > 1.0:
        pil = pil.resize((int(w * aspect_ratio), h), Image.BICUBIC)
    elif aspect_ratio < 1.0:
        pil = pil.resize((w, int(h / aspect_ratio)), Image.BICUBIC)
    pil.save(image_path)


def diagnose_network(tree, name="network"):
    """Mean over the leaves of each leaf's mean absolute value. `tree` is
    an nn.Module (its state_dict, in order), a state dict or a nested dict
    of arrays or tensors."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    vals = []

    def visit(node):
        if isinstance(node, dict):
            for v in node.values():
                visit(v)
        else:
            vals.append(float(np.mean(np.abs(_numpy(node)))))

    visit(tree)
    mean = float(np.mean(vals)) if vals else 0.0
    print(f"{name}: mean |leaf| = {mean}")
    return mean


def print_numpy(x, val=True, shp=False):
    x = _numpy(x).astype(np.float64)
    if shp:
        print("shape,", x.shape)
    if val:
        x = x.flatten()
        print("mean = %3.3f, min = %3.3f, max = %3.3f, median = %3.3f, "
              "std=%3.3f" % (np.mean(x), np.min(x), np.max(x),
                             np.median(x), np.std(x)))


def mkdir(path):
    """Create a directory if absent."""
    os.makedirs(path, exist_ok=True)


def mkdirs(paths):
    """Create each directory in a list (or the one path given)."""
    if isinstance(paths, list) and not isinstance(paths, str):
        for p in paths:
            mkdir(p)
    else:
        mkdir(paths)
