"""Geometric (classical) augmentation policy (counterpart:
latentaugment_tpu/augments/geometric_aug.py).

RandomHorizontalFlip, RandomAffine (degrees / translate, reflection
padding) and RandomElasticTransform in kornia's conventions, each
applied per sample with probability `1 - p_thres` and composed in that
order, on the whole batch on `--device`. `F.grid_sample(padding_mode=
'reflection', align_corners=False)` samples the warped grids; randomness
comes from one explicit torch.Generator seeded with `--seed`.
"""

import math
import time

import numpy as np
import torch
import torch.nn.functional as F

from . import engine as engine_mod
from .base_aug import BaseAugment
from .latent_aug import check_slice, sanity_check


def _identity_grid(h, w, device):
    """[H, W, 2] normalized (x, y) sampling grid, align_corners=False."""
    ys = (torch.arange(h, device=device, dtype=torch.float32) + 0.5) / h * 2.0 - 1.0
    xs = (torch.arange(w, device=device, dtype=torch.float32) + 0.5) / w * 2.0 - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def _gaussian_kernel1d(kernel_size, sigma):
    x = np.arange(kernel_size, dtype=np.float32) - (kernel_size - 1) / 2.0
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _bernoulli(generator, p, n, device):
    return torch.rand([n], generator=generator, device=device) < p


def _uniform(generator, shape, lo, hi, device):
    return torch.rand(shape, generator=generator, device=device) * (hi - lo) + lo


def random_hflip(generator, x, p):
    """Per-sample horizontal flip with probability p."""
    mask = _bernoulli(generator, p, x.shape[0], x.device)
    return torch.where(mask[:, None, None, None], x.flip(-1), x)


def _normal_transform_pixel(h, w, device):
    """kornia's normal_transform_pixel: pixel coordinates -> [-1, 1] with
    (size - 1) denominators, which kornia uses even though the final
    grid_sample runs with align_corners=False. Reproduced as it is."""
    return torch.tensor([[2.0 / (w - 1), 0.0, -1.0],
                         [0.0, 2.0 / (h - 1), -1.0],
                         [0.0, 0.0, 1.0]], dtype=torch.float32, device=device)


def affine_theta(angle_deg, translate_px, h, w, device, dtype=torch.float32):
    """[N, 3, 3] map from normalized output positions to normalized source
    positions of kornia RandomAffine on fixed parameters: rotation about
    the image centre ((W-1)/2, (H-1)/2) with the angle negated, pixel
    translations added to the matrix's last column, the homography
    normalized and inverted as warp_affine does. float32 as in the JAX
    package; `dtype` is there for a check of what float32 costs."""
    ang = -torch.as_tensor(angle_deg, dtype=dtype, device=device) * (math.pi / 180.0)
    translate_px = torch.as_tensor(translate_px, dtype=dtype, device=device)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    cos, sin = torch.cos(ang), torch.sin(ang)
    tx, ty = translate_px[:, 0], translate_px[:, 1]
    zeros, ones = torch.zeros_like(cos), torch.ones_like(cos)
    m = torch.stack([
        torch.stack([cos, sin, (1.0 - cos) * cx - sin * cy + tx], dim=-1),
        torch.stack([-sin, cos, sin * cx + (1.0 - cos) * cy + ty], dim=-1),
        torch.stack([zeros, zeros, ones], dim=-1),
    ], dim=-2)  # [N, 3, 3] src -> dst pixel homography
    norm = _normal_transform_pixel(h, w, device).to(dtype)
    dst_norm_trans_src_norm = norm[None] @ m @ torch.linalg.inv(norm)[None]
    return torch.linalg.inv(dst_norm_trans_src_norm)  # dst norm -> src norm


def affine_positions(theta, h, w):
    """[N, H, W, 2] normalized (x, y) source positions of every output
    pixel under theta (affine_theta)."""
    base = _identity_grid(h, w, theta.device).to(theta.dtype)
    gxy1 = torch.cat([base, torch.ones([h, w, 1], device=theta.device, dtype=theta.dtype)],
                     dim=-1)
    return torch.einsum('nij,hwj->nhwi', theta, gxy1)[..., :2]


def affine_warp(x, angle_deg, translate_px):
    """Deterministic core of kornia RandomAffine on fixed parameters:
    affine_theta, the affine grid, and grid_sample with
    align_corners=False and reflection padding.
    angle_deg: [N] degrees; translate_px: [N, 2] (dx, dy) in pixels.

    theta is made in float32, as in the JAX package (with theta made in
    float64 the port leaves the reference by more than 1e-5 at 32x32).
    Its two 3x3 inverses differ between devices in the last place, which
    at 256x256 moves a sampling position by some 1e-5 of a pixel, and an
    image by that much times its slope: under 1e-5 of the range on smooth
    images, 1e-4 on white noise (chip_smoke.py measures theta, positions
    and both images, and that a float64 theta removes the difference)."""
    h, w = x.shape[2:]
    src = affine_positions(affine_theta(angle_deg, translate_px, h, w, x.device), h, w)
    return F.grid_sample(x, src.to(x.dtype), mode='bilinear', padding_mode='reflection',
                         align_corners=False)


def random_affine(generator, x, p, degrees, translate):
    """Per-sample rotation (+-degrees) and translation (+-translate as a
    fraction): dx ~ U(-t*W, t*W) pixels, dy ~ U(-t*H, t*H) pixels."""
    n, c, h, w = x.shape
    angle = _uniform(generator, [n], -degrees, degrees, x.device)
    tx = _uniform(generator, [n], -translate, translate, x.device) * w
    ty = _uniform(generator, [n], -translate, translate, x.device) * h
    apply = _bernoulli(generator, p, n, x.device)
    warped = affine_warp(x, angle, torch.stack([tx, ty], dim=-1))
    return torch.where(apply[:, None, None, None], warped, x)


def elastic_warp(x, noise, kernel_size=63, sigma=32.0, alpha=1.0):
    """Deterministic core of kornia elastic_transform2d on a fixed noise
    field [N, 2, H, W]: Gaussian-smooth the two displacement channels with
    zero padding (two 1-D passes; the normalized 2-D kernel is their outer
    product), scale by alpha, add to kornia's create_meshgrid grid
    (linspace(-1, 1, size), the align_corners=True spacing, reproduced as
    it is), clamp to [-1, 1], and grid_sample with align_corners=False and
    reflection padding."""
    n, c, h, w = x.shape
    dev = x.device
    kern = torch.as_tensor(_gaussian_kernel1d(kernel_size, sigma), device=dev)
    pad = kernel_size // 2
    kx = kern.reshape(1, 1, 1, kernel_size).repeat(2, 1, 1, 1)
    ky = kern.reshape(1, 1, kernel_size, 1).repeat(2, 1, 1, 1)
    noise = torch.as_tensor(noise, dtype=torch.float32, device=dev)
    smooth = F.conv2d(noise, kx, padding=(0, pad), groups=2)
    smooth = F.conv2d(smooth, ky, padding=(pad, 0), groups=2)
    disp = smooth * alpha
    xs = torch.linspace(-1.0, 1.0, w, device=dev)
    ys = torch.linspace(-1.0, 1.0, h, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    grid = torch.stack([gx, gy], dim=-1)[None] + disp.permute(0, 2, 3, 1)
    grid = grid.clamp(-1.0, 1.0)
    return F.grid_sample(x, grid.to(x.dtype), mode='bilinear', padding_mode='reflection',
                         align_corners=False)


def random_elastic(generator, x, p, kernel_size=63, sigma=32.0, alpha=1.0):
    """Per-sample elastic warp; noise ~ U(-1, 1) per displacement channel."""
    n = x.shape[0]
    noise = _uniform(generator, [n, 2, *x.shape[2:]], -1.0, 1.0, x.device)
    warped = elastic_warp(x, noise, kernel_size, sigma, alpha)
    apply = _bernoulli(generator, p, n, x.device)
    return torch.where(apply[:, None, None, None], warped, x)


class GeometricAugment(BaseAugment):
    @staticmethod
    def modify_commandline_options(parser, is_train):
        from ..options.base_options import str2bool

        parser.add_argument('--device', type=str, default='cuda', help='torch device of the transforms (cuda, cuda:N or cpu); cuda without CUDA raises')
        parser.add_argument('--p_thres', type=float, default=0.5, help='Augmentation probability.')
        parser.add_argument('--horizontal_flip', action='store_true', help='If specified, flip the images for augmentation')
        parser.add_argument('--affine', action='store_true', help='If specified, rotate|shift|scale images for augmentation')
        parser.add_argument('--elastic_deform', action='store_true', help='If specified, elastic deform the images for augmentation')
        parser.add_argument('--rotate_limit', type=float, default=3, help='Rotation range (-rotate_limit, rotate_limit) in [DEGREE]')
        parser.add_argument('--shift_limit', type=float, default=0.05, help='Shift as a fraction of the image height/width')
        parser.add_argument('--verbose_log', help='Print the time of each batch.', type=str2bool, default=False)
        return parser

    def __init__(self, opt):
        BaseAugment.__init__(self, opt)
        self.device = engine_mod.resolve_device(opt.device)
        self.phase = opt.phase
        self.p_thres = opt.p_thres
        self.horizontal_flip = opt.horizontal_flip
        self.affine = opt.affine
        self.elastic_deform = opt.elastic_deform
        self.rotate_limit = opt.rotate_limit
        self.shift_limit = opt.shift_limit
        self.verbose_log = opt.verbose_log
        self.stats_time = []
        self._gen = torch.Generator(device=self.device).manual_seed(opt.seed)

        if self.phase == 'train':
            self.transform = self.get_train_transform()
        elif self.phase in ('val', 'test'):
            print('Val/Test phase: all augmentation disabled.')
            self.transform = lambda generator, x: x
        else:
            raise NotImplementedError(f"phase {self.phase!r}")

    def input_sanity_check(self, img):
        check_slice(img, self.opt.load_size)

    output_sanity_check = input_sanity_check

    def set_input(self, data):
        if data['A_paths'] != data['B_paths']:
            raise ValueError("A and B paths differ")
        self.real_A = np.asarray(data['A'], dtype=np.float32)
        self.real_B = np.asarray(data['B'], dtype=np.float32)
        self.fname = data['A_paths']
        self.real_AB = np.concatenate((self.real_A, self.real_B), axis=1)

    def get_output(self):
        real_AB_aug = np.asarray(self.real_AB_aug, dtype=np.float32)
        return {'A': real_AB_aug[:, 0:1], 'B': real_AB_aug[:, 1:2],
                'A_paths': self.fname, 'B_paths': self.fname}

    def get_train_transform(self):
        """Compose the enabled transforms into one callable
        (generator, x) -> x."""
        p = 1.0 - self.p_thres
        use_flip, use_affine, use_elastic = (self.horizontal_flip, self.affine,
                                             self.elastic_deform)
        degrees, translate = float(self.rotate_limit), float(self.shift_limit)
        for on, name in ((use_flip, 'Horizontal flip'), (use_affine, 'Affine'),
                         (use_elastic, 'Elastic deform')):
            if on:
                print(f'{name} ON')

        @torch.no_grad()
        def apply(generator, x):
            if use_flip:
                x = random_hflip(generator, x, p)
            if use_affine:
                x = random_affine(generator, x, p, degrees, translate)
            if use_elastic:
                x = random_elastic(generator, x, p)
            return x

        return apply

    def forward(self):
        since = time.time()
        x = torch.as_tensor(self.real_AB, device=self.device)
        # One device-to-host copy per batch.
        self.real_AB_aug = self.transform(self._gen, x).cpu().numpy()
        time_elapsed = time.time() - since
        self.stats_time.append(time_elapsed)
        if self.verbose_log:
            print('Augmentation completed in {:.0f}m {:.3f}s'.format(
                time_elapsed // 60, time_elapsed % 60))

    def sanity_check(self):
        sanity_check(self)
