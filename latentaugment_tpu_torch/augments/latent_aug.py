"""LatentAugment policy: the public augment for paired medical images
(counterpart: latentaugment_tpu/augments/latent_aug.py).

The p_thres train-only gate, rand_aug mode (zeroes all loss weights and
samples z ~ N(0, I)), w lookup from the inversion zip, A/B channel
concat, output split with optional lower-bound clip, latent accessors,
per-batch wall times and the sanity_check PNG dumps. Data is NumPy at
the API boundary (NCHW float32); the engine moves it to `--device`.
`--gpu_ids_aug` is kept for the JAX package's command lines and selects
nothing. `--n_mesh_devices N` (N > 1) walks data-parallel over N ranks,
one process per device (started by torchrun, or joined before the policy
is made): each rank walks its rows of the global batch and every rank
gets the global output. `--n_model_devices M` (M > 1) with it lays the
N ranks out as an (N / M) x M ('data', 'model') mesh: the batch splits
over N / M data ranks and each conv layer's output channels over the M
ranks of a model group (tensor parallelism, parallel/tensor.py).
"""

import os
import pickle
import random
import time

import numpy as np
import torch
import torch.distributed as dist

from ..parallel import mesh as pmesh
from ..utils import util_path
from ..utils.util_misc import span
from . import engine as engine_mod
from .base_aug import BaseAugment

# Bytes of the host arrays the policy builds from other host arrays: the
# A/B concatenation, dtype conversions that copy, the lower-bound clip.
counters = {"host_copy_bytes": 0}


def _as_float32(a):
    """`a` as a float32 array, its copy counted where one is made."""
    out = np.asarray(a, dtype=np.float32)
    if not np.may_share_memory(out, a):
        counters["host_copy_bytes"] += out.nbytes
    return out


def reverse_broadcasting(latent):
    """[B, num_ws, w_dim] -> [B, 1, w_dim]."""
    return latent[:, :1, :]


def map_range(x, old_min=-1000, old_max=2000, new_min=-1, new_max=1):
    return (((x - old_min) * (new_max - new_min)) / (old_max - old_min)) + new_min


def check_slice(img, res):
    """One modality of one sample: a float32 array [1, res, res]."""
    if not isinstance(img, np.ndarray) or img.dtype != np.float32:
        raise TypeError(f"expected a float32 numpy array, got {type(img).__name__} "
                        f"{getattr(img, 'dtype', '')}")
    if img.shape != (1, res, res):
        raise ValueError(f"expected shape {(1, res, res)}, got {img.shape}")


class LatentAugment(BaseAugment):
    @staticmethod
    def modify_commandline_options(parser, is_train):
        from ..options.base_options import str2bool

        parser.add_argument('--model_dir', help='Where to load the StyleGAN pretrained model', metavar='DIR', required=True)
        parser.add_argument('--interim_dir', help='Where to save/load the data', metavar='DIR', required=True)
        parser.add_argument('--device', type=str, default='cuda', help='torch device of the walk (cuda, cuda:N or cpu); cuda without CUDA raises')
        parser.add_argument('--impl', type=str, default='auto', choices=['auto', 'ref'], help="ops: 'auto' runs the hand-written kernels on CUDA, 'ref' the plain PyTorch versions")
        parser.add_argument('--gpu_ids_aug', type=str, default='0', help='kept for command-line compatibility; --device selects the device')
        parser.add_argument('--n_mesh_devices', type=int, default=0, help='walk over this many ranks, one process per device (0 = single device); the batch splits over them, or over N / --n_model_devices of them; the process group must hold exactly this many (torchrun --nproc_per_node N)')
        parser.add_argument('--n_model_devices', type=int, default=0, help='tensor parallelism: split each conv layer\'s output channels over this many of the --n_mesh_devices ranks (0 or 1 = none); it must divide --n_mesh_devices')

        # Common dataset options.
        parser.add_argument('--dataset_aug', help='', metavar='DIR', default="Pelvis_2.1_repo_no_mask")
        parser.add_argument('--dataset_name_aug', help='', metavar='DIR', default="Pelvis_2.1_repo_no_mask-num-375_train-0.70_val-0.20_test-0.10")
        parser.add_argument('--modalities_aug', help='', metavar='DIR', default="MR_nonrigid_CT,MR_MR_T2")
        parser.add_argument('--img_resolution', help='Image resolution.', type=int, default=256)
        # StyleGAN options.
        parser.add_argument('--exp_stylegan', help='', metavar='DIR', default="00003")
        parser.add_argument('--network_pkl_stylegan', help='', metavar='DIR', default="network-snapshot-005320.pkl")
        # Inversion options.
        parser.add_argument('--dataset_w_name', help='', metavar='DIR', default="Pelvis_2.1_repo_no_mask-num-375_train-0.70_val-0.20_test-0.10-expinv_00001")
        parser.add_argument('--exp_inv', help='', metavar='DIR', default="00001")
        parser.add_argument('--network_pkl_inv', help='', metavar='DIR', default="")

        # Augmentation options.
        parser.add_argument('--truncation_psi', help='Truncation value.', type=float, default=1.0)
        parser.add_argument('--rand_aug', action='store_true', help='Compute only random GAN augmentation.')
        parser.add_argument('--lower_bound_clip', action='store_true', help='Clip the pixels values under -1 to -1.')
        parser.add_argument('--step_img', help='Selection step to create the image dataset from which compute the distances.', type=int, default=20)
        parser.add_argument('--step_w', help='Selection step to create the latent dataset from which compute the distances.', type=int, default=5)
        parser.add_argument('--lpips_script', help="How to extract the features manifold: 'lpips_script' (five-tap VGG16 embedding) or 'lpips_tr' (the local LPIPS criterion's three taps).", type=str, default='lpips_script')
        parser.add_argument('--lpips_ref_input', help='Feed raw [-1,1] synthetic crops to the LPIPS VGG (default: the [0,255] scale the manifold features use).', action='store_true')
        parser.add_argument('--opt_num_epochs', help='Number of optimization steps', type=int, default=10)
        parser.add_argument('--opt_lr', help='Learning rate of optimization algorithm', type=float, default=0.01)
        parser.add_argument('--init_w', help='Initialization point for latent codes [inv | random]', type=str, default='random')

        parser.add_argument('--crop_size_aug', help='Size of the crop applied to images.', type=int, default=64)
        parser.add_argument('--preprocess_aug', help='Type of preprocessing [center_crop | random_crop | center_random_crop | original]', type=str, default='center_random_crop')

        parser.add_argument('--w_pix', help='Weight of recontruction loss', type=float, default=1.0)
        parser.add_argument('--w_lpips', help='Weight of lpips loss', type=float, default=1.0)
        parser.add_argument('--w_latent', help='Weight of latent loss', type=float, default=1.0)
        parser.add_argument('--w_disc', help='Weight of discriminator loss.', type=float, default=1.0)

        parser.add_argument('--num_fp16_res', help='Run the top-N resolution blocks of G/D in bfloat16 (0 = full fp32).', type=int, default=4)
        parser.add_argument('--p_thres', help='Augmentation probability.', type=float, default=1.0)
        parser.add_argument('--soft_aug', help='Activate smooth augmentation via interpolation.', type=str2bool, default=False)
        parser.add_argument('--alpha', help='Value for linear interpolation in soft_aug.', type=float, default=1.0)
        parser.add_argument('--verbose_log', help='Print losses and time during the optimization process.', type=str2bool, default=False)
        return parser

    def __init__(self, opt):
        BaseAugment.__init__(self, opt)
        self.device = engine_mod.resolve_device(opt.device)
        self.mesh = None
        n_mesh = getattr(opt, 'n_mesh_devices', 0) or 0
        n_model = getattr(opt, 'n_model_devices', 0) or 1
        if opt.phase == 'train' and n_model > 1 and n_mesh <= 1:
            raise ValueError(
                f"--n_model_devices {n_model} requires --n_mesh_devices (the total rank count "
                "the ('data', 'model') mesh is built from); without it the tensor-parallel "
                "request would be dropped")
        if n_mesh > 1 and opt.phase == 'train':
            if not dist.is_initialized():
                pmesh.init_distributed(backend=pmesh.backend_for(self.device))
            self.device = pmesh.rank_device(opt.device)
            self.mesh = pmesh.get_mesh(n_mesh, devices=self.device, n_model=n_model)
        self.phase = opt.phase
        self.batch_size = opt.batch_size
        self.rand_aug = opt.rand_aug
        self.lower_bound_clip = opt.lower_bound_clip
        self.p_thres = opt.p_thres
        self.init_w = opt.init_w
        self.verbose_log = opt.verbose_log
        self.stats_time = []
        self._rng = random.Random(opt.seed)
        self._z_gen = torch.Generator().manual_seed(opt.seed)
        self.augmented = False
        self.w_AB = self.w_AB_aug = None

        if self.phase == 'train':
            if self.rand_aug:
                print('Random GAN augmentation! Disable latent aug parameters.')
                opt.w_pix = opt.w_lpips = opt.w_latent = opt.w_disc = 0.0
                opt.init_w = self.init_w = 'random'
                opt.opt_num_epochs = 0
                opt.soft_aug = False
            self.latent_aug = engine_mod.define_latentaugment(
                module_name='latent_aug', phase=opt.phase, opt=opt,
                save_dir=self.save_dir, device=self.device, mesh=self.mesh)
            self.stats_dataset_w = self.latent_aug.stats_dataset_w
            self.num_ws = self.latent_aug.num_ws
            self.w_dim = self.latent_aug.w_dim
            self.z_dim = self.latent_aug.z_dim
        elif self.phase not in ('val', 'test'):
            raise NotImplementedError(f"phase {self.phase!r}")

    # ------------------------------------------------------------------

    def input_sanity_check(self, img):
        check_slice(img, self.opt.load_size)

    output_sanity_check = input_sanity_check

    def set_input(self, data):
        with span("latent_aug.set_input"):
            if data['A_paths'] != data['B_paths']:
                raise ValueError("A and B paths differ")
            self.real_A = _as_float32(data['A'])
            self.real_B = _as_float32(data['B'])
            self.fname = data['A_paths']
            # A final partial batch is padded up to batch_size for the walk
            # (minibatch_stddev needs whole groups); accessors trim back.
            self._n_valid = len(self.fname)
            self.real_AB = np.concatenate((self.real_A, self.real_B), axis=1)
            counters["host_copy_bytes"] += self.real_AB.nbytes

    def get_output(self):
        with span("latent_aug.get_output"):
            real_AB_aug = _as_float32(self.real_AB_aug)[:self._n_valid]
            real_A_aug = real_AB_aug[:, 0:1, :, :]  # CT
            real_B_aug = real_AB_aug[:, 1:2, :, :]  # MRI
            if self.lower_bound_clip:
                real_A_aug = np.clip(real_A_aug, -1.0, None)
                real_B_aug = np.clip(real_B_aug, -1.0, None)
                counters["host_copy_bytes"] += real_A_aug.nbytes + real_B_aug.nbytes
            return {'A': real_A_aug, 'B': real_B_aug,
                    'A_paths': self.fname, 'B_paths': self.fname}

    def _require_latents(self, w):
        if w is None:
            raise RuntimeError(
                "augmentation was skipped for this batch (p_thres gate or "
                "val/test phase); no latents to fetch - guard on `augment.augmented`")

    def get_latent_output(self):
        self._require_latents(self.w_AB_aug)
        w_aug = np.squeeze(reverse_broadcasting(self.w_AB_aug[:self._n_valid]))
        return {'w': w_aug, 'paths': self.fname if not self.rand_aug else ''}

    def get_latent_input(self):
        self._require_latents(self.w_AB)
        w = np.squeeze(np.asarray(self.w_AB)[:self._n_valid])
        return {'w': w, 'paths': self.fname if not self.rand_aug else ''}

    def forward(self):
        """Gate on p_thres, then run the walk (or ganrand for rand_aug)."""
        since = time.time()
        if self._rng.random() > self.p_thres and self.phase == 'train':
            self.augmented = True
            if self.rand_aug:
                with span("latent_aug.sample_z"):
                    z = self.sample_from_randn()
                img, ws = self.latent_aug.forward_ganrand(z)
            elif self.init_w == 'inv':
                with span("latent_aug.read_inversion"):
                    self.w_AB = self.sample_from_inversion(self.fname)
                img, ws = self.latent_aug.forward(self.w_AB, self.fname)
            else:
                raise NotImplementedError(f"init_w {self.init_w!r}")
            # The batch's device-to-host copies, after the walk.
            with span("latent_aug.to_host"):
                self.w_AB_aug = ws.cpu().numpy()
                if self.rand_aug:
                    self.w_AB = self.w_AB_aug
                self.real_AB_aug = img.float().cpu().numpy()
        else:
            # No latents exist for a skipped batch.
            self.augmented = False
            self.w_AB = self.w_AB_aug = None
            self.real_AB_aug = self.real_AB
        time_elapsed = time.time() - since
        if self.verbose_log:
            print('{} {:.0f}m {:.3f}s'.format(
                'Augmentation completed in' if self.augmented else 'No augmentation, time',
                time_elapsed // 60, time_elapsed % 60))
        self.stats_time.append(time_elapsed)

    # ------------------------------------------------------------------

    def sanity_check(self):
        sanity_check(self)

    # ------------------------------------------------------------------

    def sample_from_randn(self):
        return torch.randn((self.batch_size, self.z_dim), generator=self._z_gen).numpy()

    def sample_from_inversion(self, fname):
        if not fname:
            raise ValueError("empty batch")
        w = np.empty((self.batch_size, self.num_ws, self.w_dim), dtype=np.float32)
        for i, fn in enumerate(fname):
            with self.stats_dataset_w.open_file(fn) as f:
                w[i] = np.asarray(pickle.load(f), dtype=np.float32)
        # Pad a partial final batch by repeating the last real row.
        w[len(fname):] = w[len(fname) - 1]
        return reverse_broadcasting(w)


def sanity_check(augment):
    """Check the first sample of the augment's current input, run its
    forward, check the output, and dump both as <fname>.png and
    <fname>aug.png."""
    augment.input_sanity_check(augment.real_A[0])
    augment.input_sanity_check(augment.real_B[0])
    visualize(augment.real_A[0], augment.real_B[0],
              util_path.get_filename_without_extension(augment.fname[0]), augment.save_dir)
    augment.forward()
    data = augment.get_output()
    augment.output_sanity_check(data['A'][0])
    augment.output_sanity_check(data['B'][0])
    visualize(data['A'][0], data['B'][0],
              util_path.get_filename_without_extension(data['A_paths'][0]) + 'aug',
              augment.save_dir)


def visualize(imgA, imgB, img_name, save_dir):
    """[A | B] side by side as <save_dir>/<img_name>.png; nothing is
    written where matplotlib is not installed."""
    imgA, imgB = np.asarray(imgA), np.asarray(imgB)
    if imgA.ndim == 2:
        img = np.concatenate([imgA, imgB], axis=1)
    else:
        img = np.concatenate([imgA[0], imgB[0]], axis=1)
    try:
        import matplotlib
    except ImportError:
        return
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=plt.figaspect(img))
    fig.subplots_adjust(0, 0, 1, 1)
    ax.imshow(img, cmap='gray')
    plt.axis('off')
    fig.savefig(os.path.join(save_dir, f"{img_name}.png"), dpi=150, format='png')
    plt.close(fig)
