"""Options with plugin option injection (counterpart:
latentaugment_tpu/options/base_options.py).

Three-phase parse: base flags, then the dataset's option setter (from
this package's `data` registry), then the augment's (from its
`augments` registry). A programmatic override dict serves sweep
scripts; the experiment name encodes the operating point.

`--gpu_ids` is kept for the JAX package's command lines and becomes the
same list of ints there; it selects nothing (the augments' `--device`
does). `--verbose` and `--suffix` are parsed and unused, as there.
"""

import argparse
import os

from ..utils import util_logger, util_path


def str2bool(v):
    """argparse type for boolean flags: '--flag False' must be False."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("true", "1", "yes", "y"):
        return True
    if v.lower() in ("false", "0", "no", "n"):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {v!r}")


class BaseOptions:
    """Options used during both training and test time."""

    def __init__(self):
        self.initialized = False

    def initialize(self, parser):
        parser.add_argument('--dataroot', required=True, help='path to images (zip of per-slice pickle dicts)')
        parser.add_argument('--name', type=str, default='experiment_name', help='name of the experiment. It decides where to store samples and models')
        parser.add_argument('--gpu_ids', type=str, default='0', help='accelerator ids, kept for command-line compatibility; --device selects the device')
        parser.add_argument('--checkpoints_dir', type=str, default='./checkpoints', help='models are saved here')
        # dataset parameters
        parser.add_argument('--dataset_mode', type=str, default='pelvis2.1', help='chooses how datasets are loaded.')
        parser.add_argument('--load_size', type=int, default=256, help='scale images to this size')
        parser.add_argument('--aug', type=str, default=None, help='Augmentation mode [latent]')
        parser.add_argument('--batch_size', type=int, default=1, help='input batch size')
        parser.add_argument('--serial_batches', action='store_true', help='if true, takes images in order to make batches, otherwise takes them randomly')
        parser.add_argument('--max_dataset_size', type=int, default=float("inf"), help='Maximum number of samples allowed per dataset.')
        parser.add_argument('--verbose', action='store_true', help='if specified, print more debugging information')
        parser.add_argument('--suffix', default='', type=str, help='customized suffix: opt.name = opt.name + suffix')
        parser.add_argument('--seed', type=int, default=42, help='global RNG seed (crop draws, noise and z generators)')
        self.initialized = True
        return parser

    def gather_options(self, argv=None):
        """Three-phase parse: base flags, then dataset/augment plugin setters."""
        from .. import augments, data

        parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
        parser = self.initialize(parser)
        opt, _ = parser.parse_known_args(argv)

        parser = data.get_option_setter(opt.dataset_mode)(parser, self.isTrain)
        opt, _ = parser.parse_known_args(argv)

        if opt.aug is not None:
            parser = augments.get_option_setter(opt.aug)(parser, self.isTrain)

        self.parser = parser
        return parser.parse_args(argv)

    def print_options(self, opt):
        """Print all options (flagging non-default values) and save to disk."""
        message = '----------------- Options ---------------\n'
        for k, v in sorted(vars(opt).items()):
            default = self.parser.get_default(k)
            comment = '\t[default: %s]' % str(default) if v != default else ''
            message += '{:>25}: {:<30}{}\n'.format(str(k), str(v), comment)
        message += '----------------- End -------------------'
        print(message)
        expr_dir = os.path.join(opt.checkpoints_dir, opt.name)
        util_path.mkdirs(expr_dir)
        with open(os.path.join(expr_dir, '{}_opt.txt'.format(opt.phase)), 'wt') as f:
            f.write(message + '\n')

    def parse(self, args=None, argv=None, install_logger=True):
        """Parse options, apply the sweep override dict `args`, set up the
        experiment directory and the log tee. `argv` optionally supplies
        the CLI token list (default sys.argv)."""
        opt = self.gather_options(argv)

        if args is not None:
            if 'n_imgs' in args:
                opt.n_imgs = args['n_imgs']
            if opt.aug == 'geometric':
                keys = ('p_thres', 'horizontal_flip', 'affine', 'elastic_deform')
            elif opt.aug == 'latent' and getattr(opt, 'rand_aug', False):
                keys = ('p_thres', 'truncation_psi')
            else:
                keys = ('p_thres', 'opt_num_epochs', 'opt_lr', 'w_lpips',
                        'w_pix', 'w_latent', 'w_disc', 'init_w')
            for k in keys:
                if k in args:
                    setattr(opt, k, args[k])

        opt.isTrain = self.isTrain

        # The experiment name records the operating point.
        if opt.aug is not None and hasattr(opt, 'n_imgs'):
            if opt.aug == 'geometric':
                suffix = (f"n_imgs_{opt.n_imgs}-p_thres_{opt.p_thres}"
                          f"-horizontal_flip_{opt.horizontal_flip}-affine_{opt.affine}"
                          f"-elastic_deform_{opt.elastic_deform}")
            elif opt.aug == 'latent' and getattr(opt, 'rand_aug', False):
                suffix = f"n_imgs_{opt.n_imgs}-truncation_psi_{opt.truncation_psi}"
            else:
                suffix = (f"n_imgs_{opt.n_imgs}-opt_lr_{opt.opt_lr}"
                          f"-opt_num_epochs_{opt.opt_num_epochs}-w_latent_{opt.w_latent}"
                          f"-w_pix_{opt.w_pix}-w_lpips_{opt.w_lpips}-w_disc_{opt.w_disc}")
            opt.name = opt.name + '-' + suffix

        util_path.mkdirs(os.path.join(opt.checkpoints_dir, opt.name))
        if install_logger:
            util_logger.Logger(
                file_name=os.path.join(opt.checkpoints_dir, opt.name, 'log.txt'),
                file_mode='a', should_flush=True)
        self.print_options(opt)
        opt.gpu_ids = [int(s) for s in str(opt.gpu_ids).split(',') if s != '' and int(s) >= 0]
        self.opt = opt
        return self.opt
