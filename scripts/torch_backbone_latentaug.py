#!/usr/bin/env python3
"""The LatentAugment sweep of the PyTorch port (counterpart:
backbone_latentaug.py): the policy at the tuned operating point (a random
draw from `params_space`, one value per key), its `sanity_check`, then
`LATENTAUGMENT_N_IMGS` images (default 10000) augmented batch by batch.
Each batch is dumped under `<checkpoints_dir>/<name>/`: `img/img_<i>`
(the batch as read), `img_aug/img_aug_<i>` (the augmented batch), and,
only for batches the `p_thres` gate augmented, `latent/w_<i>` and
`latent_aug/w_aug_<i>`. Prints the mean per-batch wall time after the
first batch.

    LATENTAUGMENT_N_IMGS=64 python scripts/torch_backbone_latentaug.py \\
        --dataroot <zip> --aug latent --model_dir <ckpt> ... [--device cpu]

`--device` is the policy's option (default cuda; cuda without CUDA raises).
"""

import copy
import os
import random
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from latentaugment_tpu_torch.augments import create_augment  # noqa: E402
from latentaugment_tpu_torch.data import create_dataset  # noqa: E402
from latentaugment_tpu_torch.options import AugOptions  # noqa: E402
from latentaugment_tpu_torch.utils import util_io, util_path  # noqa: E402

# The tuned operating point.
params_space = {
    'w_lpips': [10],
    'w_pix': [0.1],
    'w_latent': [0.001],
    'w_disc': [0.01],
    'p_thres': [0.0],
    'opt_num_epochs': [6],
    'opt_lr': [0.01],
}


def main(argv=None, install_logger=True):
    """Returns the experiment directory and the per-batch wall times."""
    n_imgs = int(os.environ.get('LATENTAUGMENT_N_IMGS', 10000))
    params = copy.deepcopy(params_space)
    for key in params_space:
        params[key] = random.choice(params_space[key])
    params['n_imgs'] = n_imgs
    print('Parameters.')
    print(params)

    opt = AugOptions().parse(args=params, argv=argv, install_logger=install_logger)

    outdir = os.path.join(opt.checkpoints_dir, opt.name)
    for outname in ['img', 'latent', 'img_aug', 'latent_aug']:
        util_path.create_dir(os.path.join(outdir, outname))

    dataset = create_dataset(opt)
    print('The number of training images = %d' % len(dataset))

    augment = create_augment(opt)

    # Sanity check of the augmentation class.
    data = next(iter(dataset))
    augment.set_input(data)
    augment.sanity_check()

    n_iter = n_imgs // opt.batch_size
    for i, data in enumerate(dataset):
        print(f"Iteration: {i} of {n_iter}")
        if i >= n_iter:
            break

        augment.set_input(data)
        augment.forward()

        data_aug = augment.get_output()
        util_io.write_pickle(data, os.path.join(outdir, 'img', f'img_{i}'))
        util_io.write_pickle(data_aug, os.path.join(outdir, 'img_aug', f'img_aug_{i}'))
        # Latents exist only for batches the p_thres gate augmented.
        if augment.augmented:
            data_w = augment.get_latent_input()
            data_w_aug = augment.get_latent_output()
            util_io.write_pickle(data_w, os.path.join(outdir, 'latent', f'w_{i}'))
            util_io.write_pickle(data_w_aug, os.path.join(outdir, 'latent_aug', f'w_aug_{i}'))

    stats_time = augment.stats_time[1:]
    print(np.mean(stats_time))
    print('May the force be with you.')
    return outdir, list(augment.stats_time)


if __name__ == '__main__':
    main()
