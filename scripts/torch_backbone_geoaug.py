#!/usr/bin/env python3
"""The geometric sweep of the PyTorch port (counterpart:
backbone_geoaug.py): flip, affine and elastic augmentation
(`--aug geometric`, overrides through `parse(args=...)`) over
`LATENTAUGMENT_N_IMGS` images (default 1000), dumping `img/img_<i>` and
`img_aug/img_aug_<i>` under `<checkpoints_dir>/<name>/`. Prints the mean
per-batch wall time after the first batch.

    LATENTAUGMENT_N_IMGS=64 python scripts/torch_backbone_geoaug.py \\
        --dataroot <zip> --aug geometric ... [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from latentaugment_tpu_torch.augments import create_augment  # noqa: E402
from latentaugment_tpu_torch.data import create_dataset  # noqa: E402
from latentaugment_tpu_torch.options import AugOptions  # noqa: E402
from latentaugment_tpu_torch.utils import util_io, util_path  # noqa: E402


def main(argv=None, install_logger=True):
    """Returns the experiment directory and the per-batch wall times."""
    n_imgs = int(os.environ.get('LATENTAUGMENT_N_IMGS', 1000))
    params = {
        'n_imgs': n_imgs,
        'p_thres': 0.0,
        'horizontal_flip': True,
        'affine': True,
        'elastic_deform': True,
    }
    print('Parameters.')
    print(params)

    opt = AugOptions().parse(args=params, argv=argv, install_logger=install_logger)

    outdir = os.path.join(opt.checkpoints_dir, opt.name)
    for outname in ['img', 'img_aug']:
        util_path.create_dir(os.path.join(outdir, outname))

    dataset = create_dataset(opt)
    print('The number of training images = %d' % len(dataset))

    augment = create_augment(opt)

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

    stats_time = augment.stats_time[1:]
    print(np.mean(stats_time))
    print('May the force be with you.')
    return outdir, list(augment.stats_time)


if __name__ == '__main__':
    main()
