#!/usr/bin/env python3
"""The template loop of the PyTorch port (counterpart: backbone.py):
parse the options, build the dataset and the augment, and run
set_input / forward / get_output on every batch.

    python scripts/torch_backbone.py --dataroot <zip> --aug latent ... [--device cpu]

`--device` is the augment's option (default cuda; cuda without CUDA
raises).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from latentaugment_tpu_torch.augments import create_augment  # noqa: E402
from latentaugment_tpu_torch.data import create_dataset  # noqa: E402
from latentaugment_tpu_torch.options import AugOptions  # noqa: E402


def main(argv=None, install_logger=True):
    opt = AugOptions().parse(argv=argv, install_logger=install_logger)

    dataset = create_dataset(opt)
    print('The number of training images = %d' % len(dataset))

    augment = create_augment(opt)

    for data in dataset:
        augment.set_input(data)
        augment.forward()
        data_aug = augment.get_output()
        del data_aug
    return augment


if __name__ == '__main__':
    main()
