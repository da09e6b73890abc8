"""Augmentation-phase options (counterpart:
latentaugment_tpu/options/aug_options.py)."""

from .base_options import BaseOptions


class AugOptions(BaseOptions):
    """Training-phase options; adds --phase and sets isTrain."""

    def initialize(self, parser):
        parser = BaseOptions.initialize(self, parser)
        parser.add_argument('--phase', type=str, default='train', help='train, val, test, etc')
        self.isTrain = True
        return parser
