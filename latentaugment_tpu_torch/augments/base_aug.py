"""Abstract augment base class (counterpart:
latentaugment_tpu/augments/base_aug.py): the set_input / forward /
get_output contract."""

import os
from abc import ABC, abstractmethod


class BaseAugment(ABC):
    """Subclasses implement __init__, set_input, forward (and usually
    get_output, modify_commandline_options)."""

    def __init__(self, opt):
        self.opt = opt
        self.save_dir = os.path.join(opt.checkpoints_dir, opt.name)
        os.makedirs(self.save_dir, exist_ok=True)

    @staticmethod
    def modify_commandline_options(parser, is_train):
        return parser

    @abstractmethod
    def set_input(self, data):
        """Unpack input data from the dataloader and pre-process."""

    @abstractmethod
    def forward(self):
        pass
