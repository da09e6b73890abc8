"""Dataset base class (counterpart: latentaugment_tpu/data/base_dataset.py:15-37)."""

from abc import ABC, abstractmethod


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
