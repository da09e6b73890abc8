"""Augment registry and factory (counterpart:
latentaugment_tpu/augments/__init__.py): `--aug <name>` imports
augments/<name>_aug.py and picks the class named `<Name>Augment`."""

import importlib

from .base_aug import BaseAugment


def find_augment_using_name(augment_name):
    augment_filename = __name__ + "." + augment_name + "_aug"
    augmentlib = importlib.import_module(augment_filename)
    target = augment_name.replace("_", "") + "augment"
    for name, cls in augmentlib.__dict__.items():
        if name.lower() == target and isinstance(cls, type) \
                and issubclass(cls, BaseAugment):
            return cls
    raise NotImplementedError(
        f"In {augment_filename}.py, there should be a subclass of BaseAugment "
        f"with class name that matches {target} in lowercase.")


def get_option_setter(augment_name):
    return find_augment_using_name(augment_name).modify_commandline_options


def create_augment(opt):
    """Create an augment pipeline given the options."""
    instance = find_augment_using_name(opt.aug)(opt)
    print("Augment [%s] was created" % type(instance).__name__)
    return instance
