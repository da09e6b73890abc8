from . import vgg  # noqa: F401
from .stylegan2 import checkpoint, networks  # noqa: F401


def networks_for(cfg):
    """Generator-module dispatch on the config's arch tag: the alias-free
    (StyleGAN3) module for 'stylegan3', else StyleGAN2. Takes any mapping
    with .get (an EasyDict cfg or {'arch': ...}). The discriminator is
    always the StyleGAN2 one."""
    if cfg.get("arch") == "stylegan3":
        from .stylegan3 import networks as networks_sg3

        return networks_sg3
    return networks
