from . import vgg  # noqa: F401
from .stylegan2 import checkpoint, networks  # noqa: F401


def networks_for(cfg):
    """Generator-module dispatch on the config's arch tag (StyleGAN2 only)."""
    if cfg.get("arch", "stylegan2") != "stylegan2":
        raise NotImplementedError(
            f"arch {cfg.get('arch')!r} is not ported yet (StyleGAN2 only)")
    return networks
