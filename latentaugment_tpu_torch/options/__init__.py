from .base_options import BaseOptions  # noqa: F401
from .aug_options import AugOptions  # noqa: F401
