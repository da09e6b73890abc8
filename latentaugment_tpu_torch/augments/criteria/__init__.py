"""Perceptual criteria (counterpart: latentaugment_tpu/augments/criteria)."""

from .lpips import LPIPS  # noqa: F401
from .nst import NSTLoss, gram_matrix  # noqa: F401
