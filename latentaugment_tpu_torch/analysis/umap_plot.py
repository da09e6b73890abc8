"""Plotting front-end of the coverage analysis (counterpart:
latentaugment_tpu/analysis/umap_plot.py): the plot helpers and the
embedding entry points under the second name the tools are known by."""

from ..utils.util_reports import (  # noqa: F401
    image_grid, scatter_plot, scatter_plot_interactive,
)
from .umap_analysis import load_latents_from_dir, manifold_coverage  # noqa: F401
