"""Analysis tools of the port (counterpart: latentaugment_tpu/analysis/):
the tuning study, the coverage plot, precision/recall plots, trajectory
GIFs and the metric sweeps over dumped experiments."""

from . import hpo  # noqa: F401
