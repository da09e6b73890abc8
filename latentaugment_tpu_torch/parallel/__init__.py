"""Data and tensor parallelism across processes (counterpart:
latentaugment_tpu/parallel/): the data axis of a DeviceMesh, the rows of
a global batch each rank computes, and the collectives that assemble the
global result (mesh.py); each conv layer's output channels split over a
'model' axis (tensor.py)."""

from .mesh import get_hybrid_mesh, get_mesh, init_distributed, pad_to_multiple, shard_rows

__all__ = ["get_mesh", "get_hybrid_mesh", "init_distributed", "pad_to_multiple", "shard_rows"]
