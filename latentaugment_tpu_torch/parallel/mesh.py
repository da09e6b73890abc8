"""Data parallelism across processes (counterpart:
latentaugment_tpu/parallel/mesh.py).

The JAX package runs data parallelism from one process over a `Mesh`
with a 'data' axis: GSPMD shards the batch, and a global batch goes in
and comes out. The port keeps that contract with one process (rank) per
device:

  * every rank is built the same way from the same seed (and
    `broadcast_module` makes parameters equal to rank 0's where a caller
    wants that guaranteed);
  * every rank receives the same global batch;
  * each rank computes its own rows (`shard_rows`);
  * every rank returns the global result (`Rows.gather`, `Rows.sum`).

Random draws of a batch (noise, augmentation parameters) are made for the
whole global batch on every rank, which then takes its rows, so the
generators stay in step and a run over N ranks is the one-process run.

A minibatch-stddev layer (the discriminator's epilogue) couples samples
j, j + n/g, j + 2n/g, ... of a batch of n in groups of g. Where whole
groups fit a rank, `shard_rows` with `group_size` g hands each rank
whole groups, ordered so that its local reshape forms exactly the global
groups, and no collective is needed inside D. Where they do not (a batch
of 8 on 8 ranks, 4 on 2), each rank holds a contiguous block of rows and
D's epilogue gathers its input across the ranks (`Rows.gather_grad`, a
gather that autograd differentiates to any order), forms the global
groups and keeps its own rows. A batch need only split evenly over the
ranks, as in the JAX package; the metrics pad theirs instead
(`shard_rows(..., pad=True)`).

Collectives go through the group of the mesh's data axis: NCCL with one
rank per card in production; gloo on the CPU, and for two ranks on one
card (a check, not a deployment: NCCL refuses two ranks on one device),
where gloo runs all_reduce, broadcast and all_gather on the card's
tensors through host memory itself (chip_smoke phase 18 probes which
collectives it takes).

Tensor parallelism adds a 'model' axis: `get_mesh(n, n_model=m)` lays
the ranks out as a (n / m) x m ('data', 'model') mesh, the model axis
innermost as in the JAX package. The batch splits over the data axis
only: every helper here that carries the batch (`data_group`,
`world_size`, `data_rank`, `mesh_ranks`, hence `shard_rows` and `Rows`)
sees the data axis through this rank, and the m ranks of a model group
hold the same rows. parallel/tensor.py splits each conv layer's output
channels over the model group. Only the walk engine takes such a mesh
(`check_mesh(mesh, model_axis=True)`); the trainer, the projector and
the metrics shard only the batch and refuse it.
"""

import datetime
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

def backend_for(device):
    """The collective backend for ranks on `device`: nccl on CUDA, gloo
    on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(coordinator_address=None, num_processes=None, process_id=None,
                     backend="nccl", timeout_s=600):
    """Join the process group of `num_processes` ranks as rank `process_id`,
    meeting at `coordinator_address` ('host:port' or a URL such as
    'tcp://host:port'). Without arguments, torchrun's environment
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) names them. A group that
    does not form raises; nothing runs on alone. Returns (rank, world size)."""
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    if coordinator_address is None:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
                   if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"init_distributed without a coordinator address reads torchrun's "
                f"environment, and {missing} are not set: start the program with "
                "torchrun --nproc_per_node N, or pass the address, count and rank")
        where = dict(init_method="env://")
    else:
        where = dict(init_method=(coordinator_address if "://" in coordinator_address
                                  else f"tcp://{coordinator_address}"),
                     world_size=int(num_processes), rank=int(process_id))
    dist.init_process_group(backend, timeout=datetime.timedelta(seconds=timeout_s), **where)
    return dist.get_rank(), dist.get_world_size()


def rank_device(name="cuda"):
    """This rank's device for `--device name`: a bare 'cuda' becomes the
    card of the rank's LOCAL_RANK (torchrun) or global rank, modulo the
    cards present; an explicit 'cuda:N' or 'cpu' is kept."""
    device = torch.device(name)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return device


def get_mesh(n_devices=None, devices=None, n_model=1):
    """A DeviceMesh over the process group's ranks: 1-D with the dim name
    'data', or with n_model > 1 a ('data', 'model') mesh whose ranks are
    arange(world).reshape(world // n_model, n_model) (the model axis
    innermost, as in the JAX package). `devices` lists one device per rank
    (e.g. ['cuda:0', 'cuda:0'] places two ranks on one card) or names this
    rank's; by default each rank takes `rank_device()`. The mesh spans
    every rank: `n_devices` must be the world size, and n_model must
    divide it."""
    from torch.distributed.device_mesh import DeviceMesh

    n_model = int(n_model or 1)
    if n_model > 1 and n_devices is not None and int(n_devices) % n_model:
        raise ValueError(f"n_model={n_model} must divide the device count {n_devices}")
    if not dist.is_initialized():
        raise RuntimeError("get_mesh needs the process group: call init_distributed first "
                           "(or start under torchrun)")
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"a mesh of {n_devices} ranks, but the process group has "
                         f"{world}: start one process per device")
    device = _this_device(devices)
    if n_model == 1:
        return DeviceMesh(device.type, list(range(world)), mesh_dim_names=("data",))
    if world % n_model:
        raise ValueError(f"n_model={n_model} must divide the device count {world}")
    ranks = np.arange(world).reshape(world // n_model, n_model).tolist()
    return DeviceMesh(device.type, ranks, mesh_dim_names=("data", "model"))


def get_hybrid_mesh(n_slices, per_slice=None, devices=None):
    """A 2-D ('dcn', 'data') DeviceMesh over every rank: the outer axis
    across hosts (or slices), the inner one within. The batch shards over
    both: the data group of such a mesh is the whole group (`data_group`)."""
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    if per_slice is None:
        if world % n_slices:
            raise ValueError(f"n_slices={n_slices} must divide {world} ranks")
        per_slice = world // n_slices
    if n_slices * per_slice != world:
        raise ValueError(f"a {n_slices}x{per_slice} mesh over {world} ranks: the batch "
                         "axis spans every rank")
    device = _this_device(devices)
    ranks = np.arange(world).reshape(n_slices, per_slice).tolist()
    return DeviceMesh(device.type, ranks, mesh_dim_names=("dcn", "data"))


def _this_device(devices):
    """This rank's device: `devices[rank]` of a per-rank list, a single
    device as given, or by default `rank_device()` of the CUDA cards (the
    CPU where there is none)."""
    if devices is None:
        device = rank_device("cuda" if torch.cuda.is_available() else "cpu")
    elif isinstance(devices, (list, tuple)):
        device = torch.device(devices[dist.get_rank()])
    else:
        device = torch.device(devices)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device


def check_mesh(mesh, model_axis=False):
    """`mesh` as the port's parallel paths take it: None (one process) or
    a DeviceMesh whose axes carry the batch, and, where `model_axis`
    (the walk engine), a 'model' axis besides."""
    from torch.distributed.device_mesh import DeviceMesh

    if mesh is None:
        return None
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch DeviceMesh (parallel.mesh.get_mesh), "
                        f"got {type(mesh).__name__}")
    if has_model_axis(mesh) and not model_axis:
        raise ValueError("this path shards only the batch, as the JAX package's does "
                         "(batch_sharding): tensor parallelism (a 'model' axis) runs in "
                         "the walk engine only; build its mesh with n_model=1")
    return mesh


def _rank_entry(rank, fn, n, port, backend, args):
    init_distributed(f"localhost:{port}", n, rank, backend=backend)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def run_on_ranks(fn, n, device, *args):
    """fn(*args) on `n` ranks. Where this process already is one rank of a
    group of n (joined before, or started by torchrun, whose environment
    names the group), it runs here and its result is returned. Otherwise
    n new processes on this host form a group over localhost (nccl on
    CUDA devices, gloo on the CPU), each runs fn(*args), and None is
    returned once all have finished; one that fails raises here."""
    import torch.multiprocessing as mp

    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        if not dist.is_initialized():
            init_distributed(backend=backend_for(device))
        if dist.get_world_size() != n:
            raise ValueError(f"{n} ranks asked for, but the process group has "
                             f"{dist.get_world_size()}")
        return fn(*args)
    mp.spawn(_rank_entry, args=(fn, n, free_port(), backend_for(device), args), nprocs=n,
             join=True)
    return None


def has_model_axis(mesh):
    return "model" in (mesh.mesh_dim_names or ())


def model_axis_size(mesh):
    """The size of the mesh's 'model' axis (1 without one)."""
    return int(mesh.size(mesh.mesh_dim_names.index("model"))) if has_model_axis(mesh) else 1


def model_group(mesh):
    """The process group of this rank's model group: the ranks that split
    each sharded layer's output channels and hold the same rows."""
    return mesh.get_group("model")


def model_rank(mesh):
    """This rank's position on the mesh's 'model' axis (0 without one)."""
    return int(mesh.get_local_rank("model")) if has_model_axis(mesh) else 0


def mesh_ranks(mesh):
    """The global ranks of the mesh's batch axis, in batch order: the
    flattened mesh, or under a 'model' axis the data axis through this
    rank."""
    if has_model_axis(mesh):
        return [int(r) for r in mesh.mesh[:, model_rank(mesh)].tolist()]
    return [int(r) for r in mesh.mesh.flatten().tolist()]


def mesh_group(mesh):
    """The group of every rank of the mesh: the dim of a 1-D mesh, the
    whole group under a 2-D one (get_mesh and get_hybrid_mesh span every
    rank)."""
    return mesh.get_group(0) if mesh.ndim == 1 else dist.group.WORLD


def data_group(mesh):
    """The process group that carries the batch: the 'data' dim through
    this rank under a 'model' axis, else every rank of the mesh (a
    ('dcn', 'data') mesh shards the batch over both)."""
    return mesh.get_group("data") if has_model_axis(mesh) else mesh_group(mesh)


def world_size(mesh):
    """The number of ranks the batch splits over."""
    return len(mesh_ranks(mesh))


def data_rank(mesh):
    """This rank's position on the mesh's batch axis."""
    return mesh_ranks(mesh).index(dist.get_rank())


def is_lead(mesh):
    """Whether this rank is the mesh's first (the one that writes files
    every rank reads)."""
    return dist.get_rank() == int(mesh.mesh.flatten()[0])


def all_sum(t, mesh):
    """The sum of `t` over the mesh's batch axis (a new tensor, equal on
    every rank)."""
    buf = t.detach().clone()
    dist.all_reduce(buf, group=data_group(mesh))
    return buf


def all_gather(t, mesh):
    """[t of rank 0, t of rank 1, ...] in batch-axis order; every rank
    passes a tensor of the same shape and dtype."""
    src = t.detach().contiguous()
    out = [torch.empty_like(src) for _ in range(world_size(mesh))]
    dist.all_gather(out, src, group=data_group(mesh))
    return out


def barrier(mesh):
    """Wait for every rank of the mesh."""
    dist.barrier(group=mesh_group(mesh))


def broadcast_module(module, mesh, src=0):
    """Make every parameter and buffer of `module` equal to the one of the
    rank at batch-axis position `src`."""
    group, src_rank = data_group(mesh), mesh_ranks(mesh)[src]
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src_rank, group=group)
    return module


def pad_to_multiple(x, multiple, axis=0):
    """Pad the batch axis of tensor `x` so it divides `multiple`, repeating
    the last row (edge); returns (padded, original length)."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    last = x.narrow(axis, n - 1, 1)
    reps = [rem if i == axis else 1 for i in range(x.ndim)]
    return torch.cat([x, last.repeat(*reps)], dim=axis), n


class Rows:
    """One rank's rows of a global batch of `n`. `order` lists the global
    positions of every rank's rows, rank after rank, each rank's in its
    local order; this rank holds `order[lo:hi]`. A padded split
    (`shard_rows(..., pad=True)`) lists position n - 1 again at the end
    (edge padding, as `pad_to_multiple`); `gather` drops those rows.
    `group` is the minibatch-stddev group size whose groups each rank's
    local reshape forms (1 where the rows make no groups)."""

    def __init__(self, n, order, bounds, rank, mesh, group=1):
        self.n = int(n)
        self.order = order
        self.bounds = bounds
        self.index = order[bounds[rank]:bounds[rank + 1]]
        self.mesh = mesh
        self.group = int(group)
        self._on = {}

    @property
    def n_local(self):
        return int(self.index.numel())

    @property
    def scale(self):
        """n_local / n: a mean over the local rows times this is the
        rank's share of the global mean."""
        return self.n_local / self.n

    def holds_groups(self, group_size):
        """Whether each rank's local reshape(g, -1) forms the global
        minibatch-stddev groups of size g = min(group_size, n)."""
        return self.group == max(1, min(int(group_size), self.n))

    def _index_on(self, device, which="index"):
        key = (which, str(device))
        if key not in self._on:
            self._on[key] = getattr(self, which).to(device)
        return self._on[key]

    def take(self, x):
        """The local rows of a global batch (tensor or numpy array)."""
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            return x.index_select(0, self._index_on(x.device))
        return np.asarray(x)[self.index.numpy()]

    def randn(self, shape, generator=None, device=None, dtype=torch.float32):
        """The local rows of torch.randn([n, *shape[1:]]) drawn from
        `generator`: the draw of the global batch, so that every rank's
        generator advances as the one-process run's does."""
        full = torch.randn([self.n, *shape[1:]], generator=generator, device=device, dtype=dtype)
        return self.take(full)

    def mean(self, x):
        """The rank's share of the global batch mean of x [n_local, ...]
        over its first axis (x.sum(0) / n)."""
        return x.sum(dim=0) / self.n

    def sum(self, t):
        """All-reduce sum over the ranks of the mesh."""
        return all_sum(t, self.mesh)

    def _place(self, parts):
        """The global batch [n, ...] from the ranks' rows in rank order."""
        order = self._index_on(parts.device, "order")[:self.n]
        out = torch.empty((self.n, *parts.shape[1:]), dtype=parts.dtype, device=parts.device)
        out[order] = parts[:self.n]
        return out

    def gather(self, x):
        """The global batch [n, ...] from every rank's local rows, in the
        global order, on every rank."""
        return self._place(torch.cat(all_gather(x, self.mesh)))

    def gather_grad(self, x):
        """`gather` under autograd: the gradient of a rank's local rows is
        the sum over the ranks of the gradients of their copies of the
        global batch. Its backward is a differentiable Function too, so
        second derivatives (R1) pass through it."""
        return _GatherRows.apply(x, self)


class _GatherRows(torch.autograd.Function):
    """x [n_local, ...] -> the global batch [n, ...] on every rank. The
    adjoint of a gather is an all-reduce of the global gradient followed
    by taking the local rows (`_ReduceTakeRows`), whose adjoint is this
    gather again."""

    @staticmethod
    def forward(ctx, x, rows):
        ctx.rows = rows
        return rows.gather(x)

    @staticmethod
    def backward(ctx, dy):
        return _ReduceTakeRows.apply(dy, ctx.rows), None


class _ReduceTakeRows(torch.autograd.Function):
    """y [n, ...] on every rank -> this rank's rows of their sum."""

    @staticmethod
    def forward(ctx, y, rows):
        ctx.rows = rows
        return rows.take(rows.sum(y.contiguous()))

    @staticmethod
    def backward(ctx, dx):
        return _GatherRows.apply(dx, ctx.rows), None


def shard_rows(n, mesh, group_size=1, pad=False):
    """This rank's Rows of a global batch of `n` over the mesh's batch
    axis. With `group_size` g (a minibatch-stddev layer's, effective
    min(g, n)), sample i = k * (n / g) + j belongs to group j. Where n
    splits into whole groups on every rank (n % (g * world) == 0), each
    rank takes a block of whole groups j and orders its rows k-major, so
    that its local reshape(g, -1) forms exactly the global groups.
    Otherwise, and with g = 1, the ranks hold contiguous blocks, and a
    minibatch-stddev layer gathers across them (`Rows.holds_groups`).
    n must split evenly over the ranks, unless `pad`: then the batch is
    padded to a multiple of the ranks by repeating row n - 1, for
    computations that treat each row alone (the metrics' detectors,
    generator and distance tiles)."""
    world, rank = world_size(mesh), data_rank(mesh)
    g = max(1, min(int(group_size), n))
    if n % (g * world) == 0:
        m = n // g                   # number of groups
        per = m // world             # groups per rank
        k = torch.arange(g)
        order = torch.cat([(k[:, None] * m + torch.arange(r * per, (r + 1) * per)[None, :])
                           .reshape(-1) for r in range(world)])
        bounds = [r * g * per for r in range(world + 1)]
        return Rows(n, order, bounds, rank, mesh, group=g)
    if n % world and not pad:
        raise ValueError(f"a batch of {n} does not split over {world} ranks: pad it to a "
                         f"multiple of {world}")
    per = -(-n // world)
    order = torch.arange(per * world).clamp(max=n - 1)
    bounds = [r * per for r in range(world + 1)]
    return Rows(n, order, bounds, rank, mesh, group=1)


def free_port():
    """A free TCP port on localhost for a coordinator address."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]
