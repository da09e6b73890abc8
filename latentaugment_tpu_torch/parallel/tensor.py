"""Tensor parallelism over the 'model' axis of a ('data', 'model') mesh
(counterpart: latentaugment_tpu/parallel/mesh.py:100-133,
`tp_tree_shardings`, and the partitioning GSPMD derives from it).

The JAX package shards every 4-D parameter [O, I, kh, kw] whose O is a
multiple of the model axis m and at least 2m on O, and replicates the rest; GSPMD
then inserts the collectives. Here each rank of a model group builds the
whole module from the same weights, and `shard_for_model` keeps, in every
layer whose `weight` meets that rule, the rank's O/m output channels of
the weight and the bias. The layer then runs its own forward on that
slice (the modulated or plain conv, the noise, K1 bias_act, K2's blur
where it follows the conv, K3 filtered_lrelu in StyleGAN3), so each
kernel launches on C/m channels, and `ModelShard.gather` concatenates the
ranks' slices along C. Everything else (the affines, the mapping, toRGB
at 2 output channels, the FCs, minibatch stddev, the LPIPS heads) stays
replicated and runs alike on every rank of the group.

Two adjoints carry the layer's gradient (the walk differentiates the
loss, the same on every rank of the group, with respect to w):
  * the gather's adjoint is this rank's slice of the incoming gradient,
    which every rank of the group holds whole. It is not an all-reduce:
    that would count it m times (`Rows.gather_grad`'s adjoint is one,
    which is right across data ranks and wrong here);
  * a replicated tensor entering a sharded layer (its input x, and the
    w its styles come from) passes through `ModelShard.enter`, an
    identity whose adjoint all-reduces over the model group: each rank's
    layer differentiates only its own output channels.
Both are first-order (`once_differentiable`): no path of the port
differentiates a sharded network twice.
"""

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.autograd.function import once_differentiable

from . import mesh as pmesh


def shards(shape, m):
    """The JAX package's rule: a 4-D leaf whose dim 0 is a multiple of m
    and at least 2m is split on dim 0 over the model axis."""
    return len(shape) == 4 and shape[0] % m == 0 and shape[0] >= 2 * m


def plan(params, m):
    """The names of the parameters the rule splits over a model axis of
    size m: a module's dotted names, or a VGG-style tree's
    ('conv1_1.weight'). Each must be a layer's `weight`."""
    if m <= 1:
        return []
    items = (params.named_parameters() if isinstance(params, nn.Module)
             else _tree_items(params))
    names = [name for name, t in items if shards(tuple(t.shape), m)]
    for name in names:
        if name.rsplit(".", 1)[-1] != "weight":
            raise ValueError(f"{name} meets the tensor-parallel rule but is no layer's "
                             "weight: the port cannot split it")
    return names


def _tree_items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tree_items(v, f"{prefix}{k}.")
        elif isinstance(v, torch.Tensor):
            yield f"{prefix}{k}", v


class ModelShard:
    """This rank's place on the mesh's model axis: the group, its size m
    and this rank's index r, which owns output channels [r O/m, (r+1) O/m)."""

    def __init__(self, mesh):
        self.group = pmesh.model_group(mesh)
        self.size = pmesh.model_axis_size(mesh)
        self.index = pmesh.model_rank(mesh)

    def take(self, t):
        """This rank's block of t's dim 0."""
        n = t.shape[0] // self.size
        return t.narrow(0, self.index * n, n).clone()

    def enter(self, x):
        """x, replicated, into a sharded layer: an identity whose adjoint
        sums the group's partial gradients."""
        if isinstance(x, torch.Tensor) and x.requires_grad and torch.is_grad_enabled():
            return _Enter.apply(x, self)
        return x

    def gather(self, y):
        """[N, C/m, ...] on each rank -> [N, C, ...], the slices in rank
        order, on every rank of the group."""
        return _GatherChannels.apply(y, self)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    @once_differentiable
    def backward(ctx, dx):
        buf = dx.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(buf, group=ctx.shard.group)
        return buf, None


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, shard):
        ctx.shard = shard
        y = y.contiguous()
        parts = [torch.empty_like(y) for _ in range(shard.size)]
        dist.all_gather(parts, y, group=shard.group)
        return torch.cat(parts, dim=1)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        shard = ctx.shard
        c = dy.shape[1] // shard.size
        return dy.narrow(1, shard.index * c, c).contiguous(), None


def _enter_args(shard):
    def hook(module, args, kwargs):
        return (tuple(shard.enter(a) for a in args),
                {k: shard.enter(v) for k, v in kwargs.items()})
    return hook


def _gather_output(shard):
    def hook(module, args, kwargs, out):
        return shard.gather(out)
    return hook


def shard_for_model(module, mesh):
    """Split `module`'s layers over the mesh's model axis in place: each
    layer whose weight meets the rule keeps this rank's output channels of
    its weight and bias, and runs between `enter` (its inputs) and
    `gather` (its output). Returns the split parameter names (`plan`)."""
    shard = ModelShard(mesh)
    names = plan(module, shard.size)
    for name in names:
        layer = module.get_submodule(name.rsplit(".", 1)[0]) if "." in name else module
        if hasattr(layer, "_tp_hooks"):
            raise ValueError(f"{name} is split already")
        with torch.no_grad():
            for pname in ("weight", "bias"):
                p = getattr(layer, pname, None)
                if p is not None:
                    setattr(layer, pname, nn.Parameter(shard.take(p), requires_grad=p.requires_grad))
        layer._tp_hooks = (
            layer.register_forward_pre_hook(_enter_args(shard), with_kwargs=True),
            layer.register_forward_hook(_gather_output(shard), with_kwargs=True))
        layer._tp_shard = shard
    return names


def gather_from_model(module):
    """The inverse of shard_for_model: every split layer gets its whole
    weight and bias back (the group's slices concatenated) and runs
    unsplit again. Every rank of the group must call it."""
    for layer in module.modules():
        if not hasattr(layer, "_tp_hooks"):
            continue
        shard = layer._tp_shard
        with torch.no_grad():
            for pname in ("weight", "bias"):
                p = getattr(layer, pname, None)
                if p is not None:
                    parts = [torch.empty_like(p) for _ in range(shard.size)]
                    dist.all_gather(parts, p.detach().contiguous(), group=shard.group)
                    setattr(layer, pname, nn.Parameter(torch.cat(parts), requires_grad=p.requires_grad))
        for h in layer._tp_hooks:
            h.remove()
        del layer._tp_hooks, layer._tp_shard
    return module


def shard_params(params, mesh):
    """A VGG-style tree {'convX_Y': {'weight', 'bias'}, ...} with each
    layer whose weight meets the rule replaced by this rank's slice and
    its ModelShard under 'tp' (models/vgg.py runs such a layer split).
    Returns (new tree, split names); the given tree is not changed."""
    shard = ModelShard(mesh)
    names = plan(params, shard.size)
    out = dict(params)
    for name in names:
        layer = name.rsplit(".", 1)[0]
        p = params[layer]
        out[layer] = {**p, "weight": shard.take(p["weight"]),
                      "bias": shard.take(p["bias"]), "tp": shard}
    return out, names


def shard_bundle(bundle, mesh):
    """The walk's bundle (augments/engine.make_bundle) with G, D and the
    VGG16 split over the mesh's model axis (G and D in place). Returns
    (bundle, split names prefixed 'G.', 'D.', 'vgg.')."""
    bundle, names = dict(bundle), []
    for key in ("G", "D"):
        if bundle[key] is not None:
            names += [f"{key}.{n}" for n in shard_for_model(bundle[key], mesh)]
    if bundle["vgg"] is not None:
        bundle["vgg"], split = shard_params(bundle["vgg"], mesh)
        names += [f"vgg.{n}" for n in split]
    return bundle, names
