"""Multi-device helpers (counterpart: latentaugment_tpu/utils/util_misc.py:128-159):
a check that every rank holds the same parameters, and a parameter
summary table; and `span`, the named ranges the program marks its layers
with (the counterpart of the JAX package's `profiled_function`)."""

import contextlib

import numpy as np
import torch

_NO_SPAN = contextlib.nullcontext()


def span(name):
    """A named range of the program's host work and of the kernels it
    launches, recorded by whatever profiler is on (`torch.profiler`,
    or `torch.autograd.profiler.emit_nvtx` for Nsight); with no profiler
    on, one shared context that does nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def _named_tensors(tree):
    """(name, tensor) pairs of a module (parameters, then buffers) or of a
    nested dict of tensors / arrays."""
    if isinstance(tree, torch.nn.Module):
        yield from tree.named_parameters()
        yield from tree.named_buffers()
        return
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from ((f"{k}.{n}", t) for n, t in _named_tensors(v))
        else:
            yield k, v


def checksum(t):
    """Two int64 sums over the bits of a tensor (plain and position-
    weighted): any differing bit pattern almost surely changes them."""
    t = torch.as_tensor(t).detach().contiguous()
    if t.is_floating_point():
        t = t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
    bits = t.reshape(-1).to(torch.int64)
    pos = torch.arange(1, bits.numel() + 1, device=bits.device, dtype=torch.int64)
    return torch.stack([bits.sum(), (bits * pos).sum()])


def check_replica_consistency(tree, mesh=None):
    """Raise unless every rank of the mesh holds bit-identical parameters
    (and buffers): each rank's checksums of every tensor are gathered and
    compared (NVIDIA's check_ddp_consistency). Without a mesh there is
    one replica and nothing to compare."""
    if mesh is None:
        return
    from ..parallel import mesh as pmesh

    named = list(_named_tensors(tree))
    if not named:
        return
    device = torch.as_tensor(named[0][1]).device
    sums = torch.stack([checksum(torch.as_tensor(t).to(device)) for _, t in named])
    ranks = pmesh.all_gather(sums, mesh)
    bad = [name for i, (name, _) in enumerate(named)
           if any(not torch.equal(r[i], ranks[0][i]) for r in ranks[1:])]
    if bad:
        raise RuntimeError(f"replica mismatch across {len(ranks)} ranks in {len(bad)} "
                           f"tensors: {bad[:10]}")


def print_param_summary(tree, name="model", max_rows=None):
    """Parameter table of a module or a nested dict (NVIDIA's
    print_module_summary); returns the total count."""
    rows = [(n, tuple(t.shape), int(np.prod(tuple(t.shape)))) for n, t in _named_tensors(tree)]
    total = sum(r[2] for r in rows)
    print(f"\n{name:<40s} {'shape':<20s} {'params':>12s}")
    print("-" * 74)
    for n, shape, cnt in rows[:max_rows]:
        print(f"{n:<40s} {str(list(shape)):<20s} {cnt:>12,d}")
    if max_rows is not None and len(rows) > max_rows:
        print(f"... ({len(rows) - max_rows} more)")
    print("-" * 74)
    print(f"{'Total':<40s} {'':<20s} {total:>12,d}\n")
    return total
