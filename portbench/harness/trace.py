"""Reduce torch.profiler traces of the window's first batches to what the
per-layer readers take. Two traces: the first records each op's
arguments (`record_shapes`), whose cost on the host would read as device
idle time, and gives the hand-written kernels' launches with their
arguments and the device time of every kernel; the second records no
arguments and gives the timeline: the device's busy time over the
traced batches, its longest idle gaps by the harness span the host was
in, and the device time by kind of kernel."""

import torch

from . import kernels

OP_PREFIX = "latentaugment_torch::"
SPANS = ("policy.set_input", "policy.forward", "policy.get_output",
         "policy.get_latent_output", "portbench.batch")


def _kernels_and_spans(prof):
    kern, spans = [], []
    for evt in prof.events():
        start, end = evt.time_range.start, evt.time_range.end
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            if end > start and not getattr(evt, "is_user_annotation", False) \
                    and evt.name not in SPANS:
                kern.append((start, end, evt.name))
        elif evt.name in SPANS:
            spans.append((start, end, evt.name))
    batches = sorted((s, e) for s, e, n in spans if n == "portbench.batch")
    if not batches:
        raise RuntimeError("the trace holds no batch span")
    w0, w1 = batches[0][0], batches[-1][1]
    kern = sorted(k for k in kern if k[1] > w0 and k[0] < w1)
    return kern, spans, len(batches), w0, w1


def _ops(prof):
    """(op name, input shapes, concrete inputs, input dtypes) of every
    launch of a hand-written kernel's op."""
    out = []
    for evt in prof.profiler.kineto_results.events():
        name = evt.name()
        if evt.device_type() == torch.autograd.DeviceType.CPU and name.startswith(OP_PREFIX):
            out.append((name[len(OP_PREFIX):], evt.shapes(), list(evt.concrete_inputs()),
                        list(evt.dtypes())))
    return out


def op_schema(name):
    """[(argument name, type)] of the program's op `name`, in order."""
    op = getattr(getattr(torch.ops, OP_PREFIX[:-2]), name).default
    return [(a.name, str(a.type)) for a in op._schema.arguments]


def reduce(prof_args, prof_timeline):
    kern, _, n_a, _, _ = _kernels_and_spans(prof_args)
    launches = sum(1 for _, _, name in kern if not any(k in name for k in ("Memcpy", "Memset")))
    ops = _ops(prof_args)
    counts = {}
    for name, *_ in ops:
        counts[name] = counts.get(name, 0) + 1

    tl, spans, n_b, w0, w1 = _kernels_and_spans(prof_timeline)
    merged = []
    for s, e, _ in tl:
        s, e = max(s, w0), min(e, w1)
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps, prev = [], w0
    for s, e in merged:
        if s > prev:
            gaps.append((s - prev, prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((w1 - prev, prev, w1))
    inner = [(s, e, n) for s, e, n in spans if n != "portbench.batch"]

    def label(t0, t1):
        mid = (t0 + t1) / 2
        return next((n for s, e, n in inner if s <= mid <= e), "portbench.batch")

    gaps.sort(reverse=True)
    by_kind = {}
    for s, e, name in tl:
        kind = kernels.kind_of(name)
        by_kind[kind] = by_kind.get(kind, 0.0) + (e - s) / 1e6
    return dict(
        n_batches=n_a, launches=launches, kernels=kern, ops=ops, op_counts=counts,
        schemas={name: op_schema(name) for name in counts},
        timeline_batches=n_b, window_s=(w1 - w0) / 1e6,
        busy_s=sum(e - s for s, e in merged) / 1e6,
        device_ops=sorted(by_kind.items(), key=lambda kv: -kv[1])[:10],
        idle_gaps=[[label(a, b), g / 1e6] for g, a, b in gaps[:10]])


_OPS = {"k1": ("bias_act",), "k2": ("upfirdn2d",), "k3": ("filtered_lrelu",)}


def roofline(trace, which):
    """Least time of every launch of kernel `which` ('k1', 'k2', 'k3') in
    the traced batches over the device time of its kernels there, in %;
    None where the traced batches launched none of it. Raises
    kernels.UnreadLaunch where its launches cannot be read, or its ops and
    its device kernels do not both appear."""
    least, n = 0.0, 0
    for name, shapes, args, dtypes in trace["ops"]:
        if name.startswith(_OPS[which]):
            least += kernels.launch_bound(name, trace["schemas"][name], shapes, args, dtypes)[1]
            n += 1
    names = kernels.KERNEL_NAMES[which]
    dev = sum((e - s) / 1e6 for s, e, k in trace["kernels"] if any(m in k for m in names))
    if n == 0 and dev <= 0:
        return None
    if n == 0 or dev <= 0:
        raise kernels.UnreadLaunch(f"{which}: {n} op launches recorded against {dev} s of "
                                   f"device time of its kernels {names}")
    return 100.0 * least / dev
