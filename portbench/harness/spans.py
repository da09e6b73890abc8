"""Attribute the traced batches' device time and device idle time to the
program's own spans (`latentaugment_tpu_torch.utils.util_misc.span`),
from the timeline profiler (the traced run that records no arguments).

Kernels: each kernel goes to the host op that launched it (the
profiler's correlation, `FunctionEvent.kernels`), and from there to the
program spans that enclose that op on its thread. A backward node
(`autograd::engine::evaluate_function: ...`, run by the autograd engine
on a thread of its own) stands for the forward op with the same
(forward thread, sequence number), and its kernels go to that op's
spans; a node with no forward op (AccumulateGrad, sequence number -1)
keeps the spans of its own thread. A kernel linked to no host op, or to
a backward node whose forward op is not in the trace, is unplaced.

Idle: the device's idle intervals over the traced window (the union of
kernel intervals, as harness/trace.py takes it), each split by overlap
among the program spans open on the thread that ran the batches.

The program marks its layers with these spans; a program without
`util_misc.span` (before it had spans) reads as nothing to read. Where
the program has spans and one that a metric reads is absent from a cell
that runs its layer, the run stops (MissingSpan): a renamed span must
never read as 0."""

import importlib
import sys

import torch

G_SPANS = ("G.mapping", "G.synthesis")
MODEL_SPANS = G_SPANS + ("D.forward", "vgg16.features")
ENGINE_SPANS = ("engine.forward", "engine.ganrand")
POLICY_SPANS = ("latent_aug.set_input", "latent_aug.get_output", "latent_aug.read_inversion",
                "latent_aug.sample_z", "latent_aug.to_host")
PROGRAM_SPANS = MODEL_SPANS + ENGINE_SPANS + POLICY_SPANS
BATCH = "portbench.batch"
BACKWARD = "autograd::engine::evaluate_function: "
UNPLACED = None  # the stack of a kernel that cannot be placed

_CACHE = []  # [(profiler, attribution)]: one attribution per traced run


class MissingSpan(RuntimeError):
    pass


def program_has_spans():
    try:
        mod = importlib.import_module("latentaugment_tpu_torch.utils.util_misc")
    except ImportError:
        return False
    return hasattr(mod, "span")


def timeline(ctx):
    """The traced run's timeline profiler: ctx['timeline'] where the
    harness passes it, else the second of the profilers that run.py's
    run_cell, the readers' caller, holds as its local `profs`."""
    if ctx.get("timeline") is not None:
        return ctx["timeline"]
    frame = sys._getframe(1)
    while frame is not None:
        profs = frame.f_locals.get("profs")
        if isinstance(profs, list) and len(profs) == 2:
            return profs[1]
        frame = frame.f_back
    return None


def _is_cpu(evt):
    return evt.device_type == torch.autograd.DeviceType.CPU


def _stacks(cpu):
    """{id(event): tuple of the program spans enclosing it, outermost
    first, or UNPLACED} for every host event."""
    out, under_backward = {}, {}

    def in_backward(e):
        key = id(e)
        if key not in under_backward:
            p = e.cpu_parent
            under_backward[key] = e.name.startswith(BACKWARD) or (p is not None
                                                                  and in_backward(p))
        return under_backward[key]

    # The forward op of each (thread, sequence number): the last to start.
    # Ops that create no autograd node record the number the next node
    # will take, and start before the op that creates it.
    forward = {}
    for e in cpu:
        if e.sequence_nr is not None and e.sequence_nr >= 0 and not in_backward(e):
            key = (e.thread, e.sequence_nr)
            if key not in forward or e.time_range.start >= forward[key].time_range.start:
                forward[key] = e

    def resolve(e):
        key = id(e)
        if key in out:
            return out[key]
        if e.name.startswith(BACKWARD) and e.sequence_nr is not None and e.sequence_nr >= 0:
            fwd = forward.get((e.fwd_thread, e.sequence_nr))
            st = UNPLACED if fwd is None else resolve(fwd)
        else:
            base = () if e.cpu_parent is None else resolve(e.cpu_parent)
            st = base if base is UNPLACED or e.name not in PROGRAM_SPANS else base + (e.name,)
        out[key] = st
        return st

    for e in cpu:
        resolve(e)
    return out


def _segments(spans, w0, w1):
    """The window cut into (t0, t1, open spans outermost first) by the
    nested spans [(start, end, name)] of one thread."""
    segs, stack, t = [], [], w0

    def emit(a, b):
        a, b = max(a, w0), min(b, w1)
        if b > a:
            segs.append((a, b, tuple(n for _, n in stack)))

    for s, e, n in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            emit(t, stack[-1][0])
            t = max(t, stack[-1][0])
            stack.pop()
        emit(t, s)
        t = max(t, s)
        stack.append((e, n))
    while stack:
        emit(t, stack[-1][0])
        t = max(t, stack[-1][0])
        stack.pop()
    emit(t, w1)
    return segs


def _idle(kern, w0, w1):
    """Intervals of [w0, w1] where no kernel runs."""
    merged = []
    for s, e in sorted(kern):
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps, prev = [], w0
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    return gaps


def attribute(events):
    """Reduce a timeline trace's events: {n_batches, span_counts,
    kernel_us {(stack, kernel name): us}, total_us (every kernel),
    idle_us {stack: us}}, stacks being tuples of program spans."""
    cpu = [e for e in events if _is_cpu(e)]
    annotations = {e.name for e in cpu if getattr(e, "is_user_annotation", False)}
    annotations |= set(PROGRAM_SPANS) | {BATCH}
    batches = sorted((e.time_range.start, e.time_range.end, e.thread)
                     for e in cpu if e.name == BATCH)
    if not batches:
        raise RuntimeError("the trace holds no batch span")
    w0, w1, main = batches[0][0], batches[-1][1], batches[0][2]

    stacks = _stacks(cpu)
    kernel_us = {}
    for e in cpu:
        for k in e.kernels:
            if k.name in annotations:
                continue
            key = (stacks[id(e)], k.name)
            kernel_us[key] = kernel_us.get(key, 0.0) + k.duration
    kern = [(e.time_range.start, e.time_range.end) for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in annotations
            and not getattr(e, "is_user_annotation", False)
            and e.time_range.end > e.time_range.start]
    total_us = sum(b - a for a, b in kern)

    spans = [(e.time_range.start, e.time_range.end, e.name) for e in cpu
             if e.name in PROGRAM_SPANS and e.thread == main]
    idle_us = {}
    segs = _segments(spans, w0, w1)
    j = 0
    for a, b in _idle(kern, w0, w1):
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            over = min(b, segs[k][1]) - max(a, segs[k][0])
            if over > 0:
                idle_us[segs[k][2]] = idle_us.get(segs[k][2], 0.0) + over
            k += 1
    counts = {}
    for e in cpu:
        if e.name in PROGRAM_SPANS:
            counts[e.name] = counts.get(e.name, 0) + 1
    return dict(n_batches=len(batches), span_counts=counts, kernel_us=kernel_us,
                total_us=total_us, idle_us=idle_us)


def outer_model(stack):
    """The outermost of G, D and VGG16's spans in a stack (D's label
    mapping is D's), or None."""
    return next((n for n in stack if n in MODEL_SPANS), None)


def _report(att):
    n = att["n_batches"]
    by = {}
    for (st, _), us in att["kernel_us"].items():
        if st is UNPLACED:
            key = "unplaced"
        elif not st:
            key = "outside every span"
        else:
            key = outer_model(st) or st[-1]
        by[key] = by.get(key, 0.0) + us
    placed = sum(us for (st, _), us in att["kernel_us"].items() if st)
    un = att["total_us"] - placed
    idle = {}
    for st, us in att["idle_us"].items():
        key = st[-1] if st else "outside every span"
        idle[key] = idle.get(key, 0.0) + us

    def fmt(d):
        return ", ".join(f"{k} {v / 1e3 / n:.3f}" for k, v in sorted(d.items(),
                                                                     key=lambda kv: -kv[1]))

    print(f"spans: {sum(att['span_counts'].values()) / n:g} program spans a batch "
          f"{dict(sorted(att['span_counts'].items()))} over {n} batches; kernel ms a batch by "
          f"span: {fmt(by)}; unattributed {un / 1e3 / n:.3f} ms a batch "
          f"({100.0 * un / att['total_us'] if att['total_us'] else 0.0:.2f}% of "
          f"{att['total_us'] / 1e3 / n:.3f}); idle ms a batch by innermost span: {fmt(idle)}",
          file=sys.stderr)


def read(ctx, need):
    """The attribution of this traced run, or None where there is nothing
    to read (untraced, or a program without spans). Raises MissingSpan
    where a span of `need` is absent."""
    if ctx.get("trace") is None or not program_has_spans():
        return None
    prof = timeline(ctx)
    if prof is None:
        raise RuntimeError("the timeline profiler of the traced run is not to be found")
    hit = [att for p, att in _CACHE if p is prof]
    if hit:
        att = hit[0]
    else:
        att = attribute(prof.events())
        _CACHE[:] = [(prof, att)]
        _report(att)
    missing = [n for n in need if not att["span_counts"].get(n)]
    if missing:
        raise MissingSpan(f"the program's spans {missing} are absent from the traced batches "
                          f"(spans seen: {sorted(att['span_counts'])})")
    return att


def walks(ctx):
    return ctx["traffic"]["kind"] == "walk"


def kernel_ms(att, keep):
    """Device ms a batch of the kernels whose (stack, kernel name) `keep`
    takes."""
    us = sum(v for (st, name), v in att["kernel_us"].items()
             if st is not UNPLACED and keep(st, name))
    return us / 1e3 / att["n_batches"]


def idle_ms(att, keep):
    """Device-idle ms a batch while the open spans are ones `keep` takes."""
    return sum(v for st, v in att["idle_us"].items() if keep(st)) / 1e3 / att["n_batches"]
