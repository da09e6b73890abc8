"""harness/spans.py and the readers of the program's spans on a synthetic
timeline: kernels under nested spans, a backward node mapped to its
forward op by sequence number, idle intervals split across spans, a
missing span stopping the run, and the new readers found by name."""

import pytest
from torch.autograd import DeviceType
from torch.autograd.profiler_util import EventList, FunctionEvent

import tiny
from harness import spans, spec

BENCH = spec.benchmark(tiny.ROOT)
NEW = ["g.device_ms.aug", "g.device_ms.gen", "d.device_ms.aug", "vgg.device_ms.aug",
       "policy.to_host_ms.aug", "policy.to_host_ms.gen", "policy.host_copy_mb.aug",
       "policy.host_copy_mb.gen", "policy.idle_ms.aug", "policy.idle_ms.gen",
       "engine.idle_ms.aug", "engine.idle_ms.gen"]
MAIN, AUTOGRAD = 1, 2


class Timeline:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _cpu(name, start, end, thread=MAIN, seq=-1, fwd_thread=0, kernels=(), annotation=False):
    e = FunctionEvent(id=0, name=name, thread=thread, start_us=start, end_us=end,
                      fwd_thread=fwd_thread, sequence_nr=seq, is_user_annotation=annotation)
    for k, dur in kernels:
        e.append_kernel(k, 0, dur)
    return e


def _dev(name, start, end, annotation=False):
    return FunctionEvent(id=0, name=name, thread=7, start_us=start, end_us=end,
                         device_type=DeviceType.CUDA, is_user_annotation=annotation)


def _events():
    """One walk batch over [0, 1000] us: G's conv (and its backward on the
    autograd thread), D's linear, engine glue, the copy to the host, and a
    backward node whose forward op is not in the trace."""
    span = lambda n, a, b: _cpu(n, a, b, annotation=True)  # noqa: E731
    ev = [span("portbench.batch", 0, 1000), span("latent_aug.set_input", 0, 100),
          span("latent_aug.read_inversion", 100, 150), span("engine.forward", 150, 800),
          # The device-side range of a span is hung on the span as a kernel.
          _cpu("G.synthesis", 160, 400, kernels=[("G.synthesis", 100.0)], annotation=True),
          _cpu("aten::conv2d", 170, 180, seq=5, kernels=[("convK", 100.0)]),
          span("D.forward", 400, 500),
          _cpu("aten::linear", 410, 420, seq=6, kernels=[("gemm", 50.0)]),
          _cpu("aten::mul", 510, 520, kernels=[("elt", 10.0)]),
          span("latent_aug.to_host", 800, 900),
          _cpu("aten::copy_", 810, 890, kernels=[("Memcpy DtoH (Device -> Pageable)", 60.0)]),
          span("latent_aug.get_output", 900, 1000),
          _cpu(spans.BACKWARD + "ConvolutionBackward0", 600, 700, thread=AUTOGRAD, seq=5,
               fwd_thread=MAIN),
          _cpu("aten::convolution_backward", 610, 690, thread=AUTOGRAD,
               kernels=[("dgrad", 40.0)]),
          _cpu(spans.BACKWARD + "AddmmBackward0", 700, 720, thread=AUTOGRAD, seq=99,
               fwd_thread=MAIN),
          _cpu("aten::mm", 701, 719, thread=AUTOGRAD, kernels=[("lost", 10.0)]),
          _dev("G.synthesis", 200, 300, annotation=True),
          _dev("convK", 200, 300), _dev("gemm", 500, 550), _dev("elt", 560, 570),
          _dev("dgrad", 610, 650), _dev("lost", 700, 710),
          _dev("Memcpy DtoH (Device -> Pageable)", 820, 880)]
    out = EventList(ev)
    out._build_tree()
    return out


def _ctx(events, kind="walk"):
    spans._CACHE.clear()
    traffic = {"kind": kind, "w_disc": 0.01, "w_lpips": 10.0, "warmup_batches": 2}
    return {"trace": {"n_batches": 1, "timeline_batches": 1}, "traffic": traffic,
            "timeline": Timeline(events), "times": []}


def test_kernels_go_to_their_spans_and_backward_to_the_forward_op():
    att = spans.attribute(_events())
    stacks = {name: st for (st, name) in att["kernel_us"]}
    assert stacks["convK"] == ("engine.forward", "G.synthesis")
    assert stacks["dgrad"] == ("engine.forward", "G.synthesis")  # by sequence number 5
    assert stacks["gemm"] == ("engine.forward", "D.forward")
    assert stacks["elt"] == ("engine.forward",)
    assert stacks["lost"] is spans.UNPLACED
    assert "G.synthesis" not in stacks  # the span's own range is no kernel
    assert att["total_us"] == 270.0 and att["n_batches"] == 1


def test_idle_intervals_split_across_the_spans_open():
    att = spans.attribute(_events())
    idle = att["idle_us"]
    # [0, 200] is idle: set_input, the inversion read, engine glue, then G.
    assert idle[("latent_aug.set_input",)] == 100.0
    assert idle[("latent_aug.read_inversion",)] == 50.0
    assert idle[("engine.forward", "G.synthesis")] == 40.0 + 100.0
    assert idle[("engine.forward", "D.forward")] == 100.0
    assert idle[("engine.forward",)] == 10.0 + 10.0 + 40.0 + 50.0 + 90.0
    assert idle[("latent_aug.to_host",)] == 40.0
    assert sum(idle.values()) == 1000.0 - att["total_us"]


def test_readers_of_the_walk():
    events = _events()
    want = {"g.device_ms.aug": 0.14, "d.device_ms.aug": 0.05, "policy.to_host_ms.aug": 0.06,
            "policy.idle_ms.aug": 0.29, "engine.idle_ms.aug": 0.44}
    for name, value in want.items():
        assert spec.metric_reader(name)(_ctx(events)) == pytest.approx(value), name


def test_a_missing_span_stops_the_run():
    with pytest.raises(spans.MissingSpan, match="vgg16.features"):
        spec.metric_reader("vgg.device_ms.aug")(_ctx(_events()))
    # The sampling path must hold G.mapping and its own spans.
    with pytest.raises(spans.MissingSpan, match="G.mapping"):
        spec.metric_reader("g.device_ms.gen")(_ctx(_events(), kind="sample"))
    with pytest.raises(spans.MissingSpan, match="engine.ganrand"):
        spec.metric_reader("engine.idle_ms.gen")(_ctx(_events(), kind="sample"))


def test_a_program_without_spans_reads_nothing(monkeypatch):
    monkeypatch.setattr(spans, "program_has_spans", lambda: False)
    for name in NEW:
        if "host_copy" not in name:
            assert spec.metric_reader(name)(_ctx(_events())) is None, name


def test_host_copy_mb_reads_the_programs_counter(monkeypatch):
    from latentaugment_tpu_torch.augments import latent_aug

    read = spec.metric_reader("policy.host_copy_mb.aug")
    ctx = _ctx(_events())
    assert read(dict(ctx, counters={"host_copy_bytes": 8388608})) == pytest.approx(8.388608)
    # Without the window's delta: the total over every batch the process ran
    # (2 warm-up, 1 + 1 traced, 4 timed).
    monkeypatch.setitem(latent_aug.counters, "host_copy_bytes", 8 * 2_000_000)
    assert read(dict(ctx, times=[None] * 4)) == pytest.approx(2.0)
    monkeypatch.delattr(latent_aug, "counters")
    assert read(ctx) is None


@pytest.mark.parametrize("name", NEW)
def test_new_metrics_are_listed_and_read_by_name(name):
    entry = [m for m in BENCH["per_layer"] if m["name"] == name]
    assert len(entry) == 1 and entry[0]["workloads"]
    assert callable(spec.metric_reader(name))


def test_without_ctx_timeline_the_callers_second_profiler_is_read():
    """run.py's run_cell holds its two traced profilers as `profs`; the
    readers find the timeline there where ctx does not carry it."""
    def run_cell(ctx):
        profs = [Timeline([]), Timeline(_events())]  # noqa: F841
        return spec.metric_reader("d.device_ms.aug")(ctx)

    ctx = _ctx(_events())
    del ctx["timeline"]
    assert run_cell(ctx) == pytest.approx(0.05)
