"""The port's spans (`utils.util_misc.span`) and its host-copy counter
(`augments.latent_aug.counters`) on the CPU, over a tiny policy: which
spans one walk batch and one sampling batch record under torch.profiler,
that they cost a batch nothing and change nothing with no profiler on,
that the counter counts the A/B concatenation, and that every backward
node of a profiled walk maps back to a forward op under a program span."""

import zipfile

import numpy as np
import pytest
import torch

from latentaugment_tpu_torch import augments, benchmark
from latentaugment_tpu_torch.augments import latent_aug
from latentaugment_tpu_torch.options.aug_options import AugOptions
from latentaugment_tpu_torch.utils import util_misc
from test_torch_port_common import _one_torch_thread  # noqa: F401 (autouse fixture)

RES, BATCH, K = 32, 4, 2
MODEL = ("G.mapping", "G.synthesis", "D.forward", "vgg16.features")
WALK = ("engine.forward", "latent_aug.set_input", "latent_aug.read_inversion",
        "latent_aug.to_host", "latent_aug.get_output")
SAMPLE = ("engine.ganrand", "latent_aug.set_input", "latent_aug.sample_z",
          "latent_aug.to_host", "latent_aug.get_output")
PROGRAM = set(MODEL + WALK + SAMPLE)
BACKWARD = "autograd::engine::evaluate_function: "


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """The policy's argv over a tiny workspace and one batch of its images."""
    root = str(tmp_path_factory.mktemp("tracing"))
    argv = benchmark.build_policy_workspace(
        root, res=RES, batch_size=BATCH, num_epochs=K, crop_size=16, channel_base=1024,
        channel_max=64, n_patients=1, slices_per_patient=4, step=2)
    argv += ["--device", "cpu", "--impl", "ref"]
    names = sorted(zipfile.ZipFile(argv[argv.index("--dataroot") + 1]).namelist())[:BATCH]
    rng = np.random.RandomState(0)
    data = {"A": rng.rand(BATCH, 1, RES, RES).astype(np.float32) * 2 - 1,
            "B": rng.rand(BATCH, 1, RES, RES).astype(np.float32) * 2 - 1,
            "A_paths": names, "B_paths": names}
    return argv, data


def _policy(workspace, kind):
    argv = workspace[0] + (["--rand_aug"] if kind == "sample" else [])
    return augments.create_augment(AugOptions().parse(argv=argv, install_logger=False))


@pytest.fixture(scope="module")
def policies(workspace):
    return {kind: _policy(workspace, kind) for kind in ("walk", "sample")}


def _batch(policy, data):
    policy.set_input(data)
    policy.forward()
    return policy.get_output(), policy.get_latent_output()


def _profiled(policy, data):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = _batch(policy, data)
    return prof.events(), out


@pytest.fixture(scope="module")
def traces(policies, workspace):
    """The events of one profiled walk batch and one sampling batch."""
    return {kind: _profiled(policies[kind], workspace[1])[0] for kind in ("walk", "sample")}


def _counts(events):
    counts = {}
    for e in events:
        if e.name in PROGRAM:
            counts[e.name] = counts.get(e.name, 0) + 1
    return counts


def _ancestors(e):
    while e.cpu_parent is not None:
        e = e.cpu_parent
        yield e


def test_walk_batch_records_each_span_once_and_g_inside_the_engine(traces):
    events = traces["walk"]
    want = {n: 1 for n in WALK}
    want.update({"G.synthesis": K + 1, "D.forward": K, "vgg16.features": K})
    assert _counts(events) == want
    for e in events:
        if e.name == "G.synthesis":
            assert "engine.forward" in [a.name for a in _ancestors(e)]


def test_sampling_batch_records_each_span_once(traces):
    events = traces["sample"]
    want = {n: 1 for n in SAMPLE}
    want.update({"G.mapping": 1, "G.synthesis": 1})
    assert _counts(events) == want
    for e in events:
        if e.name in ("G.mapping", "G.synthesis"):
            assert "engine.ganrand" in [a.name for a in _ancestors(e)]


def test_span_names_keep_clear_of_the_ops_and_of_a_callers_spans(traces):
    """No span begins as the kernels' ops do, nor takes a name a caller of
    the policy (a benchmark's `policy.*` or `portbench.*`) would use."""
    names = {e.name for events in traces.values() for e in events if e.is_user_annotation}
    assert names == PROGRAM
    assert not any(n.startswith(("latentaugment_torch::", "policy.", "portbench."))
                   for n in names)


@pytest.mark.parametrize("kind", ["walk", "sample"])
def test_no_profiler_enters_no_record_function(policies, workspace, kind, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler on")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert util_misc.span("G.synthesis") is util_misc.span("D.forward")
    _batch(policies[kind], workspace[1])


@pytest.mark.parametrize("kind", ["walk", "sample"])
def test_outputs_bit_equal_with_and_without_the_profiler(workspace, kind):
    """Two fresh policies of one seed: one batch each, the second under the
    profiler."""
    plain = _batch(_policy(workspace, kind), workspace[1])
    _, traced = _profiled(_policy(workspace, kind), workspace[1])
    for got, want in ((traced[0]["A"], plain[0]["A"]), (traced[0]["B"], plain[0]["B"]),
                      (traced[1]["w"], plain[1]["w"])):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("kind", ["walk", "sample"])
def test_host_copy_bytes_count_the_concatenation(policies, workspace, kind):
    before = latent_aug.counters["host_copy_bytes"]
    for _ in range(2):
        _batch(policies[kind], workspace[1])
    assert latent_aug.counters["host_copy_bytes"] - before == 2 * (2 * BATCH * RES * RES * 4)


def test_host_copy_bytes_count_conversions_and_the_clip(workspace):
    """A float64 input is converted (one copy per modality) and the
    lower-bound clip copies both outputs."""
    argv, data = workspace
    policy = augments.create_augment(AugOptions().parse(
        argv=argv + ["--rand_aug", "--lower_bound_clip"], install_logger=False))
    wide = dict(data, A=data["A"].astype(np.float64), B=data["B"].astype(np.float64))
    before = latent_aug.counters["host_copy_bytes"]
    _batch(policy, wide)
    plane = BATCH * RES * RES * 4
    assert latent_aug.counters["host_copy_bytes"] - before == 2 * plane + 2 * plane + 2 * plane


def test_every_backward_node_maps_to_a_forward_op_under_a_program_span(traces):
    """Each `evaluate_function` event with a sequence number maps by
    (forward thread, sequence number) to the last forward op to start with
    that pair, and that op lies under G, D, VGG16 or the engine's loss
    glue; the nodes without one accumulate the walked leaf."""
    cpu = [e for e in traces["walk"] if e.device_type == torch.autograd.DeviceType.CPU]

    def in_backward(e):
        return any(a.name.startswith(BACKWARD) for a in [e, *_ancestors(e)])

    forward = {}
    for e in cpu:
        if e.sequence_nr >= 0 and not in_backward(e):
            key = (e.thread, e.sequence_nr)
            if key not in forward or e.time_range.start >= forward[key].time_range.start:
                forward[key] = e
    nodes = [e for e in cpu if e.name.startswith(BACKWARD)]
    assert nodes
    under = {}
    for e in nodes:
        if e.sequence_nr < 0:
            assert e.name.endswith("AccumulateGrad")
            continue
        op = forward[(e.fwd_thread, e.sequence_nr)]
        spans = [a.name for a in _ancestors(op) if a.name in PROGRAM]
        assert spans and spans[-1] == "engine.forward", (e.name, op.name, spans)
        inner = spans[0]
        assert inner in ("G.synthesis", "D.forward", "vgg16.features", "engine.forward")
        under[inner] = under.get(inner, 0) + 1
    assert set(under) == {"G.synthesis", "D.forward", "vgg16.features", "engine.forward"}
