"""The benchmark finds each cell's pieces by name, its weights load into
the port, its plain reference computes what the port's plain path
computes, and a run's last line carries the result's keys in their order."""

import json
import os
import time

import numpy as np
import pytest
import torch

import tiny
from harness import check, spec, workspace
from reference import nets


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


BENCH = spec.benchmark(tiny.ROOT)


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_pieces_load_by_name(workload):
    w, cfg, traffic, limits = spec.cell(BENCH, workload)
    assert cfg["name"] == w["config"] and traffic["name"] == w["traffic"]
    assert [c for c in BENCH["configs"] if c["name"] == w["config"]][0]["file"] == \
        f"portbench/configs/{w['config']}.json"
    assert limits and all(isinstance(v, float) for v in limits.values())
    for m in spec.metrics_for(BENCH, workload, "per_layer"):
        assert callable(spec.metric_reader(m["name"]))


def test_every_metric_has_a_reader_and_no_metric_repeats():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        base = m["name"].rsplit(".", 1)[0]
        assert any(os.path.isfile(os.path.join(tiny.PB, "metrics", n + ".py"))
                   for n in (m["name"], base))
        # Each cell of a per-layer metric reports the end-to-end metric it moves.
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    # Every cell reports one rate, set-up and at least one per-layer metric.
    for w in cells:
        got = [m["name"] for m in spec.metrics_for(BENCH, w, "end_to_end")]
        assert "setup_s" in got and sum(n.endswith("samples_per_s") for n in got) == 1
        assert spec.metrics_for(BENCH, w, "per_layer")


def _port_modules(cfg):
    from latentaugment_tpu_torch.models.stylegan2 import networks as n2
    from latentaugment_tpu_torch.models.stylegan3 import networks as n3

    kw = workspace.g_cfg_kwargs(cfg)
    arch = kw.pop("arch", "stylegan2")
    mod = n3 if arch == "stylegan3" else n2
    G = mod.Generator(mod.generator_config(**kw), impl="ref")
    D = n2.Discriminator(n2.discriminator_config(**workspace.d_cfg_kwargs(cfg)), impl="ref")
    return G, D


def _rel(a, b):
    return ((a - b).double().norm() / b.double().norm()).item()


@pytest.mark.parametrize("name", ["sg2-256", "sg3t-256"])
def test_weights_are_the_ports_state_and_the_reference_computes_its_plain_path(name):
    cfg = tiny.config(name)
    dev = torch.device("cpu")
    gen = torch.Generator().manual_seed(3)
    gp = workspace.make_params(workspace.g_specs(cfg), gen, dev)
    dp = workspace.make_params(workspace.d_specs(workspace.d_cfg(cfg)), gen, dev)
    G, D = _port_modules(cfg)
    assert {k: tuple(v.shape) for k, v in G.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in gp.items()}
    G.load_state_dict(gp)
    D.load_state_dict(dp)
    z = torch.randn(8, cfg["z_dim"])
    with torch.no_grad():
        ws = G.mapping(z)
        assert torch.equal(ws, nets.mapping(gp, cfg, z))
        if cfg["arch"] == "stylegan2":
            g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
            img = G.synthesis(ws, noise_mode="random", generator=g1)
            noises = [torch.randn(s, generator=g2) for s, _ in nets.sg2_noise_shapes(cfg, 8)]
            ref = nets.sg2_synthesis(gp, cfg, ws, noises=noises)
        else:
            img = G.synthesis(ws)
            ref = nets.sg3_synthesis(gp, cfg, ws)
        assert _rel(img, ref) < 1e-5
        dcfg = dict(workspace.d_cfg(cfg))
        assert _rel(D(img), nets.discriminator(dp, dcfg, img)) < 1e-5


def test_vgg_weights_and_lpips_embedding_match_the_port():
    from latentaugment_tpu_torch.models import vgg

    vp = workspace.make_params(workspace.vgg_specs(), torch.Generator().manual_seed(4),
                               torch.device("cpu"))
    tree = {}
    for k, v in vp.items():
        a, b = k.split(".")
        tree.setdefault(a, {})[b] = v
    x = torch.rand(3, 3, 32, 32) * 255
    assert torch.allclose(vgg.lpips_features(tree, x), nets.lpips_features(vp, x),
                          rtol=1e-5, atol=1e-7)


def _run(workload, limits, tmp, seed=5):
    import run

    cname, tname = tiny.CELLS[workload]
    return run.run_cell(tiny.BENCH, "test-" + workload, tiny.config(cname), tiny.traffic(tname),
                        limits, seed, 0.2, False, device="cpu", t_start=time.perf_counter(),
                        work_root=str(tmp))


@pytest.mark.parametrize("workload", list(tiny.CELLS))
def test_a_run_prints_the_result_keys_and_agrees_with_the_reference(workload, tmp_path):
    limits = spec.limits(workload)
    result, rows = _run(workload, limits, tmp_path)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"aug_samples_per_s", "gen_samples_per_s", "peak_mem_gib",
                                      "setup_s"}
    assert all(isinstance(m["value"], float) for m in result["metrics"].values())
    assert result["correct"] is True and result["failed"] == 0
    assert {n for n, _, lim in rows if lim is not None} == set(limits)
    json.dumps(result)
    # The port's plain float32 path on the CPU sits far inside every limit.
    for name, value, lim in rows:
        if lim is not None:
            assert value < lim / 10, (name, value, lim)


def test_sample_plan_is_drawn_from_the_seed():
    tr = tiny.traffic("walk-k10-b16")
    tr.update(batch=32, check=dict(batches=2, within=4))
    a, b = check.sample_plan(tr, 2 ** 31 + 11), check.sample_plan(tr, 2 ** 31 + 11)
    assert a == b and len(set(a)) == 2 and all(0 <= i < 4 for i in a)
    assert {tuple(check.sample_plan(tr, s)) for s in range(20)} != {tuple(a)}
