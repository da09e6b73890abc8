"""Find a cell's pieces by the names in BENCHMARK.json: its configuration
(configs/<name>.json), its traffic mix (traffic/<name>.json), its
correctness limits (limits/<workload>.json) and the reader of each
per-layer metric (metrics/<metric>.py, a `read(ctx)` that returns a
number or None where it finds nothing to read)."""

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root):
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(bench, workload):
    """(workload entry, configuration, traffic, limits)."""
    matches = [w for w in bench["workloads"] if w["name"] == workload]
    if len(matches) != 1:
        raise SystemExit(f"unknown workload {workload!r}")
    w = matches[0]
    cfg = configuration(w["config"])
    return w, cfg, traffic(w["traffic"]), limits(workload)


def configuration(name):
    return load_json(os.path.join(HERE, "configs", name + ".json"))


def traffic(name):
    return load_json(os.path.join(HERE, "traffic", name + ".json"))


def limits(workload):
    return load_json(os.path.join(HERE, "limits", workload + ".json"))


def metric_reader(name):
    """metrics/<name>.py's `read`; a metric `<quantity>.<group>` (one
    quantity split by the end-to-end metric its cells report) that has no
    file of its own reads as metrics/<quantity>.py."""
    path = os.path.join(HERE, "metrics", name + ".py")
    if not os.path.isfile(path) and "." in name:
        path = os.path.join(HERE, "metrics", name.rsplit(".", 1)[0] + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(bench, workload, section):
    """The entries of `section` ('end_to_end' or 'per_layer') this cell reports."""
    return [m for m in bench[section] if "workloads" not in m or workload in m["workloads"]]
