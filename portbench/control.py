#!/usr/bin/env python3
"""The control of a cell's correctness check, on the card at the cell's
own sizes: the plain reference put in the program's place and computed
one precision step below the configuration's (float32 layers in
bfloat16, bfloat16 layers in float8 e4m3), read by the same comparison
as a run's answers, on each seed given. A sound check reads the control
above its limits. With --fault the reference walk with a fault planted
stands in the program's place instead; with --program the program's own
answers are read, in short windows in one process.

    python3 portbench/control.py --workload <name> --seeds 11,12,13 [--fault d_zero]

Prints one line per seed ("control <workload> seed <n>: {numbers}") and a
last JSON line with every reading. The benchmark's runs never run it.
"""

import argparse
import json
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)

from harness import check, spec, workspace  # noqa: E402
from reference import nets, walk as rwalk  # noqa: E402


def control_readings(workload, cfg, traffic, seed, device, fault=None):
    root = os.path.join(ROOT, "build", "portbench", "control-" + workload)
    shutil.rmtree(root, ignore_errors=True)
    _, _, files, (names, imgs) = workspace.write_workspace(root, cfg, traffic, seed, device)
    staged = workspace.stage_batches(names, imgs, traffic["batch"], traffic["staged_batches"])
    plan = check.sample_plan(traffic, seed)
    gaps = check.answers(None, files, cfg, traffic, plan, staged, traffic["warmup_batches"],
                         workspace.traffic_seed(seed), device,
                         candidate=check.Candidate(nets.REF if fault else nets.Precision("control"),
                                                   fault=fault))
    shutil.rmtree(root, ignore_errors=True)
    return gaps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--fault", choices=rwalk.FAULTS,
                    help="the reference walk with half of the batch left out, D's logits "
                         "zeroed, D's gradient dropped, or each gradient rounded to bfloat16")
    ap.add_argument("--program", action="store_true",
                    help="read the program's own answers on each seed instead (short windows, "
                         "one process)")
    args = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    bench = spec.benchmark(ROOT)
    _, cfg, traffic, limits = spec.cell(bench, args.workload)
    out = {}
    for s in (int(x) for x in args.seeds.split(",")):
        t = time.perf_counter()
        if args.program:
            import run

            result, _ = run.run_cell(bench, args.workload, cfg, traffic, limits, s, 1.0, False,
                                     t_start=time.perf_counter())
            gaps = {k: v["value"] for k, v in result["checks"].items()}
        else:
            gaps = control_readings(args.workload, cfg, traffic, s, torch.device("cuda"),
                                    args.fault)
        out[s] = gaps
        ok, _ = check.judge(gaps, limits)
        who = "program" if args.program else args.fault or "control"
        print(f"{who} {args.workload} seed {s}: {json.dumps(gaps)} passes limits: {ok} "
              f"({time.perf_counter() - t:.1f} s)", flush=True)
    print(json.dumps({"workload": args.workload, "limits": limits, "control": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
