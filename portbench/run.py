#!/usr/bin/env python3
"""Run one cell of the benchmark of latentaugment_tpu_torch once, on the
card this process finds:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (timed as setup_s, from the start of
this process): the seeded workspace (checkpoint, VGG16 pickle, image and
inversion zips), the policy through its public API
(`AugOptions().parse`, `augments.create_augment`), the host batches the
window cycles through, and warm-up batches of the cell's own shapes.
The window then runs whole batches of `set_input`, `forward`,
`get_output`, `get_latent_output` until --seconds have passed, with no
work of the harness's own between them. After it the policy is freed
and a seeded sample of the window's answers is compared with the plain
reference (harness/check.py). With --trace 1 the profiler records the
window's first batches and the per-layer metrics are reported.

The last line of standard output is one JSON object; the numbers
compared, each beside its limit, are the last lines of standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)

from harness import check, flops, spec, trace as htrace, workspace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "latentaugment_tpu")
GIB = 2 ** 30


def forbidden_loaded():
    """Top-level names of sys.modules that the port must not load."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def policy_options(traffic, device):
    if traffic["kind"] == "walk":
        opts = ["--crop_size_aug", traffic["crop_size"], "--preprocess_aug", traffic["preprocess"],
                "--init_w", traffic["init_w"], "--step_img", traffic["step_img"],
                "--step_w", traffic["step_w"], "--opt_num_epochs", traffic["num_epochs"],
                "--opt_lr", traffic["lr"], "--w_lpips", traffic["w_lpips"],
                "--w_pix", traffic["w_pix"], "--w_latent", traffic["w_latent"],
                "--w_disc", traffic["w_disc"], "--truncation_psi", traffic["truncation_psi"]]
    else:
        opts = ["--rand_aug", "--truncation_psi", traffic["truncation_psi"]]
    opts += ["--p_thres", traffic["p_thres"], "--device", device]
    if device == "cpu":
        opts += ["--impl", "ref"]
    return [str(o) for o in opts]


def power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def traced_batches(torch, policy, staged, start, n, record_shapes, plan, kept):
    """Batches start .. start + n - 1 under torch.profiler, each call in a
    span of its own; returns the stopped profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts, record_shapes=record_shapes)
    rf = torch.profiler.record_function
    prof.start()
    for i in range(start, start + n):
        with rf("portbench.batch"):
            with rf("policy.set_input"):
                policy.set_input(staged[i % len(staged)])
            with rf("policy.forward"):
                policy.forward()
            with rf("policy.get_output"):
                out = policy.get_output()
            with rf("policy.get_latent_output"):
                lat = policy.get_latent_output()
        if i in plan:
            kept[i] = (out, lat, getattr(policy.latent_aug, "last_traces", None))
    torch.cuda.synchronize()
    prof.stop()
    return prof


def run_cell(bench, workload, cfg, traffic, limits, seed, seconds, traced, device="cuda",
             t_start=None, work_root=None):
    """One run of a cell; returns (result dict, [(name, value, limit)]).
    The workspace lives under `work_root` (default build/portbench/ in the
    checkout) and is removed at the end."""
    import numpy as np
    import torch

    t_start = T_START if t_start is None else t_start
    dev = torch.device(device)
    phases = {"start_and_imports": time.perf_counter() - t_start}
    t = time.perf_counter()
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
        torch.cuda.synchronize()
    phases["cuda_init"] = time.perf_counter() - t

    from latentaugment_tpu_torch import augments
    from latentaugment_tpu_torch.options.aug_options import AugOptions

    t = time.perf_counter()
    root = os.path.join(work_root or os.path.join(ROOT, "build", "portbench"), workload)
    shutil.rmtree(root, ignore_errors=True)
    argv, env, files, (names, imgs) = workspace.write_workspace(root, cfg, traffic, seed, dev)
    argv += policy_options(traffic, device)
    os.environ.update(env)
    batch = traffic["batch"]
    staged = workspace.stage_batches(names, imgs, batch, traffic["staged_batches"])
    del imgs
    phases["workspace"] = time.perf_counter() - t

    t = time.perf_counter()
    opt = AugOptions().parse(argv=argv, install_logger=False)
    policy = augments.create_augment(opt)
    phases["policy_build"] = time.perf_counter() - t

    t = time.perf_counter()
    n_warm = traffic["warmup_batches"]
    for i in range(n_warm):
        policy.set_input(staged[i % len(staged)])
        policy.forward()
        policy.get_output()
        policy.get_latent_output()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    phases["warm_up"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start

    plan = check.sample_plan(traffic, seed)
    kept = {}
    n_trace = traffic["trace_batches"] if traced else 0
    times = []  # untraced batches: (start, after set_input, after forward, end)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    profs = []
    for shapes in ((True, False) if n_trace else ()):
        # The first traced batches record each op's arguments (the kernels'
        # rooflines), the next ones only the timeline (the idle share).
        profs.append(traced_batches(torch, policy, staged, len(profs) * n_trace, n_trace, shapes,
                                    plan, kept))
    n_trace *= len(profs)
    t0 = time.perf_counter()
    i = n_trace
    while True:
        data = staged[i % len(staged)]
        ta = time.perf_counter()
        policy.set_input(data)
        tb = time.perf_counter()
        policy.forward()
        tc = time.perf_counter()
        out = policy.get_output()
        lat = policy.get_latent_output()
        td = time.perf_counter()
        times.append((ta, tb, tc, td))
        if i in plan:
            kept[i] = (out, lat, getattr(policy.latent_aug, "last_traces", None))
        i += 1
        if td - t0 >= seconds and i > max(plan):
            break
    n_batches = i
    timed = times
    window = timed[-1][3] - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del policy, out, lat
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    def answer(k):
        o, lt, tr = kept[k]
        traces = ({k: tr["loss" if k == "loss" else "loss_" + k].float().cpu().numpy()
                   for k in ("loss", "latent", "disc")} if tr else None)
        return (np.asarray(lt["w"], np.float32).reshape(batch, -1),
                np.concatenate([o["A"], o["B"]], axis=1), traces)

    gaps = check.answers(answer, files, cfg, traffic, plan, staged, n_warm,
                         workspace.traffic_seed(seed), dev)
    correct, rows = check.judge(gaps, limits)
    shutil.rmtree(root, ignore_errors=True)

    n_timed = len(timed)
    samples_per_s = n_timed * batch / window
    metrics, device_info = {}, {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if not traced:
        # The rate is the walk's augmented samples or the sampling path's
        # generated ones: BENCHMARK.json gives each cell one of the two.
        e2e = {"aug_samples_per_s": samples_per_s, "gen_samples_per_s": samples_per_s,
               "peak_mem_gib": peak / GIB, "setup_s": setup_s}
        for m in spec.metrics_for(bench, workload, "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        red = htrace.reduce(*profs) if profs else None
        ctx = dict(cfg=cfg, traffic=traffic, batch=batch, times=timed, trace=red,
                   flops_per_sample=flops.flops_per_sample(cfg, traffic))
        for m in spec.metrics_for(bench, workload, "per_layer"):
            value = spec.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            else:
                print(f"per-layer metric {m['name']} left out: nothing to read",
                      file=sys.stderr)
        if red is not None:
            print(f"trace: {red['launches']} kernel launches over {red['n_batches']} batches; "
                  f"hand-written kernel ops {json.dumps(red['op_counts'])}", file=sys.stderr)
            device_info.update(busy_s=red["busy_s"], window_s=red["window_s"])
            breakdown = {"device_ops": [[k, v] for k, v in red["device_ops"]],
                         "idle_gaps": red["idle_gaps"]}
    print(f"set-up phases (s): {json.dumps(phases)}; setup_s {setup_s}; "
          f"window {window} s, {n_timed} batches of {batch} (+{n_trace} traced, "
          f"{n_warm} warm-up)", file=sys.stderr)
    failed = sum(1 for _, v, lim in rows if lim is not None and not (v is not None and v <= lim))
    result = {"correct": bool(correct), "attempted": n_batches * batch, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return result, rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not os.path.isfile(os.path.join(ROOT, "BENCHMARK.json")):
        print("no BENCHMARK.json at the checkout's root", file=sys.stderr)
        return 2
    bench = spec.benchmark(ROOT)
    entry, cfg, traffic, limits = spec.cell(bench, args.workload)

    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"needs {entry['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import latentaugment_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is not in this checkout: {e}", file=sys.stderr)
        return 2
    result, rows = run_cell(bench, args.workload, cfg, traffic, limits, args.seed, args.seconds,
                            bool(args.trace))
    print(f"card: {power_limit()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          file=sys.stderr)
    bad = forbidden_loaded()
    if bad:
        print(f"modules that the port must not load were loaded: {bad}", file=sys.stderr)
        return 3
    for name, value, lim in rows:
        print(f"check {name} {value} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
