#!/usr/bin/env python3
"""Time the PyTorch port's CUDA kernels K2 (upfirdn2d) and K3
(filtered_lrelu) at the shapes of the StyleGAN2 and StyleGAN3 walks.

    python3 scripts/torch_kernel_times.py [--root CHECKOUT] [--resources] [--out FILE]
                                          [--only CASE,CASE] [--sweep-tiles] [--sg3r-walk]

Needs one CUDA device and nvcc. `--root` names the checkout whose
`latentaugment_tpu_torch` is timed (default: the one this file is in), so
two commits can be compared on one card in one job: unpack the other
commit somewhere and run this file once per checkout, in turns. Only the
public functions are called, forward under `no_grad` and backward through
autograd. `--resources` prints ptxas' registers, spills and shared memory
per kernel from the build. Times are medians of 20 (CUDA events, 3 warm-up
calls); the inputs of one case (up to 0.9 GB) exceed the 50 MB L2 cache.
`--sweep-tiles` times K3's large layers once per output tile of a fixed
list in place of the plan's own choice (tile null), to check the plan's
cost model against the card; tiles whose shared memory does not fit are
reported as refused. The StyleGAN3-R cases (`R L11 fu up 2`, `R L10 fu up
4`, `R L10 radial fd down 2`, `R L11 radial fd down 2`) time K2 on the R
plan's largest layers at batch 16 in bf16 (the radial filter's backward
is its up 2), through whatever variant the checkout's plan picks. With
`--sweep-tiles` the 1-D cases also run `sepn`, and the radial ones `f2d`,
at a few other tiles. `--sg3r-walk` also times the SG3-R walk
(benchmark.build_synthetic_setup at batch 16: K=10 Adam steps and the
final synthesis; median of 3, CUDA events) and splits one walk's device
time under torch.profiler by kind of kernel, K2 by variant (`sepn`,
`f2d`, `sep4`, `generic`: the kernels' names). One JSON object per line
on stdout, then the card's name and power limit.
"""

import argparse
import json
import math
import os
import statistics
import subprocess
import sys


def median_ms(torch, fn, n=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_case(torch, fn, x):
    """(forward ms under no_grad, backward ms through autograd)."""
    with torch.no_grad():
        fwd = median_ms(torch, lambda: fn(x))
    xg = x.detach().requires_grad_(True)
    y = fn(xg)
    dy = torch.randn_like(y)
    bwd = median_ms(torch, lambda: torch.autograd.grad(y, xg, dy, retain_graph=True))
    return fwd, bwd


# Device time by kind: K2 by variant first (its kernels' names), then the
# kinds of profile_walk.py, copied so that another checkout's package is
# split the same way.
_KINDS = (
    ("K2 upfirdn2d sepn", ("upfirdn2d_kernel_sepn",)),
    ("K2 upfirdn2d f2d", ("upfirdn2d_kernel_f2d",)),
    ("K2 upfirdn2d sep4", ("upfirdn2d_kernel_sep4",)),
    ("K2 upfirdn2d generic", ("upfirdn2d_kernel",)),
    ("K3 filtered_lrelu", ("filtered_lrelu_kernel",)),
    ("K1 bias_act", ("bias_act_fwd", "bias_act_bwd")),
    ("cuDNN layout transforms", ("nchwToNhwc", "nhwcToNchw")),
    ("cuDNN conv dgrad", ("dgrad",)),
    ("cuDNN conv fprop/other", ("cudnn", "conv", "xmma", "implicit_gemm")),
    ("matmul", ("gemm", "cutlass", "cublas")),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "CatArrayBatchedCopy", "fill", "copy")),
    ("memcpy/memset", ("Memcpy", "Memset")),
)


def sg3r_walk(torch, dev, batch=16, reps=3):
    """The SG3-R walk of the checkout's package: samples/s over `reps`
    walks after one to warm up, and one walk under torch.profiler, its
    device time by kind (busy = the union of kernel intervals)."""
    import time

    from latentaugment_tpu_torch import benchmark
    from latentaugment_tpu_torch.augments import manifold
    from latentaugment_tpu_torch.ops import upfirdn2d as up

    fns, bundle, g_cfg = benchmark.build_synthetic_setup(dev, arch="stylegan3", **benchmark.SG3R)
    gen = torch.Generator(device=dev).manual_seed(10)
    w0 = torch.randn([batch, 1, g_cfg.w_dim], generator=gen, device=dev) * 0.5
    crop_pos = manifold.get_params(g_cfg.img_resolution, 64)["crop_pos"]

    def walk():
        return fns.walk(bundle, w0, crop_pos, gen)

    walk()
    torch.cuda.synchronize()
    before = dict(up.variant_launches)
    walk_ms = median_ms(torch, walk, n=reps, warmup=0)
    launches = {k: (v - before[k]) // reps for k, v in up.variant_launches.items()}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        walk()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, kinds = [], {}
    for evt in prof.events():
        # Spans' device-side ranges (user annotations) are not kernels.
        if evt.device_type != torch.autograd.DeviceType.CUDA \
                or getattr(evt, "is_user_annotation", False):
            continue
        start, end = evt.time_range.start, evt.time_range.end
        if end <= start:
            continue
        spans.append((start, end))
        kind = next((k for k, keys in _KINDS if any(key in evt.name for key in keys)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + (end - start) / 1e3
    busy, cur = 0.0, None
    for a, b in sorted(spans):
        if cur is None or a > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    busy = (busy + (0.0 if cur is None else cur[1] - cur[0])) / 1e3
    if busy <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return {"kernel": "sg3r_walk", "batch": batch, "walk_ms": walk_ms,
            "samples_per_s": batch / walk_ms * 1e3, "upfirdn2d_launches_by_variant": launches,
            "profiled_wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": 1 - busy / wall_ms,
            "device_ms_by_kind": dict(sorted(kinds.items(), key=lambda kv: -kv[1]))}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--resources", action="store_true")
    ap.add_argument("--out", default=None, help="also append the JSON lines to this file")
    ap.add_argument("--only", default=None, help="comma-separated case names (L10, 'G blur 257->256', ...)")
    ap.add_argument("--sweep-tiles", action="store_true")
    ap.add_argument("--sg3r-walk", action="store_true")
    args = ap.parse_args()
    only = set(args.only.split(",")) if args.only else None
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    from latentaugment_tpu_torch.models.stylegan3 import networks as net3
    from latentaugment_tpu_torch.ops import _build
    from latentaugment_tpu_torch.ops import filtered_lrelu as fl
    from latentaugment_tpu_torch.ops import upfirdn2d as up

    sources = ["upfirdn2d.cu", "filtered_lrelu.cu"]
    if args.resources:
        for source, text in (_build.build_cuda_libraries(sources, resource_usage=True) or {}).items():
            print(f"--- {source}\n{text}", flush=True)
    else:
        _build.build_cuda_libraries(sources)
    dev = torch.device("cuda", 0)
    bf16, f32 = torch.bfloat16, torch.float32
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def emit(row):
        row["root"] = os.path.abspath(args.root)
        rows.append(row)
        print(json.dumps(row), flush=True)

    layers = {layer.name.split("_")[0]: layer for layer in net3.generator_config().layers}
    tiles = [None]
    forced = {}
    if args.sweep_tiles:
        tiles += [(16, 32), (16, 48), (16, 64), (24, 32), (24, 48), (24, 64), (32, 32), (32, 48),
                  (32, 64), (40, 32), (40, 48), (48, 32), (8, 64)]
        plan_tile = fl._tiled_tile

        def forced_tile(up_, down, t2, out_hw):
            if forced.get("tile") is None:
                return plan_tile(up_, down, t2, out_hw)
            toh, tow = forced["tile"]
            mh = fl._round_up((toh - 1) * down + t2 + 3, 8)
            mw = fl._round_up((tow - 1) * down + t2 + 3, 8)
            return toh, tow, mh, mw, fl._tiled_smem_bytes(up_, toh, mh, mw)

        fl._tiled_tile = forced_tile
    for lname, shape, dtype in [("L10", [16, 256, 150, 150], bf16), ("L8", [16, 512, 150, 150], bf16),
                                ("L13", [16, 128, 278, 278], bf16), ("L5", [16, 512, 54, 54], bf16),
                                ("L0", [16, 512, 38, 38], f32), ("L14", [16, 2, 256, 256], bf16)]:
        if only and lname not in only:
            continue
        layer = layers[lname]
        fu, fd = (None if f is None else torch.as_tensor(f, device=dev)
                  for f in net3._layer_filters(layer))
        lo, hi = layer.padding
        kw = dict(up=layer.up_factor, down=layer.down_factor, padding=(lo, hi, lo, hi),
                  gain=1.0 if layer.is_torgb else math.sqrt(2.0),
                  slope=1.0 if layer.is_torgb else 0.2, clamp=256.0)
        x = torch.randn(shape, generator=g, device=dev).to(dtype)
        b = (torch.randn([shape[1]], generator=g, device=dev) * 0.1).to(dtype)
        for tile in (tiles if not layer.is_torgb else [None]):
            row = {"kernel": "filtered_lrelu", "case": lname, "shape": shape,
                   "dtype": str(dtype).split(".")[1]}
            if args.sweep_tiles:
                forced["tile"] = tile
                fl._plan_of.cache_clear()
                row["tile"] = tile
            try:
                row["fwd_ms"], row["bwd_ms"] = time_case(
                    torch, lambda x: fl.filtered_lrelu(x, fu, fd, b, **kw), x)
            except RuntimeError as e:
                if tile is None:
                    raise
                row["refused"] = str(e)[:80]
            emit(row)
        del x
        torch.cuda.empty_cache()

    f = up.setup_filter([1, 3, 3, 1], device=dev, separable=True)
    for name, shape, dtype, kw in [
            ("G blur 257->256", [32, 128, 257, 257], bf16, dict(padding=1, gain=4)),
            ("D blur 256->257", [32, 128, 256, 256], bf16, dict(padding=2)),
            ("D skip down 2 256->128", [32, 128, 256, 256], bf16, dict(down=2, padding=1)),
            ("skip image up 2 128->256", [32, 2, 128, 128], f32,
             dict(up=2, padding=(2, 1, 2, 1), gain=4)),
            ("G blur 65->64", [32, 512, 65, 65], bf16, dict(padding=1, gain=4))]:
        if only and name not in only:
            continue
        x = torch.randn(shape, generator=g, device=dev).to(dtype)
        fwd, bwd = time_case(torch, lambda x: up.upfirdn2d(x, f, **kw), x)
        emit({"kernel": "upfirdn2d", "case": name, "shape": shape,
              "dtype": str(dtype).split(".")[1], "fwd_ms": fwd, "bwd_ms": bwd})
        del x
        torch.cuda.empty_cache()

    # StyleGAN3-R: K2 on the R plan's largest decomposed layers, batch 16.
    from latentaugment_tpu_torch import benchmark

    g_cfg, _ = benchmark.make_gd_configs(256, 2, num_fp16_res=0, arch="stylegan3",
                                         channel_base=32768, channel_max=512, **benchmark.SG3R)
    r_layers = {layer.name.split("_")[0]: layer for layer in g_cfg.layers if layer.down_radial}
    for name, lname, which in [("R L11 fu up 2", "L11", "fu"), ("R L10 fu up 4", "L10", "fu"),
                               ("R L10 radial fd down 2", "L10", "fd"),
                               ("R L11 radial fd down 2", "L11", "fd")]:
        if only and name not in only:
            continue
        layer = r_layers[lname]
        fu, fd = (torch.as_tensor(f, device=dev) for f in net3._layer_filters(layer))
        lo, hi = layer.padding
        n_in = layer.in_size
        if which == "fu":
            shape, fr = [16, layer.out_channels, n_in, n_in], fu
            kw = dict(up=layer.up_factor, padding=(lo, hi, lo, hi), gain=layer.up_factor ** 2)
        else:
            mid = n_in * layer.up_factor + lo + hi - (fu.shape[0] - 1)
            shape, fr, kw = [16, layer.out_channels, mid, mid], fd, dict(down=layer.down_factor)
        x = torch.randn(shape, generator=g, device=dev).to(bf16)
        # --sweep-tiles: other tiles of this case's forward and backward
        # rows in place of the plan's, in `sepn`'s (up, down, taps) -> tile
        # or `f2d`'s (up, down) -> tile (at most its launcher's largest),
        # where the checkout has the table.
        u, t = layer.up_factor, fr.shape[0]
        if which == "fu":
            tiles, tiles_key = getattr(up, "_SEPN_TILES", None), "sepn_tiles"
            others = [{(u, 1, t): fwd_tile, (1, u, t): bwd_tile} for fwd_tile, bwd_tile in
                      [((32, 128), (32, 32)), ((64, 64), (16, 64)), ((32, 256), (8, 64)),
                       ((128, 128), (32, 64))]]
        else:
            tiles, tiles_key = getattr(up, "_F2D_TILES", None), "f2d_tiles"
            others = [{(1, 2): fwd_tile, (2, 1): bwd_tile} for fwd_tile, bwd_tile in
                      [((32, 64), (32, 128)), ((64, 32), (64, 64)), ((48, 64), (32, 64)),
                       ((64, 48), (64, 96))]]
        sweep = [None] + (others if args.sweep_tiles and tiles is not None else [])
        planned = dict(tiles or {})
        for tiles_now in sweep:
            before = dict(up.variant_launches)
            row = {"kernel": "upfirdn2d", "case": name, "shape": shape, "dtype": "bfloat16"}
            if tiles_now is not None:
                tiles.update(tiles_now)
                row[tiles_key] = {str(k): v for k, v in tiles_now.items()}
            try:
                row["fwd_ms"], row["bwd_ms"] = time_case(
                    torch, lambda x: up.upfirdn2d(x, fr, **kw), x)
            except RuntimeError as e:
                if tiles_now is None:
                    raise
                row["refused"] = str(e)[:80]
            finally:
                if tiles_now is not None:
                    tiles.update(planned)
            row["variants"] = sorted(k for k, v in up.variant_launches.items() if v != before[k])
            emit(row)
        del x
        torch.cuda.empty_cache()

    if args.sg3r_walk:
        emit(sg3r_walk(torch, dev))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as fh:
            for row in rows:
                fh.write(json.dumps(dict(row, nvidia_smi=smi)) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
