"""Where the time of one latent walk goes, layer by layer.

    python -m latentaugment_tpu_torch.profile_walk [--arch stylegan2|stylegan3]
        [--impl auto|ref ...] [--batch N] [--out chiprun_out/profile_walk.json]

At the operating point of `benchmark.build_synthetic_setup` (256x256, 2
modalities, channel_base 32768, channel_max 512, bf16 in the top 4
blocks (StyleGAN3: from layer 3 on), LPIPS VGG16 on 64x64 crops, K=10,
batch 32 (StyleGAN3: 16), seeded weights) it times, for each --impl:

  * the layers of one Adam step, forward and forward+backward: G
    synthesis (w.r.t. w), D (w.r.t. the image), LPIPS VGG16 (w.r.t. its
    input crops); then one whole Adam step and the whole K-step walk
    (median of --reps runs, CUDA events);
  * one walk under torch.profiler: the device's busy time (the union of
    its kernels' intervals) against the wall time, so the idle share, and
    the device time by kind of kernel (the hand-written K1, K2 and K3,
    cuDNN convolutions and layout transforms, elementwise ops, ...).

It prints one line per --impl and writes all of it as JSON to --out.
`--device cpu` with a small `--res` runs the same code path on the CPU
(host timers, no device time) to check that it still runs.
"""

import argparse
import json
import os
import statistics
import sys
import time

import torch

from . import benchmark
from .augments import manifold
from .models import vgg

# Kernel name fragments -> kind, first match wins.
_KINDS = (
    ("K3 filtered_lrelu", ("filtered_lrelu_kernel",)),
    ("K2 upfirdn2d", ("upfirdn2d_kernel",)),
    ("K1 bias_act", ("bias_act_fwd", "bias_act_bwd")),
    ("plain FIR (depthwise conv)", ("conv_depthwise2d",)),
    ("cuDNN layout transforms", ("nchwToNhwc", "nhwcToNchw")),
    ("cuDNN conv dgrad", ("dgrad",)),
    ("cuDNN conv fprop/other", ("cudnn", "conv", "xmma", "implicit_gemm")),
    ("matmul", ("gemm", "cutlass", "cublas")),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "CatArrayBatchedCopy", "fill", "copy")),
    ("memcpy/memset", ("Memcpy", "Memset")),
)


def kind_of(name):
    for kind, keys in _KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def _timer(device, reps, warmup=2):
    """fn -> median ms over `reps` runs (CUDA events on the card)."""
    def run(fn):
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            if device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    return run


def _device_busy(prof):
    """(busy ms as the union of kernel intervals, {kind: ms}, top kernels).
    The device-side ranges of `record_function` spans (user annotations)
    are not kernels and are left out."""
    spans, kinds, names = [], {}, {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA \
                or getattr(evt, "is_user_annotation", False):
            continue
        start, end = evt.time_range.start, evt.time_range.end
        if end <= start:
            continue
        spans.append((start, end))
        ms, kind = (end - start) / 1e3, kind_of(evt.name)
        kinds[kind] = kinds.get(kind, 0.0) + ms
        names[evt.name] = names.get(evt.name, 0.0) + ms
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    top = sorted(names.items(), key=lambda kv: -kv[1])[:15]
    return busy / 1e3, dict(sorted(kinds.items(), key=lambda kv: -kv[1])), top


def profile_walk(device, impl="auto", batch=32, reps=10, seed=0, **setup):
    """Layer times and the device-time breakdown of one walk; a dict."""
    fns, bundle, g_cfg = benchmark.build_synthetic_setup(device, impl=impl, seed=seed, **setup)
    res, n_modes = g_cfg.img_resolution, g_cfg.img_channels
    crop = setup.get("crop_size", 64)
    gen = torch.Generator(device=device).manual_seed(seed + 10)
    w0 = torch.randn([batch, 1, g_cfg.w_dim], generator=gen, device=device) * 0.5
    crop_pos = manifold.get_params(res, crop)["crop_pos"]
    timed = _timer(device, reps)
    G, D = bundle["G"], bundle["D"]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def fwd_bwd(f, x, backward):
        with torch.enable_grad():
            x = x.detach().requires_grad_(backward)
            y = f(x)
            if backward:
                torch.autograd.grad(y, x, torch.ones_like(y))

    def g_fn(w):
        return G.synthesis(w.repeat(1, g_cfg.num_ws, 1), noise_mode="const")

    img = g_fn(w0).detach()
    lp_in = torch.rand([batch * n_modes, 3, crop, crop], generator=gen, device=device) * 255
    layers = {"G": (g_fn, w0), "D": (D, img),
              "VGG": (lambda x: vgg.lpips_features(bundle["vgg"], x), lp_in)}
    out = {"arch": g_cfg.get("arch", "stylegan2"), "impl": impl, "batch": batch, "res": res,
           "reps": reps}
    for name, (f, x) in layers.items():
        out[f"{name}_fwd_ms"] = timed(lambda: fwd_bwd(f, x, False))
        out[f"{name}_fwd_bwd_ms"] = timed(lambda: fwd_bwd(f, x, True))
    carry = (w0, torch.zeros_like(w0), torch.zeros_like(w0))
    out["adam_step_ms"] = timed(lambda: fns.adam_step(bundle, carry, 0, crop_pos))
    out["walk_ms"] = timed(lambda: fns.walk(bundle, w0, crop_pos, gen))
    out["num_epochs"] = fns.num_epochs

    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    sync()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fns.walk(bundle, w0, crop_pos, gen)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out["profiled_walk_wall_ms"] = wall_ms
    if device.type == "cuda":
        busy_ms, kinds, top = _device_busy(prof)
        if busy_ms <= 0:
            raise RuntimeError("the profiler recorded no device time")
        out.update(profiled_walk_device_busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
                   device_ms_by_kind=kinds, top_kernels=top)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="stylegan2", choices=["stylegan2", "stylegan3"])
    ap.add_argument("--impl", nargs="+", default=["auto", "ref"], choices=["auto", "ref"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=None,
                    help="default 32 for stylegan2, 16 for stylegan3")
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--channel_base", type=int, default=32768)
    ap.add_argument("--channel_max", type=int, default=512)
    ap.add_argument("--crop_size", type=int, default=64)
    ap.add_argument("--num_epochs", type=int, default=10)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "profile_walk.json"))
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: CUDA is not available")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    batch = args.batch or (16 if args.arch == "stylegan3" else 32)
    results = {}
    for impl in args.impl:
        r = profile_walk(device, impl=impl, batch=batch, reps=args.reps,
                         res=args.res, channel_base=args.channel_base,
                         channel_max=args.channel_max, crop_size=args.crop_size,
                         num_epochs=args.num_epochs, arch=args.arch)
        results[impl] = r
        print(json.dumps({k: v for k, v in r.items() if k != "top_kernels"}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
