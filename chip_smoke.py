#!/usr/bin/env python3
"""Drive the PyTorch port of LatentAugment once on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA device, nvcc (for the
upfirdn2d kernel) and Triton (for bias_act), and imports no JAX. Any
failure raises and exits non-zero, printing no result line.

  1. Kernels: builds both hand-written kernels from the checkout's
     sources and holds each, forward and input gradient, against its
     plain PyTorch version at the shapes the walk gives it, in float32
     (TF32 off) and bfloat16, timing both (median of 20, CUDA events).
  2. Small reference: a 32x32 walk (K=3) on the CPU with the plain
     versions against the same walk on the card through the kernels.
  3. The slice: the LatentAugment policy at the operating point (256x256,
     2 modalities, channel_base 32768, channel_max 512, bf16 in the top 4
     blocks, LPIPS VGG16 on 64x64 crops, K=10 Adam steps, batch 32) through
     AugOptions -> create_dataset -> create_augment -> set_input / forward
     / get_output for 3 batches, with the kernels' launch counters reset
     just before and read just after; then the same with --impl ref.

The last two lines of stdout are the kernels' JSON record and
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
"""

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
TOL = {"float32": 1e-5, "bfloat16": 1e-2}        # forward, max err / max |plain|
TOL_GRAD = {"float32": 1e-5, "bfloat16": 2e-2}   # bf16 plain gradients round 3-4 times
SQRT_HALF = math.sqrt(0.5)
BATCH, RES, N_BATCHES = 32, 256, 3


def log(msg):
    print(msg, flush=True)


def median_ms(fn, n=20, warmup=3):
    import torch

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


def compare(name, fn, x, dy_seed, dtype_name, records):
    """Kernel (impl='auto') vs plain (impl='ref'): values and dx, timed."""
    import torch

    ys, dxs, ms = {}, {}, {}
    for impl in ("auto", "ref"):
        xg = x.detach().requires_grad_(True)
        y = fn(xg, impl)
        if impl == "auto":
            g = torch.Generator(device=x.device).manual_seed(dy_seed)
            dy = torch.randn(y.shape, generator=g, device=x.device).to(y.dtype)
        dx, = torch.autograd.grad(y, xg, dy, retain_graph=True)
        torch.cuda.synchronize()
        with torch.no_grad():
            fwd_ms = median_ms(lambda: fn(x, impl))
        bwd_ms = median_ms(lambda: torch.autograd.grad(y, xg, dy, retain_graph=True))
        ys[impl], dxs[impl], ms[impl] = y.detach(), dx, (fwd_ms, bwd_ms)
        del y, xg
    rec = {"case": name, "dtype": dtype_name, "shape": list(x.shape)}
    for key, (k, r), tol in (("fwd", (ys["auto"], ys["ref"]), TOL[dtype_name]),
                              ("bwd", (dxs["auto"], dxs["ref"]), TOL_GRAD[dtype_name])):
        if k.shape != r.shape or k.dtype != r.dtype:
            raise AssertionError(f"{name} {key}: kernel {tuple(k.shape)} {k.dtype}, "
                                 f"plain {tuple(r.shape)} {r.dtype}")
        diff = (k.float() - r.float()).abs().max().item()
        scale = r.float().abs().max().item()
        if not math.isfinite(diff) or diff > tol * max(scale, 1e-30):
            raise AssertionError(f"{name} {key} {dtype_name}: max |kernel - plain| = {diff} "
                                 f"> {tol} x max |plain| = {scale}")
        rec[f"{key}_max_abs_err"] = diff
        rec[f"{key}_rel_err"] = diff / max(scale, 1e-30)
    rec["fwd_ms"], rec["bwd_ms"] = ms["auto"]
    rec["plain_fwd_ms"], rec["plain_bwd_ms"] = ms["ref"]
    records.append(rec)
    log(f"  {name:34s} {dtype_name:8s} fwd err {rec['fwd_rel_err']:.2e} bwd err "
        f"{rec['bwd_rel_err']:.2e} | fwd {rec['fwd_ms']:.3f} ms (plain {rec['plain_fwd_ms']:.3f})"
        f" bwd {rec['bwd_ms']:.3f} ms (plain {rec['plain_bwd_ms']:.3f})")
    return rec


def phase_kernels(torch, ba, up, dev):
    """Both kernels against their plain versions at the walk's shapes."""
    log("phase 1: kernels vs plain PyTorch")
    bf16, f32 = torch.bfloat16, torch.float32
    names = {f32: "float32", bf16: "bfloat16"}
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    bias_recs, up_recs = [], []
    # bias_act: every conv / FC of G and D ends in it.
    cases = [
        ("G conv 256x256 lrelu clamp", [BATCH, 128, RES, RES], bf16, dict(act="lrelu", clamp=256)),
        ("G conv 256x256 lrelu clamp", [BATCH, 128, RES, RES], f32, dict(act="lrelu", clamp=256)),
        ("D skip 128x128 linear", [BATCH, 256, 128, 128], bf16, dict(act="linear", gain=SQRT_HALF, bias=False)),
        ("torgb 256x256 linear clamp", [BATCH, 2, RES, RES], f32, dict(act="linear", clamp=256)),
        ("fp32 block 16x16, clamp engaged", [BATCH, 512, 16, 16], f32, dict(act="lrelu", clamp=256, scale=300.0)),
        ("mapping / D FC [32,512]", [BATCH, 512], f32, dict(act="lrelu")),
        ("mapping / D FC [32,512]", [BATCH, 512], bf16, dict(act="lrelu")),
    ]
    cases += [(f"activation {a}", [8, 64, 32, 32], dt, dict(act=a))
              for a in sorted(ba.activation_funcs) for dt in (f32, bf16)]
    for name, shape, dtype, kw in cases:
        kw = dict(kw)
        scale, has_bias = kw.pop("scale", 1.0), kw.pop("bias", True)
        x = randn(shape, dtype, scale)
        b = randn([shape[1]], dtype) if has_bias else None
        rec = compare(name, lambda x, impl: ba.bias_act(x, b, impl=impl, **kw), x,
                      len(bias_recs), names[dtype], bias_recs)
        rec["kw"] = kw

    # upfirdn2d: every FIR blur and resample of G and D.
    f = up.setup_filter([1, 3, 3, 1], device=dev, separable=True)
    cases = [
        ("G blur after up-conv (257->256)", [BATCH, 128, RES + 1, RES + 1], bf16,
         dict(padding=1, gain=4)),
        ("G blur after up-conv (257->256)", [BATCH, 128, RES + 1, RES + 1], f32, dict(padding=1, gain=4)),
        ("D blur before stride-2 (256->257)", [BATCH, 128, RES, RES], bf16, dict(padding=2)),
        ("D 1x1 skip down=2 (256->128)", [BATCH, 128, RES, RES], bf16, dict(down=2, padding=1)),
        ("skip-image upsample2d (128->256)", [BATCH, 2, RES // 2, RES // 2], f32,
         dict(up=2, padding=(2, 1, 2, 1), gain=4)),
    ]
    for name, shape, dtype, kw in cases:
        x = randn(shape, dtype)
        rec = compare(name, lambda x, impl: up.upfirdn2d(x, f, impl=impl, **kw), x,
                      100 + len(up_recs), names[dtype], up_recs)
        rec["kw"] = {k: list(v) if isinstance(v, tuple) else v for k, v in kw.items()}
        del x
        torch.cuda.empty_cache()
    return bias_recs, up_recs


def phase_small_reference(torch, benchmark):
    """A 32x32 walk on the CPU (plain versions) against the card (kernels)."""
    log("phase 2: small walk, CPU plain vs card kernels (float32)")
    out = {}
    for dev in ("cpu", "cuda"):
        fns, bundle, g_cfg = benchmark.build_synthetic_setup(
            torch.device(dev), res=32, channel_base=1024, channel_max=64, num_epochs=3,
            crop_size=16, manifold_items=8, seed=5)
        w0 = torch.randn([4, 1, g_cfg.w_dim], generator=torch.Generator().manual_seed(6)) * 0.5
        img, ws, traces = fns.walk(bundle, w0.to(dev), (2, 4), torch.Generator(device=dev))
        out[dev] = (ws.cpu(), {k: v.cpu() for k, v in traces.items()}, img.cpu())
    (ws_c, tr_c, img_c), (ws_g, tr_g, img_g) = out["cpu"], out["cuda"]
    # 1e-3 relative: two devices' conv algorithms sum in other orders.
    for k in tr_c:
        torch.testing.assert_close(tr_g[k], tr_c[k], rtol=1e-3, atol=1e-6)
    # 1e-3 absolute on w, a tenth of one Adam step (lr 0.01): Adam's
    # normalisation magnifies tiny gradient differences where a gradient
    # changes sign between steps.
    torch.testing.assert_close(ws_g, ws_c, rtol=0, atol=1e-3)
    if not (torch.isfinite(img_g).all() and img_g.shape == img_c.shape):
        raise AssertionError("small walk: bad final image on the card")
    err = {k: (tr_g[k] - tr_c[k]).abs().max().item() for k in tr_c}
    log(f"  per-step loss max |card - cpu|: {err}; final w max |diff| "
        f"{(ws_g - ws_c).abs().max().item():.2e}")
    return {"trace_max_abs_diff": err, "w_max_abs_diff": (ws_g - ws_c).abs().max().item()}


def run_policy(torch, argv, counters):
    """AugOptions -> create_dataset -> create_augment -> per-batch
    set_input / forward / get_output; returns per-batch records."""
    from latentaugment_tpu_torch.augments import create_augment
    from latentaugment_tpu_torch.data import create_dataset
    from latentaugment_tpu_torch.options import AugOptions

    opt = AugOptions().parse(argv=argv, install_logger=False)
    dataset = create_dataset(opt)
    for c in counters:
        c.update(dict.fromkeys(c, 0))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    augment = create_augment(opt)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    batches = []
    for data in dataset:
        t0 = time.time()
        augment.set_input(data)
        augment.forward()
        out = augment.get_output()
        torch.cuda.synchronize()
        wall = time.time() - t0
        traces = {k: v.float().cpu() for k, v in augment.latent_aug.last_traces.items()}
        batches.append(dict(out=out, wall=wall, traces=traces,
                            w_in=augment.get_latent_input()["w"],
                            w_out=augment.get_latent_output()["w"]))
    launches = {k: v for c in counters for k, v in c.items()}
    return batches, launches, setup_s, torch.cuda.max_memory_allocated()


def phase_slice(torch, np, benchmark, ba, up):
    log("phase 3: the LatentAugment policy at the operating point")
    root = os.path.join(REPO, "build", "chip_smoke")
    shutil.rmtree(root, ignore_errors=True)
    argv = benchmark.build_policy_workspace(root, batch_size=BATCH)
    counters = (ba.launches, up.launches)

    batches, launches, setup_s, peak = run_policy(torch, argv, counters)
    if len(batches) != N_BATCHES:
        raise AssertionError(f"expected {N_BATCHES} batches, got {len(batches)}")
    for i, b in enumerate(batches):
        for k in ("A", "B"):
            a = b["out"][k]
            if a.shape != (BATCH, 1, RES, RES) or not np.isfinite(a).all():
                raise AssertionError(f"batch {i} {k}: shape {a.shape}, finite {np.isfinite(a).all()}")
        if np.allclose(b["w_out"], b["w_in"]):
            raise AssertionError(f"batch {i}: the walk did not move w")
        for k, v in b["traces"].items():
            if v.shape != (10,) or not torch.isfinite(v).all():
                raise AssertionError(f"batch {i}: loss trace {k} = {v}")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    kernel_sps = 2 * BATCH / (batches[1]["wall"] + batches[2]["wall"])
    log(f"  kernels: batch walls {[round(b['wall'], 3) for b in batches]} s, "
        f"{kernel_sps:.3f} samples/s over batches 2-3, set-up {setup_s:.1f} s, "
        f"peak memory {peak / 2**30:.2f} GiB, launches {launches}")

    ref, ref_launches, _, ref_peak = run_policy(torch, argv + ["--impl", "ref"], counters)
    if any(ref_launches.values()):
        raise AssertionError(f"--impl ref launched kernels: {ref_launches}")
    ref_sps = 2 * BATCH / (ref[1]["wall"] + ref[2]["wall"])
    log(f"  plain (--impl ref): batch walls {[round(b['wall'], 3) for b in ref]} s, "
        f"{ref_sps:.3f} samples/s over batches 2-3, peak memory {ref_peak / 2**30:.2f} GiB")
    # The step-0 losses depend on the forward pass only (same data, w and
    # crop): kernels and plain versions agree to bf16 rounding.
    step0 = []
    for i, (bk, br) in enumerate(zip(batches, ref)):
        np.testing.assert_array_equal(bk["w_in"], br["w_in"])
        for k in bk["traces"]:
            a, r = bk["traces"][k][0].item(), br["traces"][k][0].item()
            if abs(a - r) > 1e-2 * abs(r) + 1e-6:
                raise AssertionError(f"batch {i} step-0 {k}: kernels {a}, plain {r}")
            step0.append((i, k, a, r))
    log(f"  step-0 losses, kernels vs plain: max rel diff "
        f"{max(abs(a - r) / max(abs(r), 1e-12) for _, _, a, r in step0):.2e}")
    return dict(launches=launches, kernel_samples_per_s=kernel_sps,
                plain_samples_per_s=ref_sps, batch_wall_s=[b["wall"] for b in batches],
                plain_batch_wall_s=[b["wall"] for b in ref], setup_s=setup_s,
                peak_mem_bytes=peak, plain_peak_mem_bytes=ref_peak,
                step0_losses=[{"batch": i, "loss": k, "kernels": a, "plain": r}
                              for i, k, a, r in step0],
                loss_traces=[{k: v.tolist() for k, v in b["traces"].items()} for b in batches])


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "latentaugment_tpu_torch")):
        print(f"chip_smoke: {REPO} is not a checkout of the repository "
              "(latentaugment_tpu_torch/ is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import numpy as np

    from latentaugment_tpu_torch import benchmark
    from latentaugment_tpu_torch.ops import bias_act as ba
    from latentaugment_tpu_torch.ops import upfirdn2d as up

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}; "
        "TF32 off for convs and matmuls")

    t0 = time.time()
    bias_recs, up_recs = phase_kernels(torch, ba, up, dev)
    log(f"  phase 1 took {time.time() - t0:.1f} s (builds included)")
    small = phase_small_reference(torch, benchmark)
    slice_rec = phase_slice(torch, np, benchmark, ba, up)

    def main_rec(recs, name, dtype):
        return next(r for r in recs if r["case"] == name and r["dtype"] == dtype)

    ba_main = main_rec(bias_recs, "G conv 256x256 lrelu clamp", "bfloat16")
    up_main = main_rec(up_recs, "G blur after up-conv (257->256)", "bfloat16")
    kernels = [
        {"name": "bias_act_fwd", "route": "triton", "source": "latentaugment_tpu_torch/ops/bias_act.py",
         "replaces": "latentaugment_tpu/ops/bias_act.py:125",
         "launches": slice_rec["launches"]["bias_act_fwd"],
         "max_abs_err": max(r["fwd_max_abs_err"] for r in bias_recs),
         "ms": ba_main["fwd_ms"], "plain_ms": ba_main["plain_fwd_ms"]},
        {"name": "bias_act_bwd", "route": "triton", "source": "latentaugment_tpu_torch/ops/bias_act.py",
         "replaces": "latentaugment_tpu/ops/bias_act.py:125",
         "launches": slice_rec["launches"]["bias_act_bwd"],
         "max_abs_err": max(r["bwd_max_abs_err"] for r in bias_recs),
         "ms": ba_main["bwd_ms"], "plain_ms": ba_main["plain_bwd_ms"]},
        {"name": "upfirdn2d", "route": "cuda", "source": "latentaugment_tpu_torch/csrc/upfirdn2d.cu",
         "replaces": "latentaugment_tpu/ops/upfirdn2d.py:564",
         "launches": slice_rec["launches"]["upfirdn2d"],
         "max_abs_err": max(max(r["fwd_max_abs_err"], r["bwd_max_abs_err"]) for r in up_recs),
         "ms": up_main["fwd_ms"], "plain_ms": up_main["plain_fwd_ms"]},
    ]

    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
                   "bias_act": bias_recs, "upfirdn2d": up_recs, "small_reference": small,
                   "slice": slice_rec, "kernels": kernels}, f, indent=1)

    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
