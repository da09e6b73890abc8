#!/usr/bin/env python3
"""Drive the PyTorch port of LatentAugment once on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA device, nvcc (for the
upfirdn2d and filtered_lrelu kernels), Triton (for bias_act) and the CPU
(phases 2, 7 and 8 hold the card against it), and imports no JAX. Any failure raises and exits non-zero, printing no result
line.

  1. Kernels: builds the three hand-written kernels from the checkout's
     sources (the two nvcc builds run side by side) and holds each,
     forward and input gradient, against its plain PyTorch version at the
     shapes the StyleGAN2 and StyleGAN3 walks give it, in float32 (TF32
     off) and bfloat16, timing both (median of 20, CUDA events), with
     each case's bound (the larger of its bytes over 3.35 TB/s and its
     fp32 operations over 67 TFLOP/s, from the wrappers' `work`) and,
     for the three upfirdn2d cases one PyTorch call computes (a depthwise
     `F.conv2d` with the 4x4 filter), that call's time. filtered_lrelu's
     record (2 bits per up-rate pixel) is compared unpacked.
  2. Small reference: a 32x32 StyleGAN2 walk and a 64x64 StyleGAN3 walk
     (K=3, float32) on the CPU with the plain versions against the same
     walks on the card through the kernels.
  3. The StyleGAN2 slice: the LatentAugment policy at the operating point
     (256x256, 2 modalities, channel_base 32768, channel_max 512, bf16 in
     the top 4 blocks, LPIPS VGG16 on 64x64 crops, K=10 Adam steps, batch
     32) through AugOptions -> create_dataset -> create_augment ->
     set_input / forward / get_output for 3 batches, with the kernels'
     launch counters reset just before and read just after (no launch
     may have gone through a kernel's `generic` variant); then the same
     with --impl ref.
  4. The StyleGAN3 slice: the same policy over an alias-free SG3-T
     checkpoint (same widths, bf16 from layer 3 on, batch 16, no remat),
     3 batches with the kernels, then with --impl ref; where the plain
     versions do not fit the card at batch 16 it says so and compares at
     the largest batch that fits.
  5. The projector at full width: `scripts/torch_project_dataset.py`'s
     `main` over a synthetic zip at the operating-point StyleGAN2, batch
     16, 20 steps (one batch to warm up, held at step 0 against --impl
     ref; then 32 slices with the launch counts read), and the policy
     reads the inversion zip it wrote with --init_w inv. Then 5 steps at
     batch 8 over phase 4's SG3-T checkpoint, which reaches
     filtered_lrelu from this path, held at step 0 against --impl ref.
  6. The `tr` walk: 2 policy batches at batch 32 with --lpips_script
     lpips_tr on phase 3's workspace, then with --impl ref.
  7. GeometricAugment: the deterministic cores on the card against the
     same call on the CPU at batch 32, 256x256 (1e-5, float32, on smooth
     images; affine_warp on white noise within the bound its float32
     sampling positions' difference gives, and to 1e-5 with theta made in
     float64), then the policy with all three transforms through the
     registry, timed.
  8. Metrics: InceptionV3 and the VGG16 detector on one batch of 32, card
     against CPU (1e-4), the metrics' generator call (batch 16, random
     noise) with the kernels against the plain versions, then FID and
     precision/recall of the live StyleGAN2 generator (512 generated
     images) against phase 3's 96 slices, with the launch counts read.
  9. The trainer at the operating point's widths (StyleGAN2 G and D at
     256x256, 2 modalities, channel_base 32768, channel_max 512, 2 mapping
     layers, conv_clamp 256, bf16 in the top 4 resolutions, batch 32, path
     length at 16, no remat, seeded random weights): the four phase losses
     (const noise, no mixing, no ADA) and every parameter gradient with the
     kernels against the plain versions, in float32 (losses 1e-2 relative,
     gradients 2e-2 of max |plain|) and with the bf16 top blocks (losses
     1e-2, gradient errors recorded); then `train_loop` with ADA bgc at a fixed
     p = 0.2, random noise and style mixing 0.9 for one warm-up step and
     16 timed ones (one d_reg_interval: 4 path-length and 1 R1 phases),
     with s/step, images/s, the peak memory and the launches over the 16
     steps (second-order ones included, which must be > 0); each phase
     once alone (CUDA events), then under torch.profiler (device time by
     kind of kernel); the final snapshot loads back.

Phase 1c differentiates K1 and K2 twice, as R1 and path length do, at
the trainer's shapes (1e-5 of max |plain| in float32, 2e-2 in bfloat16).
No launch of phases 5, 6, 8 and 9 may go through a kernel's `generic`
variant. The last two lines of stdout are the kernels' JSON record and
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
"""

import gc
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
# filtered_lrelu in bf16: K3 rounds once, the plain version at each of its
# four stages (bias, up-FIR, lrelu, down-FIR), so its values get the
# gradient bound. Its backward is held against the plain backward at the
# plain version's own sign/clamp record: lrelu's derivative jumps at 0,
# and where an up-rate value lies within rounding of 0 (in bf16 about one
# pixel in a thousand) the two may take different branches. K3's own
# record may differ from the plain one on at most this share of pixels:
TOL_FL = {"float32": 1e-5, "bfloat16": 2e-2}
RECORD_SLIVER = {"float32": 1e-5, "bfloat16": 1e-2}
SQRT_HALF = math.sqrt(0.5)
# The card's published peaks (H100 SXM): device memory, fp32 outside the tensor cores.
PEAK_BYTES_PER_S, PEAK_F32_FLOPS = 3.35e12, 67e12
BATCH, RES, N_BATCHES = 32, 256, 3
SG3_BATCH = 16
PROJ_BATCH, PROJ_STEPS = 16, 20          # the projector on StyleGAN2
PROJ_SG3_BATCH, PROJ_SG3_STEPS = 8, 5    # and on the SG3-T checkpoint
N_GEN = 512                              # generated images of the metrics
# Launch counts by kernel variant, by kernel name; main() fills it.
VARIANT_COUNTERS = {}


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


def run_both(fn, x, dy_seed):
    """Kernel (impl='auto') and plain (impl='ref') on the same x and dy:
    (values, dx, (fwd ms, bwd ms)) keyed by impl, and dy."""
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
        torch.cuda.empty_cache()
    return ys, dxs, ms, dy


def check_close(rec, key, got, want, tol):
    """max |got - want| <= tol * max |want| (same shape and dtype), noted
    in rec under `key`."""
    name, dtype_name = rec["case"], rec["dtype"]
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name} {key}: kernel {tuple(got.shape)} {got.dtype}, "
                             f"plain {tuple(want.shape)} {want.dtype}")
    diff = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if not math.isfinite(diff) or diff > tol * max(scale, 1e-30):
        raise AssertionError(f"{name} {key} {dtype_name}: max |kernel - plain| = {diff} "
                             f"> {tol} x max |plain| = {scale}")
    rec[f"{key}_max_abs_err"] = diff
    rec[f"{key}_rel_err"] = diff / max(scale, 1e-30)


def bound_ms(nbytes, macs=0):
    """(least ms the card could take, 'bytes' or 'operations'): each input
    byte read once and each output byte written once at the memory rate,
    against two operations per multiply-add at the fp32 rate."""
    by_bytes, by_ops = nbytes / PEAK_BYTES_PER_S * 1e3, 2 * macs / PEAK_F32_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def set_bounds(rec, fwd, bwd):
    """Note a case's forward and backward bounds, each (bytes, multiply-adds)."""
    (rec["bound_fwd_ms"], rec["bound_fwd_by"]), (rec["bound_bwd_ms"], rec["bound_bwd_by"]) = \
        bound_ms(*fwd), bound_ms(*bwd)


def finish_record(rec, ms, records, extra=""):
    rec["fwd_ms"], rec["bwd_ms"] = ms["auto"]
    rec["plain_fwd_ms"], rec["plain_bwd_ms"] = ms["ref"]
    records.append(rec)
    lib = (f", library {rec['library_fwd_ms']:.3f} / {rec['library_bwd_ms']:.3f}"
           if rec.get("library_fwd_ms") is not None else "")
    log(f"  {rec['case']:34s} {rec['dtype']:8s} fwd err {rec['fwd_rel_err']:.2e} bwd err "
        f"{rec['bwd_rel_err']:.2e}{extra} | fwd {rec['fwd_ms']:.3f} ms (plain "
        f"{rec['plain_fwd_ms']:.3f}) bwd {rec['bwd_ms']:.3f} ms (plain {rec['plain_bwd_ms']:.3f}) "
        f"| bound {rec['bound_fwd_ms']:.3f} / {rec['bound_bwd_ms']:.3f} ms{lib}")


def compare(name, fn, x, dy_seed, dtype_name, records, bounds, library=None):
    """Kernel vs plain: values and dx, timed. `bounds` are the forward's and
    the backward's (bytes, multiply-adds); `library`, where one PyTorch
    call computes the same function, is that call as x -> y: it is timed
    and held to the plain version, and the port never calls it."""
    import torch

    ys, dxs, ms, dy = run_both(fn, x, dy_seed)
    rec = {"case": name, "dtype": dtype_name, "shape": list(x.shape)}
    check_close(rec, "fwd", ys["auto"], ys["ref"], TOL[dtype_name])
    check_close(rec, "bwd", dxs["auto"], dxs["ref"], TOL_GRAD[dtype_name])
    set_bounds(rec, *bounds)
    rec["library_fwd_ms"] = rec["library_bwd_ms"] = None
    if library is not None:
        xg = x.detach().requires_grad_(True)
        y = library(xg)
        check_close(rec, "library", y.detach(), ys["ref"], TOL_GRAD[dtype_name])
        with torch.no_grad():
            rec["library_fwd_ms"] = median_ms(lambda: library(x))
        rec["library_bwd_ms"] = median_ms(
            lambda: torch.autograd.grad(y, xg, dy, retain_graph=True))
        del y, xg
    finish_record(rec, ms, records)
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
        # Forward: x in, y out; backward: dy and the saved y in, dx out.
        nbytes = x.numel() * x.element_size()
        rec = compare(name, lambda x, impl: ba.bias_act(x, b, impl=impl, **kw), x,
                      len(bias_recs), names[dtype], bias_recs,
                      ((2 * nbytes, 0), (3 * nbytes, 0)))
        rec["kw"] = kw

    # upfirdn2d: every FIR blur and resample of G and D.
    f = up.setup_filter([1, 3, 3, 1], device=dev, separable=True)
    f2d = torch.outer(f, f).flip([0, 1])  # conv2d correlates; the op convolves
    # (name, shape, dtype, arguments, the forward's and the backward's variant,
    # F.conv2d's stride and padding where one such call computes the case)
    cases = [
        ("G blur after up-conv (257->256)", [BATCH, 128, RES + 1, RES + 1], bf16,
         dict(padding=1, gain=4), ("u1d1", "u1d1"), (1, 1)),
        ("G blur after up-conv (257->256)", [BATCH, 128, RES + 1, RES + 1], f32, dict(padding=1, gain=4),
         ("u1d1", "u1d1"), None),
        ("D blur before stride-2 (256->257)", [BATCH, 128, RES, RES], bf16, dict(padding=2),
         ("u1d1", "u1d1"), (1, 2)),
        ("D 1x1 skip down=2 (256->128)", [BATCH, 128, RES, RES], bf16, dict(down=2, padding=1),
         ("u1d2", "u2d1"), (2, 1)),
        ("skip-image upsample2d (128->256)", [BATCH, 2, RES // 2, RES // 2], f32,
         dict(up=2, padding=(2, 1, 2, 1), gain=4), ("u2d1", "u1d2"), None),
    ]
    for name, shape, dtype, kw, variants, conv in cases:
        x = randn(shape, dtype)
        library = None
        if conv is not None:
            weight = (f2d * kw.get("gain", 1)).to(dtype)[None, None].repeat(shape[1], 1, 1, 1)

            def library(x, weight=weight, conv=conv):
                return torch.nn.functional.conv2d(x, weight, stride=conv[0], padding=conv[1],
                                                  groups=weight.shape[0])
        work = up.work(shape, f.shape, itemsize=x.element_size(),
                       **{k: v for k, v in kw.items() if k != "gain"})
        # The backward reads dy and writes dx, the same bytes; they bound both.
        bound = (work["bytes"], work["macs"])
        before = dict(up.variant_launches)
        rec = compare(name, lambda x, impl: up.upfirdn2d(x, f, impl=impl, **kw), x,
                      100 + len(up_recs), names[dtype], up_recs, (bound, bound), library)
        used = {k for k in before if up.variant_launches[k] != before[k]}
        if used != set(variants):
            raise AssertionError(f"{name}: launched variants {used}, expected {variants}")
        rec["variant"], rec["bwd_variant"] = variants
        rec["kw"] = {k: list(v) if isinstance(v, tuple) else v for k, v in kw.items()}
        del x
        torch.cuda.empty_cache()
    return bias_recs, up_recs


def second_order(torch, fn, x, dy1, dy2):
    """R1's and path length's pattern: g = d<fn(x), dy1>/dx with its graph,
    then d<g, dy2>/d dy1 (d/dx is zero for these piecewise-linear ops and
    autograd gives none). Returns (g, d/d dy1)."""
    xg, d1 = x.detach().requires_grad_(True), dy1.detach().requires_grad_(True)
    g, = torch.autograd.grad(fn(xg), xg, d1, create_graph=True)
    gx, gdy = torch.autograd.grad(g, (xg, d1), dy2, allow_unused=True)
    if gx is not None and gx.any():
        raise AssertionError("a second derivative with respect to x appeared")
    return g.detach(), gdy


def phase_second_order(torch, ba, up, dev):
    """K1 and K2 differentiated twice, as R1 and path length do, at the
    trainer's shapes: kernels (impl='auto') and plain (impl='ref') on the
    same tensors, with each side's time (forward, backward with its graph
    and the second backward; CUDA events: the kernels' median of 10, the
    plain side once)."""
    log("phase 1c: second derivatives through K1 and K2 vs plain PyTorch")
    bf16, f32 = torch.bfloat16, torch.float32
    names = {f32: "float32", bf16: "bfloat16"}
    g = torch.Generator(device=dev).manual_seed(21)
    f = up.setup_filter([1, 3, 3, 1], device=dev, separable=True)
    shape = [BATCH, 128, RES, RES]
    b = torch.randn([128], generator=g, device=dev)
    # (name, dtype, function, (kernel, variants), K2's arguments for its bound)
    cases = [
        ("G conv 256x256 lrelu clamp", f32, lambda x, impl: ba.bias_act(
            x, b.to(x.dtype), act="lrelu", clamp=256, impl=impl), ("bias_act", None), None),
        ("G conv 256x256 lrelu clamp", bf16, lambda x, impl: ba.bias_act(
            x, b.to(x.dtype), act="lrelu", clamp=256, impl=impl), ("bias_act", None), None),
        ("D blur before stride-2 (256->257)", bf16, lambda x, impl: up.upfirdn2d(
            x, f, padding=2, impl=impl), ("upfirdn2d", {"u1d1": 3}), dict(padding=2)),
        ("D 1x1 skip down=2 (256->128)", bf16, lambda x, impl: up.upfirdn2d(
            x, f, down=2, padding=1, impl=impl), ("upfirdn2d", {"u1d2": 2, "u2d1": 1}),
         dict(down=2, padding=1)),
    ]
    recs = []
    for name, dtype, fn, (kernel, variants), k2_args in cases:
        x = torch.randn(shape, generator=g, device=dev).to(dtype)
        dy1 = torch.randn(fn(x, "ref").shape, generator=g, device=dev).to(dtype)
        dy2 = torch.randn(shape, generator=g, device=dev).to(dtype)
        before_k = {k: v for c in (ba.launches, up.launches) for k, v in c.items()}
        before_v = dict(up.variant_launches)
        got = second_order(torch, lambda x: fn(x, "auto"), x, dy1, dy2)
        launched = {k: v - before_k[k] for c in (ba.launches, up.launches) for k, v in c.items()}
        used = {k: up.variant_launches[k] - before_v[k] for k in before_v
                if up.variant_launches[k] != before_v[k]}
        want_launches = ({"bias_act_fwd": 1, "bias_act_bwd": 1, "bias_act_bwd2": 1, "upfirdn2d": 0}
                         if kernel == "bias_act" else
                         {"bias_act_fwd": 0, "bias_act_bwd": 0, "bias_act_bwd2": 0, "upfirdn2d": 3})
        if launched != want_launches or (variants is not None and used != variants):
            raise AssertionError(f"{name}: second order launched {launched}, variants {used}")
        want = second_order(torch, lambda x: fn(x, "ref"), x, dy1, dy2)
        rec = {"case": name, "dtype": names[dtype], "shape": shape, "kernel": kernel,
               "launches": launched, "variants": used}
        check_close(rec, "grad", got[0], want[0], TOL_GRAD[names[dtype]])
        check_close(rec, "grad2", got[1], want[1], TOL_GRAD[names[dtype]])
        del got, want
        rec["ms"] = median_ms(lambda: second_order(torch, lambda x: fn(x, "auto"), x, dy1, dy2),
                              n=10)
        # One timing of the plain side: its depthwise-conv double backward
        # takes seconds in bfloat16.
        rec["plain_ms"] = median_ms(lambda: second_order(torch, lambda x: fn(x, "ref"), x, dy1,
                                                         dy2), n=1, warmup=0)
        # The bound of the three launches: K1 moves x, y (forward), dy, y, dx
        # (backward) and dy2, y, d/d dy (second order), 8 element passes; K2
        # moves each launch's input and output, the forward's bytes 3 times.
        if k2_args is None:
            rec["bound_ms"], rec["bound_by"] = bound_ms(8 * x.numel() * x.element_size())
        else:
            w = up.work(shape, f.shape, itemsize=x.element_size(), **k2_args)
            rec["bound_ms"], rec["bound_by"] = bound_ms(3 * w["bytes"], 3 * w["macs"])
        recs.append(rec)
        log(f"  {name:34s} {rec['dtype']:8s} g err {rec['grad_rel_err']:.2e}, d/d dy err "
            f"{rec['grad2_rel_err']:.2e} | fwd + bwd + 2nd bwd {rec['ms']:.3f} ms (plain "
            f"{rec['plain_ms']:.3f}) | bound {rec['bound_ms']:.3f} ms ({rec['bound_by']}) | "
            f"launches {launched}{', ' + str(used) if used else ''}")
        del x, dy1, dy2
        torch.cuda.empty_cache()
    return recs


def phase_flrelu(torch, fl, net3, dev):
    """K3 against its plain version at the StyleGAN3 walk's layer shapes,
    with the layers' own filters, clamp and gains."""
    log("phase 1b: filtered_lrelu (K3) vs plain PyTorch")
    bf16, f32 = torch.bfloat16, torch.float32
    names = {f32: "float32", bf16: "bfloat16"}
    layers = {layer.name.split("_")[0]: layer for layer in net3.generator_config().layers}
    g = torch.Generator(device=dev).manual_seed(7)
    recs = []
    cases = [
        ("L10 up4 crop(-6,-9)", "L10", [SG3_BATCH, 256, 150, 150], bf16),
        ("L8 up2 pad(9,8)", "L8", [SG3_BATCH, 512, 150, 150], bf16),
        ("L13 critical crop(-11,-12)", "L13", [SG3_BATCH, 128, 278, 278], bf16),
        ("L0 up2 pad(9,8)", "L0", [SG3_BATCH, 512, 38, 38], f32),
        ("toRGB", "L14", [SG3_BATCH, 2, 256, 256], bf16),
    ]
    for name, lname, shape, dtype in cases:
        layer = layers[lname]
        fu, fd = (None if f is None else torch.as_tensor(f, device=dev)
                  for f in net3._layer_filters(layer))
        lo, hi = layer.padding
        kw = dict(up=layer.up_factor, down=layer.down_factor, padding=(lo, hi, lo, hi),
                  gain=1.0 if layer.is_torgb else math.sqrt(2.0),
                  slope=1.0 if layer.is_torgb else 0.2, clamp=256.0, flip_filter=False)
        x = torch.randn(shape, generator=g, device=dev).to(dtype)
        b = (torch.randn([shape[1]], generator=g, device=dev) * 0.1).to(dtype)
        ys, dxs, ms, dy = run_both(
            lambda x, impl: fl.filtered_lrelu(x, fu, fd, b, impl=impl, **kw), x, 200 + len(recs))
        args = (kw["up"], kw["down"], kw["padding"], kw["gain"], kw["slope"])
        tu, td = (1 if f is None else f.shape[0] for f in (fu, fd))
        wargs = (shape, tu, td, kw["up"], kw["down"], kw["padding"])
        # As timed: the forward under no_grad writes no record, the backward reads it.
        wf = fl.work(*wargs, itemsize=x.element_size())
        wb = fl.work(*wargs, backward=True, itemsize=x.element_size(), record=True)
        before = dict(fl.variant_launches)
        rec_ref = fl._record_ref(x, fu, b, kw["up"], kw["padding"], kw["gain"], kw["slope"],
                                 kw["clamp"], False)
        dx_at_ref = fl._backward_kernel(dy, rec_ref, tuple(shape[2:]), fu, fd, *args, False)
        _, rec_k = fl._forward_kernel(x, fu, fd, b, *args, kw["clamp"], False, need_record=True)
        dx_at_own = fl._backward_kernel(dy, rec_k, tuple(shape[2:]), fu, fd, *args, False)
        dn = names[dtype]
        rec = {"case": name, "dtype": dn, "shape": list(shape)}
        check_close(rec, "fwd", ys["auto"], ys["ref"], TOL_FL[dn])
        check_close(rec, "bwd", dx_at_ref, dxs["ref"], TOL_GRAD[dn])
        set_bounds(rec, (wf["bytes"], wf["macs"]), (wb["bytes"], wb["macs"]))
        rec["library_fwd_ms"] = rec["library_bwd_ms"] = None  # no one PyTorch call computes it
        mid_w = fl._geometry(tuple(shape[2:]), *wargs[1:], False)["mid_hw"][1]
        if rec_k.shape != rec_ref.shape or rec_k.numel() != wf["record_bytes"]:
            raise AssertionError(f"{name}: record {tuple(rec_k.shape)}, plain "
                                 f"{tuple(rec_ref.shape)}, expected {wf['record_bytes']} bytes")
        sliver = (fl.unpack_record(rec_k, mid_w) != fl.unpack_record(rec_ref, mid_w)) \
            .float().mean().item()
        if sliver > RECORD_SLIVER[dn]:
            raise AssertionError(f"{name}: K3's record differs from the plain one on "
                                 f"{sliver:.2e} of the pixels (> {RECORD_SLIVER[dn]})")
        if not torch.equal(dxs["auto"], dx_at_own):
            raise AssertionError(f"{name}: the autograd backward is not K3 at its own record")
        rec["record_mismatch_share"] = sliver
        rec["record_bytes"] = rec_k.numel()
        rec["variants"] = sorted(k for k in before if fl.variant_launches[k] != before[k])
        if "generic" in rec["variants"]:
            raise AssertionError(f"{name}: a layer of the walk went through the generic kernel")
        finish_record(rec, ms, recs, extra=f" record {sliver:.1e} ({rec_k.numel() / 1e6:.1f} MB, "
                                           f"{'+'.join(rec['variants'])})")
        del x, b, dy, ys, dxs, rec_ref, rec_k, dx_at_ref, dx_at_own
        torch.cuda.empty_cache()
    return recs


def phase_small_reference(torch, benchmark, arch="stylegan2"):
    """A small walk on the CPU (plain versions) against the card (kernels):
    StyleGAN2 at 32x32, the alias-free generator at 64x64 (6 layers)."""
    log(f"phase 2: small {arch} walk, CPU plain vs card kernels (float32)")
    setup = dict(res=32, channel_base=1024, channel_max=64) if arch == "stylegan2" else \
        dict(res=64, channel_base=2048, channel_max=64, num_fp16_res=0, arch=arch,
             num_layers=6)
    out = {}
    for dev in ("cpu", "cuda"):
        fns, bundle, g_cfg = benchmark.build_synthetic_setup(
            torch.device(dev), num_epochs=3, crop_size=16, manifold_items=8, seed=5, **setup)
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


def reset_counters(counters):
    for c in (*counters, *VARIANT_COUNTERS.values()):
        c.update(dict.fromkeys(c, 0))


def read_counters(counters, label, need):
    """(launches by kernel, by variant) since reset_counters. Every kernel
    named in `need` must have been launched, none through `generic`."""
    launches = {k: v for c in counters for k, v in c.items()}
    variants = {name: dict(c) for name, c in VARIANT_COUNTERS.items()}
    for k in need:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the {label} path")
    for name, c in variants.items():
        if c["generic"] != 0:
            raise AssertionError(f"{label}: {c['generic']} launches of {name} went through its "
                                 f"generic variant: {c}")
    return launches, variants


def run_policy(torch, argv, counters, n_batches=N_BATCHES):
    """AugOptions -> create_dataset -> create_augment -> per-batch
    set_input / forward / get_output over the first n_batches batches;
    returns per-batch records, the launch counts, set-up seconds and the
    peak device memory. `counters` are the kernels' launch dicts; the
    per-variant dicts (VARIANT_COUNTERS) are set to 0 with them."""
    from latentaugment_tpu_torch.augments import create_augment
    from latentaugment_tpu_torch.data import create_dataset
    from latentaugment_tpu_torch.options import AugOptions

    opt = AugOptions().parse(argv=argv, install_logger=False)
    dataset = create_dataset(opt)
    reset_counters(counters)
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
        if len(batches) == n_batches:
            break
    launches = {k: v for c in counters for k, v in c.items()}
    return batches, launches, setup_s, torch.cuda.max_memory_allocated()


def run_policy_fits(torch, argv, counters):
    """run_policy, or None when the card runs out of memory."""
    try:
        return run_policy(torch, argv, counters)
    except torch.cuda.OutOfMemoryError as e:
        log(f"  out of memory: {str(e).splitlines()[0]}")
    gc.collect()
    torch.cuda.empty_cache()
    return None


def check_batches(torch, np, batches, batch, label, n_batches=N_BATCHES):
    if len(batches) != n_batches:
        raise AssertionError(f"{label}: expected {n_batches} batches, got {len(batches)}")
    for i, b in enumerate(batches):
        for k in ("A", "B"):
            a = b["out"][k]
            if a.shape != (batch, 1, RES, RES) or not np.isfinite(a).all():
                raise AssertionError(f"{label} batch {i} {k}: shape {a.shape}, "
                                     f"finite {np.isfinite(a).all()}")
        if np.allclose(b["w_out"], b["w_in"]):
            raise AssertionError(f"{label} batch {i}: the walk did not move w")
        for k, v in b["traces"].items():
            if v.shape != (10,) or not torch.isfinite(v).all():
                raise AssertionError(f"{label} batch {i}: loss trace {k} = {v}")


def step0_agree(np, batches, ref, label):
    """The step-0 losses depend on the forward pass only (same data, w and
    crop): kernels and plain versions agree to bf16 rounding (1e-2)."""
    step0 = []
    for i, (bk, br) in enumerate(zip(batches, ref)):
        np.testing.assert_array_equal(bk["w_in"], br["w_in"])
        for k in bk["traces"]:
            a, r = bk["traces"][k][0].item(), br["traces"][k][0].item()
            if abs(a - r) > 1e-2 * abs(r) + 1e-6:
                raise AssertionError(f"{label} batch {i} step-0 {k}: kernels {a}, plain {r}")
            step0.append((i, k, a, r))
    log(f"  step-0 losses, kernels vs plain: max rel diff "
        f"{max(abs(a - r) / max(abs(r), 1e-12) for _, _, a, r in step0):.2e}")
    return [{"batch": i, "loss": k, "kernels": a, "plain": r} for i, k, a, r in step0]


def samples_per_s(batches, batch):
    return 2 * batch / (batches[1]["wall"] + batches[2]["wall"])


def phase_slice(torch, np, benchmark, counters, arch="stylegan2", batch=BATCH):
    """The policy at the operating point for one generator family: kernels,
    then plain versions (at a smaller batch if the card cannot hold them)."""
    sg3 = arch == "stylegan3"
    log(f"phase {4 if sg3 else 3}: the LatentAugment policy, {arch}, batch {batch}")
    root = os.path.join(REPO, "build", f"chip_smoke_{arch}")
    shutil.rmtree(root, ignore_errors=True)
    # 3 batches' worth of slices at this batch size.
    argv = benchmark.build_policy_workspace(root, batch_size=batch, arch=arch,
                                            n_patients=N_BATCHES * batch // 24)

    batches, launches, setup_s, peak = run_policy(torch, argv, counters)
    check_batches(torch, np, batches, batch, arch)
    # Every kernel the walk runs (second derivatives belong to the trainer).
    launches, variants = read_counters(counters, arch, [k for k in launches if k != "bias_act_bwd2"])
    kernel_sps = samples_per_s(batches, batch)
    log(f"  kernels: batch walls {[round(b['wall'], 3) for b in batches]} s, "
        f"{kernel_sps:.3f} samples/s over batches 2-3, set-up {setup_s:.1f} s, "
        f"peak memory {peak / 2**30:.2f} GiB, launches {launches}, by variant {variants}")
    rec = dict(arch=arch, batch=batch, launches=launches, variant_launches=variants,
               kernel_samples_per_s=kernel_sps,
               batch_wall_s=[b["wall"] for b in batches], setup_s=setup_s,
               peak_mem_bytes=peak,
               argv=argv,
               loss_traces=[{k: v.tolist() for k, v in b["traces"].items()} for b in batches])
    gc.collect()
    torch.cuda.empty_cache()

    plain_batch = batch
    while True:
        argv_b = argv + ["--batch_size", str(plain_batch)]
        got = run_policy_fits(torch, argv_b + ["--impl", "ref"], counters)
        if got is not None:
            break
        if plain_batch == 1:
            raise AssertionError(f"{arch}: the plain versions do not fit at batch 1")
        log(f"plain (--impl ref) does not fit at batch {plain_batch} on this card; "
            f"plain comparison at batch {plain_batch // 2}")
        plain_batch //= 2
    ref, ref_launches, _, ref_peak = got
    check_batches(torch, np, ref, plain_batch, f"{arch} plain")
    if any(ref_launches.values()):
        raise AssertionError(f"--impl ref launched kernels: {ref_launches}")
    ref_sps = samples_per_s(ref, plain_batch)
    log(f"  plain (--impl ref) at batch {plain_batch}: batch walls "
        f"{[round(b['wall'], 3) for b in ref]} s, {ref_sps:.3f} samples/s over batches 2-3, "
        f"peak memory {ref_peak / 2**30:.2f} GiB")
    if plain_batch != batch:
        # The kernels again at the plain batch, for the step-0 comparison.
        batches, _, _, k_peak = run_policy(torch, argv_b, counters)
        rec.update(kernel_samples_per_s_at_plain_batch=samples_per_s(batches, plain_batch),
                   peak_mem_bytes_at_plain_batch=k_peak)
        log(f"  kernels at batch {plain_batch}: "
            f"{rec['kernel_samples_per_s_at_plain_batch']:.3f} samples/s, "
            f"peak memory {k_peak / 2**30:.2f} GiB")
    rec.update(step0_losses=step0_agree(np, batches, ref, arch), plain_batch=plain_batch,
               plain_fits_batch=plain_batch == batch, plain_samples_per_s=ref_sps,
               plain_batch_wall_s=[b["wall"] for b in ref], plain_peak_mem_bytes=ref_peak)
    return rec


def rel_close(got, want, tol, label):
    """max |got - want| <= tol * max |want|; returns the relative error."""
    if got.shape != want.shape:
        raise AssertionError(f"{label}: shapes {tuple(got.shape)} and {tuple(want.shape)}")
    err = (got.float().cpu() - want.float().cpu()).abs().max().item()
    scale = want.float().abs().max().item()
    if not math.isfinite(err) or err > tol * max(scale, 1e-30):
        raise AssertionError(f"{label}: max |got - want| = {err} > {tol} x max |want| = {scale}")
    return err / max(scale, 1e-30)


def load_generator(ckpt, dev):
    """The checkpoint's generator on the card, frozen, bf16 in its top 4
    blocks as the policy runs it."""
    from latentaugment_tpu_torch.models import networks_for
    from latentaugment_tpu_torch.models.stylegan2 import checkpoint

    g_params, g_cfg, _, _ = checkpoint.load_stylegan(ckpt)
    g_cfg.num_fp16_res = 4
    G = networks_for(g_cfg).Generator(g_cfg)
    G.load_state_dict(checkpoint.params_to_state_dict(g_params))
    return G.to(dev).eval().requires_grad_(False)


def projector_step_split(torch, ckpt, batch, dev):
    """The two halves of one projector step alone, forward + backward
    (median of 10, CUDA events): G synthesis with respect to w at `batch`,
    and the LPIPS VGG16 with respect to its 2 * batch full-size inputs."""
    from latentaugment_tpu_torch.models import vgg

    G = load_generator(ckpt, dev)
    g_cfg = G.cfg
    vgg_params = vgg.get_vgg16(device=dev)
    gen = torch.Generator(device=dev).manual_seed(13)
    w = torch.randn([batch, 1, g_cfg.w_dim], generator=gen, device=dev) * 0.5
    x = torch.rand([batch * g_cfg.img_channels, 3, RES, RES], generator=gen, device=dev) * 255

    def fwd_bwd(f, inp):
        inp = inp.detach().requires_grad_(True)
        y = f(inp)
        torch.autograd.grad(y, inp, torch.ones_like(y))

    split = {
        "G_fwd_bwd": median_ms(lambda: fwd_bwd(
            lambda w: G.synthesis(w.repeat(1, g_cfg.num_ws, 1), noise_mode="const"), w), n=10),
        "VGG_fwd_bwd": median_ms(lambda: fwd_bwd(
            lambda x: vgg.lpips_features(vgg_params, x), x), n=10)}
    log(f"  one step's halves alone, fwd+bwd: G at batch {batch} {split['G_fwd_bwd']:.1f} ms, "
        f"VGG16 on {x.shape[0]} images of {RES}x{RES} {split['VGG_fwd_bwd']:.1f} ms")
    del G, vgg_params, w, x
    gc.collect()
    torch.cuda.empty_cache()
    return split


def phase_projector(torch, np, benchmark, counters, sg2_need, sg3_need, sg3_rec, dev):
    """The port's inversion command line at full width, then its zip read
    back by the policy; then a short projection over the SG3-T checkpoint."""
    import pickle
    import zipfile

    from scripts.torch_project_dataset import main as project_main

    batch, steps = PROJ_BATCH, PROJ_STEPS
    log(f"phase 5: the projector, stylegan2, batch {batch}, {steps} steps")
    root = os.path.join(REPO, "build", "chip_smoke_projector")
    shutil.rmtree(root, ignore_errors=True)
    # Two batches' worth of slices.
    argv = benchmark.build_policy_workspace(root, batch_size=batch, n_patients=2,
                                            slices_per_patient=batch)
    opt = dict(zip(argv[::2], argv[1::2]))
    w_name = "PolicyBench-projected-256"
    dest_zip = os.path.join(os.path.dirname(opt["--dataroot"]), w_name + ".zip")
    base = ["--checkpoint", opt["--model_dir"], "--data_zip", opt["--dataroot"],
            "--resolution", str(RES), "--num_steps", str(steps), "--batch_size", str(batch)]

    # One batch to warm up, with the kernels and with the plain versions:
    # step 0 depends on the forward pass only (same seed, so the same z,
    # noise and targets).
    first = {}
    for impl in ("auto", "ref"):
        reset_counters(counters)
        first[impl] = project_main(base + ["--max_items", str(batch), "--impl", impl, "--outdir",
                                           os.path.join(root, f"warm_{impl}")])[0]
        torch.cuda.synchronize()
    if any(c for cs in counters for c in cs.values()):
        raise AssertionError(f"--impl ref launched kernels: {[dict(c) for c in counters]}")
    d_k, d_p = first["auto"]["dists"][0], first["ref"]["dists"][0]
    if not (math.isfinite(d_k) and abs(d_k - d_p) <= 1e-2 * abs(d_p)):
        raise AssertionError(f"projector step-0 dist: kernels {d_k}, plain {d_p}")
    log(f"  step-0 dist, kernels {d_k:.6f} vs plain {d_p:.6f} (rel diff "
        f"{abs(d_k - d_p) / abs(d_p):.2e}); warm batch: kernels {first['auto']['seconds']:.2f} s, plain {first['ref']['seconds']:.2f} s")

    reset_counters(counters)
    torch.cuda.reset_peak_memory_stats()
    records = project_main(base + ["--outdir", os.path.join(root, "temp-projector"),
                                   "--dest_zip", dest_zip])
    torch.cuda.synchronize()
    launches, variants = read_counters(counters, "projector", sg2_need)
    peak = torch.cuda.max_memory_allocated()
    if [r["n"] for r in records] != [batch, batch]:
        raise AssertionError(f"projector batches: {[r['n'] for r in records]}")
    for r in records:
        d = r["dists"]
        if len(d) != steps or not all(math.isfinite(v) for v in d) or not d[-1] < d[1]:
            raise AssertionError(f"projector dists did not descend: {d}")
    step_ms = [r["seconds"] / steps * 1e3 for r in records]
    slices_per_s = batch / records[1]["seconds"]
    log(f"  kernels: {step_ms[1]:.1f} ms/step, {slices_per_s:.3f} slices/s at {steps} steps "
        f"(second batch; first {step_ms[0]:.1f} ms/step), peak memory {peak / 2**30:.2f} GiB, "
        f"dist {records[1]['dists'][0]:.4f} -> {records[1]['dists'][-1]:.4f}, "
        f"launches over 2 batches {launches}, by variant {variants}")

    # The inversion zip is member-exact with the image zip, and the policy reads it.
    with zipfile.ZipFile(opt["--dataroot"]) as zi, zipfile.ZipFile(dest_zip) as zw:
        if sorted(zi.namelist()) != sorted(zw.namelist()):
            raise AssertionError("inversion zip and image zip differ in their members")
    pol_argv = list(argv)
    pol_argv[pol_argv.index("--dataset_w_name") + 1] = w_name
    batches, _, _, _ = run_policy(torch, pol_argv, counters, n_batches=1)
    check_batches(torch, np, batches, batch, "policy over the projected codes", n_batches=1)
    with zipfile.ZipFile(dest_zip) as zw:
        want = np.stack([pickle.loads(zw.read(n))[0] for n in batches[0]["out"]["A_paths"]])
    np.testing.assert_array_equal(batches[0]["w_in"], want)
    log("  inversion zip: member-exact with the image zip; the policy walked from its codes")
    rec = dict(batch=batch, steps=steps, launches=launches, variant_launches=variants,
               ms_per_step=step_ms[1], slices_per_s=slices_per_s, peak_mem_bytes=peak,
               batch_seconds=[r["seconds"] for r in records], dists=[r["dists"] for r in records],
               step0_dist={"kernels": d_k, "plain": d_p},
               warm_batch_seconds={k: v["seconds"] for k, v in first.items()})
    del batches
    gc.collect()
    torch.cuda.empty_cache()
    rec["step_split_ms"] = projector_step_split(torch, opt["--model_dir"], batch, dev)

    sg3_batch, sg3_steps = PROJ_SG3_BATCH, PROJ_SG3_STEPS
    log(f"  stylegan3 (phase 4's checkpoint), batch {sg3_batch}, {sg3_steps} steps")
    sg3_opt = dict(zip(sg3_rec["argv"][::2], sg3_rec["argv"][1::2]))
    sg3_argv = ["--checkpoint", sg3_opt["--model_dir"], "--data_zip", sg3_opt["--dataroot"],
                "--resolution", str(RES), "--num_steps", str(sg3_steps),
                "--batch_size", str(sg3_batch), "--max_items", str(sg3_batch)]
    reset_counters(counters)
    sg3 = project_main(sg3_argv + ["--outdir", os.path.join(root, "temp-projector-sg3")])[0]
    torch.cuda.synchronize()
    sg3_launches, sg3_variants = read_counters(counters, "stylegan3 projector", sg3_need)
    # Too few steps to ask for a descent under the exploration noise: the
    # distances are finite and w moved.
    if not all(math.isfinite(v) for v in sg3["dists"]) or len(set(sg3["dists"][1:])) < 2:
        raise AssertionError(f"stylegan3 projector dists: {sg3['dists']}")
    log(f"  {sg3['seconds'] / sg3_steps * 1e3:.1f} ms/step (first batch, warm-up included), dist "
        f"{sg3['dists'][0]:.4f} -> {sg3['dists'][-1]:.4f}, launches {sg3_launches}, "
        f"by variant {sg3_variants}")
    gc.collect()
    torch.cuda.empty_cache()
    # The same batch with the plain versions: step 0 agrees as above.
    reset_counters(counters)
    sg3_ref = project_main(sg3_argv + ["--impl", "ref", "--outdir",
                                       os.path.join(root, "temp-projector-sg3-ref")])[0]
    torch.cuda.synchronize()
    if any(c for cs in counters for c in cs.values()):
        raise AssertionError(f"--impl ref launched kernels: {[dict(c) for c in counters]}")
    s_k, s_p = sg3["dists"][0], sg3_ref["dists"][0]
    if not (math.isfinite(s_p) and abs(s_k - s_p) <= 1e-2 * abs(s_p)):
        raise AssertionError(f"stylegan3 projector step-0 dist: kernels {s_k}, plain {s_p}")
    log(f"  step-0 dist, kernels {s_k:.6f} vs plain {s_p:.6f} (rel diff "
        f"{abs(s_k - s_p) / abs(s_p):.2e}); plain {sg3_ref['seconds'] / sg3_steps * 1e3:.1f} "
        "ms/step")
    rec["stylegan3"] = dict(batch=sg3_batch, steps=sg3_steps, launches=sg3_launches,
                            variant_launches=sg3_variants, seconds=sg3["seconds"],
                            dists=sg3["dists"], plain_seconds=sg3_ref["seconds"],
                            step0_dist={"kernels": s_k, "plain": s_p})
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_tr_walk(torch, np, counters, need, slice_rec):
    """The policy with the local LPIPS criterion's embedding, on phase 3's
    workspace: kernels, then plain versions."""
    n = 2
    log(f"phase 6: the policy with --lpips_script lpips_tr, batch {BATCH}, {n} batches")
    argv = slice_rec["argv"] + ["--lpips_script", "lpips_tr"]
    batches, launches, setup_s, peak = run_policy(torch, argv, counters, n_batches=n)
    check_batches(torch, np, batches, BATCH, "tr walk", n_batches=n)
    launches, variants = read_counters(counters, "tr walk", need)
    sps = BATCH / batches[1]["wall"]
    log(f"  kernels: batch walls {[round(b['wall'], 3) for b in batches]} s, {sps:.3f} samples/s "
        f"(second batch; the script walk: {slice_rec['kernel_samples_per_s']:.3f} over batches "
        f"2-3), set-up {setup_s:.1f} s, peak memory {peak / 2**30:.2f} GiB, launches {launches}, "
        f"by variant {variants}")
    gc.collect()
    torch.cuda.empty_cache()
    ref, ref_launches, _, _ = run_policy(torch, argv + ["--impl", "ref"], counters, n_batches=n)
    check_batches(torch, np, ref, BATCH, "tr walk plain", n_batches=n)
    if any(ref_launches.values()):
        raise AssertionError(f"--impl ref launched kernels: {ref_launches}")
    ref_sps = BATCH / ref[1]["wall"]
    log(f"  plain (--impl ref): {ref_sps:.3f} samples/s (second batch)")
    rec = dict(batch=BATCH, launches=launches, variant_launches=variants,
               kernel_samples_per_s=sps, plain_samples_per_s=ref_sps, setup_s=setup_s,
               peak_mem_bytes=peak, batch_wall_s=[b["wall"] for b in batches],
               step0_losses=step0_agree(np, batches, ref, "tr walk"))
    del batches, ref
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def affine_position_errors(torch, geo, x_noise, angles, shifts, dev, core_rec):
    """Why affine_warp agrees between card and CPU to 1e-5 on smooth images
    only: its float32 sampling positions differ, and an image's error is
    at most that difference times the image's slope. Measured here: theta
    and the positions (in pixels) card against CPU, the bound they give on
    white noise beside the error seen, and the same with theta made in
    float64 (then rounded), which tells the 3x3 inverses' share from the
    position arithmetic's: that one must agree to 1e-5 on white noise."""
    cpu = torch.device("cpu")

    def sample(img, pos):
        return torch.nn.functional.grid_sample(img, pos, mode="bilinear",
                                               padding_mode="reflection", align_corners=False)

    out = {}
    for name, dtype in (("float32", torch.float32), ("theta_in_float64", torch.float64)):
        th_c = geo.affine_theta(angles, shifts, RES, RES, cpu, dtype).float()
        th_d = geo.affine_theta(angles.to(dev), shifts.to(dev), RES, RES, dev, dtype).float()
        pos_c, pos_d = geo.affine_positions(th_c, RES, RES), geo.affine_positions(th_d, RES, RES)
        out[name] = {
            "theta_max_abs_err": (th_d.cpu() - th_c).abs().max().item(),
            "position_max_err_px": (pos_d.cpu() - pos_c).abs().max().item() * RES / 2,
            "white_noise_max_abs_err": (sample(x_noise.to(dev), pos_d).cpu()
                                        - sample(x_noise, pos_c)).abs().max().item()}
    slope = ((x_noise[..., :, 1:] - x_noise[..., :, :-1]).abs().max()
             + (x_noise[..., 1:, :] - x_noise[..., :-1, :]).abs().max()).item()
    f32 = out["float32"]
    # grid_sample maps a position to a pixel index in float32 again: two
    # units in the last place of an index below RES on top of what was measured.
    bound = (f32["position_max_err_px"] + 2 * RES * 2.0 ** -24) * slope + 1e-6
    out.update(white_noise_slope_per_px=slope, white_noise_err_bound=bound)
    if not f32["white_noise_max_abs_err"] <= bound:
        raise AssertionError(f"affine_warp on white noise: card vs CPU {f32} exceeds the bound "
                             f"{bound} that its positions' difference gives")
    f64 = out["theta_in_float64"]
    if not f64["white_noise_max_abs_err"] <= 1e-5:
        raise AssertionError(f"affine_warp with a float64 theta on white noise: card vs CPU {f64}")
    log(f"  affine_warp's positions, card vs CPU: theta {f32['theta_max_abs_err']:.2e}, positions "
        f"{f32['position_max_err_px']:.2e} px; white noise (slope {slope:.2f}/px) err "
        f"{f32['white_noise_max_abs_err']:.2e} <= bound {bound:.2e}; with theta made in float64: "
        f"theta {f64['theta_max_abs_err']:.2e}, positions {f64['position_max_err_px']:.2e} px, "
        f"white noise err {f64['white_noise_max_abs_err']:.2e} "
        f"(smooth images: {core_rec['rel_err']:.2e})")
    return out


def phase_geometric(torch, np, dev):
    """GeometricAugment's cores, card against CPU, and the policy timed."""
    from latentaugment_tpu_torch.augments import create_augment
    from latentaugment_tpu_torch.augments import geometric_aug as geo
    from latentaugment_tpu_torch.options import AugOptions

    log(f"phase 7: GeometricAugment, batch {BATCH}, {RES}x{RES}")
    g = torch.Generator().manual_seed(11)
    # A warp's error is its sampling position's error times the image's
    # slope. affine_warp's float32 positions are good to ~1e-4 of a pixel at
    # this size (affine_position_errors measures it); the 1e-5 is asked of
    # smooth images, as the slices are (one cycle of a sinusoid per image,
    # slope 0.025 per pixel), and white noise (slope up to 2 per pixel) is
    # held to 1e-3 and to the bound its positions give.
    u = torch.linspace(0, 2 * math.pi, RES)
    phase = torch.rand([BATCH, 2, 1, 1], generator=g) * 2 * math.pi
    x = torch.sin(u[None, None, :, None] + phase) * torch.cos(u[None, None, None, :] - phase)
    x_noise = torch.rand([BATCH, 2, RES, RES], generator=g) * 2 - 1
    angles = torch.rand([BATCH], generator=g) * 6 - 3
    angles[:2] = torch.tensor([30.0, -30.0])
    shifts = (torch.rand([BATCH, 2], generator=g) * 2 - 1) * 0.05 * RES
    noise = torch.rand([BATCH, 2, RES, RES], generator=g) * 2 - 1
    cases = {"affine_warp": (geo.affine_warp, (angles, shifts), {}),
             "elastic_warp": (geo.elastic_warp, (noise,), {})}
    rec = {"cores": {}}
    for name, (fn, args, kw) in cases.items():
        want = fn(x, *args, **kw)
        if not (want - x).abs().max().item() > 1e-3:
            raise AssertionError(f"{name} left the image where it was")
        xd, argsd = x.to(dev), tuple(a.to(dev) for a in args)
        err = rel_close(fn(xd, *argsd, **kw), want, 1e-5, name)
        err_noise = rel_close(fn(x_noise.to(dev), *argsd, **kw), fn(x_noise, *args, **kw), 1e-3,
                              f"{name} on white noise")
        ms = median_ms(lambda: fn(xd, *argsd, **kw))
        rec["cores"][name] = {"rel_err": err, "rel_err_white_noise": err_noise, "ms": ms}
        log(f"  {name:24s} card vs CPU rel err {err:.2e} (white noise {err_noise:.2e}), "
            f"{ms:.3f} ms on the card")
    rec["affine_positions"] = affine_position_errors(torch, geo, x_noise, angles, shifts, dev,
                                                     rec["cores"]["affine_warp"])
    flipped = geo.random_hflip(torch.Generator(device=dev).manual_seed(0), x.to(dev), 1.0)
    if not torch.equal(flipped.cpu(), x.flip(-1)):  # bit-exact
        raise AssertionError("random_hflip at p = 1 did not flip every sample")

    argv = ["--dataroot", "unused.zip", "--checkpoints_dir",
            os.path.join(REPO, "build", "chip_smoke_geometric"), "--load_size", str(RES),
            "--batch_size", str(BATCH), "--aug", "geometric", "--horizontal_flip", "--affine",
            "--elastic_deform", "--p_thres", "0.0"]
    augment = create_augment(AugOptions().parse(argv=argv, install_logger=False))
    paths = [f"train/p/train_p_{i:05d}.pickle" for i in range(BATCH)]
    data = {"A": x_noise[:, :1].numpy(), "B": x_noise[:, 1:].numpy(), "A_paths": paths,
            "B_paths": paths}
    walls = []
    for _ in range(6):
        t0 = time.time()
        augment.set_input(data)
        augment.forward()  # ends in the copy to the host
        out = augment.get_output()
        walls.append(time.time() - t0)
    for k in ("A", "B"):
        a = out[k]
        changed = (np.abs(a - data[k]).reshape(BATCH, -1).max(axis=1) > 1e-3).all()
        if a.shape != (BATCH, 1, RES, RES) or not np.isfinite(a).all() or not changed:
            raise AssertionError(f"geometric policy output {k}: shape {a.shape}, finite "
                                 f"{np.isfinite(a).all()}, every sample transformed {changed}")
    rec["policy_ms_per_batch"] = statistics.median(walls[1:]) * 1e3
    rec["policy_first_batch_ms"] = walls[0] * 1e3
    log(f"  policy (flip + affine + elastic, host to host): {rec['policy_ms_per_batch']:.2f} ms "
        f"per batch of {BATCH} (median of 5; first {rec['policy_first_batch_ms']:.1f} ms)")
    return rec


def phase_metrics(torch, np, counters, need, slice_rec, dev):
    """The two detectors, card against CPU, then FID and precision/recall
    of the live generator."""
    from latentaugment_tpu_torch.metrics import frechet_inception_distance as fid_mod
    from latentaugment_tpu_torch.metrics import metric_utils, precision_recall
    from latentaugment_tpu_torch.models.stylegan2.networks import set_impl

    n_gen = N_GEN
    log(f"phase 8: metrics, detectors on a batch of {BATCH}, then {n_gen} generated images")
    x = torch.rand([BATCH, 3, RES, RES], generator=torch.Generator().manual_seed(12)) * 255
    rec = {"detectors": {}}
    for name, url in (("inception", fid_mod.DETECTOR_URL), ("vgg16", precision_recall.DETECTOR_URL)):
        want = metric_utils.get_feature_detector(url, torch.device("cpu"))(x)
        det = metric_utils.get_feature_detector(url, dev)
        xd = x.to(dev)
        err = rel_close(det(xd), want, 1e-4, f"{name} detector")
        ms = median_ms(lambda: det(xd), n=10)
        rec["detectors"][name] = {"rel_err": err, "ms_per_batch": ms,
                                  "images_per_s": BATCH / ms * 1e3}
        log(f"  {name:10s} card vs CPU rel err {err:.2e}, {ms:.2f} ms per batch of {BATCH} "
            f"({BATCH / ms * 1e3:.0f} images/s)")
        del want
    metric_utils._feature_detector_cache.pop(("vgg16", "cpu"), None)  # 0.5 GB of host memory

    opt = dict(zip(slice_rec["argv"][::2], slice_rec["argv"][1::2]))
    G = load_generator(opt["--model_dir"], dev)
    # The metrics' generator call (batch 16, random noise, one seeded
    # generator for z and noise) with the kernels against the plain versions.
    imgs = {}
    for impl in ("auto", "ref"):
        set_impl(G, impl)
        gen = torch.Generator(device=dev).manual_seed(5)
        with torch.no_grad():
            z = torch.randn([16, G.cfg.z_dim], generator=gen, device=dev)
            imgs[impl] = G(z, truncation_psi=1.0, noise_mode="random", generator=gen)
    set_impl(G, "auto")
    # Four bf16 blocks deep, the plain versions rounding 3-4 times per layer
    # where a kernel rounds once: the bound of bf16 gradients and K3's values.
    rec["generator_rel_err"] = rel_close(imgs["auto"], imgs["ref"], TOL_GRAD["bfloat16"],
                                         "metrics' generator, kernels vs plain")
    log(f"  G(z) at batch 16, random noise: kernels vs plain rel err "
        f"{rec['generator_rel_err']:.2e} (bf16 top blocks, allowed {TOL_GRAD['bfloat16']})")
    del imgs

    # Each pass's own progress reports time it: one when a pass begins, one
    # when its last item is in (features reach the host batch by batch).
    marks = []
    progress = metric_utils.ProgressMonitor(
        verbose=False, progress_fn=lambda cur, total: marks.append(time.time()))
    opts = metric_utils.MetricOptions(
        G=G, G_kwargs=dict(seed=0), cache=False, device=dev, progress=progress,
        dataset_kwargs=dict(path=opt["--dataroot"], split="train",
                            modalities=["MR_nonrigid_CT", "MR_MR_T2"], resolution=RES),
        mode_dict=dict(mode_name="MR_nonrigid_CT", mode_idx=0))
    reset_counters(counters)
    t0 = time.time()
    fid = fid_mod.compute_fid(opts, max_real=None, num_gen=n_gen)
    fid_s = time.time() - t0
    fid_gen_s = marks[-1] - marks[-2]
    t0 = time.time()
    precision, recall = precision_recall.compute_pr(
        opts, max_real=200000, num_gen=n_gen, nhood_size=3, row_batch_size=10000,
        col_batch_size=10000)
    pr_s = time.time() - t0
    pr_gen_s = marks[-1] - marks[-2]
    launches, variants = read_counters(counters, "metrics", need)
    if not (math.isfinite(fid) and fid > 0 and fid_gen_s > 0 and pr_gen_s > 0) \
            or not (0.0 <= precision <= 1.0 and 0.0 <= recall <= 1.0):
        raise AssertionError(f"metrics: fid {fid}, precision {precision}, recall {recall}, "
                             f"generator passes {fid_gen_s} s and {pr_gen_s} s")
    log(f"  fid50k_full at {n_gen} generated vs the real slices: {fid:.4f} in {fid_s:.1f} s (host "
        f"matrix root included), its generator + InceptionV3 pass {n_gen / fid_gen_s:.1f} images/s "
        f"(first pass, warm-up included); pr50k3_full: precision {precision:.4f}, recall "
        f"{recall:.4f} in {pr_s:.1f} s, its generator + VGG16 pass {n_gen / pr_gen_s:.1f} images/s; "
        f"launches {launches}, by variant {variants}")
    rec.update(n_gen=n_gen, fid=fid, precision=precision, recall=recall,
               generator_features_images_per_s=n_gen / fid_gen_s,
               generator_vgg_features_images_per_s=n_gen / pr_gen_s, fid_seconds=fid_s,
               pr_seconds=pr_s, launches=launches, variant_launches=variants)
    return rec


def phase_train(torch, np, counters, need, dev):
    """The trainer at the operating point's full width: step-0 phase losses
    and gradients with the kernels against the plain versions, then
    train_loop (ADA bgc at a fixed p, random noise, style mixing) for one
    warm-up step and 16 timed ones, launches counted over those 16, the
    final snapshot loaded back."""
    from latentaugment_tpu_torch import profile_walk
    from latentaugment_tpu_torch.models.stylegan2 import checkpoint, networks, train
    from latentaugment_tpu_torch.models.stylegan2.networks import set_impl

    steps, pl_batch = 16, BATCH // 2
    log(f"phase 9: the trainer, StyleGAN2 {RES}x{RES}, batch {BATCH} (path length {pl_batch}), "
        f"1 + {steps} steps")
    net = dict(img_resolution=RES, img_channels=2, channel_base=32768, channel_max=512,
               conv_clamp=256, num_fp16_res=4)
    g_cfg = networks.generator_config(num_mapping_layers=2, **net)
    d_cfg = networks.discriminator_config(**net)
    root = os.path.join(REPO, "build", "chip_smoke_train")
    shutil.rmtree(root, ignore_errors=True)

    # Step 0, kernels against plain: const noise, no mixing, no ADA. In
    # float32 (TF32 off) every parameter gradient is held to 2e-2 of its
    # max |plain|; in the loop's bfloat16 top blocks the losses are held to
    # 1e-2 and the gradients' errors recorded: there the plain side rounds
    # at every op, and a gradient as small as the mapping's (lr multiplier
    # 0.01) that sums every layer's style path differs by a few percent.
    g32, d32 = (dict(c, num_fp16_res=0) for c in (g_cfg, d_cfg))
    g32, d32 = networks.generator_config(**{k: g32[k] for k in checkpoint._G_CFG_KEYS}), \
        networks.discriminator_config(**{k: d32[k] for k in checkpoint._D_CFG_KEYS})
    fns = train.make_train_fns(g32, d32, train.train_config(
        batch_size=BATCH, style_mixing_prob=0.0, noise_mode="const", aug="noaug"), device=dev)
    state = fns.init_state(seed=0)
    g = torch.Generator(device=dev).manual_seed(31)
    z = torch.randn([BATCH, g_cfg.z_dim], generator=g, device=dev)
    real = torch.rand([BATCH, 2, RES, RES], generator=g, device=dev) * 2 - 1
    pl_noise = torch.randn([pl_batch, 2, RES, RES], generator=g, device=dev) / RES
    pl_mean = torch.tensor(0.5, device=dev)
    phases = {
        "Gmain": (state.G, lambda: fns.loss_g_main(state.G, state.D, z, z, None, g, 0.0)[0]),
        "Gpl": (state.G, lambda: fns.loss_g_pl(state.G, pl_mean, z[:pl_batch], z[:pl_batch], None,
                                               g, pl_noise=pl_noise)[0]),
        "Dmain": (state.D, lambda: fns.loss_d_main(state.D, state.G, real, z, z, None, g, 0.0)[0]),
        "Dr1": (state.D, lambda: fns.loss_d_r1(state.D, real, None)[0]),
    }
    step0, plain32 = {}, {}
    for dtype_name, n16 in (("float32", 0), ("bfloat16", g_cfg.num_fp16_res)):
        state.G.cfg.num_fp16_res = state.D.cfg.num_fp16_res = n16
        for phase, (module, loss_fn) in phases.items():
            out = {}
            for impl in ("auto", "ref"):
                set_impl(state.G, impl)
                set_impl(state.D, impl)
                torch.cuda.synchronize()
                t0 = time.time()
                loss = loss_fn()
                out[impl] = (loss.item(), train._grads(loss, module), time.time() - t0)
                del loss
            set_impl(state.G, "auto")
            set_impl(state.D, "auto")
            (lk, gk, sk), (lp, gp, sp) = out["auto"], out["ref"]
            if not (math.isfinite(lk) and abs(lk - lp) <= 1e-2 * abs(lp)):
                raise AssertionError(f"trainer step 0 {dtype_name} {phase}: loss kernels {lk}, "
                                     f"plain {lp}")
            names = [n for n, _ in module.named_parameters()]

            def worst_err(got, want, tol=math.inf):
                return max((rel_close(a, b, tol, f"trainer step 0 {dtype_name} {phase} d/d {n}"), n)
                           for n, a, b in zip(names, got, want))

            worst = worst_err(gk, gp, TOL_GRAD["bfloat16"] if dtype_name == "float32" else math.inf)
            rec0 = {"loss_kernels": lk, "loss_plain": lp, "loss_rel_err": abs(lk - lp) / abs(lp),
                    "grad_worst_rel_err": worst[0], "grad_worst_param": worst[1],
                    "seconds_kernels": sk, "seconds_plain": sp}
            extra = ""
            if dtype_name == "float32":
                plain32[phase] = gp
            else:
                # How far bf16 rounding alone moves the gradients: each side
                # against the plain float32 ones (same weights and inputs).
                rec0["plain_vs_float32"], rec0["kernels_vs_float32"] = \
                    worst_err(gp, plain32[phase]), worst_err(gk, plain32[phase])
                extra = (f"; against plain float32: plain {rec0['plain_vs_float32'][0]:.2e}, "
                         f"kernels {rec0['kernels_vs_float32'][0]:.2e}")
            step0[f"{phase} {dtype_name}"] = rec0
            log(f"  step 0 {phase:5s} {dtype_name:8s}: loss kernels {lk:.6f} vs plain {lp:.6f} "
                f"(rel {rec0['loss_rel_err']:.1e}), worst gradient {worst[0]:.2e} ({worst[1]})"
                f"{extra}; loss + gradients {sk:.2f} s (plain {sp:.2f} s)")
            del out, gk, gp
    del state, fns, phases, plain32
    gc.collect()
    torch.cuda.empty_cache()

    # The loop through its entry point: one warm-up step, then 16 timed.
    cfg = train.train_config(batch_size=BATCH, aug="fixed", aug_p=0.2, aug_pipe="bgc",
                             style_mixing_prob=0.9, noise_mode="random")
    marks = {}

    def timing(step, cur_nimg, st, p):
        if step == 1 or step == 1 + steps:
            torch.cuda.synchronize()
            marks[step] = time.time()
            if step == 1:
                reset_counters(counters)
                torch.cuda.reset_peak_memory_stats()
            else:
                marks["launches"] = read_counters(counters, "trainer", need)
                marks["peak"] = torch.cuda.max_memory_allocated()

    def data():
        rng = np.random.RandomState(0)
        while True:
            yield rng.rand(BATCH, 2, RES, RES).astype(np.float32) * 2 - 1, None

    kimg = (1 + steps) * BATCH / 1000
    state = train.train_loop(g_cfg, d_cfg, data(), cfg, total_kimg=kimg, run_dir=root, seed=0,
                             snapshot_kimg=kimg, log_every=1 + steps, callbacks=[timing],
                             device=dev)
    wall = marks[1 + steps] - marks[1]
    (launches, variants), peak = marks["launches"], marks["peak"]
    rows = [json.loads(r) for r in open(os.path.join(root, "log.jsonl"))]
    losses = {k: v for k, v in rows[-1].items() if k.startswith("Loss/")}
    if len(rows) != 1 or rows[0]["step"] != 1 + steps or not all(map(math.isfinite, losses.values())):
        raise AssertionError(f"trainer log: {rows}")
    for k in ("bias_act_bwd2", "upfirdn2d"):
        if launches[k] <= 0:
            raise AssertionError(f"trainer: no {k} launches over {steps} steps")

    # The snapshot loads back through the port's loader and is G_ema.
    snaps = sorted(f for f in os.listdir(root) if f.startswith("network-snapshot-"))
    g_params, g_cfg2, d_params, _ = checkpoint.load_stylegan(os.path.join(root, snaps[-1]))
    G2 = networks.Generator(g_cfg2)
    G2.load_state_dict(checkpoint.params_to_state_dict(g_params))
    for k, v in state.G_ema.state_dict().items():
        if not torch.equal(G2.state_dict()[k], v.cpu()):
            raise AssertionError(f"snapshot {snaps[-1]}: {k} differs from G_ema")
    with torch.no_grad():
        img = G2.to(dev)(torch.randn([4, g_cfg2.z_dim], device=dev))
    if img.shape != (4, 2, RES, RES) or not torch.isfinite(img).all() or d_params is None:
        raise AssertionError(f"snapshot {snaps[-1]}: G(z) {tuple(img.shape)}")
    del G2, img

    # Each phase once more, alone (CUDA events).
    fns = train.make_train_fns(g_cfg, d_cfg, cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(32)
    z, z2 = (torch.randn([BATCH, g_cfg.z_dim], generator=g, device=dev) for _ in range(2))
    real = torch.rand([BATCH, 2, RES, RES], generator=g, device=dev) * 2 - 1
    p = torch.tensor(0.2, device=dev)

    def once(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    phase_fns = {
        "Gmain": lambda: fns.g_main(state, z, z2, None, g, p),
        "Gpl": lambda: fns.g_reg(state, z[:pl_batch], z2[:pl_batch], None, g, p),
        "Dmain": lambda: fns.d_main(state, real, z, z2, None, g, p),
        "Dr1": lambda: fns.d_reg(state, real, None, g, p),
        "ema": lambda: fns.ema(state, 0.99)}
    phase_ms = {k: once(fn) for k, fn in phase_fns.items()}
    # Each phase once more under the profiler: device busy time, idle share
    # and device time by kind of kernel (cuDNN's share in the second-order
    # phases).
    profiled = {}
    for k in ("Gmain", "Gpl", "Dmain", "Dr1"):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            phase_fns[k]()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms, kinds, top = profile_walk._device_busy(prof)
        profiled[k] = dict(wall_ms=wall_ms, device_busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
                           device_ms_by_kind=kinds, top_kernels=top[:8])
        log(f"  {k} under the profiler: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms (idle "
            f"{1 - busy_ms / wall_ms:.1%}); device ms by kind "
            + ", ".join(f"{kind} {ms:.1f}" for kind, ms in list(kinds.items())[:6]))
    rec = dict(batch=BATCH, pl_batch=pl_batch, steps=steps, s_per_step=wall / steps,
               images_per_s=steps * BATCH / wall, peak_mem_bytes=peak, phase_ms=phase_ms,
               profiled_phases=profiled,
               launches=launches, variant_launches=variants, step0=step0, last_log=rows[-1],
               snapshot=snaps[-1])
    log(f"  {steps} steps: {rec['s_per_step']:.4f} s/step, {rec['images_per_s']:.2f} images/s, "
        f"peak memory {peak / 2**30:.2f} GiB; each phase alone: "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in phase_ms.items()))
    log(f"  launches over {steps} steps {launches}, by variant {variants}; last log {losses}; "
        f"snapshot {snaps[-1]} loads back")
    del state, fns
    gc.collect()
    torch.cuda.empty_cache()
    return rec


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
    from latentaugment_tpu_torch.models.stylegan3 import networks as net3
    from latentaugment_tpu_torch.ops import _build
    from latentaugment_tpu_torch.ops import bias_act as ba
    from latentaugment_tpu_torch.ops import filtered_lrelu as fl
    from latentaugment_tpu_torch.ops import upfirdn2d as up

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}; "
        "TF32 off for convs and matmuls")

    VARIANT_COUNTERS.update(upfirdn2d=up.variant_launches, filtered_lrelu=fl.variant_launches)
    t0 = time.time()
    _build.build_cuda_libraries(["upfirdn2d.cu", "filtered_lrelu.cu"])
    log(f"  nvcc builds (side by side) took {time.time() - t0:.1f} s")
    bias_recs, up_recs = phase_kernels(torch, ba, up, dev)
    fl_recs = phase_flrelu(torch, fl, net3, dev)
    second_recs = phase_second_order(torch, ba, up, dev)
    log(f"  phase 1 took {time.time() - t0:.1f} s (builds included)")
    small = {"stylegan2": phase_small_reference(torch, benchmark),
             "stylegan3": phase_small_reference(torch, benchmark, arch="stylegan3")}
    slice_rec = phase_slice(torch, np, benchmark, (ba.launches, up.launches))
    all_counters = (ba.launches, up.launches, fl.launches)
    sg3_rec = phase_slice(torch, np, benchmark, all_counters, arch="stylegan3", batch=SG3_BATCH)
    # What each new path must launch: bias_act and upfirdn2d forward and
    # backward under a StyleGAN2 G (forward only for the metrics' G),
    # filtered_lrelu besides under the alias-free one, and the second
    # derivatives besides in the trainer (R1, path length).
    first_order = ["bias_act_fwd", "bias_act_bwd"]
    sg2_need = [*first_order, *up.launches]
    proj_rec = phase_projector(torch, np, benchmark, all_counters, sg2_need,
                               [*first_order, *fl.launches], sg3_rec, dev)
    tr_rec = phase_tr_walk(torch, np, all_counters, sg2_need, slice_rec)
    geo_rec = phase_geometric(torch, np, dev)
    metrics_rec = phase_metrics(torch, np, all_counters, ["bias_act_fwd", "upfirdn2d"],
                                slice_rec, dev)
    train_rec = phase_train(torch, np, all_counters, [*ba.launches, *up.launches], dev)
    paths = {"walk": slice_rec, "walk_stylegan3": sg3_rec, "projector": proj_rec,
             "projector_stylegan3": proj_rec["stylegan3"], "tr_walk": tr_rec,
             "metrics": metrics_rec, "train": train_rec}

    def main_rec(recs, name, dtype):
        return next(r for r in recs if r["case"] == name and r["dtype"] == dtype)

    ba_main = main_rec(bias_recs, "G conv 256x256 lrelu clamp", "bfloat16")
    up_main = main_rec(up_recs, "G blur after up-conv (257->256)", "bfloat16")
    fl_main = main_rec(fl_recs, "L10 up4 crop(-6,-9)", "bfloat16")
    def entry(name, route, source, replaces, launches, recs, main, direction, variant):
        """One kernel of the `kernels` line: times, bound and library time
        are the main-path case's (`main`), the error the worst of `recs`."""
        return {"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": launches, "variant": variant,
                "launches_by_path": {p: r["launches"].get(name, 0) for p, r in paths.items()},
                "max_abs_err": max(r[f"{d}_max_abs_err"] for r in recs
                                   for d in direction.split("+")),
                "ms": main[f"{direction[:3]}_ms"], "plain_ms": main[f"plain_{direction[:3]}_ms"],
                "bound_ms": main[f"bound_{direction[:3]}_ms"],
                "bound_by": main[f"bound_{direction[:3]}_by"],
                "library_ms": main[f"library_{direction[:3]}_ms"]}

    ba_src, ba_tpu = "latentaugment_tpu_torch/ops/bias_act.py", "latentaugment_tpu/ops/bias_act.py:125"
    fl_src = "latentaugment_tpu_torch/csrc/filtered_lrelu.cu"
    fl_tpu = "latentaugment_tpu/ops/filtered_lrelu.py:410"
    kernels = [
        entry("bias_act_fwd", "triton", ba_src, ba_tpu, slice_rec["launches"]["bias_act_fwd"],
              bias_recs, ba_main, "fwd", None),
        dict(entry("bias_act_bwd", "triton", ba_src, ba_tpu, slice_rec["launches"]["bias_act_bwd"],
                   bias_recs, ba_main, "bwd", None),
             second_order_launches_by_path={p: r["launches"].get("bias_act_bwd2", 0)
                                            for p, r in paths.items()}),
        entry("upfirdn2d", "cuda", "latentaugment_tpu_torch/csrc/upfirdn2d.cu",
              "latentaugment_tpu/ops/upfirdn2d.py:564", slice_rec["launches"]["upfirdn2d"],
              up_recs, up_main, "fwd+bwd", up_main["variant"]),
        entry("filtered_lrelu_fwd", "cuda", fl_src, fl_tpu,
              sg3_rec["launches"]["filtered_lrelu_fwd"], fl_recs, fl_main, "fwd", "u4t24_d2t12"),
        entry("filtered_lrelu_bwd", "cuda", fl_src, fl_tpu,
              sg3_rec["launches"]["filtered_lrelu_bwd"], fl_recs, fl_main, "bwd", "u2t12_d4t24"),
    ]

    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
                   "bias_act": bias_recs, "upfirdn2d": up_recs, "filtered_lrelu": fl_recs,
                   "second_order": second_recs, "train": train_rec,
                   "small_reference": small, "slice": slice_rec, "slice_stylegan3": sg3_rec,
                   "projector": proj_rec, "tr_walk": tr_rec, "geometric": geo_rec,
                   "metrics": metrics_rec, "kernels": kernels}, f, indent=1)

    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
