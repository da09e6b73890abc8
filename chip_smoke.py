#!/usr/bin/env python3
"""Drive the PyTorch port of LatentAugment once on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA device, nvcc (for the
upfirdn2d and filtered_lrelu kernels) and Triton (for bias_act), and
imports no JAX. Any failure raises and exits non-zero, printing no result
line.

  1. Kernels: builds the three hand-written kernels from the checkout's
     sources (the two nvcc builds run side by side) and holds each,
     forward and input gradient, against its plain PyTorch version at the
     shapes the StyleGAN2 and StyleGAN3 walks give it, in float32 (TF32
     off) and bfloat16, timing both (median of 20, CUDA events), with
     each case's bound (the larger of its bytes over 3.35 TB/s and its
     fp32 operations over 67 TFLOP/s, from the wrappers' `work`) and,
     for the two upfirdn2d cases one PyTorch call computes (a depthwise
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

The last two lines of stdout are the kernels' JSON record and
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
         ("u1d1", "u1d1"), None),
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


def run_policy(torch, argv, counters):
    """AugOptions -> create_dataset -> create_augment -> per-batch
    set_input / forward / get_output over the first N_BATCHES batches;
    returns per-batch records, the launch counts, set-up seconds and the
    peak device memory. `counters` are the kernels' launch dicts; the
    per-variant dicts (VARIANT_COUNTERS) are set to 0 with them."""
    from latentaugment_tpu_torch.augments import create_augment
    from latentaugment_tpu_torch.data import create_dataset
    from latentaugment_tpu_torch.options import AugOptions

    opt = AugOptions().parse(argv=argv, install_logger=False)
    dataset = create_dataset(opt)
    for c in (*counters, *VARIANT_COUNTERS.values()):
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
        if len(batches) == N_BATCHES:
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


def check_batches(torch, np, batches, batch, label):
    if len(batches) != N_BATCHES:
        raise AssertionError(f"{label}: expected {N_BATCHES} batches, got {len(batches)}")
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
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} was not launched on the {arch} path")
    variants = {name: dict(c) for name, c in VARIANT_COUNTERS.items()}
    for name, c in variants.items():
        if c["generic"] != 0:
            raise AssertionError(f"{arch}: {c['generic']} launches of {name} went through its "
                                 f"generic variant: {c}")
    kernel_sps = samples_per_s(batches, batch)
    log(f"  kernels: batch walls {[round(b['wall'], 3) for b in batches]} s, "
        f"{kernel_sps:.3f} samples/s over batches 2-3, set-up {setup_s:.1f} s, "
        f"peak memory {peak / 2**30:.2f} GiB, launches {launches}, by variant {variants}")
    rec = dict(arch=arch, batch=batch, launches=launches, variant_launches=variants,
               kernel_samples_per_s=kernel_sps,
               batch_wall_s=[b["wall"] for b in batches], setup_s=setup_s,
               peak_mem_bytes=peak,
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
    log(f"  phase 1 took {time.time() - t0:.1f} s (builds included)")
    small = {"stylegan2": phase_small_reference(torch, benchmark),
             "stylegan3": phase_small_reference(torch, benchmark, arch="stylegan3")}
    slice_rec = phase_slice(torch, np, benchmark, (ba.launches, up.launches))
    sg3_rec = phase_slice(torch, np, benchmark, (ba.launches, up.launches, fl.launches),
                          arch="stylegan3", batch=SG3_BATCH)

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
        entry("bias_act_bwd", "triton", ba_src, ba_tpu, slice_rec["launches"]["bias_act_bwd"],
              bias_recs, ba_main, "bwd", None),
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
                   "small_reference": small, "slice": slice_rec, "slice_stylegan3": sg3_rec,
                   "kernels": kernels}, f, indent=1)

    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
