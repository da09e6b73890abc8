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
     walks on the card through the kernels, with deterministic cuDNN.
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
 10. Real-format checkpoints at phase 3's widths, from the NVIDIA-faithful
     torch G and D of tests/reference_oracles.py (seeded, NVIDIA's init,
     w_avg and noise strengths nonzero): (a) written as an NVIDIA
     persistence pickle and converted (host seconds), the port's G (psi 1
     and 0.7, const noise) and D in float32 against those modules on the
     card (CONVERT_TOL of max |oracle|); the policy for 2 batches over the
     pickle, its launches per batch equal to phase 3's, and its first batch
     against the walk from the native file of the converted modules, run
     twice: step-0 losses (STEP0_TOL, beside the native walk's own rerun:
     cuDNN's algorithms differ between engines), walked w under the default
     algorithms beside that rerun; then with deterministic cuDNN, where the
     native walk run again and the pickle's walk must both be bit-equal to
     the native walk in bf16; (b) a conditional pair (c_dim 3):
     `forward(w, c=...)` at batch 32 in float32 with the kernels and with
     --impl ref, the launches read right after the kernels' walk (the
     gradient at w within TOL_GRAD_WALK of its max, every step's losses
     within 1e-3, walked w within W_ATOL on all but W_SLIVER of its
     coordinates), beside the plain walk from w moved by one float32 step
     (the plain path's own spread), other labels moving w, each walk at
     the same crop, `forward_ganrand(z, c=...)`; (c) phase 4's SG3-T
     checkpoint re-written as an NVIDIA-style payload (`class_name`
     ...networks_stylegan3.Generator): every tensor
     bit-equal to the native one's, and one module's image under both
     (CONVERT_TOL, bit-equality recorded), through K3; (d) a TorchScript
     VGG16 with LPIPS heads through `vgg.convert_torchscript`: the taps on
     the card against the script module's (CONVERT_TOL).

 11. StyleGAN3-R (radial 2-D down filters, G twice D's widths): the R
     generator at 256x256 in float32, kernels against the plain versions
     (image and gradient at ws); the policy walk over an SG3-R checkpoint
     for 3 batches at the largest of SG3R_BATCHES that fits without
     remat, the decomposed filtered_lrelu (K1 and K2) launched, K2 `sepn`
     (the 1-D up filters and their backwards) and `f2d` (the radial down
     filter and its backward) each 12 x 21 times a batch and `generic`
     never, K3 on the critically sampled layers; one engine walk at that
     batch under torch.profiler, its device time by kind, K2 by variant;
     then K2 at the R plan's largest layers at the walk's batch, forward
     and backward against the plain version in float32 and bfloat16:
     `f2d` on L10's and L11's radial 12x12 filter at down 2 (its backward
     at up 2; L11 in float32 values only), `sepn` on L10's 24-tap filter
     at up 4 and L11's 12-tap filter at up 2 (float32 values only: three
     10 GB tensors and the plain graph leave no room for timing), with
     bounds, the one PyTorch call that computes the same (the depthwise
     F.conv2d for the 2-D filter, the depthwise F.conv_transpose2d at
     stride s with the outer product, cropped, for the 1-D ones) and
     `generic` launched directly on the same inputs (the kernel they ran
     on before), held to the plain version forward and backward and
     timed; the kernels line keeps its entry, with 0 launches.
 12. The sweep drivers (scripts/torch_backbone_{latentaug,sg2aug,geoaug}.py)
     on phase 3's workspace, 3 batches after the sanity check's: the
     LatentAugment sweep's dumps complete and its launches per batch equal
     to phase 3's, its mean wall beside phase 3's samples/s; the
     random-GAN sweep's samples/s and launches; the geometric sweep's ms
     per batch.
 13. scripts/torch_run_pipeline.py at 256x256 and the operating point's
     widths: train (one warm-up step and one d_reg_interval at batch 32),
     project (batch 16, PIPE_PROJECT_STEPS steps), walk and dump
     PIPE_N_IMGS images at batch 32, FID and precision/recall per
     modality, the PCA coverage plot and a GIF, each stage's seconds; then
     one sg2_metrics_opt trial over phase 3's workspace. Cut from the
     full-size loop: 25k kimg of training to 17 steps, 1000 projector
     steps to PIPE_PROJECT_STEPS, 50k scored images to PIPE_N_IMGS,
     50 tuning trials to 1.
 14. scripts/torch_sustained_train.py at the JAX run's operating point
     (phantom dataset at 256x256, batch 32, SUSTAINED_KIMG kimg, ADA, R1
     over the whole batch): scripts/torch_check_train_run.py's check must
     pass; its summary, seconds, images/s, peak memory and launches
     (bias_act_bwd2 among them). log.jsonl, summary.json and dynamics.png
     go to chiprun_out/torch_sustained_train_h100/.
 15. Export and serving: phase 3's G exported with a symbolic batch
     (scripts/torch_export_model.py), saved and loaded (.pt2), its
     graph's latentaugment_torch ops counted; the loaded program at batch
     32 against the eager G through the kernels (bf16, TOL) with equal
     launches per forward, a float32 export against the eager G with
     impl='ref' (CONVERT_TOL); the program served over HTTP on port 0
     (examples/torch_serve_generator.py) at n = SERVE_NS (33 chunked),
     images/s beside the eager G's; phase 4's SG3-T G exported at batch
     SG3_EXPORT_BATCH (filtered_lrelu ops), against its eager forward.
 16. examples/torch_train_pix2pix.py on phase 3's workspace (batch 32,
     K=10, 256x256) for PIX2PIX_STEPS steps: s/step split into the walk
     and the pix2pix step, losses finite, the walk's launches per batch
     equal to phase 3's.
 17. From volumes to an augmented batch: phantom .npy volumes (TOOL_PATIENTS
     patients, 2 modalities, RES x RES) through the port's dataset tool
     (`prepare_pelvis_2_1`: resize, normalize, mask, slice, split, zip),
     the zip's members checked; the StyleGAN2 policy walks one batch of it
     over phase 3's checkpoint (launches per batch equal to phase 3's);
     then examples/torch_train_pix2pix.py for 2 steps on a Mayo Clinic
     phantom set (create_csv_mayoclinic, the `mayoclinic` loader, the
     example's baseline without augmentation). It says whether the sanity
     pictures were written and which of yaml, matplotlib, pandas, nibabel
     and pydicom this host has.
 18. Data parallelism on one card. NCCL at world size 1: the walk through
     an engine with a 1-rank mesh bit-equal to the one-process walk under
     deterministic cuDNN. Then two ranks on cuda:0 under gloo (a check, not
     a deployment; collectives pass through the host), at full width:
     which gloo collectives take CUDA tensors; the policy with
     --n_mesh_devices 2 for 2 batches of phase 3's workspace (launches per
     batch per rank equal to phase 3's), its step-0 loss and gradient at w
     in float32 against one process (DP_TOL of their max), the walked w's
     largest difference and the share of coordinates above 1e-3; the
     trainer at phase 9's widths, step-0 losses and every parameter
     gradient in float32 against one process (DP_TOL), both step-0
     comparisons under deterministic cuDNN, then each phase
     twice in bf16 with ADA, random noise and mixing, the replicas
     bit-equal after every step; the projector's command line with
     --n_devices 2 (float32), its step-0 distance against one process;
     FID and precision/recall of the float32 live generator at DP_N_GEN
     images against one process. Per rank: samples/s, peak memory, K1 and
     K2 launches.
 19. Tensor parallelism on one card: two ranks on cuda:0 under gloo form a
     ('data', 'model') = 1 x 2 mesh (a check, not a deployment). The
     policy with --n_mesh_devices 2 --n_model_devices 2 walks 2 batches
     of TP_BATCH over phase 3's workspace, each conv layer of G, D and
     VGG16 computing half its output channels: each rank holds O/2 of
     every split weight, and K1 and K2 launch on each rank as often as in
     the one-process walk at the same batch (run after it on rank 0);
     step-0 loss and w-gradient in float32 under deterministic cuDNN
     against one process (DP_TOL, TOL_GRAD_WALK of its max, beside the
     one-process gradient's own spread); the bf16 walked w against the
     one-process walk's; then phase 4's SG3-T G at batch 2 in float32
     under the mesh against one process (DP_TOL of its max, K3's launches
     equal). Per rank: samples/s beside the one-process walk's, peak
     memory, launches.

Phase 1c differentiates K1 and K2 twice, as R1 and path length do, at
the trainer's shapes (1e-5 of max |plain| in float32, 2e-2 in bfloat16).
No launch of any phase's main path may go through a kernel's `generic`
variant; phase 11 must launch K2's `sepn` and `f2d`. The last two lines
of stdout are the kernels' JSON record and
{"ok": true, "device": {...}}. Details go to chiprun_out/chip_smoke.json.
"""

import contextlib
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
# Phase 10: a converted network (float32) against the module it came from,
# max err / max |reference|; the walked w (a tenth of one Adam step).
CONVERT_TOL, W_ATOL = 1e-4, 1e-3
STEP0_TOL = 1e-3  # a walk's step-0 losses from one engine to the next (bf16)
# The conditional walk at batch 32 in float32, kernels against plain. Four
# readings on an H100: the gradient at w 1.31e-3 to 2.50e-3 of its max
# (in the same runs the plain gradient alone moved as much, 1.31e-3 and
# 2.50e-3, when w moved by one float32 step), w past W_ATOL on 0.54% to
# 0.80% of its coordinates. The bounds are 4x and 2.5x the largest reading.
TOL_GRAD_WALK = 1e-2
W_SLIVER = 2e-2
WIDTHS = dict(channel_base=32768, channel_max=512)  # the operating point's G and D
# Phase 11, StyleGAN3-R: G twice as wide as D. The generator's float32
# check at SG3R_G_BATCH (image within SG3R_TOL_IMG and its gradient at ws
# within SG3R_TOL_GRAD of their max); the walk at the first of
# SG3R_BATCHES that fits the card without remat, and K2's cases at the R
# plan's largest layer at the walk's batch.
SG3R_G_BATCH, SG3R_BATCHES = 2, (16, 8, 4)
SG3R_TOL_IMG, SG3R_TOL_GRAD = 1e-4, 1e-3
# Phase 13, the pipeline: images walked and scored, projector steps, and
# the images of the one tuning trial.
PIPE_N_IMGS, PIPE_PROJECT_STEPS, PIPE_TRIAL_IMGS = 512, 5, 64
# Phase 14: sustained training at the JAX run's operating point (its
# artifacts/sustained_train_r4 covered 10.016 kimg in 32 log rows).
SUSTAINED_KIMG = 10
# Phase 15: the served request sizes (33 is chunked through bucket 32),
# timed SERVE_REPS times each; the SG3-T G is exported at a concrete batch.
SERVE_NS, SERVE_REPS, SG3_EXPORT_BATCH = (1, 8, 32, 33), 3, 8
# Phase 16: pix2pix steps on augmented batches.
PIX2PIX_STEPS = 20
# Phase 17: phantom volumes for the dataset tool (patients x depth, the
# slices dropped at each end: the tool's default, which keeps the slice
# ids 10.. that the walk's manifold schedule reads); 4 x (28 - 2 x 10) =
# 32 slices, one batch.
TOOL_PATIENTS, TOOL_DEPTH, TOOL_POP = 4, 28, 10
# Phase 18: 2 ranks against 1 process, step-0 loss and gradient (float32)
# within DP_TOL of their max; FID within DP_FID_TOL (relative) at DP_N_GEN
# generated images; the projector's steps; the ranks' time limit.
DP_TOL, DP_FID_TOL, DP_N_GEN, DP_PROJ_STEPS, DP_TIMEOUT_S = 1e-4, 1e-3, 128, 5, 600
# Phase 19: each sharded layer's output crosses the host under gloo, so a
# small batch; its time is recorded, not judged (one card shows no speed-up).
TP_BATCH, TP_TIMEOUT_S = 4, 300
# Phase 9's bound on a float32 parameter gradient between two correct
# implementations (of its max), which phase 18 reads its trainer against.
TRAIN_TOL_GRAD = 2e-2
# Launch counts by kernel variant, by kernel name; main() fills it.
VARIANT_COUNTERS = {}


def log(msg):
    print(msg, flush=True)


SLOW_CALL_MS, SLOW_CALL_REPS = 100.0, 5  # a call slower than this is timed this many times


def median_ms(fn, n=20, warmup=3):
    """Median of n timed calls (CUDA events) after `warmup` calls; a call
    that takes over SLOW_CALL_MS is timed SLOW_CALL_REPS times."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    if start.elapsed_time(end) > SLOW_CALL_MS:
        n = min(n, SLOW_CALL_REPS)
    for _ in range(warmup - 1):
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


def compare(name, fn, x, dy_seed, dtype_name, records, bounds, library=None, tol_bwd=TOL_GRAD):
    """Kernel vs plain: values and dx, timed. `bounds` are the forward's and
    the backward's (bytes, multiply-adds); `library`, where one PyTorch
    call computes the same function, is that call as x -> y: it is timed
    and held to the plain version, and the port never calls it."""
    import torch

    ys, dxs, ms, dy = run_both(fn, x, dy_seed)
    rec = {"case": name, "dtype": dtype_name, "shape": list(x.shape)}
    check_close(rec, "fwd", ys["auto"], ys["ref"], TOL[dtype_name])
    check_close(rec, "bwd", dxs["auto"], dxs["ref"], tol_bwd[dtype_name])
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
    # cuDNN's default algorithms are not deterministic, and Adam magnifies
    # their run-to-run noise in w: over 18 runs on an H100 the card's walk
    # ended 7e-6 to 3.8e-4 from the CPU's, and once 1.3e-3, past the bound;
    # with deterministic algorithms 2.9e-6 in each of 16 runs. The kernels
    # are deterministic, and so is this comparison of them.
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for dev in ("cpu", "cuda"):
            fns, bundle, g_cfg = benchmark.build_synthetic_setup(
                torch.device(dev), num_epochs=3, crop_size=16, manifold_items=8, seed=5, **setup)
            w0 = torch.randn([4, 1, g_cfg.w_dim],
                             generator=torch.Generator().manual_seed(6)) * 0.5
            img, ws, traces = fns.walk(bundle, w0.to(dev), (2, 4), torch.Generator(device=dev))
            out[dev] = (ws.cpu(), {k: v.cpu() for k, v in traces.items()}, img.cpu())
    finally:
        torch.backends.cudnn.deterministic = deterministic
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


def k2_generic(torch, up, x, f, rate_up, rate_down, padding, flip, gain):
    """K2's `generic` kernel (run-time taps) launched directly on one case,
    as the port routed StyleGAN3-R's filters before `sepn` and `f2d`: the
    "before" column. Not a path of the port, and not counted."""
    n, c, out_h, out_w = up._output_shape(x, f, (rate_up,) * 2, (rate_down,) * 2, padding)
    y = torch.empty([n, c, out_h, out_w], dtype=x.dtype, device=x.device)
    taps = f.to(torch.float32).contiguous()
    fw, fh = up._get_filter_size(taps)
    err = up._library().upfirdn2d_launch(
        x.data_ptr(), y.data_ptr(), taps.data_ptr(), up._DTYPE_CODE[x.dtype], n * c,
        x.shape[2], x.shape[3], out_h, out_w, rate_up, rate_up, rate_down, rate_down,
        padding[0], padding[2], fw, fh, int(taps.ndim == 1), int(flip), float(gain),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K2 generic launch failed: CUDA error {err}")
    return y


def check_only(torch, name, fn, x, dy_seed, dtype_name, records):
    """Kernel vs plain on values and dx without timing, holding one
    full-size tensor at a time beside the plain version's graph (the 1-D
    up filters in float32 at the walk's batch: 10 GB an output)."""
    rec = {"case": name, "dtype": dtype_name, "shape": list(x.shape), "timed": False}
    with torch.no_grad():
        y_k = fn(x, "auto")
        check_close(rec, "fwd", y_k, fn(x, "ref"), TOL[dtype_name])
    g = torch.Generator(device=x.device).manual_seed(dy_seed)
    dy = torch.randn(y_k.shape, generator=g, device=x.device).to(y_k.dtype)
    del y_k
    dxs = {}
    for impl in ("auto", "ref"):
        xg = x.detach().requires_grad_(True)
        dxs[impl], = torch.autograd.grad(fn(xg, impl), xg, dy)
        del xg
        torch.cuda.empty_cache()
    check_close(rec, "bwd", dxs["auto"], dxs["ref"], TOL[dtype_name])
    records.append(rec)
    log(f"  {name:34s} {dtype_name:8s} fwd err {rec['fwd_rel_err']:.2e} bwd err "
        f"{rec['bwd_rel_err']:.2e} (values only)")
    return rec


def phase_sg3r_kernels(torch, up, layers, batch, dev):
    """K2 at the R plan's largest decomposed layers at the walk's batch,
    forward and backward against the plain version (float32 and bfloat16),
    with bounds and the one PyTorch call that computes the same: the radial
    12x12 down filter at L10 and L11 through `f2d`, its backward at up 2
    (the depthwise F.conv2d), the 1-D up filters through `sepn`: 24 taps
    at up 4 (L10) and 12 at up 2 (L11), their backwards at down 4 and 2
    (the depthwise F.conv_transpose2d with the outer product, cropped).
    Every timed case also holds `generic` (the kernel the port ran for
    them before) on the same inputs to the plain version, forward and
    backward, and times it. `layers` maps a layer name to (layer, fu,
    fd)."""
    bf16, f32 = torch.bfloat16, torch.float32
    names = {f32: "float32", bf16: "bfloat16"}
    g = torch.Generator(device=dev).manual_seed(11)
    cases = []
    for lname, which in (("L10", "fd"), ("L11", "fd"), ("L10", "fu"), ("L11", "fu")):
        layer, fu, fd = layers[lname]
        lo, hi = layer.padding
        pad = (lo, hi, lo, hi)
        c, n_in = layer.out_channels, layer.in_size
        if which == "fd":
            mid = (n_in * layer.up_factor + lo + hi - (fu.shape[0] - 1))
            cases.append((f"{lname} radial fd {fd.shape[0]}x{fd.shape[1]} down "
                          f"{layer.down_factor}", [batch, c, mid, mid], fd,
                          dict(down=layer.down_factor), "f2d"))
        else:
            cases.append((f"{lname} fu {fu.shape[0]} taps up {layer.up_factor}",
                          [batch, c, n_in, n_in], fu,
                          dict(up=layer.up_factor, padding=pad, gain=layer.up_factor ** 2),
                          "sepn"))
    recs = []
    for name, shape, f, kw, variant in cases:
        for dtype in (f32, bf16):
            x = torch.randn(shape, generator=g, device=dev).to(dtype)
            wkw = dict(up=kw.get("up", 1), down=kw.get("down", 1), padding=kw.get("padding", 0))
            before = dict(up.variant_launches)

            def fn(x, impl, f=f, kw=kw):
                return up.upfirdn2d(x, f, impl=impl, **kw)

            if dtype == f32 and (f.ndim == 1 or name.startswith("L11")):
                # The plain version's graph and three 10 GB tensors do not
                # fit beside a timed run: values only (L11's radial filter
                # too, to hold the phase's time).
                rec = check_only(torch, name, fn, x, 300 + len(recs), names[dtype], recs)
            else:
                if f.ndim == 2:
                    weight = f.flip([0, 1]).to(dtype)[None, None].repeat(shape[1], 1, 1, 1)

                    def library(x, weight=weight, stride=kw["down"]):
                        return torch.nn.functional.conv2d(x, weight, stride=stride,
                                                          groups=weight.shape[0])
                elif dtype == bf16:
                    # Up-sampling by s with a T-tap filter: the depthwise
                    # transposed conv at stride s with the T x T outer product
                    # (times the gain), cropped to the padding (lo, hi):
                    # upfirdn2d's output m is the full convolution's m + T-1-lo.
                    taps, s_up = f.shape[0], kw["up"]
                    lo, hi = kw["padding"][0], kw["padding"][1]
                    weight = (torch.outer(f, f) * kw["gain"]).to(dtype)[None, None] \
                        .repeat(shape[1], 1, 1, 1)
                    crop = [lo - (taps - 1), hi + s_up - taps] * 2

                    def library(x, weight=weight, stride=s_up, crop=crop):
                        return torch.nn.functional.pad(torch.nn.functional.conv_transpose2d(
                            x, weight, stride=stride, groups=weight.shape[0]), crop)
                wf = up.work(shape, tuple(f.shape), itemsize=x.element_size(), **wkw)
                # The backward is K2 on dy with up and down swapped.
                bpad = up.transposed_padding(shape, wf["out_shape"], up._get_filter_size(f),
                                             (wkw["up"],) * 2, (wkw["down"],) * 2,
                                             up._parse_padding(wkw["padding"]))
                wb = up.work(wf["out_shape"], tuple(f.shape), up=wkw["down"], down=wkw["up"],
                             padding=bpad, itemsize=x.element_size())
                # The backward too within TOL: one FIR, rounded once either way.
                rec = compare(name, fn, x, 300 + len(recs), names[dtype], recs,
                              ((wf["bytes"], wf["macs"]), (wb["bytes"], wb["macs"])), library,
                              tol_bwd=TOL)
                # `generic` on the same inputs, forward and backward (up and
                # down swapped, the filter flipped), held to the plain
                # version: the before column.
                padding = up._parse_padding(wkw["padding"])
                gain = float(kw.get("gain", 1))
                gen_args = (f, wkw["up"], wkw["down"], padding, False, gain)
                gb_args = (f, wkw["down"], wkw["up"], bpad, True, gain)
                with torch.no_grad():
                    y_p = fn(x, "ref")
                    check_close(rec, "generic", k2_generic(torch, up, x, *gen_args), y_p,
                                TOL[names[dtype]])
                    dy = torch.randn_like(y_p)
                    del y_p
                xg = x.detach().requires_grad_(True)
                dx_p, = torch.autograd.grad(fn(xg, "ref"), xg, dy)
                del xg
                with torch.no_grad():
                    check_close(rec, "generic_bwd", k2_generic(torch, up, dy, *gb_args), dx_p,
                                TOL[names[dtype]])
                    del dx_p
                    rec["generic_fwd_ms"] = median_ms(
                        lambda: k2_generic(torch, up, x, *gen_args))
                    rec["generic_bwd_ms"] = median_ms(
                        lambda: k2_generic(torch, up, dy, *gb_args))
                del dy
                log(f"    before (K2 generic, same inputs): fwd err {rec['generic_rel_err']:.2e} "
                    f"bwd err {rec['generic_bwd_rel_err']:.2e} | fwd {rec['generic_fwd_ms']:.3f} "
                    f"ms, bwd {rec['generic_bwd_ms']:.3f} ms")
            used = {k for k in before if up.variant_launches[k] != before[k]}
            if used != {variant}:
                raise AssertionError(f"{name}: launched variants {used}, expected {variant}")
            rec["variant"] = rec["bwd_variant"] = variant
            rec["plan"] = up._plan(tuple(f.shape), (wkw["up"],) * 2, (wkw["down"],) * 2,
                                   tuple(shape[2:]))
            rec["kw"] = {k: list(v) if isinstance(v, tuple) else v for k, v in kw.items()}
            del x
            torch.cuda.empty_cache()
    return recs


def phase_sg3r(torch, np, benchmark, net3, up, fl, counters, dev):
    """StyleGAN3-R on the card: K2 `sepn` and `f2d` on the decomposed
    layers, the R generator at 256x256 with the kernels against the plain
    versions, and the policy walk at the largest batch that fits without
    remat."""
    log("phase 11: StyleGAN3-R (radial filters) on the card")
    g_cfg, _ = benchmark.make_gd_configs(RES, 2, num_fp16_res=0, arch="stylegan3",
                                         **WIDTHS, **benchmark.SG3R)
    radial = [layer for layer in g_cfg.layers if layer.down_radial]
    layers = {layer.name.split("_")[0]: (layer, *(torch.as_tensor(f, device=dev)
                                                  for f in net3._layer_filters(layer)))
              for layer in radial}

    # The generator in float32, kernels against the plain versions: the
    # image and its gradient with respect to ws.
    G = net3.Generator(g_cfg, seed=21).to(dev).eval().requires_grad_(False)
    gen = torch.Generator(device=dev).manual_seed(22)
    z = torch.randn([SG3R_G_BATCH, g_cfg.z_dim], generator=gen, device=dev)
    r = torch.randn([SG3R_G_BATCH, g_cfg.img_channels, RES, RES], generator=gen, device=dev)
    with torch.no_grad():
        ws0 = G.mapping(z)
    out = {}
    for impl in ("auto", "ref"):
        net3.set_impl(G, impl)
        reset_counters(counters)
        fl.decomposed_calls.update(filtered_lrelu_decomposed=0)
        ws = ws0.detach().requires_grad_(True)
        img = G.synthesis(ws)
        grad, = torch.autograd.grad((img * r).sum(), ws)
        torch.cuda.synchronize()
        out[impl] = (img.detach(), grad, read_counters(counters, f"SG3-R G ({impl})", []),
                     dict(fl.decomposed_calls))
    (img_k, grad_k, (launches_k, variants_k), dec_k), (img_r, grad_r, (launches_r, _), _) = \
        out["auto"], out["ref"]
    if any(launches_r.values()):
        raise AssertionError(f"SG3-R G with impl='ref' launched kernels: {launches_r}")
    for k in ("bias_act_fwd", "bias_act_bwd", "upfirdn2d", "filtered_lrelu_fwd",
              "filtered_lrelu_bwd"):
        if launches_k[k] <= 0:
            raise AssertionError(f"SG3-R G: kernel {k} was not launched: {launches_k}")
    if (variants_k["upfirdn2d"]["f2d"] <= 0 or variants_k["upfirdn2d"]["sepn"] <= 0
            or dec_k["filtered_lrelu_decomposed"] <= 0):
        raise AssertionError(f"SG3-R G: no decomposed layer ran through K2 f2d and sepn: "
                             f"{variants_k}, {dec_k}")
    g_rec = dict(batch=SG3R_G_BATCH, launches=launches_k, variant_launches=variants_k,
                 decomposed_calls=dec_k,
                 img_rel_err=rel_close(img_k, img_r, SG3R_TOL_IMG, "SG3-R G image, kernels vs plain"),
                 grad_rel_err=rel_close(grad_k, grad_r, SG3R_TOL_GRAD,
                                        "SG3-R G gradient at ws, kernels vs plain"))
    log(f"  G at batch {SG3R_G_BATCH}, float32: image kernels vs plain {g_rec['img_rel_err']:.2e} "
        f"(<= {SG3R_TOL_IMG}), gradient at ws {g_rec['grad_rel_err']:.2e} (<= {SG3R_TOL_GRAD}); "
        f"launches {launches_k}, by variant {variants_k}, {dec_k}")
    del G, img_k, img_r, grad_k, grad_r, out, r
    gc.collect()
    torch.cuda.empty_cache()

    # The policy walk over an SG3-R checkpoint (bf16 from layer 3 on, as
    # phase 4), at the largest batch that fits without remat.
    walk = None
    for batch in SG3R_BATCHES:
        root = os.path.join(REPO, "build", "chip_smoke_stylegan3r")
        shutil.rmtree(root, ignore_errors=True)
        argv = benchmark.build_policy_workspace(root, batch_size=batch, arch="stylegan3",
                                                n_patients=-(-N_BATCHES * batch // 24),
                                                **benchmark.SG3R)
        fl.decomposed_calls.update(filtered_lrelu_decomposed=0)
        got = run_policy_fits(torch, argv, counters)
        if got is not None:
            walk = (batch, argv, got, dict(fl.decomposed_calls))
            break
        log(f"  the SG3-R walk does not fit at batch {batch} without remat")
    if walk is None:
        raise AssertionError(f"the SG3-R walk fits none of the batches {SG3R_BATCHES}")
    batch, argv, (batches, launches, setup_s, peak), dec = walk
    check_batches(torch, np, batches, batch, "SG3-R")
    launches, variants = read_counters(counters, "SG3-R walk",
                                       [k for k in launches if k != "bias_act_bwd2"])
    # Per batch, each of the decomposed layers' two FIRs runs in 11
    # syntheses (10 Adam steps and the final one) and 10 backwards: the
    # 1-D up filter through `sepn`, the radial down filter through `f2d`
    # (read_counters holds `generic` at 0).
    want = len(radial) * (2 * 10 + 1) * N_BATCHES
    k2 = variants["upfirdn2d"]
    if k2["sepn"] != want or k2["f2d"] != want or dec["filtered_lrelu_decomposed"] <= 0:
        raise AssertionError(f"SG3-R walk: K2 launches by variant {k2} over {N_BATCHES} "
                             f"batches, expected {want} sepn and {want} f2d; {dec}")
    sps = samples_per_s(batches, batch)
    walk_rec = dict(batch=batch, launches=launches, variant_launches=variants,
                    decomposed_calls=dec, samples_per_s=sps, peak_mem_bytes=peak,
                    batch_wall_s=[b["wall"] for b in batches], setup_s=setup_s, remat=False)
    log(f"  policy walk at batch {batch} (no remat): batch walls "
        f"{[round(b['wall'], 3) for b in batches]} s, {sps:.3f} samples/s over batches 2-3, "
        f"peak memory {peak / 2**30:.2f} GiB, launches {launches}, by variant {variants}, "
        f"{dec}")
    shutil.rmtree(root, ignore_errors=True)
    del batches, walk, got
    gc.collect()
    torch.cuda.empty_cache()

    # One engine walk at the same batch under torch.profiler: device time
    # by kind of kernel, K2 by variant (after the counters were read).
    from scripts.torch_kernel_times import sg3r_walk

    walk_rec["device_split"] = sg3r_walk(torch, dev, batch=batch, reps=1)
    split = walk_rec["device_split"]
    log(f"  engine walk at batch {batch}: {split['walk_ms']:.1f} ms, idle "
        f"{split['idle_share']:.3f}; device ms by kind "
        f"{ {k: round(v, 1) for k, v in split['device_ms_by_kind'].items()} }")
    gc.collect()
    torch.cuda.empty_cache()

    # K2 at the largest decomposed layers, at the batch the walk gives them.
    kernel_recs = phase_sg3r_kernels(torch, up, layers, batch, dev)
    return dict(kernels=kernel_recs, generator=g_rec, walk=walk_rec,
                layers=[layers[k][0].name for k in ("L10", "L11")])


def run_driver(torch, counters, main, argv, n_imgs, **over):
    """A driver script's main at LATENTAUGMENT_N_IMGS = n_imgs with the
    launch counters reset just before it and read just after; `over`
    replaces entries of the module's sweep space for this run."""
    space = sys.modules[main.__module__].params_space if over else {}
    saved_env, saved_space = os.environ.get("LATENTAUGMENT_N_IMGS"), {}
    os.environ["LATENTAUGMENT_N_IMGS"] = str(n_imgs)
    for k, v in over.items():
        saved_space[k] = space[k]
        space[k] = [v]
    try:
        reset_counters(counters)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        got = main(argv, install_logger=False)
        torch.cuda.synchronize()
        seconds = time.time() - t0
    finally:
        space.update(saved_space)
        if saved_env is None:
            os.environ.pop("LATENTAUGMENT_N_IMGS")
        else:
            os.environ["LATENTAUGMENT_N_IMGS"] = saved_env
    return got, {k: v for c in counters for k, v in c.items()}, seconds


def check_dumps(outdir, names):
    """Every file `names` lists ({subdir: [file, ...]}) is there, and no other."""
    for sub, files in names.items():
        got = sorted(os.listdir(os.path.join(outdir, sub)))
        if got != sorted(files):
            raise AssertionError(f"{outdir}/{sub}: dumped {got}, expected {sorted(files)}")


def phase_drivers(torch, counters, slice_rec):
    """The sweep drivers (scripts/torch_backbone_*.py) on phase 3's
    workspace: the LatentAugment sweep at phase 3's operating point (its
    K=10 in place of the sweep space's 6, so both run one walk), the
    random-GAN sweep and the geometric sweep, N_BATCHES batches each after
    the sanity check's."""
    from scripts import torch_backbone_geoaug, torch_backbone_latentaug, torch_backbone_sg2aug

    log("phase 12: the sweep drivers on phase 3's workspace")
    argv = slice_rec["argv"] + ["--device", "cuda"]
    n_imgs = N_BATCHES * BATCH
    names = {"img": [f"img_{i}" for i in range(N_BATCHES)],
             "img_aug": [f"img_aug_{i}" for i in range(N_BATCHES)]}
    (outdir, times), launches, seconds = run_driver(
        torch, counters, torch_backbone_latentaug.main, argv + ["--name", "driver_latentaug"],
        n_imgs, opt_num_epochs=10)
    check_dumps(outdir, dict(names, latent=[f"w_{i}" for i in range(N_BATCHES)],
                             latent_aug=[f"w_aug_{i}" for i in range(N_BATCHES)]))
    # The sanity check's batch and N_BATCHES more: per batch, phase 3's launches.
    walks = 1 + N_BATCHES
    if {k: launches[k] * N_BATCHES for k in slice_rec["launches"]} != \
            {k: v * walks for k, v in slice_rec["launches"].items()} or \
            any(launches[k] for k in launches if k not in slice_rec["launches"]):
        raise AssertionError(f"latentaug driver: launches {launches} over {walks} walks, phase 3 "
                             f"{slice_rec['launches']} over {N_BATCHES}")
    wall = statistics.mean(times[1:])
    lat = dict(launches=launches, walks=walks, batch_wall_s=times, mean_wall_s=wall,
               samples_per_s=BATCH / wall, seconds=seconds, outdir=outdir)
    log(f"  latentaug: mean wall after the first batch {wall:.3f} s ({BATCH / wall:.3f} "
        f"samples/s) beside phase 3's {slice_rec['kernel_samples_per_s']:.3f} samples/s; "
        f"launches per batch {({k: v // walks for k, v in launches.items()})} = phase 3's")
    shutil.rmtree(outdir)

    runs, launches, seconds = run_driver(
        torch, counters, torch_backbone_sg2aug.main,
        argv + ["--rand_aug", "--name", "driver_sg2aug"], n_imgs)
    (outdir, times), = runs
    check_dumps(outdir, dict(names, latent=[], latent_aug=[f"w_aug_{i}" for i in range(N_BATCHES)]))
    for k in ("bias_act_fwd", "upfirdn2d"):
        if launches[k] <= 0:
            raise AssertionError(f"sg2aug driver: kernel {k} was not launched: {launches}")
    wall = statistics.mean(times[1:])
    sg2 = dict(launches=launches, batch_wall_s=times, mean_wall_s=wall,
               samples_per_s=BATCH / wall, seconds=seconds)
    log(f"  sg2aug (ganrand, psi 1): {wall * 1e3:.1f} ms per batch of {BATCH}, "
        f"{BATCH / wall:.1f} samples/s; launches {launches}")
    shutil.rmtree(outdir)

    geo_argv = ["--dataroot", slice_rec["argv"][slice_rec["argv"].index("--dataroot") + 1],
                "--checkpoints_dir", os.path.join(REPO, "build", "chip_smoke_geoaug"),
                "--dataset_mode", "pelvis", "--load_size", str(RES), "--batch_size", str(BATCH),
                "--aug", "geometric", "--device", "cuda", "--name", "driver_geoaug"]
    (outdir, times), _, seconds = run_driver(torch, counters, torch_backbone_geoaug.main,
                                             geo_argv, n_imgs)
    check_dumps(outdir, names)
    wall = statistics.mean(times[1:])
    geo = dict(batch_wall_s=times, mean_wall_s=wall, seconds=seconds)
    log(f"  geoaug (flip, affine, elastic): {wall * 1e3:.2f} ms per batch of {BATCH}")
    shutil.rmtree(os.path.join(REPO, "build", "chip_smoke_geoaug"))
    return dict(latentaug=lat, sg2aug=sg2, geoaug=geo)


def phase_pipeline(torch, counters, slice_rec):
    """scripts/torch_run_pipeline.py at full width (SG2 at 256x256, channel
    base 32768): train one warm-up step and one d_reg_interval at batch 32,
    project the synthetic split (batch 16, PIPE_PROJECT_STEPS steps), walk
    and dump PIPE_N_IMGS images at batch 32 (K=10), FID and precision/recall
    per modality, the PCA coverage plot and the GIFs; then one
    sg2_metrics_opt trial on phase 3's workspace."""
    from latentaugment_tpu_torch.analysis import hpo, sg2_metrics_opt
    from scripts import torch_run_pipeline

    log("phase 13: the one-command pipeline at 256x256")
    reset_counters(counters)
    train_steps = 17
    outdir, results, seconds = torch_run_pipeline.main([
        "--synthetic", "--res", str(RES), "--channel_base", str(WIDTHS["channel_base"]),
        "--channel_max", str(WIDTHS["channel_max"]), "--n_imgs", str(PIPE_N_IMGS),
        "--train", "--train_kimg", str(train_steps * BATCH / 1000), "--train_batch", str(BATCH),
        "--project", "--project_steps", str(PIPE_PROJECT_STEPS), "--project_batch",
        str(PROJ_BATCH), "--batch_size", str(BATCH), "--opt_num_epochs", "10",
        "--w_lpips", "10", "--device", "cuda"])
    launches = {k: v for c in counters for k, v in c.items()}
    for k in ("bias_act_fwd", "bias_act_bwd", "bias_act_bwd2", "upfirdn2d"):
        if launches[k] <= 0:
            raise AssertionError(f"pipeline: kernel {k} was not launched: {launches}")
    if any(c["generic"] for c in VARIANT_COUNTERS.values()):
        raise AssertionError(f"pipeline: a generic launch: {VARIANT_COUNTERS}")
    if len(results) != 4 or not all(math.isfinite(v) for _, _, r in results for v in r.values()):
        raise AssertionError(f"pipeline: metric results {results}")
    gifs = [f for f in os.listdir(outdir) if f.endswith(".gif")]
    for f in ("pipeline_metrics.json", "umap_coverage.png"):
        if not os.path.isfile(os.path.join(outdir, f)):
            raise AssertionError(f"pipeline: {f} missing under {outdir}")
    if not gifs or len(os.listdir(os.path.join(outdir, "img_aug"))) != PIPE_N_IMGS // BATCH:
        raise AssertionError(f"pipeline: gifs {gifs}, dumps "
                             f"{os.listdir(os.path.join(outdir, 'img_aug'))}")
    log(f"  stage seconds {({k: round(v, 2) for k, v in seconds.items()})}; metrics "
        f"{results}; launches {launches}")
    shutil.rmtree(os.path.dirname(os.path.dirname(outdir)))

    # One tuning trial, objective_recall's: dump PIPE_TRIAL_IMGS walked
    # images and score their recall. Precision/recall only: the pipeline
    # above scored FID, whose 2048x2048 matrix root takes the host 10-30 s.
    argv = slice_rec["argv"] + ["--device", "cuda"]
    study = hpo.create_study(directions=["maximize"], seed=0)

    def objective(trial):
        opt = sg2_metrics_opt.dump_imgs(trial, n_imgs=PIPE_TRIAL_IMGS, argv=argv)
        return sg2_metrics_opt.calc_pr(opt, metrics_name=["pr50k3_full"], eval_split="train")[1]

    t0 = time.time()
    study.optimize(objective, n_trials=1)
    trial = study.trials[0]
    if trial["state"] != "COMPLETE" or not 0.0 <= trial["value"] <= 1.0:
        raise AssertionError(f"sg2_metrics_opt trial: {trial}")
    trial_s = time.time() - t0
    log(f"  one sg2_metrics_opt trial ({PIPE_TRIAL_IMGS} images): recall {trial['value']:.4f}, "
        f"params {trial['params']}, {trial_s:.1f} s")
    return dict(stage_seconds=seconds, metrics=results, launches=launches,
                trial=dict(trial, seconds=trial_s))


@contextlib.contextmanager
def cudnn_deterministic(torch):
    """cuDNN's deterministic algorithms inside the block. Under the default
    ones a float32 step 0 does not rerun bit-equal even in one process, and
    the trainer's path-length loss, a function of G's gradient, once came out
    1.1e-4 apart between 2 ranks and 1 process on an H100, past DP_TOL; with
    deterministic algorithms every rerun is bit-equal
    (scripts/torch_dp_step0_spread.py measures both)."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


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


def _nvidia_pair(torch, oracle, c_dim, seed):
    """The NVIDIA-faithful torch G and D of tests/reference_oracles.py at the
    operating point's widths (8 mapping layers), seeded, in NVIDIA's init
    (mapping weights randn / lr multiplier), with w_avg and the noise
    strengths nonzero."""
    torch.manual_seed(seed)
    g = oracle.GeneratorT(z_dim=512, c_dim=c_dim, w_dim=512, img_resolution=RES, img_channels=2,
                          mapping_kwargs={"num_layers": 8},
                          synthesis_kwargs={**WIDTHS, "conv_clamp": 256})
    d = oracle.DiscriminatorT(c_dim=c_dim, img_resolution=RES, img_channels=2, conv_clamp=256,
                              mapping_kwargs={"num_layers": 8}, **WIDTHS)
    with torch.no_grad():
        for net in (g, d):
            for m in net.modules():
                if isinstance(m, oracle.FullyConnectedT):
                    m.weight.div_(m.lr_multiplier)
        g.mapping.w_avg.copy_(torch.randn_like(g.mapping.w_avg) * 0.1)
        for m in g.modules():
            if isinstance(m, oracle.SynthesisLayerT):
                m.noise_strength.fill_(0.37)
    return g.eval().requires_grad_(False), d.eval().requires_grad_(False)


def _ts_vgg16(torch, vgg):
    """A TorchScript-able VGG16 shaped like NVIDIA's vgg16.pt: the 13 convs
    in definition order and five 1x1 LPIPS `lin` convs."""

    class TSVGG16(torch.nn.Module):
        def __init__(self):
            super().__init__()
            layers, c_in = [], 3
            for item in vgg.VGG16_PLAN:
                if item == "M":
                    layers.append(torch.nn.MaxPool2d(2))
                    continue
                layers += [torch.nn.Conv2d(c_in, item[1], 3, padding=1), torch.nn.ReLU()]
                c_in = item[1]
            self.layers = torch.nn.Sequential(*layers)
            for i, tap in enumerate(vgg.LPIPS_TAPS):
                setattr(self, f"lin{i}",
                        torch.nn.Conv2d(vgg.LPIPS_CHANNELS[tap], 1, 1, bias=False))

        def forward(self, x):
            return self.layers(x)

    return TSVGG16()


def phase_convert(torch, np, counters, slice_rec, sg3_rec, dev):
    """Real-format checkpoints at the operating point's widths: (a) an NVIDIA
    StyleGAN2 pickle held against its torch modules and walked by the
    policy, against the native file of the same weights; (b) a conditional
    pickle walked with labels, kernels against plain; (c) phase 4's SG3-T
    checkpoint as an NVIDIA-style payload; (d) a TorchScript VGG16."""
    import pickle

    import reference_oracles as oracle

    from latentaugment_tpu_torch.augments import engine as engine_mod
    from latentaugment_tpu_torch.models import networks_for, vgg
    from latentaugment_tpu_torch.models.stylegan2 import checkpoint, networks
    from latentaugment_tpu_torch.options import AugOptions

    log("phase 10: real-format checkpoints (NVIDIA / TorchScript stand-ins) at full width")
    root = os.path.join(REPO, "build", "chip_smoke_convert")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    argv = slice_rec["argv"]
    rec = {}

    # (a) An NVIDIA StyleGAN2 pickle.
    g_o, d_o = _nvidia_pair(torch, oracle, 0, seed=10)
    pkl = os.path.join(root, "network-snapshot-nvidia.pkl")
    with open(pkl, "wb") as f:
        f.write(oracle.persistence_pickle_bytes({"G_ema": g_o, "D": d_o}))
    t0 = time.time()
    g_params, g_cfg, d_params, d_cfg = checkpoint.load_stylegan(pkl, img_resolution=RES,
                                                                img_channels=2)
    load_s = time.time() - t0
    if tuple(np.shape(g_params["synthesis"]["resample_filter"])) != (4,) or \
            tuple(np.shape(d_params["resample_filter"])) != (4,):
        raise AssertionError("the converted resample filters are not the 1-D 4-tap filter")
    G = networks.Generator(g_cfg)  # float32: num_fp16_res 0
    G.load_state_dict(checkpoint.params_to_state_dict(g_params))
    D = networks.Discriminator(d_cfg)
    D.load_state_dict(checkpoint.params_to_state_dict(d_params))
    G, D, g_od, d_od = (m.to(dev).eval().requires_grad_(False) for m in (G, D, g_o, d_o))
    gen = torch.Generator(device=dev).manual_seed(41)
    z = torch.randn([8, 512], generator=gen, device=dev)
    errs = {}
    # `with dev`: the oracle makes its identity filter with torch.ones, on
    # the default device.
    with torch.no_grad(), dev:
        for psi in (1.0, 0.7):
            errs[f"G psi {psi}"] = rel_close(G(z, truncation_psi=psi, noise_mode="const"),
                                             g_od(z, truncation_psi=psi, noise_mode="const"),
                                             CONVERT_TOL, f"converted G, psi {psi}")
        img = torch.rand([8, 2, RES, RES], generator=gen, device=dev) * 2 - 1
        errs["D logits"] = rel_close(D(img), d_od(img), CONVERT_TOL, "converted D")
    log(f"  NVIDIA pickle: converted in {load_s:.2f} s on the host; port (kernels, float32, TF32 "
        f"off) vs the oracle modules on the card, max err / max |oracle|: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f" (bound {CONVERT_TOL})")
    native = os.path.join(root, "native-of-nvidia.pkl")
    checkpoint.save_checkpoint(native, G.cpu(), D.cpu())
    del G, D, g_od, d_od, g_o, d_o
    gc.collect()
    torch.cuda.empty_cache()

    n = 2
    argv_pkl = argv + ["--model_dir", root, "--network_pkl_stylegan", os.path.basename(pkl)]
    batches, launches, setup_s, peak = run_policy(torch, argv_pkl, counters, n_batches=n)
    check_batches(torch, np, batches, BATCH, "walk from the NVIDIA pickle", n_batches=n)
    launches, variants = read_counters(counters, "walk from the NVIDIA pickle",
                                       ["bias_act_fwd", "bias_act_bwd", "upfirdn2d"])
    # The same walk per batch as phase 3's (3 batches there, n here).
    want = {k: slice_rec["launches"][k] for k in launches if k in slice_rec["launches"]}
    want_v = slice_rec["variant_launches"]["upfirdn2d"]
    if any(launches[k] * N_BATCHES != want[k] * n for k in want) or \
            any(variants["upfirdn2d"][k] * N_BATCHES != want_v[k] * n for k in want_v):
        raise AssertionError(f"walk from the NVIDIA pickle launched {launches} {variants} over "
                             f"{n} batches; phase 3: {want} {want_v} over {N_BATCHES}")
    # The first batch again from the native file of the converted modules,
    # twice. Under cuDNN's default algorithms, picked per engine (the free
    # workspace counts), no two bf16 walks are bit-equal, so there the
    # step-0 losses are held to STEP0_TOL beside the native walk's own
    # rerun and the walked w is recorded beside that rerun (Adam turns any
    # difference of a gradient near 0 into whole steps of lr). With
    # deterministic cuDNN (benchmark off) the bf16 walk must be
    # reproducible, and the pickle's walk must equal the native file's bit
    # for bit.
    argv_nat = argv + ["--model_dir", native]
    nat, nat2 = (run_policy(torch, argv_nat, counters, n_batches=1)[0][0] for _ in range(2))

    def step0_rel(got, want):
        return max(abs(got["traces"][k][0].item() - v[0].item()) / abs(v[0].item())
                   for k, v in want["traces"].items())

    step0, step0_rerun = step0_rel(batches[0], nat), step0_rel(nat2, nat)
    if not step0 <= STEP0_TOL:
        raise AssertionError(f"step-0 losses, NVIDIA pickle vs its native file: rel diff {step0} "
                             f"(the native walk against itself: {step0_rerun})")
    w_default = float(np.abs(batches[0]["w_out"] - nat["w_out"]).max())
    w_rerun = float(np.abs(nat2["w_out"] - nat["w_out"]).max())
    cudnn = torch.backends.cudnn
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        w_det = {name: run_policy(torch, a, counters, n_batches=1)[0][0]["w_out"]
                 for name, a in (("pickle", argv_pkl), ("native", argv_nat),
                                 ("native again", argv_nat))}
    finally:
        cudnn.deterministic = False
    w_det_rerun = float(np.abs(w_det["native again"] - w_det["native"]).max())
    w_diff = float(np.abs(w_det["pickle"] - w_det["native"]).max())
    if not (w_det_rerun == 0 and w_diff == 0):
        raise AssertionError(f"bf16 walks with deterministic cuDNN: the native walk against "
                             f"itself run again differs by {w_det_rerun}, the NVIDIA pickle's "
                             f"against the native file's by {w_diff}")
    sps = BATCH / batches[1]["wall"]
    log(f"  policy over the NVIDIA pickle: {sps:.3f} samples/s (second batch; phase 3 "
        f"{slice_rec['kernel_samples_per_s']:.3f} over batches 2-3), set-up {setup_s:.1f} s, "
        f"peak memory {peak / 2**30:.2f} GiB, launches per batch equal phase 3's {launches}, "
        f"by variant {variants}; against the walk from the native file: step-0 losses rel "
        f"diff {step0:.2e} (the native walk against itself run again {step0_rerun:.2e}, bound "
        f"{STEP0_TOL}); walked w (bf16 top blocks, default cuDNN) max |diff| {w_default:.2e}, the "
        f"native walk against itself run again {w_rerun:.2e}; bf16 with deterministic cuDNN: "
        f"the native walk run again and the pickle's walk both bit-equal to the native walk")
    rec["nvidia_pickle"] = dict(
        load_seconds=load_s, rel_err=errs, bound=CONVERT_TOL, launches=launches,
        variant_launches=variants, samples_per_s=sps, batch_wall_s=[b["wall"] for b in batches],
        setup_s=setup_s, peak_mem_bytes=peak, step0_rel_diff_vs_native=step0,
        step0_rel_diff_native_rerun=step0_rerun,
        w_vs_native_default_cudnn=w_default, w_native_rerun_default_cudnn=w_rerun,
        w_vs_native_bf16_deterministic=w_diff, w_native_rerun_bf16_deterministic=w_det_rerun)
    del batches, nat, nat2, w_det
    gc.collect()
    torch.cuda.empty_cache()

    # (b) A conditional pickle, walked with labels: kernels against plain,
    # in float32 (TF32 off) so that the walked w compares to 1e-3.
    g_o, d_o = _nvidia_pair(torch, oracle, 3, seed=11)
    cond = os.path.join(root, "network-snapshot-conditional.pkl")
    with open(cond, "wb") as f:
        f.write(oracle.persistence_pickle_bytes({"G_ema": g_o, "D": d_o}))
    del g_o, d_o
    rng = np.random.RandomState(12)
    w = rng.randn(BATCH, 1, 512).astype(np.float32) * 0.1
    zc = rng.randn(BATCH, 512).astype(np.float32)
    c_a = np.eye(3, dtype=np.float32)[np.arange(BATCH) % 3]
    c_b = np.roll(c_a, 1, axis=1)
    # The same w moved by one float32 rounding step (the next float up):
    # the plain path's own spread under a rounding-size change of its input.
    w_ulp = np.nextafter(w, np.float32(np.inf))

    def walk(eng, w_in, labels=c_a):
        # Each walk draws its crop from the engine's crop stream: rewind it,
        # so that every walk here sees the same crop.
        eng._crop_rng.setstate(crop_state)
        t0 = time.time()
        _, ws = eng.forward(w_in, c=labels)
        torch.cuda.synchronize()
        return (ws.cpu().numpy()[:, 0], time.time() - t0,
                {k: v.float().cpu() for k, v in eng.last_traces.items()})

    def grad_at(eng, w_in):
        """d loss / d w at w_in, one crop: the labels' gradient path alone."""
        w_leaf = torch.as_tensor(w_in, device=dev).requires_grad_(True)
        total, _ = eng._fns.loss_fn(eng._bundle, w_leaf, (8, 8), torch.as_tensor(c_a, device=dev))
        return torch.autograd.grad(total, w_leaf)[0].cpu()

    walked, grads = {}, {}
    for impl in ("auto", "ref"):
        opt = AugOptions().parse(argv=argv + ["--model_dir", root, "--network_pkl_stylegan",
                                              os.path.basename(cond), "--num_fp16_res", "0",
                                              "--impl", impl], install_logger=False)
        eng = engine_mod.define_latentaugment("latent_aug", "train", opt, root, dev)
        crop_state = eng._crop_rng.getstate()
        reset_counters(counters)
        walked[impl] = walk(eng, w)
        if impl == "auto":
            cond_launches, cond_variants = read_counters(
                counters, "conditional walk", ["bias_act_fwd", "bias_act_bwd", "upfirdn2d"])
        elif any(c for cs in counters for c in cs.values()):
            raise AssertionError(f"--impl ref launched kernels: {[dict(c) for c in counters]}")
        grads[impl] = grad_at(eng, w)
        if impl == "auto":
            moved = float(np.abs(walk(eng, w, c_b)[0] - walked["auto"][0]).max())
            img_g, _ = eng.forward_ganrand(zc, c=c_a)
            if not (moved > 0 and torch.isfinite(img_g).all()):
                raise AssertionError(f"conditional walk: other labels moved w by {moved}; "
                                     f"ganrand finite {bool(torch.isfinite(img_g).all())}")
        else:
            walked["ref_ulp"], grads["ref_ulp"] = walk(eng, w_ulp), grad_at(eng, w_ulp)
        del eng
        gc.collect()
        torch.cuda.empty_cache()

    # Adam normalises each coordinate's step, so where a gradient passes
    # near 0 a rounding-size difference may step it a whole lr the other
    # way, and a lrelu or clamp kink within rounding of an input flips that
    # element's slope in the gradient. The plain walk from w_ulp shows how
    # far the plain path alone spreads so; kernels against plain are held
    # to TOL_GRAD_WALK in the gradient at w, 1e-3 in every step's losses,
    # and W_ATOL in w on all but W_SLIVER of its coordinates.
    def spread(a, b):
        d = np.abs(walked[a][0] - walked[b][0])
        trace = max(((walked[a][2][k] - v).abs() / v.abs()).max().item()
                    for k, v in walked[b][2].items())
        return dict(w_max_abs_diff=float(d.max()), w_share_above_atol=float((d > W_ATOL).mean()),
                    w_p999=float(np.quantile(d, 0.999)), loss_trace_rel=trace)

    kvp, ulp = spread("auto", "ref"), spread("ref_ulp", "ref")
    ulp["grad_rel_err"] = rel_close(grads["ref_ulp"], grads["ref"], math.inf,
                                    "plain gradient at w_ulp vs at w")
    kvp["grad_rel_err"] = rel_close(grads["auto"], grads["ref"], TOL_GRAD_WALK,
                                    "conditional walk's gradient at w, kernels vs plain")
    if not (kvp["w_share_above_atol"] <= W_SLIVER and kvp["loss_trace_rel"] <= 1e-3):
        raise AssertionError(f"conditional walk, kernels vs plain: {kvp} (w share bound "
                             f"{W_SLIVER}, losses 1e-3); the plain walk from w_ulp: {ulp}")

    def show(s):
        return (f"gradient at w rel err {s['grad_rel_err']:.2e}; losses of every step rel "
                f"{s['loss_trace_rel']:.2e}; walked w max |diff| {s['w_max_abs_diff']:.2e}, share "
                f"above {W_ATOL} {s['w_share_above_atol']:.2e}, 99.9th percentile "
                f"{s['w_p999']:.2e}")

    log(f"  conditional pickle (c_dim 3), float32, batch {BATCH}, kernels vs plain: {show(kvp)} "
        f"(bounds: gradient {TOL_GRAD_WALK}, share {W_SLIVER}); the plain walk from w moved by "
        f"one float32 step against the plain walk from w: {show(ulp)}; walk "
        f"{walked['auto'][1]:.2f} s (plain {walked['ref'][1]:.2f} s, first batch, warm-up "
        f"included); other labels move w by {moved:.2e}; forward_ganrand(z, c) finite; "
        f"launches {cond_launches}")
    rec["conditional"] = dict(kernels_vs_plain=kvp, plain_ulp_vs_plain=ulp, w_atol=W_ATOL,
                              w_sliver=W_SLIVER, grad_bound=TOL_GRAD_WALK,
                              seconds={k: walked[k][1] for k in ("auto", "ref")},
                              labels_move_w_by=moved, launches=cond_launches,
                              variant_launches=cond_variants)

    # (c) Phase 4's SG3-T checkpoint as an NVIDIA-style payload.
    sg3_opt = dict(zip(sg3_rec["argv"][::2], sg3_rec["argv"][1::2]))
    p3, cfg3, _, _ = checkpoint.load_stylegan(sg3_opt["--model_dir"])
    keys = ("z_dim", "c_dim", "w_dim", "img_resolution", "img_channels", "channel_base",
            "channel_max", "num_layers", "num_critical", "first_cutoff", "first_stopband",
            "last_stopband_rel", "margin_size", "output_scale", "conv_clamp", "conv_kernel",
            "filter_size", "lrelu_upsampling", "use_radial_filters")
    payload = {"class_name": "training.networks_stylegan3.Generator",
               "init_kwargs": {**{k: cfg3[k] for k in keys},
                               "mapping_kwargs": {"num_layers": cfg3.num_mapping_layers}},
               "state": {k: v.numpy() for k, v in checkpoint.params_to_state_dict(p3).items()}}
    sg3_pkl = os.path.join(root, "network-snapshot-stylegan3.pkl")
    with open(sg3_pkl, "wb") as f:
        pickle.dump({"G_ema": payload}, f, pickle.HIGHEST_PROTOCOL)
    q3, qcfg3, _, _ = checkpoint.load_stylegan(sg3_pkl)
    if qcfg3.get("arch") != "stylegan3":
        raise AssertionError(f"SG3 payload loaded as {qcfg3.get('arch')}")
    # Every tensor bit for bit; then one module's image under each load (a
    # second module could get other cuDNN algorithms, as phase 10 (a)
    # shows of two engines).
    sd_native, sd_pickle = (checkpoint.params_to_state_dict(p) for p in (p3, q3))
    if sd_native.keys() != sd_pickle.keys() or \
            not all(torch.equal(sd_native[k], sd_pickle[k]) for k in sd_native):
        raise AssertionError("SG3 pickle's tensors differ from the native checkpoint's")
    qcfg3.num_fp16_res = 4
    G3 = networks_for(qcfg3).Generator(qcfg3).to(dev).eval()
    z3 = torch.randn([8, qcfg3.z_dim], generator=torch.Generator(device=dev).manual_seed(43),
                     device=dev)
    imgs = {}
    for name, sd in (("native", sd_native), ("pickle", sd_pickle)):
        G3.load_state_dict(sd)
        reset_counters(counters)
        with torch.no_grad():
            imgs[name] = G3(z3)
        torch.cuda.synchronize()
    sg3_launches, sg3_variants = read_counters(counters, "stylegan3 pickle",
                                               ["filtered_lrelu_fwd"])
    sg3_bit_equal = torch.equal(imgs["pickle"], imgs["native"])
    sg3_err = rel_close(imgs["pickle"], imgs["native"], CONVERT_TOL, "SG3 pickle's image")
    log(f"  SG3-T payload (class_name {payload['class_name']}): arch stylegan3, every tensor "
        f"bit-equal to the native checkpoint's, image at batch 8 "
        f"{'bit-equal' if sg3_bit_equal else f'rel err {sg3_err:.2e}'} to the native one's; "
        f"launches {sg3_launches}, by variant {sg3_variants['filtered_lrelu']}")
    rec["stylegan3_pickle"] = dict(bit_equal=sg3_bit_equal, rel_err=sg3_err,
                                   launches=sg3_launches, variant_launches=sg3_variants)
    del G3, sd_native, sd_pickle
    del imgs
    torch.cuda.empty_cache()

    # (d) A TorchScript VGG16 with LPIPS heads.
    torch.manual_seed(44)
    ts_path = os.path.join(root, "vgg16.pt")
    torch.jit.script(_ts_vgg16(torch, vgg).eval()).save(ts_path)
    params = vgg.convert_torchscript(ts_path)
    mod = torch.jit.load(ts_path, map_location=dev).eval()
    plan = [it[0] for it in vgg.VGG16_PLAN if it != "M"]
    x = torch.randn([2 * BATCH, 3, 64, 64], generator=torch.Generator(device=dev).manual_seed(45),
                    device=dev)
    taps, i = {}, 0
    with torch.no_grad():
        h = x
        for layer in mod.layers.children():
            h = layer(h)
            if getattr(layer, "original_name", "") == "ReLU":
                if plan[i] in vgg.LPIPS_TAPS:
                    taps[plan[i]] = h
                i += 1
        acts = vgg.vgg_features(vgg.params_from_numpy(params, dev), x, taps=vgg.LPIPS_TAPS,
                                input_range="unit")
    vgg_errs = {t: rel_close(acts[t], taps[t], CONVERT_TOL, f"TorchScript VGG16 tap {t}")
                for t in vgg.LPIPS_TAPS}
    log(f"  TorchScript VGG16 -> convert_torchscript: LPIPS taps on the card vs the script "
        f"module's, max err / max |script| " + ", ".join(f"{t} {e:.2e}" for t, e in
                                                       vgg_errs.items()) + f" (bound {CONVERT_TOL})")
    rec["vgg16_torchscript"] = dict(rel_err=vgg_errs, bound=CONVERT_TOL,
                                    has_lin=sorted(params.get("lin", {})) == sorted(vgg.LPIPS_TAPS))
    del mod, taps, acts
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_sustained(torch, counters, dev):
    """scripts/torch_sustained_train.py at the JAX run's operating point:
    the phantom dataset at 256x256, batch 32, SUSTAINED_KIMG kimg, R1 over
    the whole batch; the dynamics check must pass. Its log.jsonl,
    summary.json and dynamics.png go to chiprun_out/."""
    from scripts import torch_check_train_run, torch_sustained_train

    log(f"phase 14: sustained training, {RES}x{RES}, batch {BATCH}, {SUSTAINED_KIMG} kimg")
    art = os.path.join(REPO, "chiprun_out", "torch_sustained_train_h100")
    shutil.rmtree(art, ignore_errors=True)
    reset_counters(counters)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    summary = torch_sustained_train.main(["--kimg", str(SUSTAINED_KIMG), "--res", str(RES),
                                          "--artifacts", art, "--device", str(dev)])
    torch.cuda.synchronize()
    seconds = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    launches, variants = read_counters(counters, "sustained training",
                                       ["bias_act_fwd", "bias_act_bwd", "bias_act_bwd2",
                                        "upfirdn2d"])
    rows = torch_check_train_run.load_log(art)
    # The log's `sec` runs from the loop's start: set-up (the phantom zip,
    # the networks) is outside it. Steady state: after the first row.
    images_s = rows[-1]["kimg"] * 1e3 / rows[-1]["sec"]
    steady_s = (rows[-1]["kimg"] - rows[0]["kimg"]) * 1e3 / (rows[-1]["sec"] - rows[0]["sec"])
    rec = dict(summary=summary, seconds=seconds, loop_seconds=rows[-1]["sec"],
               images_per_s=images_s, steady_images_per_s=steady_s, peak_mem_bytes=peak,
               launches=launches, variant_launches=variants, kimg=SUSTAINED_KIMG,
               rows=len(rows))
    log(f"  check_rows passed: {json.dumps(summary)}")
    log(f"  {seconds:.1f} s in all, loop {rows[-1]['sec']:.1f} s: {images_s:.2f} images/s "
        f"({steady_s:.2f} after the first log row), peak memory {peak / 2**30:.2f} GiB; "
        f"launches {launches}, by variant {variants}")
    return rec


def _node_counts(program):
    """Calls of the kernels' custom ops in an exported program's graph."""
    counts = {}
    for n in program.graph.nodes:
        name = str(n.target)
        if n.op == "call_function" and name.startswith("latentaugment_torch."):
            key = name.split(".")[1]
            counts[key] = counts.get(key, 0) + 1
    return counts


def _launches_of(torch, counters, fn):
    """(fn's result, the kernels' launches it made) under no_grad."""
    reset_counters(counters)
    with torch.no_grad():
        out = fn()
    torch.cuda.synchronize()
    return out, {k: v for c in counters for k, v in c.items()}


def phase_export(torch, np, counters, slice_rec, sg3_rec, dev):
    """scripts/torch_export_model.py and examples/torch_serve_generator.py
    on the card: phase 3's operating-point G exported with a symbolic
    batch, saved and loaded, its graph's custom ops counted, the loaded
    program at batch 32 against the eager G through the kernels (bf16,
    TOL) with the same launches per forward; a float32 export against the
    eager G with impl='ref' (CONVERT_TOL); the program served on port 0 at
    n = SERVE_NS, images/s beside the eager G's; phase 4's SG3-T G exported
    at batch SG3_EXPORT_BATCH against its eager forward."""
    import base64
    import io
    import threading
    import urllib.request

    from examples.torch_serve_generator import serve
    from latentaugment_tpu_torch.models import networks_for
    from latentaugment_tpu_torch.models.stylegan2 import checkpoint, networks
    from scripts.torch_export_model import GeneratorProgram, build_export, input_shapes

    log("phase 15: export and serving")
    root = os.path.join(REPO, "build", "chip_smoke_export")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    argv = slice_rec["argv"]
    ckpt = argv[argv.index("--model_dir") + 1]
    t0 = time.time()
    ep = build_export(ckpt, device=str(dev))
    export_s = time.time() - t0
    path = os.path.join(root, "g.pt2")
    t0 = time.time()
    torch.export.save(ep, path)
    program = torch.export.load(path)
    save_load_s = time.time() - t0
    nodes = _node_counts(program)
    for k in ("bias_act_fwd", "upfirdn2d"):
        if nodes.get(k, 0) <= 0:
            raise AssertionError(f"exported G: no {k} op in the graph: {nodes}")
    shapes = input_shapes(program)
    if len(shapes) != 1 or isinstance(shapes[0][0], int):
        raise AssertionError(f"exported G: inputs {shapes}, expected one with a symbolic batch")

    def eager_generator(path):
        """The checkpoint's G with its own config, as the export builds it."""
        params, cfg, _, _ = checkpoint.load_stylegan(path)
        G = networks_for(cfg).Generator(cfg)
        G.load_state_dict(checkpoint.params_to_state_dict(params))
        return params, cfg, GeneratorProgram(G, 1.0).to(dev).eval().requires_grad_(False)

    g_params, g_cfg, eager = eager_generator(ckpt)
    gen = torch.Generator(device=dev).manual_seed(41)
    z = torch.randn([BATCH, g_cfg.z_dim], generator=gen, device=dev)
    module = program.module()
    img_e, launches_e = _launches_of(torch, counters, lambda: eager(z))
    img_p, launches_p = _launches_of(torch, counters, lambda: module(z))
    if launches_p != launches_e or launches_p["bias_act_fwd"] <= 0 or launches_p["upfirdn2d"] <= 0:
        raise AssertionError(f"exported G: launches per forward {launches_p}, eager {launches_e}")
    err = rel_close(img_p, img_e, TOL["bfloat16"], "exported G (bf16 top blocks) vs eager G")
    ms_p = median_ms(lambda: module(z), n=10)
    ms_e = median_ms(lambda: eager(z), n=10)

    # Float32: the export through the kernels against the eager G's plain versions.
    g32 = networks.generator_config(**dict({k: g_cfg[k] for k in checkpoint._G_CFG_KEYS},
                                           num_fp16_res=0))
    ckpt32 = os.path.join(root, "g32.pkl")
    G32 = networks.Generator(g32)
    G32.load_state_dict(checkpoint.params_to_state_dict(g_params))
    checkpoint.save_checkpoint(ckpt32, G32)
    ep32 = build_export(ckpt32, device=str(dev))
    networks.set_impl(G32, "ref")
    eager32 = GeneratorProgram(G32, 1.0).to(dev).eval().requires_grad_(False)
    with torch.no_grad():
        err32 = rel_close(ep32.module()(z), eager32(z), CONVERT_TOL,
                          "exported G (float32, kernels) vs eager G (plain)")
    del ep32, eager32, G32

    # Served on port 0: each n once to warm its bucket, then timed.
    service, httpd = serve(path, port=0, device=str(dev))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/generate"

    def http_generate(n, seed):
        req = urllib.request.Request(url, data=json.dumps(dict(n=n, seed=seed)).encode(),
                                     headers={"Content-Type": "application/json"})
        resp = json.loads(urllib.request.urlopen(req, timeout=300).read())
        return np.load(io.BytesIO(base64.b64decode(resp["images_b64"])))

    served = {}
    try:
        for n in SERVE_NS:
            imgs = http_generate(n, 7)
            if imgs.shape != (n, g_cfg.img_channels, RES, RES) or not np.isfinite(imgs).all():
                raise AssertionError(f"served n={n}: {imgs.shape}")
            times_http, times_direct = [], []
            for rep in range(SERVE_REPS):
                t0 = time.time()
                http_generate(n, rep)
                times_http.append(time.time() - t0)
                t0 = time.time()
                service.generate(n, seed=rep)
                times_direct.append(time.time() - t0)
            served[n] = dict(http_s=statistics.median(times_http),
                             direct_s=statistics.median(times_direct))
            served[n].update(http_images_per_s=n / served[n]["http_s"],
                             direct_images_per_s=n / served[n]["direct_s"])
        # One seed's z is the JAX example's: RandomState(7); the served
        # images are the eager G's on it, and a chunked request's first 32
        # are the 32-image request's.
        z7 = torch.from_numpy(np.random.RandomState(7).randn(33, g_cfg.z_dim)
                              .astype(np.float32)).to(dev)
        with torch.no_grad():
            want = eager(z7[:32]).cpu()
        got33 = torch.from_numpy(service.generate(33, seed=7))
        serve_err = rel_close(got33[:32], want, TOL["bfloat16"], "served n=33 (chunked) vs eager G")
        if not torch.isfinite(got33[32]).all():
            raise AssertionError("served n=33: the chunked 33rd image is not finite")
    finally:
        httpd.shutdown()
        httpd.server_close()
    eager_ips = BATCH / (ms_e / 1e3)
    log(f"  G export {export_s:.1f} s, save + load {save_load_s:.1f} s "
        f"({os.path.getsize(path) / 1e6:.1f} MB), inputs {shapes}; custom-op nodes {nodes}")
    log(f"  loaded program at batch {BATCH} vs eager G (bf16): {err:.2e} (<= {TOL['bfloat16']}); "
        f"float32 export vs eager plain: {err32:.2e} (<= {CONVERT_TOL}); launches per forward "
        f"{launches_p} = eager's; {ms_p:.2f} ms per forward ({BATCH / (ms_p / 1e3):.1f} images/s) "
        f"beside the eager G's {ms_e:.2f} ms ({eager_ips:.1f} images/s)")
    for n, r in served.items():
        log(f"  served n={n}: HTTP {r['http_s'] * 1e3:.1f} ms ({r['http_images_per_s']:.1f} "
            f"images/s), in-process generate {r['direct_s'] * 1e3:.1f} ms "
            f"({r['direct_images_per_s']:.1f} images/s)")
    log(f"  served n=33 (chunked 32 + 1) vs eager G on RandomState(7): {serve_err:.2e}")
    del program, module, eager, ep
    gc.collect()
    torch.cuda.empty_cache()

    # The alias-free G (phase 4's SG3-T checkpoint) at a concrete batch.
    argv3 = sg3_rec["argv"]
    ckpt3 = argv3[argv3.index("--model_dir") + 1]
    t0 = time.time()
    ep3 = build_export(ckpt3, batch=SG3_EXPORT_BATCH, device=str(dev))
    export3_s = time.time() - t0
    path3 = os.path.join(root, "g3.pt2")
    torch.export.save(ep3, path3)
    program3 = torch.export.load(path3)
    nodes3 = _node_counts(program3)
    if nodes3.get("filtered_lrelu_fwd", 0) <= 0:
        raise AssertionError(f"exported SG3-T G: no filtered_lrelu op: {nodes3}")
    _, c3, eager3 = eager_generator(ckpt3)
    z3 = torch.randn([SG3_EXPORT_BATCH, c3.z_dim], generator=gen, device=dev)
    img3_e, launches3_e = _launches_of(torch, counters, lambda: eager3(z3))
    img3_p, launches3_p = _launches_of(torch, counters, lambda: program3.module()(z3))
    if launches3_p != launches3_e or launches3_p["filtered_lrelu_fwd"] <= 0:
        raise AssertionError(f"exported SG3-T G: launches {launches3_p}, eager {launches3_e}")
    err3 = rel_close(img3_p, img3_e, TOL["bfloat16"], "exported SG3-T G vs eager")
    log(f"  SG3-T G exported at batch {SG3_EXPORT_BATCH} in {export3_s:.1f} s: custom-op nodes "
        f"{nodes3}; vs eager {err3:.2e}; launches per forward {launches3_p} = eager's")
    shutil.rmtree(root, ignore_errors=True)
    del program3, eager3, ep3
    gc.collect()
    torch.cuda.empty_cache()
    return dict(export_s=export_s, save_load_s=save_load_s, nodes=nodes, inputs=str(shapes),
                launches=launches_p, eager_launches=launches_e, rel_err=err, rel_err_f32=err32,
                program_ms=ms_p, eager_ms=ms_e, eager_images_per_s=eager_ips,
                served={str(n): r for n, r in served.items()}, served_rel_err=serve_err,
                stylegan3=dict(batch=SG3_EXPORT_BATCH, export_s=export3_s, nodes=nodes3,
                               launches=launches3_p, rel_err=err3))


def phase_pix2pix(torch, np, counters, slice_rec, dev):
    """examples/torch_train_pix2pix.py on phase 3's workspace at the
    operating point (batch 32, K=10, 256x256): PIX2PIX_STEPS steps, each
    one policy walk and one pix2pix step; the walk's launches per batch
    must be phase 3's."""
    from examples.torch_train_pix2pix import main as pix2pix_main

    log(f"phase 16: pix2pix on augmented batches, {PIX2PIX_STEPS} steps at batch {BATCH}")
    reset_counters(counters)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    nets, history = pix2pix_main(slice_rec["argv"] + [
        "--device", str(dev), "--pix2pix_steps", str(PIX2PIX_STEPS), "--name", "pix2pix_chip"])
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = {k: v for c in counters for k, v in c.items()}
    per_batch = {k: v * N_BATCHES for k, v in launches.items()}
    want = {k: slice_rec["launches"].get(k, 0) * PIX2PIX_STEPS for k in launches}
    if per_batch != want:
        raise AssertionError(f"pix2pix: launches over {PIX2PIX_STEPS} walks {launches}, phase 3's "
                             f"{slice_rec['launches']} over {N_BATCHES}")
    for h in history:
        if not all(math.isfinite(h[k]) for k in ("loss_G", "loss_D", "loss_L1")):
            raise AssertionError(f"pix2pix: a loss is not finite: {h}")
    if not all(torch.isfinite(p).all() for p in nets.parameters()):
        raise AssertionError("pix2pix: a parameter is not finite")
    walk_s = statistics.mean(h["walk_s"] for h in history[1:])
    step_s = statistics.mean(h["step_s"] for h in history[1:])
    rec = dict(steps=PIX2PIX_STEPS, seconds=seconds, walk_s=walk_s, step_s=step_s,
               pix2pix_share=step_s / (walk_s + step_s), launches=launches,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               first=history[0], last=history[-1])
    log(f"  {walk_s + step_s:.3f} s/step after the first: walk {walk_s:.3f} s, pix2pix step "
        f"{step_s * 1e3:.1f} ms ({100 * rec['pix2pix_share']:.1f}%); losses first {history[0]}, "
        f"last {history[-1]}; launches per walk = phase 3's; {seconds:.1f} s in all")
    return rec


def _phantom_volume(np, rng, depth, ct):
    """[depth, RES, RES] of a pelvis-like phantom: a body ellipse with an
    inner organ and bone, noise, in HU (ct) or MR units."""
    yy, xx = np.mgrid[0:RES, 0:RES].astype(np.float32) / RES - 0.5
    vol = np.empty((depth, RES, RES), np.float32)
    for d in range(depth):
        a, b = 0.42 + 0.03 * np.sin(d / 3.0), 0.30 + 0.02 * np.cos(d / 4.0)
        body = (xx / a) ** 2 + (yy / b) ** 2 < 1.0
        organ = ((xx - 0.05) / 0.12) ** 2 + ((yy + 0.02) / 0.09) ** 2 < 1.0
        bone = ((np.abs(xx) - 0.22) / 0.05) ** 2 + ((yy - 0.08) / 0.06) ** 2 < 1.0
        if ct:
            sl = np.where(body, 40.0, -1000.0) + np.where(organ, 30.0, 0.0) \
                + np.where(bone, 900.0, 0.0)
        else:
            sl = np.where(body, 300.0, 0.0) + np.where(organ, 250.0, 0.0) \
                + np.where(bone, -150.0, 0.0)
        vol[d] = sl + rng.randn(RES, RES).astype(np.float32) * (20.0 if ct else 15.0)
    return vol


def phase_tools(torch, np, counters, need, slice_rec, dev):
    """From volumes to an augmented batch: phantom .npy volumes through
    the port's dataset tool into a zip, the StyleGAN2 policy walking one
    batch of it (launches per batch = phase 3's), then the pix2pix example
    for 2 steps on a Mayo Clinic phantom set."""
    import pickle
    import zipfile

    from examples.torch_train_pix2pix import main as pix2pix_main
    from latentaugment_tpu_torch.data import create_csv_mayoclinic, dataset_tool

    log(f"phase 17: volumes -> dataset tool -> zip -> walk; pix2pix on a Mayo Clinic set")
    root = os.path.join(REPO, "build", "chip_smoke_tools")
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.RandomState(17)
    raw = os.path.join(root, "raw")
    for p in range(TOOL_PATIENTS):
        pdir = os.path.join(raw, f"patient{p + 1:03d}")
        os.makedirs(pdir)
        np.save(os.path.join(pdir, "MR_nonrigid_CT.npy"), _phantom_volume(np, rng, TOOL_DEPTH, True))
        np.save(os.path.join(pdir, "MR_MR_T2.npy"), _phantom_volume(np, rng, TOOL_DEPTH, False))
    mods = {}
    for name in ("yaml", "matplotlib", "pandas", "nibabel", "pydicom"):
        try:
            __import__(name)
            mods[name] = True
        except ImportError:
            mods[name] = False
    t0 = time.time()
    tool_zip = os.path.join(root, "tool.zip")
    interim = os.path.join(root, "interim_tool")
    _, splits = dataset_tool.prepare_pelvis_2_1(
        raw, interim, tool_zip, image_shape=(RES, RES), pop_range=TOOL_POP,
        apply_mask=True, splits=(1.0, 0.0, 0.0), seed=0)
    tool_s = time.time() - t0
    with zipfile.ZipFile(tool_zip) as zf:
        names = sorted(zf.namelist())
        first = pickle.loads(zf.read(names[0]))
    n_slices = TOOL_PATIENTS * (TOOL_DEPTH - 2 * TOOL_POP)
    if len(names) != n_slices or sorted(first) != ["MR_MR_T2", "MR_nonrigid_CT"] \
            or first["MR_nonrigid_CT"].shape != (RES, RES):
        raise AssertionError(f"dataset tool: {len(names)} members (want {n_slices}), "
                             f"first {names[0]}: {sorted(first)}")
    sanity = os.path.isdir(os.path.join(interim, "pickles", "sanity_check"))
    log(f"  prepare_pelvis_2_1: {TOOL_PATIENTS} patients x 2 modalities x {TOOL_DEPTH} slices "
        f"of {RES}x{RES} -> {len(names)} members in {tool_s:.1f} s; sanity pictures written: "
        f"{sanity}; modules on this host: {mods}")

    # The policy's workspace around the tool's zip: phase 3's checkpoint,
    # an inversion zip of seeded codes under the tool's member names.
    from latentaugment_tpu_torch.models.stylegan2 import checkpoint

    ckpt = slice_rec["argv"][slice_rec["argv"].index("--model_dir") + 1]
    g_cfg = checkpoint.load_stylegan(ckpt)[1]
    ws = os.path.join(root, "interim", "ToolBench")
    os.makedirs(ws)
    shutil.copy(tool_zip, os.path.join(ws, "ToolBench-images.zip"))
    with zipfile.ZipFile(os.path.join(ws, "ToolBench-inv.zip"), "w") as zf:
        for name in names:
            w = rng.randn(g_cfg.num_ws, g_cfg.w_dim).astype(np.float32) * 0.1
            zf.writestr(name, pickle.dumps(w))
    over = {"--dataroot": tool_zip, "--interim_dir": os.path.join(root, "interim"),
            "--dataset_aug": "ToolBench", "--dataset_name_aug": "ToolBench-images",
            "--dataset_w_name": "ToolBench-inv", "--checkpoints_dir": os.path.join(root, "ck"),
            "--model_dir": ckpt, "--device": str(dev),
            # Every slice into the manifolds (the tool numbers slices from 0).
            "--step_img": "1", "--step_w": "1"}
    argv = list(slice_rec["argv"])
    for k, v in over.items():
        if k in argv:
            argv[argv.index(k) + 1] = v
        else:
            argv += [k, v]
    batches, launches, setup_s, peak = run_policy(torch, argv, counters, n_batches=1)
    check_batches(torch, np, batches, BATCH, "tool zip walk", n_batches=1)
    launches, variants = read_counters(counters, "tool zip walk", need)
    if {k: v * N_BATCHES for k, v in launches.items()} != slice_rec["launches"]:
        raise AssertionError(f"tool zip walk: launches per batch {launches}, phase 3's "
                             f"{slice_rec['launches']} over {N_BATCHES} batches")
    log(f"  the policy over the tool's zip: batch {BATCH} in {batches[0]['wall']:.3f} s "
        f"(first batch), set-up {setup_s:.1f} s, launches per batch = phase 3's {launches}")

    # pix2pix on a Mayo Clinic phantom set (HD / LD .npy slices in HU):
    # the example's baseline without augmentation, as the policies pair A
    # and B from one slice file and these are two.
    mayo = os.path.join(root, "mayo")
    for p in range(2):
        for dom, noise in (("full_dose_HD", 10.0), ("quarter_dose_LD", 40.0)):
            d = os.path.join(mayo, f"L{p:03d}", dom)
            os.makedirs(d)
            vol = _phantom_volume(np, np.random.RandomState(100 + p), 4, True)
            for s in range(4):
                np.save(os.path.join(d, f"slice_{s:03d}.npy"),
                        vol[s] + rng.randn(RES, RES).astype(np.float32) * noise)
    csv = create_csv_mayoclinic.create_annotation_file(mayo, os.path.join(root, "csv"),
                                                       train=1.0, val=0.0, test=0.0)["train"]
    reset_counters(counters)
    t0 = time.time()
    nets, history = pix2pix_main(argv + [
        "--no_augment", "--dataroot", csv, "--dataset_mode", "mayoclinic", "--img_shape",
        str(RES), "--batch_size", "4", "--pix2pix_steps", "2", "--name", "pix2pix_mayo"])
    torch.cuda.synchronize()
    mayo_s = time.time() - t0
    mayo_launches = {k: v for c in counters for k, v in c.items()}
    for h in history:
        if not all(math.isfinite(h[k]) for k in ("loss_G", "loss_D", "loss_L1")):
            raise AssertionError(f"pix2pix on the Mayo Clinic set: a loss is not finite: {h}")
    log(f"  pix2pix on the Mayo Clinic set (2 patients x 4 slice pairs, batch 4, no "
        f"augmentation): 2 steps in {mayo_s:.1f} s, losses {history[-1]}")
    return dict(tool_seconds=tool_s, n_members=len(names), sanity_pictures=sanity,
                modules=mods, launches=launches, variant_launches=variants,
                first_batch_wall_s=batches[0]["wall"], setup_s=setup_s, peak_mem_bytes=peak,
                mayo=dict(seconds=mayo_s, history=history, launches=mayo_launches))


def _probe_gloo_cuda(torch, dist, dev):
    """Which collectives a gloo group runs on CUDA tensors in this torch."""
    out = {}
    probes = {
        "all_reduce": lambda t: dist.all_reduce(t),
        "broadcast": lambda t: dist.broadcast(t, 0),
        "all_gather": lambda t: dist.all_gather([torch.empty_like(t) for _ in range(2)], t),
        "all_gather_into_tensor": lambda t: dist.all_gather_into_tensor(
            torch.empty(2 * t.numel(), device=t.device), t),
        "reduce_scatter_tensor": lambda t: dist.reduce_scatter_tensor(
            torch.empty(t.numel() // 2, device=t.device), t),
    }
    for name, fn in probes.items():
        try:
            fn(torch.ones(8, device=dev))
            torch.cuda.synchronize()
            out[name] = "ok"
        except (RuntimeError, ValueError) as e:
            out[name] = str(e).splitlines()[0][:160]
        dist.barrier()
    return out


def _dp_rank(rank, port, task_path):
    """One rank of phase 18 (two ranks on cuda:0 under gloo): the probe,
    the walk, the trainer, the projector and FID / PR at full width, each
    beside its 1-process run on rank 0. Writes rank<r>.json."""
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    import torch.distributed as dist

    import random

    from latentaugment_tpu_torch.augments import create_augment, manifold
    from latentaugment_tpu_torch.data import create_dataset
    from latentaugment_tpu_torch.metrics import frechet_inception_distance as fid_mod
    from latentaugment_tpu_torch.metrics import metric_utils, precision_recall
    from latentaugment_tpu_torch.models.stylegan2 import checkpoint, networks, train
    from latentaugment_tpu_torch.ops import bias_act as ba
    from latentaugment_tpu_torch.ops import upfirdn2d as up
    from latentaugment_tpu_torch.options import AugOptions
    from latentaugment_tpu_torch.parallel import mesh as pmesh
    from latentaugment_tpu_torch.utils.util_misc import check_replica_consistency
    from scripts.torch_project_dataset import main as project_main

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(task_path) as f:
        task = json.load(f)
    globals().update(task["sizes"])  # the parent's sizes (smaller in a CPU rehearsal)
    dev = torch.device(task["device"])
    cuda = dev.type == "cuda"
    pmesh.init_distributed(f"localhost:{port}", 2, rank, backend="gloo")
    mesh = pmesh.get_mesh(2, devices=str(dev))
    counters = (ba.launches, up.launches)
    VARIANT_COUNTERS.update(upfirdn2d=up.variant_launches)
    first = rank == 0
    rec = {"rank": rank, "gloo_cuda": _probe_gloo_cuda(torch, dist, dev) if cuda else None}

    def launches_of(label, need):
        return read_counters(counters, label, need)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def peak_reset():
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

    def peak():
        return torch.cuda.max_memory_allocated() if cuda else 0

    def free():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    # --- the walk: the policy with --n_mesh_devices 2 for 2 batches.
    argv = task["argv"] + ["--n_mesh_devices", "2", "--device", str(dev)]
    opt = AugOptions().parse(argv=argv, install_logger=False)
    augment = create_augment(opt)
    eng = augment.latent_aug
    walls = []
    batches = []
    reset_counters(counters)
    peak_reset()
    for data in create_dataset(opt):
        t0 = time.time()
        augment.set_input(data)
        augment.forward()
        out = augment.get_output()
        sync()
        walls.append(time.time() - t0)
        batches.append((augment.get_latent_input()["w"], augment.get_latent_output()["w"], out))
        if len(batches) == 2:
            break
    launches, variants = launches_of("data-parallel walk", task["walk_need"])
    per_batch = {k: v // 2 for k, v in launches.items()}
    rec["walk"] = dict(walls=walls, samples_per_s=BATCH / walls[1], launches=launches,
                       variant_launches=variants, peak_mem_bytes=peak(),
                       launches_per_batch_equal_phase3=all(
                           per_batch.get(k, 0) * N_BATCHES == v
                           for k, v in task["walk_launches"].items()))
    for _, _, o in batches:
        if o["A"].shape != (BATCH, 1, RES, RES) or not np.isfinite(o["A"]).all():
            raise AssertionError(f"rank {rank}: data-parallel walk output {o['A'].shape}")

    # Step 0 of the walk (float32, TF32 off): loss and gradient at w,
    # 2 ranks against 1 process; then the walked w of the operating point.
    fns, bundle = eng._fns, eng._bundle
    w = torch.as_tensor(batches[0][0][:, None, :], device=dev)
    crop = manifold.get_params(eng.res, eng.crop_size, eng.preprocess,
                               rng=random.Random(18))["crop_pos"]
    G, D = bundle["G"], bundle["D"]
    n16 = G.cfg.num_fp16_res
    G.cfg.num_fp16_res = D.cfg.num_fp16_res = 0
    rows = pmesh.shard_rows(BATCH, mesh, D.cfg.mbstd_group_size)
    with torch.enable_grad(), cudnn_deterministic(torch):
        wl = rows.take(w).requires_grad_(True)
        total, _ = fns.loss_fn(bundle, wl, crop, None, rows)
        g, = torch.autograd.grad(total, wl)
    loss_dp, grad_dp = rows.sum(total.detach()), rows.gather(g)
    step0 = None
    if first:
        def one_process(w_at):
            with torch.enable_grad(), cudnn_deterministic(torch):
                wf = w_at.clone().requires_grad_(True)
                total1, _ = fns.loss_fn(bundle, wf, crop)
                return total1.item(), torch.autograd.grad(total1, wf)[0]

        loss1, g1 = one_process(w)
        # The one-process gradient's own spread: w moved by one float32 step.
        _, g1n = one_process(torch.nextafter(w, torch.full_like(w, math.inf)))
        scale = g1.abs().max()
        step0 = dict(loss_2rank=loss_dp.item(), loss_1proc=loss1,
                     grad_err_of_max=((grad_dp - g1).abs().max() / scale).item(),
                     grad_spread_one_step=((g1n - g1).abs().max() / scale).item())
    G.cfg.num_fp16_res = D.cfg.num_fp16_res = n16
    gen = torch.Generator(device=dev).manual_seed(3)
    img_dp, ws_dp, _ = fns.walk(bundle, rows.take(w), crop, gen, None, rows)
    ws_dp = rows.gather(ws_dp)
    walked = None
    if first:
        gen = torch.Generator(device=dev).manual_seed(3)
        _, ws1, _ = fns.walk(bundle, w, crop, gen)
        diff = (ws_dp - ws1).abs()
        walked = dict(w_max_diff=diff.max().item(), w_share_above_1e3=(diff > 1e-3).float()
                      .mean().item())
    rec["walk"].update(step0=step0, walked=walked)
    del augment, eng, fns, bundle, G, D
    free()
    dist.barrier()

    # --- the trainer at phase 9's widths: step 0 in float32 (const noise,
    # no mixing, no ADA), every phase's loss and gradient, 2 ranks against
    # 1 process; then each phase once in the cell's bf16 configuration with
    # every random draw on, replicas held bit-equal after each step.
    net = dict(img_resolution=RES, img_channels=2, conv_clamp=256, **WIDTHS)
    g32 = networks.generator_config(num_mapping_layers=2, num_fp16_res=0, **net)
    d32 = networks.discriminator_config(num_fp16_res=0, **net)
    cfg0 = dict(batch_size=BATCH, style_mixing_prob=0.0, noise_mode="const", aug="noaug")
    gz = torch.Generator(device=dev).manual_seed(31)
    z = torch.randn([BATCH, g32.z_dim], generator=gz, device=dev)
    real = torch.rand([BATCH, 2, RES, RES], generator=gz, device=dev) * 2 - 1
    pl_b = BATCH // 2
    pl_noise = torch.randn([pl_b, 2, RES, RES], generator=gz, device=dev) / RES
    pl_mean = torch.tensor(0.5, device=dev)

    @cudnn_deterministic(torch)
    def phase_values(fns, state, m, z=z, real=real):
        gen = torch.Generator(device=dev).manual_seed(1)
        r = None if m is None else pmesh.shard_rows(BATCH, m, state.D.cfg.mbstd_group_size)
        rp = None if m is None else pmesh.shard_rows(pl_b, m)
        tk = (lambda rr, x: x) if m is None else (lambda rr, x: rr.take(x))
        vals = {}
        for phase in ("Gmain", "Gpl", "Dmain", "Dr1"):
            if phase == "Gmain":
                module, rr = state.G, r
                loss = fns.loss_g_main(state.G, state.D, tk(r, z), tk(r, z), None, gen, 0.0, r)[0]
            elif phase == "Gpl":
                module, rr = state.G, rp
                loss = fns.loss_g_pl(state.G, pl_mean, tk(rp, z[:pl_b]), tk(rp, z[:pl_b]), None,
                                     gen, pl_noise=tk(rp, pl_noise), rows=rp)[0]
            elif phase == "Dmain":
                module, rr = state.D, r
                loss = fns.loss_d_main(state.D, state.G, tk(r, real), tk(r, z), tk(r, z), None,
                                       gen, 0.0, r)[0]
            else:
                module, rr = state.D, r
                loss = fns.loss_d_r1(state.D, tk(r, real), None, r)[0]
            grads = fns.grads(loss, module, rr)
            total = loss.detach() if rr is None else rr.sum(loss.detach())
            vals[phase] = (total.item(), torch.cat([gg.reshape(-1) for gg in grads]))
            del loss, grads
        return vals

    fns_dp = train.make_train_fns(g32, d32, train.train_config(**cfg0), device=dev, mesh=mesh)
    state = fns_dp.init_state(seed=0)
    dp_vals = phase_values(fns_dp, state, mesh)
    train_step0 = None
    if first:
        fns1 = train.make_train_fns(g32, d32, train.train_config(**cfg0), device=dev)
        one = phase_values(fns1, state, None)
        # The one-process gradients' own spread: z and the images moved by
        # one float32 step.
        nudged = phase_values(fns1, state, None,
                              z=torch.nextafter(z, torch.full_like(z, math.inf)),
                              real=torch.nextafter(real, torch.full_like(real, math.inf)))
        train_step0 = {p: dict(loss_2rank=dp_vals[p][0], loss_1proc=one[p][0],
                               grad_err_of_max=((dp_vals[p][1] - one[p][1]).abs().max()
                                                / one[p][1].abs().max()).item(),
                               grad_spread_one_step=((nudged[p][1] - one[p][1]).abs().max()
                                                     / one[p][1].abs().max()).item())
                       for p in dp_vals}
        del one, nudged
    del dp_vals, state, fns_dp
    free()
    dist.barrier()

    g16 = networks.generator_config(num_mapping_layers=2, num_fp16_res=4, **net)
    d16 = networks.discriminator_config(num_fp16_res=4, **net)
    fns = train.make_train_fns(g16, d16, train.train_config(
        batch_size=BATCH, aug="fixed", aug_p=0.2, noise_mode="random",
        style_mixing_prob=0.9), device=dev, mesh=mesh)
    state = fns.init_state(seed=0)
    for name in ("G", "D", "G_ema"):
        pmesh.broadcast_module(state[name], mesh)
    gen = torch.Generator(device=dev).manual_seed(7)
    p = torch.tensor(0.2, device=dev)
    reset_counters(counters)
    peak_reset()
    step_s = {}
    for step, phase in enumerate(("Gmain", "Gpl", "Dmain", "Dr1") * 2):
        t0 = time.time()
        if phase == "Gmain":
            state, _ = fns.g_main(state, z, z, None, gen, p)
        elif phase == "Gpl":
            state, _ = fns.g_reg(state, z[:pl_b], z[:pl_b], None, gen, p)
        elif phase == "Dmain":
            state, _ = fns.d_main(state, real, z, z, None, gen, p)
        else:
            state, _ = fns.d_reg(state, real, None, gen, p)
        state = fns.ema(state, 0.99)
        sync()
        if step >= 4:  # the second round, warm
            step_s[phase] = time.time() - t0
        for name in ("G", "D", "G_ema"):
            check_replica_consistency(state[name], mesh)  # raises on any differing bit
    t_launches, _ = launches_of("data-parallel trainer", task["train_need"])
    rec["train"] = dict(step0=train_step0, phase_s=step_s,
                        images_per_s_per_phase={k: BATCH / v for k, v in step_s.items()},
                        launches=t_launches, peak_mem_bytes=peak(), replicas_bit_equal=True)
    del state, fns
    free()
    dist.barrier()

    # --- the projector's command line with --n_devices 2 (float32), beside
    # its 1-process run on rank 0 (step-0 distance).
    common = ["--checkpoint", task["ckpt"], "--data_zip", task["data_zip"], "--resolution",
              str(RES), "--num_steps", str(DP_PROJ_STEPS), "--batch_size", str(PROJ_BATCH),
              "--max_items", str(PROJ_BATCH), "--w_avg_samples", "2000", "--num_fp16_res", "0",
              "--device", str(dev)]
    reset_counters(counters)
    peak_reset()
    t0 = time.time()
    recs = project_main(common + ["--n_devices", "2", "--outdir",
                                  os.path.join(task["root"], "proj_dp")])
    proj_s = time.time() - t0
    p_launches, _ = launches_of("data-parallel projector", task["walk_need"])
    proj = dict(seconds=proj_s, batch_s=recs[0]["seconds"],
                slices_per_s=PROJ_BATCH / recs[0]["seconds"], launches=p_launches,
                peak_mem_bytes=peak(), dists=recs[0]["dists"])
    if first:
        one = project_main(common + ["--outdir", os.path.join(task["root"], "proj_1")])
        proj.update(dists_1proc=one[0]["dists"])
    rec["projector"] = proj
    dist.barrier()

    # --- FID and PR of the live generator (float32) over phase 3's
    # slices, 2 ranks against 1 process.
    g_params, g_cfg, _, _ = checkpoint.load_stylegan(task["ckpt"])
    g_cfg.num_fp16_res = 0
    Gm = networks.Generator(g_cfg)
    Gm.load_state_dict(checkpoint.params_to_state_dict(g_params))
    Gm = Gm.to(dev).eval().requires_grad_(False)

    def metrics(m):
        opts = metric_utils.MetricOptions(
            G=Gm, G_kwargs=dict(seed=0), cache=False, device=dev, mesh=m,
            dataset_kwargs=dict(path=task["data_zip"], split="train",
                                modalities=["MR_nonrigid_CT", "MR_MR_T2"], resolution=RES),
            mode_dict=dict(mode_name="MR_nonrigid_CT", mode_idx=0))
        t0 = time.time()
        fid = fid_mod.compute_fid(opts, max_real=None, num_gen=DP_N_GEN)
        pr = precision_recall.compute_pr(opts, max_real=200000, num_gen=DP_N_GEN, nhood_size=3,
                                         row_batch_size=10000, col_batch_size=10000)
        return dict(fid=fid, precision=pr[0], recall=pr[1], seconds=time.time() - t0)

    reset_counters(counters)
    rec["metrics"] = metrics(mesh)
    rec["metrics"]["launches"] = launches_of("data-parallel metrics",
                                             [k for k in task["walk_need"] if k != "bias_act_bwd"])[0]
    if first:
        rec["metrics"]["one_process"] = metrics(None)
    dist.barrier()
    with open(os.path.join(task["root"], f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()


def phase_dp(torch, np, counters, need, slice_rec, dev):
    """Data parallelism on one card: NCCL at world size 1, the walk
    bit-equal to the one-process walk under deterministic cuDNN; then two
    ranks on cuda:0 under gloo (a check, not a deployment) for the walk,
    the trainer, the projector and FID / PR at full width."""
    import multiprocessing

    import torch.distributed as dist

    from latentaugment_tpu_torch.augments import engine
    from latentaugment_tpu_torch.options import AugOptions
    from latentaugment_tpu_torch.parallel import mesh as pmesh

    log("phase 18: data parallelism on one card (NCCL at world size 1; 2 ranks under gloo)")
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # the ranks share this card with this process
    root = os.path.join(REPO, "build", "chip_smoke_dp")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    argv = slice_rec["argv"]
    opt = AugOptions().parse(argv=argv + ["--device", str(dev)], install_logger=False)
    w = np.random.RandomState(18).randn(BATCH, 1, 512).astype(np.float32) * 0.1

    pmesh.init_distributed(f"localhost:{pmesh.free_port()}", 1, 0,
                           backend=pmesh.backend_for(dev))
    det = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        outs = {}
        for label, m in (("one process", None), ("NCCL world 1", pmesh.get_mesh(1, devices=str(dev)))):
            eng = engine.LatentAugEngine("train", opt, root, dev, mesh=m)
            reset_counters(counters)
            img, ws = eng.forward(w)
            outs[label] = (img.cpu(), ws.cpu(), read_counters(counters, label, need)[0])
            del eng
        nccl_equal = all(torch.equal(a, b) for a, b in zip(outs["one process"][:2],
                                                             outs["NCCL world 1"][:2]))
        if not nccl_equal or outs["one process"][2] != outs["NCCL world 1"][2]:
            raise AssertionError("NCCL at world size 1: the walk is not bit-equal to the "
                                 "one-process walk under deterministic cuDNN")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = det
        dist.destroy_process_group()
    log(f"  NCCL at world size 1: image and w bit-equal to the one-process walk, launches "
        f"{outs['NCCL world 1'][2]}")
    del outs
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    opt_map = dict(zip(argv[::2], argv[1::2]))
    task = dict(root=root, argv=argv, ckpt=opt_map["--model_dir"], data_zip=opt_map["--dataroot"],
                device=str(dev), walk_need=need, walk_launches=slice_rec["launches"],
                train_need=[*need, "bias_act_bwd2"] if need else [],
                sizes=dict(RES=RES, BATCH=BATCH, N_BATCHES=N_BATCHES, PROJ_BATCH=PROJ_BATCH,
                           WIDTHS=WIDTHS, DP_PROJ_STEPS=DP_PROJ_STEPS, DP_N_GEN=DP_N_GEN))
    task_path = os.path.join(root, "task.json")
    with open(task_path, "w") as f:
        json.dump(task, f)
    ctx = multiprocessing.get_context("spawn")
    port = pmesh.free_port()
    t0 = time.time()
    procs = [ctx.Process(target=_dp_rank, args=(r, port, task_path)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=DP_TIMEOUT_S - (time.time() - t0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(30)
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"phase 18: rank exit codes {[p.exitcode for p in procs]}")
    ranks = []
    for r in range(2):
        with open(os.path.join(root, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    r0 = ranks[0]
    s0 = r0["walk"]["step0"]
    # Losses to DP_TOL. The gradients are read against their own spread
    # (the one-process gradient at inputs moved by one float32 step) and
    # held to the bounds of two correct implementations: the walk's
    # TOL_GRAD_WALK (phase 10), the trainer's TRAIN_TOL_GRAD (phase 9).
    if abs(s0["loss_2rank"] - s0["loss_1proc"]) > DP_TOL * abs(s0["loss_1proc"]) \
            or s0["grad_err_of_max"] > TOL_GRAD_WALK:
        raise AssertionError(f"data-parallel walk, step 0 (float32): {s0}")
    for phase, v in r0["train"]["step0"].items():
        if abs(v["loss_2rank"] - v["loss_1proc"]) > DP_TOL * abs(v["loss_1proc"]) \
                or v["grad_err_of_max"] > TRAIN_TOL_GRAD:
            raise AssertionError(f"data-parallel trainer, step 0 {phase} (float32): {v}")
    pr = r0["projector"]
    if abs(pr["dists"][0] - pr["dists_1proc"][0]) > DP_TOL * abs(pr["dists_1proc"][0]):
        raise AssertionError(f"data-parallel projector, step-0 distance: {pr['dists'][0]} vs "
                             f"{pr['dists_1proc'][0]}")
    mt, mt1 = r0["metrics"], r0["metrics"]["one_process"]
    if abs(mt["fid"] - mt1["fid"]) > DP_FID_TOL * abs(mt1["fid"]) \
            or abs(mt["precision"] - mt1["precision"]) > 2.0 / DP_N_GEN \
            or abs(mt["recall"] - mt1["recall"]) > 2.0 / DP_N_GEN:
        raise AssertionError(f"data-parallel metrics: {mt} vs one process {mt1}")
    for r in ranks:
        if not r["walk"]["launches_per_batch_equal_phase3"]:
            raise AssertionError(f"rank {r['rank']}: the walk's launches per batch "
                                 f"{r['walk']['launches']} (2 batches) are not phase 3's")
    for r in ranks:
        log(f"  rank {r['rank']}: walk {r['walk']['samples_per_s']:.3f} samples/s (batch {BATCH} "
            f"over 2 ranks, second batch), peak {r['walk']['peak_mem_bytes'] / 2**30:.2f} GiB, "
            f"launches over 2 batches {r['walk']['launches']}; trainer per phase "
            f"{ {k: round(v, 3) for k, v in r['train']['phase_s'].items()} } s, peak "
            f"{r['train']['peak_mem_bytes'] / 2**30:.2f} GiB, launches {r['train']['launches']}; "
            f"projector {r['projector']['slices_per_s']:.3f} slices/s, launches "
            f"{r['projector']['launches']}; metrics launches {r['metrics']['launches']}")
    log(f"  gloo on CUDA tensors: {r0['gloo_cuda']}")
    log(f"  step 0 of the walk (float32), 2 ranks vs 1 process: {s0}; walked w (bf16 top "
        f"blocks): {r0['walk']['walked']}")
    log(f"  trainer step 0 (float32): {r0['train']['step0']}; replicas bit-equal after every "
        f"step of each phase")
    log(f"  projector step-0 distance {pr['dists'][0]:.6f} vs 1 process {pr['dists_1proc'][0]:.6f}; "
        f"FID {mt['fid']:.4f} vs {mt1['fid']:.4f}, precision {mt['precision']:.4f} vs "
        f"{mt1['precision']:.4f}, recall {mt['recall']:.4f} vs {mt1['recall']:.4f} "
        f"({DP_N_GEN} generated, float32 G)")
    return dict(nccl_world1_bit_equal=nccl_equal, ranks=ranks, seconds=time.time() - t0)


def _tp_rank(rank, port, task_path):
    """One rank of phase 19 (a 1 x 2 ('data', 'model') mesh on cuda:0
    under gloo): the tensor-parallel policy walk, its step 0 in float32,
    the SG3-T G; rank 0 also runs them in one process. Writes
    rank<r>.json."""
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    import torch.distributed as dist

    import random

    from latentaugment_tpu_torch.augments import create_augment, manifold
    from latentaugment_tpu_torch.data import create_dataset
    from latentaugment_tpu_torch.models.stylegan2 import checkpoint
    from latentaugment_tpu_torch.models.stylegan3 import networks as net3
    from latentaugment_tpu_torch.ops import bias_act as ba
    from latentaugment_tpu_torch.ops import filtered_lrelu as fl
    from latentaugment_tpu_torch.ops import upfirdn2d as up
    from latentaugment_tpu_torch.options import AugOptions
    from latentaugment_tpu_torch.parallel import mesh as pmesh
    from latentaugment_tpu_torch.parallel import tensor as ptensor

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(task_path) as f:
        task = json.load(f)
    globals().update(task["sizes"])  # the parent's sizes (smaller in a CPU rehearsal)
    dev = torch.device(task["device"])
    cuda = dev.type == "cuda"
    pmesh.init_distributed(f"localhost:{port}", 2, rank, backend="gloo")
    counters = (ba.launches, up.launches, fl.launches)
    VARIANT_COUNTERS.update(upfirdn2d=up.variant_launches, filtered_lrelu=fl.variant_launches)
    first = rank == 0
    rec = {"rank": rank}

    def peak_reset():
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

    def peak():
        return torch.cuda.max_memory_allocated() if cuda else 0

    def free():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def walk_policy(extra):
        """The policy over the first 2 batches: (augment, per-batch records,
        launches, set-up s, peak memory)."""
        opt = AugOptions().parse(argv=task["argv"] + ["--device", str(dev)] + extra,
                                 install_logger=False)
        reset_counters(counters)
        peak_reset()
        t0 = time.time()
        augment = create_augment(opt)
        sync()
        setup_s = time.time() - t0
        out = []
        for data in create_dataset(opt):
            t0 = time.time()
            augment.set_input(data)
            augment.forward()
            o = augment.get_output()
            sync()
            out.append(dict(out=o, wall=time.time() - t0, w_in=augment.get_latent_input()["w"],
                            w_out=augment.get_latent_output()["w"]))
            if len(out) == 2:
                break
        return augment, out, {k: v for c in counters for k, v in c.items()}, setup_s, peak()

    # --- the policy walk on the mesh, then (rank 0) in one process.
    augment, batches, launches, setup_s, walk_peak = walk_policy(
        ["--n_mesh_devices", "2", "--n_model_devices", "2"])
    _, variants = read_counters(counters, "tensor-parallel walk", task["walk_need"])
    eng = augment.latent_aug
    mesh = eng.mesh
    if pmesh.model_axis_size(mesh) != 2 or not eng.tp_split:
        raise AssertionError(f"rank {rank}: the walk ran on {eng.mesh} splitting {eng.tp_split}")
    for i, b in enumerate(batches):
        for k in ("A", "B"):
            if b["out"][k].shape != (TP_BATCH, 1, RES, RES) or not np.isfinite(b["out"][k]).all():
                raise AssertionError(f"rank {rank}: tensor-parallel walk batch {i} {k}: "
                                     f"{b['out'][k].shape}")
    rec["walk"] = dict(walls=[b["wall"] for b in batches], setup_s=setup_s,
                       samples_per_s=TP_BATCH / batches[1]["wall"], launches=launches,
                       variant_launches=variants, peak_mem_bytes=walk_peak,
                       n_split=len(eng.tp_split))

    # Step 0 (float32, TF32 off): loss and gradient at w on the mesh.
    fns, bundle = eng._fns, eng._bundle
    G, D = bundle["G"], bundle["D"]
    split_shapes = {n: tuple(split_param(bundle, n).shape) for n in eng.tp_split}
    w = torch.as_tensor(batches[0]["w_in"][:, None, :], device=dev)
    crop = manifold.get_params(eng.res, eng.crop_size, eng.preprocess,
                               rng=random.Random(19))["crop_pos"]
    n16 = G.cfg.num_fp16_res
    G.cfg.num_fp16_res = D.cfg.num_fp16_res = 0
    rows = pmesh.shard_rows(TP_BATCH, mesh, D.cfg.mbstd_group_size)
    with torch.enable_grad(), cudnn_deterministic(torch):
        wl = rows.take(w).requires_grad_(True)
        total, _ = fns.loss_fn(bundle, wl, crop, None, rows)
        g, = torch.autograd.grad(total, wl)
    loss_tp, grad_tp = rows.sum(total.detach()).item(), rows.gather(g)
    G.cfg.num_fp16_res = D.cfg.num_fp16_res = n16
    # The slices gathered back: the one-process G and D (every rank).
    ptensor.gather_from_model(G)
    ptensor.gather_from_model(D)
    whole = dict(bundle, vgg=eng.vgg_params)
    full_shapes = {n: tuple(split_param(whole, n).shape) for n in eng.tp_split}
    halves = all(split_shapes[n] == (full_shapes[n][0] // 2, *full_shapes[n][1:])
                 and full_shapes[n][0] % 2 == 0 for n in eng.tp_split)
    rec["walk"].update(holds_half_of_every_split_weight=halves)
    dist.barrier()
    step0 = walked = one = None
    if first:
        G.cfg.num_fp16_res = D.cfg.num_fp16_res = 0

        def one_process(w_at):
            with torch.enable_grad(), cudnn_deterministic(torch):
                wf = w_at.clone().requires_grad_(True)
                total1, _ = fns.loss_fn(whole, wf, crop)
                return total1.item(), torch.autograd.grad(total1, wf)[0]

        loss1, g1 = one_process(w)
        _, g1n = one_process(torch.nextafter(w, torch.full_like(w, math.inf)))
        G.cfg.num_fp16_res = D.cfg.num_fp16_res = n16
        scale = g1.abs().max()
        step0 = dict(loss_tp=loss_tp, loss_1proc=loss1,
                     grad_err_of_max=((grad_tp - g1).abs().max() / scale).item(),
                     grad_spread_one_step=((g1n - g1).abs().max() / scale).item())
        del augment, eng, fns, bundle, whole, G, D
        free()
        augment, ref, ref_launches, _, ref_peak = walk_policy([])
        read_counters(counters, "one-process walk", task["walk_need"])
        for a, b in zip(batches, ref):
            np.testing.assert_array_equal(a["w_in"], b["w_in"])
        diff = np.abs(batches[0]["w_out"] - ref[0]["w_out"])
        walked = dict(w_max_diff=float(diff.max()), w_share_above_1e3=float((diff > 1e-3).mean()))
        one = dict(walls=[b["wall"] for b in ref], samples_per_s=TP_BATCH / ref[1]["wall"],
                   launches=ref_launches, peak_mem_bytes=ref_peak)
        del ref
    rec["walk"].update(step0=step0, walked=walked, one_process=one)
    del augment, batches
    free()
    dist.barrier()

    # --- phase 4's SG3-T G at batch 2, float32, on the mesh, then gathered
    # back into the one-process G.
    g_params, g_cfg, _, _ = checkpoint.load_stylegan(task["sg3_ckpt"])
    g_cfg.num_fp16_res = 0
    G3 = net3.Generator(g_cfg)
    G3.load_state_dict(checkpoint.params_to_state_dict(g_params))
    G3 = G3.to(dev).eval().requires_grad_(False)
    z = torch.randn([2, g_cfg.z_dim], generator=torch.Generator().manual_seed(19)).to(dev)
    split3 = ptensor.shard_for_model(G3, mesh)
    reset_counters(counters)
    with torch.no_grad():
        img_tp = G3(z)
    sync()
    l_tp, _ = read_counters(counters, "tensor-parallel SG3-T G", task["sg3_need"])
    ptensor.gather_from_model(G3)
    sg3 = dict(launches=l_tp, n_split=len(split3))
    if first:
        reset_counters(counters)
        with torch.no_grad():
            img1 = G3(z)
        sync()
        l1, _ = read_counters(counters, "one-process SG3-T G", task["sg3_need"])
        sg3.update(launches_1proc=l1, err_of_max=((img_tp - img1).abs().max()
                                                  / img1.abs().max()).item(),
                   finite=bool(torch.isfinite(img_tp).all()))
    rec["sg3"] = sg3
    dist.barrier()
    with open(os.path.join(task["root"], f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()


def split_param(bundle, name):
    """The tensor of a split name of parallel/tensor.shard_bundle ('G.x.weight',
    'vgg.conv1_1.weight') in `bundle`."""
    key, rest = name.split(".", 1)
    if key == "vgg":
        layer, leaf = rest.rsplit(".", 1)
        return bundle["vgg"][layer][leaf]
    return bundle[key].get_parameter(rest)


def phase_tp(torch, np, need, slice_rec, sg3_rec, dev):
    """Tensor parallelism on one card: two ranks on cuda:0 under gloo
    form a 1 x 2 ('data', 'model') mesh (a check, not a deployment) for
    the SG2 policy walk and the SG3-T G, each against one process."""
    import multiprocessing

    from latentaugment_tpu_torch.parallel import mesh as pmesh

    log(f"phase 19: tensor parallelism on one card (a 1 x 2 ('data', 'model') mesh, 2 ranks "
        f"under gloo, batch {TP_BATCH})")
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # the ranks share this card with this process
    root = os.path.join(REPO, "build", "chip_smoke_tp")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    argv = list(slice_rec["argv"])
    argv[argv.index("--batch_size") + 1] = str(TP_BATCH)
    sg3_argv = sg3_rec["argv"]
    task = dict(root=root, argv=argv, device=str(dev), walk_need=need,
                sg3_ckpt=sg3_argv[sg3_argv.index("--model_dir") + 1],
                sg3_need=["filtered_lrelu_fwd"] if need else [],
                sizes=dict(RES=RES, TP_BATCH=TP_BATCH, WIDTHS=WIDTHS))
    task_path = os.path.join(root, "task.json")
    with open(task_path, "w") as f:
        json.dump(task, f)
    ctx = multiprocessing.get_context("spawn")
    port = pmesh.free_port()
    t0 = time.time()
    procs = [ctx.Process(target=_tp_rank, args=(r, port, task_path)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=TP_TIMEOUT_S - (time.time() - t0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(30)
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"phase 19: rank exit codes {[p.exitcode for p in procs]}")
    ranks = []
    for r in range(2):
        with open(os.path.join(root, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    r0 = ranks[0]
    s0, one, sg3 = r0["walk"]["step0"], r0["walk"]["one_process"], r0["sg3"]
    if abs(s0["loss_tp"] - s0["loss_1proc"]) > DP_TOL * abs(s0["loss_1proc"]) \
            or s0["grad_err_of_max"] > TOL_GRAD_WALK:
        raise AssertionError(f"tensor-parallel walk, step 0 (float32): {s0}")
    if sg3["err_of_max"] > DP_TOL or not sg3["finite"]:
        raise AssertionError(f"tensor-parallel SG3-T G (float32): {sg3}")
    for r in ranks:
        if not r["walk"]["holds_half_of_every_split_weight"]:
            raise AssertionError(f"rank {r['rank']}: a split weight is not half the whole")
        for kernel in need:
            if r["walk"]["launches"][kernel] != one["launches"][kernel]:
                raise AssertionError(f"rank {r['rank']}: {kernel} launched "
                                     f"{r['walk']['launches'][kernel]} times on the mesh, "
                                     f"{one['launches'][kernel]} in one process")
        if r["sg3"]["launches"] != sg3["launches_1proc"]:
            raise AssertionError(f"rank {r['rank']}: SG3-T G launches {r['sg3']['launches']}, "
                                 f"one process {sg3['launches_1proc']}")
    for r in ranks:
        log(f"  rank {r['rank']}: walk {r['walk']['samples_per_s']:.3f} samples/s (batch "
            f"{TP_BATCH}, second batch, walls {[round(x, 3) for x in r['walk']['walls']]} s), "
            f"peak {r['walk']['peak_mem_bytes'] / 2**30:.2f} GiB, {r['walk']['n_split']} weights "
            f"split in half, launches over 2 batches {r['walk']['launches']}; SG3-T G launches "
            f"{r['sg3']['launches']} ({r['sg3']['n_split']} weights split)")
    log(f"  one process at batch {TP_BATCH}: walk {one['samples_per_s']:.3f} samples/s (walls "
        f"{[round(x, 3) for x in one['walls']]} s), peak {one['peak_mem_bytes'] / 2**30:.2f} GiB, "
        f"launches {one['launches']}")
    log(f"  step 0 of the walk (float32), 2 model ranks vs 1 process: {s0}; walked w (bf16 top "
        f"blocks): {r0['walk']['walked']}; SG3-T G (float32) err / max {sg3['err_of_max']:.3e}")
    return dict(ranks=ranks, seconds=time.time() - t0)


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
    # Phase 10's stand-ins of NVIDIA's networks (numpy and torch only).
    sys.path.insert(1, os.path.join(REPO, "tests"))
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
    t_start = t0 = time.time()
    _build.build_cuda_libraries(["upfirdn2d.cu", "filtered_lrelu.cu"])
    log(f"  nvcc builds (side by side) took {time.time() - t0:.1f} s")
    bias_recs, up_recs = phase_kernels(torch, ba, up, dev)
    fl_recs = phase_flrelu(torch, fl, net3, dev)
    second_recs = phase_second_order(torch, ba, up, dev)
    log(f"  phase 1 took {time.time() - t0:.1f} s (builds included)")
    phase_s = {"1": time.time() - t0}

    def timed(label, fn, *args, **kwargs):
        """fn's result; its seconds go to phase_s[label] and the log."""
        t = time.time()
        out = fn(*args, **kwargs)
        phase_s[label] = time.time() - t
        log(f"  phase {label} took {phase_s[label]:.1f} s")
        return out

    small = timed("2", lambda: {"stylegan2": phase_small_reference(torch, benchmark),
                                "stylegan3": phase_small_reference(torch, benchmark,
                                                                   arch="stylegan3")})
    slice_rec = timed("3", phase_slice, torch, np, benchmark, (ba.launches, up.launches))
    all_counters = (ba.launches, up.launches, fl.launches)
    sg3_rec = timed("4", phase_slice, torch, np, benchmark, all_counters, arch="stylegan3",
                    batch=SG3_BATCH)
    # What each new path must launch: bias_act and upfirdn2d forward and
    # backward under a StyleGAN2 G (forward only for the metrics' G),
    # filtered_lrelu besides under the alias-free one, and the second
    # derivatives besides in the trainer (R1, path length).
    first_order = ["bias_act_fwd", "bias_act_bwd"]
    sg2_need = [*first_order, *up.launches]
    proj_rec = timed("5", phase_projector, torch, np, benchmark, all_counters, sg2_need,
                     [*first_order, *fl.launches], sg3_rec, dev)
    tr_rec = timed("6", phase_tr_walk, torch, np, all_counters, sg2_need, slice_rec)
    geo_rec = timed("7", phase_geometric, torch, np, dev)
    metrics_rec = timed("8", phase_metrics, torch, np, all_counters,
                        ["bias_act_fwd", "upfirdn2d"], slice_rec, dev)
    train_rec = timed("9", phase_train, torch, np, all_counters, [*ba.launches, *up.launches],
                      dev)
    convert_rec = timed("10", phase_convert, torch, np, all_counters, slice_rec, sg3_rec, dev)
    sg3r_rec = timed("11", phase_sg3r, torch, np, benchmark, net3, up, fl, all_counters, dev)
    drivers_rec = timed("12", phase_drivers, torch, all_counters, slice_rec)
    pipeline_rec = timed("13", phase_pipeline, torch, all_counters, slice_rec)
    sustained_rec = timed("14", phase_sustained, torch, all_counters, dev)
    export_rec = timed("15", phase_export, torch, np, all_counters, slice_rec, sg3_rec, dev)
    pix2pix_rec = timed("16", phase_pix2pix, torch, np, all_counters, slice_rec, dev)
    sg2_counters = (ba.launches, up.launches)
    tools_rec = timed("17", phase_tools, torch, np, sg2_counters, sg2_need, slice_rec, dev)
    dp_rec = timed("18", phase_dp, torch, np, sg2_counters, sg2_need, slice_rec, dev)
    tp_rec = timed("19", phase_tp, torch, np, sg2_need, slice_rec, sg3_rec, dev)
    paths = {"walk": slice_rec, "walk_stylegan3": sg3_rec, "projector": proj_rec,
             "projector_stylegan3": proj_rec["stylegan3"], "tr_walk": tr_rec,
             "metrics": metrics_rec, "train": train_rec,
             "walk_nvidia_pickle": convert_rec["nvidia_pickle"],
             "walk_conditional": convert_rec["conditional"],
             "stylegan3_pickle": convert_rec["stylegan3_pickle"],
             "walk_stylegan3r": sg3r_rec["walk"], "driver_latentaug": drivers_rec["latentaug"],
             "driver_sg2aug": drivers_rec["sg2aug"], "pipeline": pipeline_rec,
             "sustained_train": sustained_rec, "exported_g_forward": export_rec,
             "exported_stylegan3_g_forward": export_rec["stylegan3"], "pix2pix": pix2pix_rec,
             "tool_zip_walk": tools_rec, "pix2pix_mayoclinic": tools_rec["mayo"],
             **{f"dp_walk_rank{r['rank']}": r["walk"] for r in dp_rec["ranks"]},
             **{f"dp_train_rank{r['rank']}": r["train"] for r in dp_rec["ranks"]},
             **{f"dp_projector_rank{r['rank']}": r["projector"] for r in dp_rec["ranks"]},
             **{f"dp_metrics_rank{r['rank']}": r["metrics"] for r in dp_rec["ranks"]},
             **{f"tp_walk_rank{r['rank']}": r["walk"] for r in tp_rec["ranks"]},
             **{f"tp_sg3_g_rank{r['rank']}": r["sg3"] for r in tp_rec["ranks"]}}

    def main_rec(recs, name, dtype):
        return next(r for r in recs if r["case"] == name and r["dtype"] == dtype)

    ba_main = main_rec(bias_recs, "G conv 256x256 lrelu clamp", "bfloat16")
    up_main = main_rec(up_recs, "G blur after up-conv (257->256)", "bfloat16")
    fl_main = main_rec(fl_recs, "L10 up4 crop(-6,-9)", "bfloat16")
    r_recs = [r for r in sg3r_rec["kernels"] if r["variant"] == "f2d"]
    g_recs = [r for r in sg3r_rec["kernels"] if "generic_max_abs_err" in r]
    r_main = next(r for r in r_recs if "radial" in r["case"] and r["dtype"] == "bfloat16")
    n_recs = [r for r in sg3r_rec["kernels"] if r["variant"] == "sepn"]
    n_main = next(r for r in n_recs if "up 4" in r["case"] and r["dtype"] == "bfloat16")
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
        # K2's staged 2-D polyphase variant, StyleGAN3-R's radial filter
        # and its backward: launches are the SG3-R walk's f2d ones.
        dict(entry("upfirdn2d_f2d", "cuda", "latentaugment_tpu_torch/csrc/upfirdn2d.cu",
                   "latentaugment_tpu/ops/upfirdn2d.py:564",
                   sg3r_rec["walk"]["variant_launches"]["upfirdn2d"]["f2d"], r_recs, r_main,
                   "fwd+bwd", "f2d"),
             case="f2d 2-D: " + r_main["case"],
             launches_by_path={"walk_stylegan3r": sg3r_rec["walk"]["variant_launches"]
                               ["upfirdn2d"]["f2d"]},
             decomposed_calls=sg3r_rec["walk"]["decomposed_calls"]),
        # K2's generic variant with run-time taps, launched directly on the
        # same case (the kernel the radial filter ran on before `f2d`) and
        # held to the plain version forward and backward; no path launches
        # it (read_counters holds it at 0), so its launches are 0.
        {"name": "upfirdn2d_generic", "route": "cuda",
         "source": "latentaugment_tpu_torch/csrc/upfirdn2d.cu",
         "replaces": "latentaugment_tpu/ops/upfirdn2d.py:564",
         "launches": sg3r_rec["walk"]["variant_launches"]["upfirdn2d"]["generic"],
         "variant": "generic", "case": "generic 2-D (run-time taps), direct: " + r_main["case"],
         "launches_by_path": {"walk_stylegan3r": sg3r_rec["walk"]["variant_launches"]
                              ["upfirdn2d"]["generic"]},
         "max_abs_err": max(r[f"{k}_max_abs_err"] for r in g_recs
                            for k in ("generic", "generic_bwd")),
         "ms": r_main["generic_fwd_ms"], "bwd_ms": r_main["generic_bwd_ms"],
         "plain_ms": r_main["plain_fwd_ms"], "bound_ms": r_main["bound_fwd_ms"],
         "bound_by": r_main["bound_fwd_by"], "library_ms": r_main["library_fwd_ms"]},
        # K2's staged polyphase variant, StyleGAN3-R's 1-D filters: launches
        # are the SG3-R walk's sepn ones; `generic` on the same case before.
        dict(entry("upfirdn2d_sepn", "cuda", "latentaugment_tpu_torch/csrc/upfirdn2d.cu",
                   "latentaugment_tpu/ops/upfirdn2d.py:564",
                   sg3r_rec["walk"]["variant_launches"]["upfirdn2d"]["sepn"], n_recs, n_main,
                   "fwd+bwd", "sepn"),
             case="sepn 1-D: " + n_main["case"],
             launches_by_path={"walk_stylegan3r": sg3r_rec["walk"]["variant_launches"]
                               ["upfirdn2d"]["sepn"]},
             generic_ms=n_main["generic_fwd_ms"]),
    ]

    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
                   "bias_act": bias_recs, "upfirdn2d": up_recs, "filtered_lrelu": fl_recs,
                   "second_order": second_recs, "train": train_rec,
                   "small_reference": small, "slice": slice_rec, "slice_stylegan3": sg3_rec,
                   "projector": proj_rec, "tr_walk": tr_rec, "geometric": geo_rec,
                   "metrics": metrics_rec, "convert": convert_rec, "sg3r": sg3r_rec,
                   "drivers": drivers_rec, "pipeline": pipeline_rec,
                   "sustained_train": sustained_rec, "export": export_rec,
                   "pix2pix": pix2pix_rec, "tools": tools_rec, "data_parallel": dp_rec,
                   "tensor_parallel": tp_rec,
                   "phase_seconds": phase_s,
                   "seconds": time.time() - t_start,
                   "kernels": kernels}, f,
                  indent=1)

    log(f"chip_smoke took {time.time() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
