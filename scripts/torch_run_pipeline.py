#!/usr/bin/env python3
"""The whole LatentAugment loop in one command, on the PyTorch port
(counterpart: scripts/run_pipeline.py): [optionally train a StyleGAN2 on
the dataset] -> [optionally invert the dataset to w latents] -> augment
it and dump the pairs and latents -> FID and precision/recall per
modality -> the latent-coverage plot -> the walk-trajectory GIFs.

`--train` runs the port's trainer (scripts/torch_train_sg2.py) on the
pipeline's dataset zip and hands its last snapshot to every later stage;
`--project` runs the port's projector (scripts/torch_project_dataset.py)
and hands its inversion zip to the policy. `--synthetic` writes a seeded
workspace first (`benchmark.build_policy_workspace`: checkpoint, image
zip, inversion zip) at `--res` with G and D of `--channel_base` /
`--channel_max`, `--arch stylegan3` for an alias-free checkpoint. Every
stage runs on `--device` (default cuda; cuda without CUDA raises;
`--cpu`, or LATAUG_PIPELINE_FORCE_CPU set, is `--device cpu` and refuses
any other `--device`). Each stage's seconds are printed.

    python scripts/torch_run_pipeline.py --synthetic --device cpu
    python scripts/torch_run_pipeline.py --synthetic --train --project --device cpu
    python scripts/torch_run_pipeline.py --dataroot ... --model_dir ... --aug latent ...

The GIFs come from the engine's verbose walk (`--verbose_log`, on with
`--synthetic`), which writes per-step snapshots at batch 1 only: at a
larger batch the pipeline walks the first slice of the first batch once
more at batch 1 to draw its trajectory.
"""

import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def carry_vgg_env(model_dir):
    """Pin the LPIPS VGG16 found in `model_dir`'s layout in the
    LATENTAUGMENT_VGG16 environment variable (unless it is set) and return
    it. Called before --train replaces opt.model_dir by the snapshot file,
    beside which no VGG16 lies: the projector and the walk would run a
    seeded random VGG16 instead."""
    from latentaugment_tpu_torch.augments.engine import resolve_vgg_path

    vgg = resolve_vgg_path(model_dir)
    if vgg and not os.environ.get("LATENTAUGMENT_VGG16"):
        os.environ["LATENTAUGMENT_VGG16"] = vgg
    return vgg


def main(argv=None):
    """Returns (outdir, metric results, seconds by stage)."""
    argv = list(sys.argv[1:] if argv is None else argv)

    def pop_flag(name, default=None, is_bool=False):
        if name in argv:
            i = argv.index(name)
            argv.pop(i)
            return True if is_bool else argv.pop(i)
        return default

    synthetic = pop_flag("--synthetic", False, is_bool=True)
    n_imgs = int(pop_flag("--n_imgs", "32"))
    # --arch stylegan3 builds the synthetic workspace around an alias-free
    # checkpoint; every later stage dispatches on its saved arch tag.
    arch = pop_flag("--arch", "stylegan2")
    res = int(pop_flag("--res", "32"))
    channel_base = int(pop_flag("--channel_base", "1024"))
    channel_max = int(pop_flag("--channel_max", "64"))
    do_train = pop_flag("--train", False, is_bool=True)
    train_kimg = float(pop_flag("--train_kimg", "0.2"))
    train_batch = int(pop_flag("--train_batch", "4"))
    do_project = pop_flag("--project", False, is_bool=True)
    project_steps = int(pop_flag("--project_steps", "100"))
    project_batch = int(pop_flag("--project_batch", "16"))
    device = pop_flag("--device")
    force_cpu = pop_flag("--cpu", False, is_bool=True) or os.environ.get("LATAUG_PIPELINE_FORCE_CPU")
    if force_cpu and device not in (None, "cpu"):
        raise SystemExit(f"--device {device} conflicts with --cpu / LATAUG_PIPELINE_FORCE_CPU")
    device = "cpu" if force_cpu else device or "cuda"

    from latentaugment_tpu_torch.utils.util_general import resolve_device

    resolve_device(device)  # cuda without CUDA raises here, before any stage
    seconds = {}
    tick = time.time()

    def stage_done(name):
        nonlocal tick
        seconds[name] = time.time() - tick
        print(f"[pipeline] stage {name} took {seconds[name]:.2f} s")
        tick = time.time()

    if synthetic and do_train and arch != "stylegan2":
        raise SystemExit("--train produces a StyleGAN2 snapshot that would "
                         "replace the --arch checkpoint; drop one of them")
    if synthetic:
        import tempfile

        from latentaugment_tpu_torch import benchmark

        root = tempfile.mkdtemp(prefix="lataug_pipeline_")
        ws_argv = benchmark.build_policy_workspace(
            root, res=res, batch_size=1, num_epochs=2, crop_size=min(64, res // 2),
            channel_base=channel_base, channel_max=channel_max,
            n_patients=-(-n_imgs // 24), slices_per_patient=24, step=10, arch=arch)
        argv = ws_argv + ["--init_w", "inv", "--p_thres", "0.0",
                          "--w_pix", "0.1", "--w_lpips", "1.0",
                          "--w_latent", "0.001", "--w_disc", "0.01",
                          "--opt_num_epochs", "2", "--verbose_log", "1",
                          "--batch_size", "1",
                          "--name", "pipeline_demo"] + argv
        stage_done("workspace")

    from latentaugment_tpu_torch.analysis import create_gif, umap_analysis
    from latentaugment_tpu_torch.augments import create_augment
    from latentaugment_tpu_torch.data import create_dataset
    from latentaugment_tpu_torch.metrics.metric_main_mi_multimodal import calc_metric
    from latentaugment_tpu_torch.options import AugOptions
    from latentaugment_tpu_torch.utils import util_general, util_io, util_path

    opt = AugOptions().parse(argv=argv + ["--device", device], install_logger=False)
    outdir = os.path.join(opt.checkpoints_dir, opt.name)
    for sub in ("img_aug", "latent_aug", "snap"):
        util_path.create_dir(os.path.join(outdir, sub))
    data_zip = os.path.join(opt.interim_dir, opt.dataset_aug, opt.dataset_name_aug + ".zip")

    # ---- Stage -1 (opt-in): StyleGAN2 training on the same dataset zip;
    # its last snapshot replaces the checkpoint of every later stage.
    if do_train:
        import glob

        from scripts.torch_train_sg2 import main as train_main

        train_dir = os.path.join(outdir, "train")
        train_argv = [
            "--data", data_zip, "--modalities", opt.modalities_aug,
            "--split", opt.phase, "--resolution", str(opt.img_resolution),
            "--outdir", train_dir, "--kimg", str(train_kimg),
            "--batch", str(train_batch), "--snap", str(train_kimg),
            "--device", device,
        ]
        if synthetic:
            train_argv += ["--channel_base", str(channel_base), "--channel_max", str(channel_max)]
        print(f"[pipeline] training StyleGAN2 on {data_zip} "
              f"({train_kimg} kimg, batch {train_batch}) -> {train_dir}")
        train_main(train_argv)
        snaps = sorted(glob.glob(os.path.join(train_dir, "network-snapshot-*.pkl")))
        if not snaps:
            raise RuntimeError(f"the trainer wrote no snapshot under {train_dir}")
        print(f"[pipeline] trained snapshot: {snaps[-1]}")
        # The environment variable is how the engine and the projector
        # find the LPIPS VGG16 once model_dir is no longer the layout root.
        vgg_from_layout = carry_vgg_env(opt.model_dir)
        if vgg_from_layout:
            print(f"[pipeline] LPIPS VGG carried over from the original "
                  f"model_dir: {vgg_from_layout}")
        opt.model_dir = snaps[-1]  # resolve_stylegan_path takes file paths
        if opt.init_w == "inv" and not do_project:
            print("[pipeline] WARNING: --train replaced the checkpoint but "
                  "--init_w inv will seed the walk from an inversion zip made "
                  "with another generator; pass --project to invert against it")
        stage_done("train")

    # ---- Stage 0 (opt-in): inversion; its zip seeds the walk (--init_w inv).
    if do_project:
        from latentaugment_tpu_torch.augments.engine import (resolve_stylegan_path,
                                                             resolve_vgg_path)
        from scripts.torch_project_dataset import main as project_main

        # model_dir may be the training runs' root: resolve the checkpoint
        # file as the engine does, and hand the projector the engine's
        # LPIPS VGG16, so inversion and walk score the same space.
        ckpt_path = resolve_stylegan_path(
            opt.model_dir, opt.dataset_aug, opt.dataset_name_aug,
            util_general.parse_comma_separated_list(opt.modalities_aug),
            opt.exp_stylegan, opt.network_pkl_stylegan)
        vgg_path = resolve_vgg_path(opt.model_dir)
        proj_w_name = opt.dataset_w_name + "-projected"
        dest_zip = os.path.join(opt.interim_dir, opt.dataset_aug, proj_w_name + ".zip")
        if opt.init_w != "inv":
            print("[pipeline] WARNING: --project requested but --init_w "
                  f"is '{opt.init_w}': the projected latents will not "
                  "seed the walk (pass --init_w inv)")
        print(f"[pipeline] projecting {data_zip} -> {dest_zip} "
              f"({project_steps} steps, batch {project_batch})")
        project_main([
            "--checkpoint", ckpt_path, "--data_zip", data_zip,
            "--split", opt.phase, "--modalities", opt.modalities_aug,
            "--resolution", str(opt.img_resolution),
            "--num_steps", str(project_steps),
            "--batch_size", str(project_batch),
            "--w_avg_samples", "256" if synthetic else "10000",
            "--outdir", os.path.join(outdir, "temp-projector"),
            "--dest_zip", dest_zip, "--device", device,
        ] + (["--vgg", vgg_path] if vgg_path else []))
        opt.dataset_w_name = proj_w_name  # the engine reads interim/<ds>/<name>.zip
        stage_done("project")

    # ---- Stage 1: augment and dump.
    dataset = create_dataset(opt)
    augment = create_augment(opt)
    print(f"[pipeline] augmenting {n_imgs} images ({len(dataset)} in dataset)")
    n_iter = max(1, n_imgs // opt.batch_size)
    w_in, w_out, first = [], [], None
    for i, data in enumerate(dataset):
        if i >= n_iter:
            break
        augment.set_input(data)
        augment.forward()
        out = augment.get_output()
        util_io.write_pickle(out, os.path.join(outdir, "img_aug", f"img_aug_{i}"))
        # Latents exist only for batches the p_thres gate augmented.
        if augment.augmented:
            lat = augment.get_latent_output()
            util_io.write_pickle(lat, os.path.join(outdir, "latent_aug", f"latent_aug_{i}"))
            # A batch of 1 comes back squeezed to [w_dim]: restore the batch axis.
            w_in.append(np.atleast_2d(np.asarray(augment.get_latent_input()["w"])))
            w_out.append(np.atleast_2d(np.asarray(lat["w"])))
            if first is None:
                first = (w_in[-1][:1], list(data["A_paths"][:1]))
    stage_done("augment")

    # ---- Stage 2: FID and precision/recall per modality.
    modalities = util_general.parse_comma_separated_list(opt.modalities_aug)
    # Real-image statistics come from the split the dumps were made from.
    dataset_kwargs = dict(path=data_zip, split=opt.phase, modalities=modalities,
                          resolution=opt.img_resolution)
    dataset_kwargs_gen = dict(dataroot=outdir, aug_name=opt.name, batch_size=opt.batch_size)
    results = []
    for mode_idx, mode in enumerate(modalities):
        for metric in ("fid50k_full", "pr50k3_full"):
            res_ = calc_metric(metric, dataset_kwargs=dataset_kwargs,
                               dataset_kwargs_gen=dataset_kwargs_gen,
                               mode_dict=dict(mode_name=mode, mode_idx=mode_idx),
                               device=device)
            results.append((metric, mode, dict(res_.results)))
            print(f"[pipeline] {metric}/{mode}: {dict(res_.results)}")
    util_io.write_json([dict(metric=m, mode=mo, results=r) for m, mo, r in results],
                       os.path.join(outdir, "pipeline_metrics.json"))
    stage_done("metrics")

    # ---- Stage 3: latent coverage (UMAP, else PCA).
    if w_in:
        w_in = np.concatenate(w_in, axis=0)
        w_out = np.concatenate(w_out, axis=0)
        umap_path = os.path.join(outdir, "umap_coverage.png")
        umap_analysis.manifold_coverage(w_in, {"LatentAugment": w_out}, umap_path)
        print(f"[pipeline] UMAP coverage plot: {umap_path}")
    else:
        print("[pipeline] no augmented latents (p_thres gate skipped "
              "every batch); UMAP stage skipped")
    stage_done("coverage")

    # ---- Stage 4: trajectory GIFs from the verbose walk's snapshots.
    engine = augment.latent_aug
    snap_dir = engine.save_dir

    def snapshots():
        """Per-step snapshots (<fname>_<step>.png; the verbose walk's loss
        plots are PNGs too)."""
        return os.path.isdir(snap_dir) and any(re.match(r"(.+)_(\d+)\.png$", f)
                                               for f in os.listdir(snap_dir))

    if opt.verbose_log and first is not None and not snapshots():
        # The verbose walk ran at batch > 1, which writes no snapshots:
        # walk the first slice once more at batch 1.
        w0, fname = first
        engine._verbose_done = False
        engine.forward(w0.reshape(1, 1, -1), fname)
    if snapshots():
        gifs = create_gif.create_gif(snap_dir)
        print(f"[pipeline] trajectory GIFs: {gifs}")
    else:
        print("[pipeline] no snapshots (run with --verbose_log for GIFs)")
    stage_done("gif")

    print(f"[pipeline] stage seconds: {seconds}")
    print(f"[pipeline] DONE — outputs under {outdir}")
    return outdir, results, seconds


if __name__ == "__main__":
    main()
