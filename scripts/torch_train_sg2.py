#!/usr/bin/env python3
"""Train StyleGAN2(-ADA) with the PyTorch port, on the card unless
`--device cpu` is given. Snapshots are native checkpoints, which the
port's policy (`--model_dir`), its projector
(`scripts/torch_project_dataset.py --checkpoint`), its metrics and the JAX
package's loader all read:

    python scripts/torch_train_sg2.py --outdir runs/pelvis \\
        --data interim/Pelvis/Pelvis-img.zip \\
        --modalities MR_nonrigid_CT,MR_MR_T2 --resolution 256 \\
        --batch 32 --kimg 25000 --aug ada --augpipe bgc

    python scripts/torch_train_sg2.py --synthetic --kimg 0.05   # smoke run

The flags are those of scripts/train_sg2.py (NVIDIA train.py's names:
gamma, kimg, snap, aug, p, target, augpipe, mirror, resume), plus
`--device`. `--resume` takes a native checkpoint; `--resume-state` a
training state of this trainer (`training-state-*.pt`).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--outdir', default='./runs/sg2')
    p.add_argument('--data', default=None,
                   help='dataset zip (<split>/<patient>/<slice>.pickle, [0,255] floats)')
    p.add_argument('--modalities', default='MR_nonrigid_CT,MR_MR_T2')
    p.add_argument('--split', default='train')
    p.add_argument('--resolution', type=int, default=256)
    p.add_argument('--cond', action='store_true',
                   help='conditional training on dataset.json labels')
    p.add_argument('--mirror', action='store_true', help='x-flip dataset amplification')
    p.add_argument('--batch', type=int, default=32)
    p.add_argument('--gamma', default='auto', help='R1 weight; auto = 0.0002*res^2/batch')
    p.add_argument('--kimg', type=float, default=25000)
    p.add_argument('--snap', type=float, default=50, help='snapshot every N kimg')
    p.add_argument('--lr', type=float, default=2.5e-3)
    p.add_argument('--aug', default='ada', choices=['noaug', 'ada', 'fixed'])
    p.add_argument('--p', type=float, default=0.0,
                   help='initial (fixed: constant) augmentation prob')
    p.add_argument('--target', type=float, default=0.6, help='ADA r_t target')
    p.add_argument('--augpipe', default='bgc',
                   choices=['blit', 'geom', 'color', 'noise', 'cutout', 'bg', 'bgc', 'bgcfnc'])
    p.add_argument('--fp16_res', type=int, default=4,
                   help='num highest-res blocks in bf16 (0 = fp32)')
    p.add_argument('--remat', type=int, default=0,
                   help='checkpoint blocks with res >= this (0 = off)')
    p.add_argument('--r1_chunks', type=int, default=1,
                   help='compute R1 in N sequential sub-batches (bounds its memory)')
    p.add_argument('--metrics', default='none',
                   help='comma list of snapshot-time metrics (fid50k_full,pr50k3_full) '
                        'or "none"; needs --data (real statistics)')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--resume', default=None, help='native checkpoint to resume G/D from')
    p.add_argument('--resume-state', default=None, dest='resume_state',
                   help='training-state-*.pt of an interrupted run: continue exactly '
                        '(raw G/D, EMA, Adam moments, ADA controller, generator, nimg); '
                        'the saved configs override the network shape flags')
    p.add_argument('--n_devices', type=int, default=0,
                   help='data-parallel size (more than 1 needs the DDP slice, not ported)')
    p.add_argument('--synthetic', action='store_true',
                   help='train on random data (smoke runs, 32x32)')
    p.add_argument('--channel_base', type=int, default=32768)
    p.add_argument('--channel_max', type=int, default=512)
    p.add_argument('--map_layers', type=int, default=2,
                   help='mapping depth (NVIDIA auto config uses 2)')
    p.add_argument('--device', default='cuda',
                   help='torch device (cuda, cuda:N or cpu); cuda without CUDA raises')
    p.add_argument('--cpu', action='store_true', help='same as --device cpu')
    return p


def parse_args(argv=None):
    return build_parser().parse_args(argv)


def _explicit_flags(argv=None):
    """Dests of the flags the user typed: --resume-state restores the
    saved hyperparameters, and flags typed explicitly still win."""
    p = build_parser()
    for action in p._actions:
        action.default = argparse.SUPPRESS
    return set(vars(p.parse_args(argv)))


def make_data_iter(args, batch_size, c_dim):
    """(iterator of (imgs [B,C,H,W] float32 in [-1,1], labels or None),
    the channel count with --synthetic, else the dataset)."""
    if args.synthetic:
        chans = len(args.modalities.split(','))
        rng = np.random.RandomState(args.seed)

        def it():
            while True:
                imgs = rng.rand(batch_size, chans, args.resolution,
                                args.resolution).astype(np.float32) * 2 - 1
                c = np.eye(c_dim, dtype=np.float32)[
                    rng.randint(0, c_dim, batch_size)] if c_dim else None
                yield imgs, c
        return it(), chans

    from latentaugment_tpu_torch.models.stylegan2.dataset import (
        CustomImageFolderDataset, InfiniteSampler)
    ds = CustomImageFolderDataset(
        args.data, modalities=args.modalities.split(','), split=args.split,
        resolution=args.resolution, use_labels=args.cond, xflip=args.mirror)
    sampler = InfiniteSampler(len(ds), seed=args.seed)

    def it():
        idx_iter = iter(sampler)
        while True:
            imgs, labels = [], []
            for _ in range(batch_size):
                img, c = ds[next(idx_iter)]
                imgs.append(img.astype(np.float32) / 127.5 - 1.0)
                labels.append(c)
            c = np.stack(labels).astype(np.float32) if args.cond and labels[0].size else None
            yield np.stack(imgs), c
    return it(), ds


def resolve_train_cfg(train, args, resume_state, argv=None):
    """The train_config. --resume-state restores the saved
    hyperparameters; flags typed explicitly override them, with a
    warning, since the continuation is then no longer exact."""
    cfg_kwargs = dict(
        batch_size=args.batch, lr=args.lr,
        r1_gamma=None if args.gamma == 'auto' else float(args.gamma),
        aug=args.aug, aug_pipe=args.augpipe, ada_target=args.target,
        aug_p=args.p, remat=args.remat if args.remat else False,
        r1_chunks=args.r1_chunks)
    if resume_state is None:
        return train.train_config(**cfg_kwargs)
    saved_cfg = dict(resume_state.get('train_cfg') or {})
    flag_to_cfg = dict(batch='batch_size', lr='lr', gamma='r1_gamma', aug='aug',
                       augpipe='aug_pipe', target='ada_target', p='aug_p', remat='remat',
                       r1_chunks='r1_chunks')
    explicit = _explicit_flags(argv)
    for flag, ck in flag_to_cfg.items():
        if flag in explicit:
            if ck in saved_cfg and saved_cfg[ck] != cfg_kwargs[ck]:
                print(f'[torch_train_sg2] WARNING: --{flag} overrides saved '
                      f'{ck}={saved_cfg[ck]!r} -> {cfg_kwargs[ck]!r}; the continuation is '
                      'no longer exact')
            saved_cfg[ck] = cfg_kwargs[ck]
    return train.train_config(**saved_cfg)


def main(argv=None):
    """Trains; returns the final state (see models/stylegan2/train.py)."""
    args = parse_args(argv)
    if args.cpu:
        args.device = 'cpu'
    if args.n_devices > 1:
        raise NotImplementedError(
            '--n_devices > 1 belongs to the DDP slice, which is not ported yet')

    from latentaugment_tpu_torch.models.stylegan2 import checkpoint, networks, train
    from latentaugment_tpu_torch.utils.util_general import resolve_device

    device = resolve_device(args.device)
    if args.synthetic:
        # A small operating point that runs in seconds on the CPU.
        args.resolution = min(args.resolution, 32)
        if args.channel_base == 32768:
            args.channel_base = 1024
        if args.channel_max == 512:
            args.channel_max = 64

    resume_state = None
    if args.resume_state:
        if args.resume:
            raise ValueError('--resume and --resume-state are exclusive')
        resume_state = train.load_training_state(args.resume_state)
    cfg = resolve_train_cfg(train, args, resume_state, argv)

    if resume_state is not None:
        if resume_state['g_cfg'].get('c_dim'):
            args.cond = True  # the restored networks need labels from the iterator
        saved_res = int(resume_state['g_cfg'].get('img_resolution', args.resolution))
        if args.resolution != saved_res:
            if 'resolution' in _explicit_flags(argv):
                raise SystemExit(f'--resolution {args.resolution} != saved network resolution '
                                 f'{saved_res}; a resumed run cannot change the architecture')
            args.resolution = saved_res

    data_iter, ds = make_data_iter(args, cfg.batch_size, c_dim=2 if args.cond else 0)
    if args.synthetic:
        img_channels, c_dim = ds, (2 if args.cond else 0)
    else:
        img_channels, c_dim = ds.num_channels, (ds.label_dim if args.cond else 0)

    g_params = d_params = None
    if resume_state is not None:
        g_cfg = networks.generator_config(**resume_state['g_cfg'])
        d_cfg = networks.discriminator_config(**resume_state['d_cfg'])
    elif args.resume:
        # Native checkpoints only: the NVIDIA / TF pickle converters are not
        # ported, and load_stylegan says so for such a file.
        g_params, g_cfg, d_params, d_cfg = checkpoint.load_stylegan(args.resume)
        if d_params is None:
            raise ValueError(f'{args.resume} has no discriminator to resume from')
    else:
        n16 = args.fp16_res if args.resolution >= 64 else 0
        g_cfg = networks.generator_config(
            img_resolution=args.resolution, img_channels=img_channels, c_dim=c_dim,
            channel_base=args.channel_base, channel_max=args.channel_max,
            num_mapping_layers=args.map_layers, num_fp16_res=n16)
        d_cfg = networks.discriminator_config(
            img_resolution=args.resolution, img_channels=img_channels, c_dim=c_dim,
            channel_base=args.channel_base, channel_max=args.channel_max, num_fp16_res=n16)

    state = None
    if g_params is not None:
        state = train.make_train_fns(g_cfg, d_cfg, cfg, device=device) \
            .state_from_params(g_params, d_params)

    # Snapshot-time metrics: every snapshot is scored against the real
    # dataset and appended to metric-<mode>-<metric>.jsonl in the run dir.
    on_snapshot = None
    metric_names = [m for m in args.metrics.split(',') if m and m != 'none']
    if metric_names:
        if not args.data:
            print('[torch_train_sg2] --metrics needs --data for real-image statistics; '
                  'skipping snapshot metrics')
        else:
            from latentaugment_tpu_torch.metrics import metric_main_mi_multimodal as metric_main
            for m in metric_names:
                if not metric_main.is_valid_metric(m):
                    raise ValueError(f'unknown metric {m!r}; valid: '
                                     f'{metric_main.list_valid_metrics()}')
            modalities = args.modalities.split(',')
            dataset_kwargs = dict(path=args.data, split=args.split, modalities=modalities,
                                  resolution=args.resolution, use_labels=bool(c_dim))

            def on_snapshot(path, snap_state, cur_nimg):
                for mode_idx, mode in enumerate(modalities):
                    for m in metric_names:
                        res = metric_main.calc_metric(
                            m, G=snap_state.G_ema, dataset_kwargs=dataset_kwargs,
                            mode_dict=dict(mode_name=mode, mode_idx=mode_idx), device=device)
                        metric_main.report_metric(res, mode=mode, run_dir=args.outdir,
                                                  snapshot_pkl=path)

    gamma_eff = cfg.r1_gamma if cfg.r1_gamma is not None else \
        0.0002 * args.resolution ** 2 / cfg.batch_size
    print(f'[torch_train_sg2] res={args.resolution} ch={img_channels} c_dim={c_dim} '
          f'batch={cfg.batch_size} aug={cfg.aug} gamma={gamma_eff:g} device={device} '
          f'outdir={args.outdir}')
    state = train.train_loop(g_cfg, d_cfg, data_iter, cfg, total_kimg=args.kimg,
                             run_dir=args.outdir, seed=args.seed, snapshot_kimg=args.snap,
                             state=state, on_snapshot=on_snapshot,
                             resume_state=resume_state, device=device)
    print('[torch_train_sg2] done')
    return state


if __name__ == '__main__':
    main()
