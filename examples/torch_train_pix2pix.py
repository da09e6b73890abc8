"""Worked end-to-end example: train a pix2pix consumer on LatentAugment
batches with the PyTorch port (the port's copy of
examples/train_pix2pix.py).

Per batch: the augment policy runs the K-step latent walk, and the
augmented (A, B) pair feeds one pix2pix train step
(`models/pix2pix.make_train_step`: both losses and gradients from the
pre-update G and D, then both Adam steps). Everything runs on the
options' `--device` (default cuda; cuda without CUDA raises). A mesh
(`--n_mesh_devices` above 1) raises in the options, as every `mesh=`
path of the port does: the DDP slice is not ported.

Run on synthetic data (no downloads; the port's own workspace builder,
32x32 tiny nets):

    python examples/torch_train_pix2pix.py --synthetic --device cpu --pix2pix_steps 20

or point the usual AugOptions flags at a real workspace, e.g.:

    python examples/torch_train_pix2pix.py --dataroot ... --model_dir ... \\
        --dataset_mode pelvis --aug latent --init_w inv --batch_size 8

`main` returns the pix2pix networks and one record per step: the walk's
and the pix2pix step's host seconds (each ends on a host copy of its
result) and the three losses.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch


def build_argv_synthetic(root):
    """A synthetic workspace under `root` (the port's
    `benchmark.build_policy_workspace`: 32x32, 2 modalities, tiny G and D)
    and the policy argv that walks it."""
    from latentaugment_tpu_torch import benchmark

    argv = benchmark.build_policy_workspace(
        root, res=32, batch_size=2, num_epochs=3, crop_size=16, channel_base=256,
        channel_max=32, n_patients=1, slices_per_patient=4, step=5)
    return argv + ["--init_w", "inv", "--p_thres", "0.0",
                   "--w_pix", "0.1", "--w_lpips", "1.0",
                   "--w_latent", "0.001", "--w_disc", "0.01",
                   "--opt_num_epochs", "2", "--name", "pix2pix_demo"]


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)

    # Example-local flags (everything else is the standard AugOptions
    # surface).
    def pop_flag(name, default=None, is_bool=False):
        if name in argv:
            i = argv.index(name)
            argv.pop(i)
            return True if is_bool else argv.pop(i)
        return default

    synthetic = pop_flag("--synthetic", False, is_bool=True)
    steps = int(pop_flag("--pix2pix_steps", "50"))
    lambda_l1 = float(pop_flag("--lambda_l1", "100.0"))
    lr = float(pop_flag("--pix2pix_lr", "2e-4"))

    if synthetic:
        import tempfile

        root = tempfile.mkdtemp(prefix="torch_pix2pix_demo_")
        argv = build_argv_synthetic(root) + argv

    from latentaugment_tpu_torch.augments import create_augment
    from latentaugment_tpu_torch.data import create_dataset
    from latentaugment_tpu_torch.models import pix2pix
    from latentaugment_tpu_torch.options import AugOptions
    from latentaugment_tpu_torch.utils.util_general import resolve_device

    opt = AugOptions().parse(argv=argv, install_logger=False)
    device = resolve_device(opt.device)
    dataset = create_dataset(opt)
    augment = create_augment(opt)

    cfg = pix2pix.pix2pix_config(lambda_l1=lambda_l1, lr=lr)
    nets = pix2pix.init_all(getattr(opt, "seed", 0), cfg, device=device)
    opt_state = pix2pix.opt_init(nets)
    train_step = pix2pix.make_train_step(cfg)
    print(f"pix2pix G+D params: {pix2pix.count_params(nets):,}")

    history = []
    t0 = time.time()
    while len(history) < steps:
        for data in dataset:
            if len(history) >= steps:
                break
            t_walk = time.time()
            augment.set_input(data)
            augment.forward()
            out = augment.get_output()  # {'A','B','A_paths','B_paths'}, host arrays
            t_step = time.time()
            a = torch.as_tensor(np.asarray(out["A"], np.float32), device=device)
            b = torch.as_tensor(np.asarray(out["B"], np.float32), device=device)
            metrics = {k: float(v) for k, v in train_step(nets, opt_state, a, b).items()}
            history.append(dict(metrics, walk_s=t_step - t_walk, step_s=time.time() - t_step))
            step = len(history)
            if step % 10 == 0 or step == steps:
                print(f"step {step:4d}  G {metrics['loss_G']:.3f}  "
                      f"D {metrics['loss_D']:.3f}  L1 {metrics['loss_L1']:.4f}  "
                      f"({(time.time() - t0) / step:.2f} s/step)")
    return nets, history


if __name__ == "__main__":
    main()
