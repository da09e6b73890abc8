"""The run-to-run spread of chip_smoke phase 18's float32 trainer step 0.

Two ranks on one card under gloo compute the four phase losses and
gradients of the trainer at the operating point's widths (256x256,
channel_base 32768, channel_max 512, batch 32, const noise, no ADA), as
phase 18 does, and rank 0 computes them twice in one process. Each is run
under cuDNN's default and then its deterministic algorithms, twice over.
Prints one JSON line per round: for each phase, the 2-rank loss against
the one-process loss (relative), the one-process loss against its own
rerun, and the same two for the gradient (of its max). Needs one CUDA card.

    python3 scripts/torch_dp_step0_spread.py
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, RES = 32, 256


def _rank(rank, port):
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    from latentaugment_tpu_torch.models.stylegan2 import networks, train
    from latentaugment_tpu_torch.parallel import mesh as pmesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    pmesh.init_distributed(f"localhost:{port}", 2, rank, backend="gloo")
    mesh = pmesh.get_mesh(2, devices=str(dev))
    net = dict(img_resolution=RES, img_channels=2, conv_clamp=256, channel_base=32768,
               channel_max=512)
    g_cfg = networks.generator_config(num_mapping_layers=2, num_fp16_res=0, **net)
    d_cfg = networks.discriminator_config(num_fp16_res=0, **net)
    cfg = train.train_config(batch_size=BATCH, style_mixing_prob=0.0, noise_mode="const",
                             aug="noaug")
    gz = torch.Generator(device=dev).manual_seed(31)
    z = torch.randn([BATCH, g_cfg.z_dim], generator=gz, device=dev)
    real = torch.rand([BATCH, 2, RES, RES], generator=gz, device=dev) * 2 - 1
    pl_b = BATCH // 2
    pl_noise = torch.randn([pl_b, 2, RES, RES], generator=gz, device=dev) / RES
    pl_mean = torch.tensor(0.5, device=dev)

    def phase_values(fns, state, m):
        gen = torch.Generator(device=dev).manual_seed(1)
        r = None if m is None else pmesh.shard_rows(BATCH, m, state.D.cfg.mbstd_group_size)
        rp = None if m is None else pmesh.shard_rows(pl_b, m)
        tk = (lambda rr, x: x) if m is None else (lambda rr, x: rr.take(x))
        losses = {
            "Gmain": (state.G, r, lambda: fns.loss_g_main(state.G, state.D, tk(r, z), tk(r, z),
                                                          None, gen, 0.0, r)),
            "Gpl": (state.G, rp, lambda: fns.loss_g_pl(state.G, pl_mean, tk(rp, z[:pl_b]),
                                                       tk(rp, z[:pl_b]), None, gen,
                                                       pl_noise=tk(rp, pl_noise), rows=rp)),
            "Dmain": (state.D, r, lambda: fns.loss_d_main(state.D, state.G, tk(r, real),
                                                          tk(r, z), tk(r, z), None, gen, 0.0, r)),
            "Dr1": (state.D, r, lambda: fns.loss_d_r1(state.D, tk(r, real), None, r)),
        }
        vals = {}
        for phase, (module, rr, fn) in losses.items():
            loss = fn()[0]
            grads = fns.grads(loss, module, rr)
            total = loss.detach() if rr is None else rr.sum(loss.detach())
            vals[phase] = (total.item(), torch.cat([g.reshape(-1) for g in grads]))
        return vals

    fns_dp = train.make_train_fns(g_cfg, d_cfg, cfg, device=dev, mesh=mesh)
    state = fns_dp.init_state(seed=0)
    fns1 = train.make_train_fns(g_cfg, d_cfg, cfg, device=dev)
    for deterministic in (False, True, False, True):
        torch.backends.cudnn.deterministic = deterministic
        dp = phase_values(fns_dp, state, mesh)
        if rank == 0:
            one, rerun = phase_values(fns1, state, None), phase_values(fns1, state, None)
            rec = {"deterministic": deterministic}
            for p, (loss, g) in one.items():
                scale = g.abs().max()
                rec[p] = dict(loss_rel=abs(dp[p][0] - loss) / abs(loss),
                              loss_rel_1proc_rerun=abs(rerun[p][0] - loss) / abs(loss),
                              grad_err_of_max=((dp[p][1] - g).abs().max() / scale).item(),
                              grad_rerun_of_max=((rerun[p][1] - g).abs().max() / scale).item())
            print(json.dumps(rec), flush=True)
        dist.barrier()
    dist.destroy_process_group()


def main():
    import multiprocessing

    import torch

    if not torch.cuda.is_available():
        print("torch_dp_step0_spread: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from latentaugment_tpu_torch.parallel import mesh as pmesh

    ctx = multiprocessing.get_context("spawn")
    port = pmesh.free_port()
    t0 = time.time()
    procs = [ctx.Process(target=_rank, args=(r, port)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=max(1.0, 900 - (time.time() - t0)))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(30)
    codes = [p.exitcode for p in procs]
    print(f"rank exit codes {codes}, {time.time() - t0:.1f} s", flush=True)
    return 0 if codes == [0, 0] else 1


if __name__ == "__main__":
    sys.exit(main())
