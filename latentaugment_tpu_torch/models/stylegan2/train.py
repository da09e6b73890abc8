"""StyleGAN2(-ADA) trainer on PyTorch
(counterpart: latentaugment_tpu/models/stylegan2/train.py).

It makes the checkpoints that the walk, the projector and the metrics
consume, so the workflow (train G and D, invert the dataset, run the
policy) needs nothing from outside the port.

- Four phases, as the JAX trainer's: Gmain, Gpl (path-length
  regularisation), Dmain and Dr1 (R1 penalty on the augmented reals).
  Each is one loss, its gradient with respect to one network's
  parameters, and one Adam step. The lazy-regularisation schedule is a
  host counter over fixed intervals; the regularisers' strength folds into
  the loss (x interval) and the mb_ratio into Adam's lr and betas.
- R1 and path length differentiate a gradient (`create_graph=True`):
  every FIR resample and bias_act of G and D then runs its kernel's
  second-order path (K2's backward is K2 again, K1's backward kernel
  launches again, counted as `bias_act_bwd2`).
- Buffers (`w_avg`, `resample_filter`, `noise_const`) are module buffers
  and never reach an optimizer; `w_avg` is lerped toward each Gmain
  batch's mean w. G_ema lerps the parameters and copies the buffers.
- Every random draw (z, style mixing, random noise, ADA, the path-length
  noise) comes from one `torch.Generator` on the device, and the ADA
  probability p is a device scalar: a step syncs with the host only where
  a log row is written or the ADA controller ticks.
- Snapshots are native checkpoints (checkpoint.save_checkpoint, G = the
  EMA weights); a training state (`torch.save`, loaded with
  `weights_only=True`) resumes a run exactly.

The state is a dict of modules and optimizers: G, D, G_ema, opt_g, opt_d
and pl_mean. The phase functions update it in place and return it with
their logs (device scalars), as `state, logs = fns.g_main(state, ...)`.

Data parallelism (`mesh=`, parallel/mesh.py, one process per device):
every rank holds the same state and receives the same global batch and
z; each phase computes its rows (`shard_rows`: minibatch-stddev groups
whole on one rank where they fit, else D's epilogue gathers across the
ranks), draws every random number for the global batch and
takes its rows, scales its batch means by n_local / n, and all-reduces
the gradients by hand over one flattened buffer after each backward (as
NVIDIA's training loop does; DistributedDataParallel's hooks do not
serve R1's and path length's create_graph gradients). The path-length
mean, r_t and the mean w are reduced over all ranks, so every rank takes
the same Adam step and G_ema stays identical. Rank 0 writes the logs,
snapshots and training states; the others wait at a barrier.
"""

import copy
import glob
import json
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from ...parallel import mesh as pmesh
from ...utils.util_easydict import EasyDict
from ...utils.util_general import resolve_device
from . import checkpoint, networks
from .ada import AdaController, apply_ada, apply_ada_draws, draw_ada, pipe_config

TRAINING_STATE_FORMAT = 1


def train_config(**overrides):
    """Hyperparameters, defaulting to stylegan2-ada's 'auto' config (the
    JAX package's train_config)."""
    cfg = EasyDict(
        batch_size=32,
        lr=2.5e-3,
        beta1=0.0,
        beta2=0.99,
        eps=1e-8,
        r1_gamma=None,            # None -> 0.0002 * res^2 / batch (auto)
        pl_weight=2.0,
        pl_decay=0.01,
        pl_batch_shrink=2,
        g_reg_interval=4,
        d_reg_interval=16,
        style_mixing_prob=0.9,
        w_avg_beta=0.995,
        ema_kimg=10.0,
        ema_rampup=0.05,          # None disables the ramp-up
        aug='ada',                # 'ada' | 'noaug' | 'fixed'
        aug_pipe='bgc',
        ada_target=0.6,
        ada_interval=4,
        ada_kimg=500,
        aug_p=0.0,                # initial (or fixed) augmentation p
        noise_mode='random',
        remat=False,
        r1_chunks=1,              # R1 in sequential sub-batches (bounds its memory)
    )
    cfg.update(overrides)
    return cfg


def _adjusted_adam(params, lr, beta1, beta2, eps, reg_interval):
    """One Adam for the main and the regularisation phase of a network,
    with the interval-corrected lr and betas (the mb_ratio folding);
    the same update as optax.adam(eps_root=0)."""
    ratio = reg_interval / (reg_interval + 1.0)
    return torch.optim.Adam(params, lr=lr * ratio, betas=(beta1 ** ratio, beta2 ** ratio),
                            eps=eps)


def _grads(loss, module, rows=None):
    """d loss / d parameters of `module`, in `module.parameters()` order;
    zeros for a parameter the loss does not reach. Under data parallelism
    (`rows`) the ranks' gradients are summed in one flattened buffer."""
    params = list(module.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    if rows is None:
        return grads
    flat = rows.sum(torch.cat([g.reshape(-1) for g in grads]))
    return [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]


def _bmean(x, rows):
    """The mean of x over its batch (all entries); under data parallelism
    the rank's share of the global batch's mean."""
    return x.mean() if rows is None else x.sum() / (rows.n * (x.numel() // rows.n_local))


def _apply(opt, module, grads):
    for p, g in zip(module.parameters(), grads):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)


def make_train_fns(g_cfg, d_cfg, cfg, device='cuda', mesh=None):
    """The phase functions. Returns an EasyDict:

      init_state(seed) -> state (random G and D drawn from the seed)
      state_from_params(g_params, d_params, pl_mean=0.0) -> state
      g_main(state, z, z2, c, gen, p)       -> (state, logs)
      g_reg(state, z, z2, c, gen, p)        -> (state, logs)
      d_main(state, real, z, z2, c, gen, p) -> (state, logs)
      d_reg(state, real, c, gen, p)         -> (state, logs)
      ema(state, beta) -> state

    and the phase losses (loss_g_main, loss_g_pl, loss_d_main, loss_d_r1)
    and r1_value_and_grads, as the JAX trainer exposes them. `gen` is a
    torch.Generator on `device`, `p` the ADA probability (float or device
    scalar). `device` is 'cuda' unless the caller names the CPU.

    With `mesh` (a DeviceMesh), the phases take the global batch (real,
    z, z2, c) on every rank and compute this rank's rows of it; the loss
    functions then take this rank's rows and their `rows`.
    """
    cfg = EasyDict(cfg)
    if cfg.r1_gamma is None:
        cfg.r1_gamma = 0.0002 * (g_cfg.img_resolution ** 2) / cfg.batch_size
    dev = resolve_device(device)
    mesh = pmesh.check_mesh(mesh)
    if mesh is not None and int(cfg.r1_chunks) > 1:
        raise ValueError("r1_chunks > 1 under a mesh: each rank's R1 batch is already "
                         "its share of the global one")
    mbstd = d_cfg.mbstd_group_size
    aug_cfg = None if cfg.aug == 'noaug' else pipe_config(cfg.aug_pipe)
    num_ws = g_cfg.num_ws

    def _state(G, D, pl_mean=0.0):
        G, D = G.to(dev), D.to(dev)
        G_ema = copy.deepcopy(G).requires_grad_(False).eval()
        return EasyDict(
            G=G, D=D, G_ema=G_ema,
            opt_g=_adjusted_adam(G.parameters(), cfg.lr, cfg.beta1, cfg.beta2, cfg.eps,
                                 cfg.g_reg_interval),
            opt_d=_adjusted_adam(D.parameters(), cfg.lr, cfg.beta1, cfg.beta2, cfg.eps,
                                 cfg.d_reg_interval),
            pl_mean=torch.tensor(float(pl_mean), device=dev))

    def init_state(seed=0):
        return _state(networks.Generator(g_cfg, seed=seed),
                      networks.Discriminator(d_cfg, seed=seed + 1))

    def state_from_params(g_params, d_params, pl_mean=0.0):
        """State around numpy parameter trees (a native checkpoint's)."""
        G = networks.Generator(g_cfg)
        G.load_state_dict(checkpoint.params_to_state_dict(g_params))
        D = networks.Discriminator(d_cfg)
        D.load_state_dict(checkpoint.params_to_state_dict(d_params))
        return _state(G, D, pl_mean)

    def _maybe_aug(img, gen, p, rows=None):
        if aug_cfg is None:
            return img
        if rows is None:
            return apply_ada(img, gen, p, aug_cfg)
        # The global batch's draws, this rank's rows of them.
        draws = draw_ada(gen, (rows.n, *img.shape[1:]), p, aug_cfg)
        return apply_ada_draws(img, {k: tuple(rows.take(t) for t in v)
                                     for k, v in draws.items()}, aug_cfg)

    def _rows(n, group_size=1):
        return None if mesh is None else pmesh.shard_rows(n, mesh, group_size)

    def _map_mix(G, z, z2, c, gen, rows=None):
        """Mapping + batch-level style mixing -> (ws, the batch's mean w;
        under data parallelism this rank's share of it). One cutoff per
        batch, drawn on the device, as a num_ws mask."""
        w1 = G.mapping(z, c, broadcast=False)
        ws = w1[:, None, :].repeat(1, num_ws, 1)
        if cfg.style_mixing_prob > 0:
            w2 = G.mapping(z2, c, broadcast=False)
            cutoff = torch.randint(1, num_ws, [], generator=gen, device=dev)
            gate = torch.rand([], generator=gen, device=dev) < cfg.style_mixing_prob
            cutoff = torch.where(gate, cutoff, num_ws)
            mix = torch.arange(num_ws, device=dev)[None, :, None] >= cutoff
            ws = torch.where(mix, w2[:, None, :], ws)
        w1 = w1.detach()
        return ws, (w1.mean(dim=0) if rows is None else rows.mean(w1))

    def _synth(G, ws, gen, rows=None):
        return G.synthesis(ws, noise_mode=cfg.noise_mode,
                           generator=gen if cfg.noise_mode == 'random' else None,
                           remat=cfg.remat, rows=rows)

    # ---- phase losses ---------------------------------------------------
    # Under data parallelism (`rows`) z, z2, c, real are this rank's rows
    # and each mean is the rank's share of the global batch's.
    def loss_g_main(G, D, z, z2, c, gen, p, rows=None):
        """Non-saturating logistic G loss: E[softplus(-D(aug(G(z))))]."""
        ws, w_mean = _map_mix(G, z, z2, c, gen, rows)
        img = _synth(G, ws, gen, rows)
        logits = D(_maybe_aug(img, gen, p, rows), c, remat=cfg.remat, rows=rows)
        return _bmean(F.softplus(-logits), rows), w_mean

    def loss_g_pl(G, pl_mean, z, z2, c, gen, pl_noise=None, rows=None):
        """Path-length penalty (lazy: x g_reg_interval folded in).
        `pl_noise` (already divided by sqrt(H * W); the local rows under
        data parallelism) is drawn from `gen` when not given."""
        ws, _ = _map_mix(G, z, z2, c, gen, rows)
        img = _synth(G, ws, gen, rows)
        if pl_noise is None:
            draw = torch.randn if rows is None else rows.randn
            pl_noise = draw(img.shape, generator=gen, device=dev) \
                / np.sqrt(img.shape[2] * img.shape[3])
        pl_grads, = torch.autograd.grad((img * pl_noise).sum(), ws, create_graph=True)
        pl_lengths = pl_grads.square().sum(dim=2).mean(dim=1).sqrt()
        batch_mean = pl_lengths.detach().mean() if rows is None \
            else rows.sum(rows.mean(pl_lengths.detach()))
        new_pl_mean = pl_mean + cfg.pl_decay * (batch_mean - pl_mean)
        pl_penalty = (pl_lengths - new_pl_mean).square()
        loss = _bmean(pl_penalty, rows) * cfg.pl_weight * cfg.g_reg_interval
        return loss, (new_pl_mean, pl_lengths.detach())

    def loss_d_main(D, G, real, z, z2, c, gen, p, rows=None):
        """D logistic loss on fakes and reals (both through the ADA pipe);
        r_t = E[sign(D(real))] feeds the ADA controller."""
        with torch.no_grad():
            ws, _ = _map_mix(G, z, z2, c, gen, rows)
            img = _synth(G, ws, gen, rows)
        gen_logits = D(_maybe_aug(img, gen, p, rows), c, remat=cfg.remat, rows=rows)
        real_logits = D(_maybe_aug(real, gen, p, rows), c, remat=cfg.remat, rows=rows)
        loss_gen = _bmean(F.softplus(gen_logits), rows)
        loss_real = _bmean(F.softplus(-real_logits), rows)
        rt = _bmean(torch.sign(real_logits.detach()), rows)
        return loss_gen + loss_real, (loss_gen.detach(), loss_real.detach(), rt)

    def loss_d_r1(D, aug_real, c, rows=None):
        """R1 penalty on the (already augmented) reals (lazy: x
        d_reg_interval and gamma / 2 folded in) -> (loss, mean penalty)."""
        img = aug_real.detach().requires_grad_(True)
        logits = D(img, c, remat=cfg.remat, rows=rows)
        r1_grads, = torch.autograd.grad(logits.sum(), img, create_graph=True)
        penalty = _bmean(r1_grads.square().sum(dim=[1, 2, 3]), rows)
        loss = penalty * (cfg.r1_gamma / 2.0) * cfg.d_reg_interval
        return loss, penalty

    def r1_value_and_grads(D, aug_real, c, rows=None):
        """((loss, penalty), grads of D's parameters) of the R1 term, in
        cfg.r1_chunks sequential sub-batches when > 1: one sub-batch's
        double-backward graph at a time. The mean over equal chunks is the
        full batch's value, except that minibatch-stddev groups form
        within a chunk."""
        if rows is not None:
            (loss, penalty) = loss_d_r1(D, aug_real, c, rows)
            return (loss.detach(), penalty.detach()), _grads(loss, D, rows)
        n_chunks = int(cfg.r1_chunks)
        if aug_real.shape[0] % n_chunks != 0:
            raise ValueError(f"r1_chunks={n_chunks} must divide the R1 batch "
                             f"{aug_real.shape[0]}")
        cs = c.chunk(n_chunks) if c is not None else [None] * n_chunks
        loss = penalty = 0.0
        grads = None
        for x, cc in zip(aug_real.chunk(n_chunks), cs):
            l_k, p_k = loss_d_r1(D, x, cc)
            g_k = _grads(l_k, D)
            loss, penalty = loss + l_k.detach(), penalty + p_k.detach()
            grads = g_k if grads is None else [a + b for a, b in zip(grads, g_k)]
        if n_chunks > 1:
            loss, penalty = loss / n_chunks, penalty / n_chunks
            grads = [g / n_chunks for g in grads]
        return (loss, penalty), grads

    # ---- phases ---------------------------------------------------------
    # Each takes the global batch; under a mesh, this rank's rows of it.
    def _summed(logs, rows):
        """Logs of a phase: under a mesh, the ranks' shares summed (one
        all-reduce for all of them)."""
        if rows is None:
            return logs
        names = list(logs)
        vals = rows.sum(torch.stack([logs[k].float().reshape(()) for k in names]))
        return dict(zip(names, vals))

    def g_main(state, z, z2, c, gen, p):
        rows = _rows(z.shape[0], mbstd)
        if rows is not None:
            z, z2, c = rows.take(z), rows.take(z2), rows.take(c)
        loss, w_mean = loss_g_main(state.G, state.D, z, z2, c, gen, p, rows)
        _apply(state.opt_g, state.G, _grads(loss, state.G, rows))
        if rows is not None:
            w_mean = rows.sum(w_mean)
        with torch.no_grad():
            w_avg = state.G.mapping.w_avg
            w_avg.copy_(w_mean + (w_avg - w_mean) * cfg.w_avg_beta)
        return state, _summed({'Loss/G/loss': loss.detach()}, rows)

    def g_reg(state, z, z2, c, gen, p):
        del p  # path length never sees D or the augmentation pipe
        # The caller has already shrunk the batch (pl_batch_shrink).
        rows = _rows(z.shape[0])
        if rows is not None:
            z, z2, c = rows.take(z), rows.take(z2), rows.take(c)
        loss, (new_pl_mean, _) = loss_g_pl(state.G, state.pl_mean, z, z2, c, gen, rows=rows)
        _apply(state.opt_g, state.G, _grads(loss, state.G, rows))
        state.pl_mean = new_pl_mean.detach()
        return state, _summed({'Loss/pl_penalty': loss.detach()}, rows)

    def d_main(state, real, z, z2, c, gen, p):
        rows = _rows(z.shape[0], mbstd)
        if rows is not None:
            real, z, z2, c = rows.take(real), rows.take(z), rows.take(z2), rows.take(c)
        loss, (loss_gen, loss_real, rt) = loss_d_main(state.D, state.G, real, z, z2, c,
                                                      gen, p, rows)
        _apply(state.opt_d, state.D, _grads(loss, state.D, rows))
        return state, _summed({'Loss/D/gen': loss_gen, 'Loss/D/real': loss_real,
                               'Progress/rt': rt}, rows)

    def d_reg(state, real, c, gen, p):
        rows = _rows(real.shape[0], mbstd)
        if rows is not None:
            real, c = rows.take(real), rows.take(c)
        # R1 penalises D's gradient at the image D sees: the augmented
        # real, augmented outside the penalty's gradient.
        with torch.no_grad():
            aug_real = _maybe_aug(real, gen, p, rows)
        (loss, penalty), grads = r1_value_and_grads(state.D, aug_real, c, rows)
        _apply(state.opt_d, state.D, grads)
        return state, _summed({'Loss/r1_penalty': penalty, 'Loss/D/reg': loss}, rows)

    def ema(state, beta):
        """G_ema: parameters lerped toward G (ema = g + (ema - g) * beta),
        buffers copied."""
        with torch.no_grad():
            for e, g in zip(state.G_ema.parameters(), state.G.parameters()):
                e.copy_(torch.lerp(g, e, beta))
            for e, g in zip(state.G_ema.buffers(), state.G.buffers()):
                e.copy_(g)
        return state

    return EasyDict(cfg=cfg, device=dev, mesh=mesh, init_state=init_state,
                    state_from_params=state_from_params,
                    loss_g_main=loss_g_main, loss_g_pl=loss_g_pl,
                    loss_d_main=loss_d_main, loss_d_r1=loss_d_r1,
                    r1_value_and_grads=r1_value_and_grads, grads=_grads,
                    g_main=g_main, g_reg=g_reg, d_main=d_main, d_reg=d_reg, ema=ema)


class _PrefetchError:
    def __init__(self, exc):
        self.exc = exc


def prefetch_iter(it, depth=2):
    """Run `it` on a background daemon thread, keeping up to `depth` items
    ready, so that reading and decoding the next batch on the host
    overlaps the device's step. Exceptions re-raise at the consuming end."""
    import queue
    import threading

    q = queue.Queue(maxsize=depth)

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # re-raised by the consumer
            q.put(_PrefetchError(e))

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if isinstance(item, _PrefetchError):
            raise item.exc
        yield item


def _flush_ada(ada, pending, batch_size):
    """Feed the deferred per-step r_t values (device scalars) to the ADA
    controller, one host sync for the window, and clear the queue. p
    changes only at a tick, so the controller ends where eager per-step
    updates would have left it."""
    p = ada.p
    for rt in pending:
        p = ada.update(float(rt), batch_size)
    pending.clear()
    return p


def ema_beta(cfg, cur_nimg):
    """Per-step EMA decay: a half-life of ema_kimg kimg, limited to
    ema_rampup of the images seen so far early in training."""
    ema_nimg = cfg.ema_kimg * 1000.0
    if cfg.ema_rampup is not None:
        ema_nimg = min(ema_nimg, max(cur_nimg, 1) * cfg.ema_rampup)
    return float(0.5 ** (cfg.batch_size / max(ema_nimg, 1e-8)))


def _to_device(a, dev):
    """A host batch on `dev`; to the card from pinned memory without
    waiting for the device."""
    t = torch.as_tensor(a, dtype=torch.float32)
    if dev.type == 'cuda':
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def train_loop(g_cfg, d_cfg, data_iter, cfg, *, total_kimg=25000, run_dir=None, seed=0,
               snapshot_kimg=50, log_every=10, callbacks=None, state=None,
               on_snapshot=None, resume_state=None, keep_states=2, device='cuda', mesh=None):
    """Drive the phase schedule. `data_iter` yields (real images
    [B, C, H, W] float32 in [-1, 1], labels [B, c_dim] or None) on the host.

    Returns the final state. Writes log.jsonl, native checkpoints and
    training states to run_dir. `on_snapshot(path, state, cur_nimg)` runs
    after each checkpoint is written (the snapshot-time metrics ride it).
    `resume_state` (a path or load_training_state's dict) continues an
    interrupted run exactly: G, D, G_ema, both Adams, pl_mean, the
    counters, the device generator and the ADA controller are restored;
    only the data iterator starts again.

    Under a `mesh` every rank runs this loop on the same global batch
    stream (each rank's data_iter yields the same batches) and computes
    its rows; the state stays identical on every rank (rank 0's
    parameters are broadcast at the start). Rank 0 writes log.jsonl,
    snapshots and training states, and every rank waits for them at a
    barrier before `on_snapshot` runs or anyone reads them.
    """
    cfg = EasyDict(cfg)
    fns = make_train_fns(g_cfg, d_cfg, cfg, device=device, mesh=mesh)
    mesh = fns.mesh
    writer = mesh is None or pmesh.data_rank(mesh) == 0
    dev = fns.device
    data_iter = prefetch_iter(data_iter, depth=2)
    gen = torch.Generator(device=dev).manual_seed(seed)

    ada = None
    if cfg.aug == 'ada':
        ada = AdaController(target=cfg.ada_target, interval=cfg.ada_interval,
                            ada_kimg=cfg.ada_kimg, p_init=cfg.aug_p)
    p = float(cfg.aug_p)

    cur_nimg = 0
    step = 0
    if resume_state is not None:
        if state is not None:
            raise ValueError('pass either state or resume_state, not both')
        rs = resume_state if isinstance(resume_state, dict) \
            else load_training_state(resume_state)
        state = _state_from_training_state(fns, rs)
        gen.set_state(rs['gen_state'])
        cur_nimg, step, p = int(rs['cur_nimg']), int(rs['step']), float(rs['p'])
        if ada is not None and rs.get('ada') is not None:
            ada.load_state_dict(rs['ada'])
        saved_batch = int(rs['train_cfg'].get('batch_size', cfg.batch_size))
        if saved_batch != cfg.batch_size:
            print(f"[train] WARNING: resuming with batch_size={cfg.batch_size} != saved "
                  f"{saved_batch}; the continuation is no longer step-exact")
    if state is None:
        state = fns.init_state(seed)
    if mesh is not None:
        for name in ('G', 'D', 'G_ema'):
            pmesh.broadcast_module(state[name], mesh)

    log_path = os.path.join(run_dir, 'log.jsonl') if run_dir and writer else None
    if run_dir and writer:
        os.makedirs(run_dir, exist_ok=True)

    t_start = time.time()
    logs_acc = {}
    ada_pending = []  # per-step r_t device scalars not fetched yet
    p_host, p_dev = p, torch.tensor(p, device=dev)
    while cur_nimg < total_kimg * 1000:
        real, c = next(data_iter)
        real = _to_device(real, dev)
        c = None if c is None else _to_device(c, dev)
        z = torch.randn([cfg.batch_size, g_cfg.z_dim], generator=gen, device=dev)
        z2 = torch.randn([cfg.batch_size, g_cfg.z_dim], generator=gen, device=dev)
        if p != p_host:
            p_host, p_dev = p, torch.tensor(p, device=dev)

        state, lg = fns.g_main(state, z, z2, c, gen, p_dev)
        logs_acc.update(lg)
        if step % cfg.g_reg_interval == 0 and cfg.pl_weight > 0:
            nb = max(cfg.batch_size // cfg.pl_batch_shrink, 1)
            state, lg = fns.g_reg(state, z[:nb], z2[:nb], None if c is None else c[:nb],
                                  gen, p_dev)
            logs_acc.update(lg)
        state, lg = fns.d_main(state, real, z, z2, c, gen, p_dev)
        logs_acc.update(lg)
        if step % cfg.d_reg_interval == 0 and fns.cfg.r1_gamma != 0:
            state, lg = fns.d_reg(state, real, c, gen, p_dev)
            logs_acc.update(lg)
        state = fns.ema(state, ema_beta(cfg, cur_nimg))

        if ada is not None:
            # Fetch r_t from the device only when the controller ticks.
            ada_pending.append(logs_acc['Progress/rt'])
            if ada.will_tick(len(ada_pending)):
                p = _flush_ada(ada, ada_pending, cfg.batch_size)
        cur_nimg += cfg.batch_size
        step += 1

        if step % log_every == 0 or cur_nimg >= total_kimg * 1000:
            row = {k: float(v) for k, v in logs_acc.items()}
            row.update(step=step, kimg=cur_nimg / 1000.0, aug_p=p,
                       sec=round(time.time() - t_start, 3))
            if writer:
                print('[train] ' + json.dumps(row))
            if log_path:
                with open(log_path, 'a') as f:
                    f.write(json.dumps(row) + '\n')
            # A row reports only the phases that ran since the last one;
            # r_t stays, the ADA controller reads it every step.
            logs_acc = {'Progress/rt': logs_acc['Progress/rt']} \
                if 'Progress/rt' in logs_acc else {}
        if callbacks:
            for cb in callbacks:
                cb(step, cur_nimg, state, p)
        snap_interval = max(int(snapshot_kimg * 1000), cfg.batch_size) \
            if snapshot_kimg else 0
        if run_dir and snap_interval and (cur_nimg % snap_interval < cfg.batch_size
                                          or cur_nimg >= total_kimg * 1000):
            if ada is not None and ada_pending:
                # Mid-window snapshot: fold the deferred r_t values in, so
                # that the saved controller is the eager one at this step.
                p = _flush_ada(ada, ada_pending, cfg.batch_size)
            snap_path = snapshot_path(run_dir, cur_nimg)
            if writer:
                save_snapshot(run_dir, state, cur_nimg)
                save_training_state(run_dir, state, g_cfg=g_cfg, d_cfg=d_cfg, cfg=cfg,
                                    cur_nimg=cur_nimg, step=step, gen=gen, p=p, ada=ada,
                                    keep=keep_states)
            if mesh is not None:
                pmesh.barrier(mesh)  # rank 0's files exist before anyone reads them
            if on_snapshot is not None:
                on_snapshot(snap_path, state, cur_nimg)
    return state


def snapshot_path(run_dir, cur_nimg):
    return os.path.join(run_dir, f'network-snapshot-{int(cur_nimg // 1000):06d}.pkl')


def save_snapshot(run_dir, state, cur_nimg):
    """Native checkpoint of G_ema and D, which the port's policy and
    projector and the JAX package's loader read."""
    path = snapshot_path(run_dir, cur_nimg)
    checkpoint.save_checkpoint(path, G=state.G_ema, D=state.D)
    return path


def _cpu_state_dict(obj):
    return {k: v.detach().cpu() if torch.is_tensor(v) else v
            for k, v in obj.state_dict().items()}


def save_training_state(run_dir, state, *, g_cfg, d_cfg, cfg, cur_nimg, step, gen, p,
                        ada=None, keep=2):
    """Everything a network snapshot drops, so that a run continues
    exactly: raw G, D and G_ema, both Adams, pl_mean, the counters, the
    device generator's state and the ADA controller. Plain containers and
    tensors only (torch.save; read back with weights_only=True). Prunes
    to the newest `keep` files; named by images seen, so that snapshots
    closer than a kimg keep their own."""
    path = os.path.join(run_dir, f'training-state-{int(cur_nimg):09d}.pt')
    obj = dict(
        format_version=TRAINING_STATE_FORMAT,
        G=_cpu_state_dict(state.G), D=_cpu_state_dict(state.D),
        G_ema=_cpu_state_dict(state.G_ema),
        opt_g=state.opt_g.state_dict(), opt_d=state.opt_d.state_dict(),
        pl_mean=state.pl_mean.detach().cpu(),
        g_cfg=checkpoint._g_cfg_kwargs(g_cfg),
        d_cfg={k: d_cfg[k] for k in checkpoint._D_CFG_KEYS},
        train_cfg={k: (dict(v) if isinstance(v, dict) else v) for k, v in dict(cfg).items()},
        cur_nimg=int(cur_nimg), step=int(step), gen_state=gen.get_state(), p=float(p),
        ada=None if ada is None else ada.state_dict())
    tmp = f'{path}.tmp.{os.getpid()}'
    torch.save(obj, tmp)
    os.replace(tmp, path)
    if keep:
        for stale in sorted(glob.glob(os.path.join(run_dir, 'training-state-*.pt')))[:-int(keep)]:
            os.remove(stale)
    return path


def load_training_state(path):
    """Read a training state (save_training_state). `weights_only=True`
    admits tensors and plain containers only: a tampered file raises
    instead of running code."""
    obj = torch.load(path, map_location='cpu', weights_only=True)
    ver = obj.get('format_version') if isinstance(obj, dict) else None
    if ver != TRAINING_STATE_FORMAT:
        raise ValueError(f'unknown training-state format_version: {ver!r}')
    return obj


def _state_from_training_state(fns, rs):
    """The state of a saved run; a file saved under other network
    shapes raises (load_state_dict checks every key and shape)."""
    state = fns.init_state()
    for name in ('G', 'D', 'G_ema'):
        try:
            state[name].load_state_dict(rs[name])
        except RuntimeError as e:
            raise ValueError(f'training state {name} does not fit the configs: {e}') from e
    state.opt_g.load_state_dict(rs['opt_g'])
    state.opt_d.load_state_dict(rs['opt_d'])
    state.pl_mean = rs['pl_mean'].to(fns.device)
    return state
