"""Data parallelism of the port (parallel/mesh.py) over a 2-rank gloo
group on the CPU, against the 1-process port and the JAX package.

One module fixture writes the inputs (numpy weights from the JAX
package's inits, seeded batches, a policy workspace), starts two worker
processes of this file that form a gloo group and run `scenarios` with a
2-rank DeviceMesh, and meanwhile runs the same `scenarios` in this
process with no mesh, and the JAX package's functions on the same
inputs. Each check is its own test over the shared results:

  * the SG2 walk, unconditional and with c_dim 3, and the SG3-T walk
    (make_walk_fns(...).walk with this rank's rows), the walk through the
    policy with --n_mesh_devices 2, and forward_ganrand;
  * the minibatch-stddev grouping: D over a batch whose ranks each hold
    two groups equals the 1-process D, where a contiguous split does not;
    where whole groups do not fit a rank (batch 4 on 2 ranks, 8 on 4), D
    gathers its epilogue input: the walk at 2 ranks x batch 4 and at 4
    ranks x batch 8, D itself, and a Dr1 step (R1 differentiates through
    the gather twice) against one process;
  * the projector; the trainer's four phase losses and gradients, one
    step of each phase (replicas bit-equal after it) and train_loop's
    resume under the mesh;
  * the detector, the live generator's feature statistics, the PR
    distance tiles, psum_moments and check_replica_consistency; FID of the
    live generator over 3 ranks, whose batch of 4 is padded to 6.

A second group of 4 worker processes (started after the first has
finished) runs `scenarios4`: the walk at batch 8 over 4 ranks, and the
generator's FID over a mesh of 3 of them.

Tolerances (ROADMAP section 3): walked w atol 1e-3, images rtol 1e-4,
trainer losses rtol 1e-5 and gradients rtol 2e-3 / atol 2e-5 between the
2-rank and the 1-process port; detector features rtol 2e-4, distance
tiles 1e-5. Against the JAX package the composed programs keep the
tolerances of the files that hold the 1-process port to it (losses
rtol 1e-4).

Run as a worker: python tests/test_torch_port_parallel.py RANK PORT DIR [WORLD]
"""

import os
import pickle
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORLD = 2
B = 8                                   # the walk's and trainer's global batch: 2 ranks x 1 group of 4
RES, CROP, K, W_DIM = 32, 16, 3, 64
WALK_W = dict(w_lpips=10.0, w_pix=0.1, w_latent=0.001, w_disc=0.05)
SG3 = dict(img_resolution=64, img_channels=2, num_layers=2, channel_base=1024, channel_max=32,
           z_dim=32, w_dim=32, num_critical=1, num_fp16_res=0)
TRAIN_NET = dict(img_resolution=16, img_channels=2, channel_base=256, channel_max=32)
STEPS = 5
PROJ_W_ATOL = 1e-2
W_ATOL, IMG_RTOL, LOSS_RTOL = 1e-3, 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-5
FEAT_RTOL, DIST_TOL = 2e-4, 1e-5


# ----------------------------------------------------------------------------
# Inputs (written by the parent with the JAX package's inits) and the
# scenarios, run alike with no mesh and with the 2-rank mesh.


def _inputs(tmp):
    """Seeded weights (the port's inits, as numpy trees in the JAX
    package's layout) and batches for every scenario -> inputs.pkl."""
    import jax

    from latentaugment_tpu_torch.models import inception, vgg
    from latentaugment_tpu_torch.models.stylegan2 import checkpoint, networks
    from latentaugment_tpu_torch.models.stylegan3 import networks as net3

    def tree(module):
        return checkpoint.state_dict_to_params(module.state_dict())

    rng = np.random.RandomState(11)
    inp = {}
    for c_dim in (0, 3):
        cfg = dict(img_resolution=RES, img_channels=2, channel_base=1024, channel_max=64,
                   c_dim=c_dim)
        G = networks.Generator(networks.generator_config(z_dim=W_DIM, w_dim=W_DIM,
                                                         num_mapping_layers=2, **cfg), seed=7)
        g = tree(G)
        for block in g["synthesis"].values():
            for conv in ("conv0", "conv1"):
                if isinstance(block, dict) and conv in block:
                    block[conv]["noise_strength"] = np.float32(0.2).reshape(())
        d = tree(networks.Discriminator(networks.discriminator_config(**cfg), seed=8))
        inp[f"sg2_{c_dim}"] = dict(g=g, d=d, cfg=cfg)
    inp["sg3"] = dict(g=tree(net3.Generator(net3.generator_config(**SG3), seed=9)),
                      d=tree(networks.Discriminator(networks.discriminator_config(
                          img_resolution=64, img_channels=2, channel_base=1024,
                          channel_max=32), seed=10)))
    inp["vgg"] = vgg.params_to_numpy(vgg.init_vgg(3))
    inp["vgg"]["lin"] = {k: rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
                         for k, v in inp["vgg"]["lin"].items()}
    inp["inception"] = vgg.params_to_numpy(inception.init_inception(4))
    num_ws3 = net3.generator_config(**SG3).num_ws
    inp["W"] = rng.randn(6, 8, W_DIM).astype(np.float32) * 0.5
    inp["W3"] = rng.randn(6, num_ws3, 32).astype(np.float32) * 0.5
    inp["X"] = rng.uniform(-1, 1, (6, 2, RES, RES)).astype(np.float32)
    inp["X3"] = rng.uniform(-1, 1, (6, 2, 64, 64)).astype(np.float32)
    inp["feas"] = [rng.randn(6, 31232).astype(np.float32) * 0.02 for _ in range(2)]
    inp["w0"] = rng.randn(B, 1, W_DIM).astype(np.float32) * 0.5
    inp["w03"] = rng.randn(B, 1, 32).astype(np.float32) * 0.5
    inp["c"] = np.eye(3, dtype=np.float32)[rng.randint(0, 3, B)]
    inp["z"] = rng.randn(B, W_DIM).astype(np.float32)
    # Per-sample scales that differ across minibatch-stddev groups.
    inp["d_batch"] = (rng.uniform(-1, 1, (16, 2, RES, RES))
                      * rng.uniform(0.05, 3.0, (16, 1, 1, 1))).astype(np.float32)
    inp["target"] = rng.uniform(-1, 1, (4, 2, RES, RES)).astype(np.float32)
    t_cfg = dict(z_dim=32, w_dim=32, num_mapping_layers=2, **TRAIN_NET)
    inp["train"] = dict(
        g=tree(networks.Generator(networks.generator_config(**t_cfg), seed=12)),
        d=tree(networks.Discriminator(networks.discriminator_config(**TRAIN_NET), seed=13)),
        z=rng.randn(B, 32).astype(np.float32), z2=rng.randn(B, 32).astype(np.float32),
        real=rng.uniform(-1, 1, (B, 2, 16, 16)).astype(np.float32),
        # The path-length noise the JAX trainer draws from its key k[3].
        pl_noise=np.asarray(jax.random.normal(jax.random.split(jax.random.PRNGKey(0), 4)[3],
                                              (B // 2, 2, 16, 16)), np.float32) / 16.0)
    inp["images"] = rng.uniform(-1, 1, (5, 3, 32, 32)).astype(np.float32) * 127.5 + 128.0
    inp["feat_rows"] = rng.randn(13, 64).astype(np.float32)
    inp["feat_cols"] = rng.randn(27, 64).astype(np.float32)
    inp["moments"] = rng.randn(WORLD, 7, 3).astype(np.float32)
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    return inp


def _walk_bundle(inp, key, arch="stylegan2"):
    from latentaugment_tpu_torch.augments import engine, losses, manifold
    from latentaugment_tpu_torch.models import vgg
    from latentaugment_tpu_torch.models.stylegan2 import checkpoint, networks
    from latentaugment_tpu_torch.models.stylegan3 import networks as net3

    t = torch.from_numpy
    if arch == "stylegan3":
        G = net3.Generator(net3.generator_config(**SG3))
        D = networks.Discriminator(networks.discriminator_config(
            img_resolution=64, img_channels=2, channel_base=1024, channel_max=32))
        W, X, res = inp["W3"], inp["X3"], 64
    else:
        cfg = inp[key]["cfg"]
        G = networks.Generator(networks.generator_config(z_dim=W_DIM, w_dim=W_DIM,
                                                         num_mapping_layers=2, **cfg))
        D = networks.Discriminator(networks.discriminator_config(**cfg))
        W, X, res = inp["W"], inp["X"], RES
    G.load_state_dict(checkpoint.params_to_state_dict(inp[key]["g"]))
    D.load_state_dict(checkpoint.params_to_state_dict(inp[key]["d"]))
    G.requires_grad_(False)
    D.requires_grad_(False)
    lpips = key == "sg2_0"  # the VGG16 term in one walk keeps the JAX side's compiles short
    bundle = engine.make_bundle(
        G, D, vgg.params_from_numpy(inp["vgg"]) if lpips else None,
        W_summary=losses.manifold_summary(t(W)),
        X_cc_summaries=[losses.manifold_summary(manifold.center_crop(t(X), res)[:, m:m + 1])
                        for m in range(2)],
        fea_summaries=[losses.manifold_summary(t(f)) for f in inp["feas"]] if lpips else None)
    weights = dict(WALK_W, w_lpips=WALK_W["w_lpips"] if lpips else 0.0)
    fns = engine.make_walk_fns(G.cfg, n_modes=2, num_epochs=K, crop_size=CROP, **weights)
    return fns, bundle, G, D


def _walk(inp, mesh, key, arch="stylegan2", c=None, n=B):
    """The walk of the first n rows of w0."""
    from latentaugment_tpu_torch.parallel import mesh as pmesh

    fns, bundle, G, D = _walk_bundle(inp, key, arch)
    w0 = torch.from_numpy(inp["w03" if arch == "stylegan3" else "w0"])[:n]
    c = None if c is None else torch.from_numpy(c)[:n]
    gen = torch.Generator().manual_seed(5)
    if mesh is None:
        img, ws, traces = fns.walk(bundle, w0, (2, 4), gen, c)
    else:
        rows = pmesh.shard_rows(n, mesh, D.cfg.mbstd_group_size)
        img, ws, traces = fns.walk(bundle, rows.take(w0), (2, 4), gen, rows.take(c), rows)
        img, ws = rows.gather(img), rows.gather(ws)
    return dict(img=img.numpy(), ws=ws.numpy(),
                traces={k: v.numpy() for k, v in traces.items()})


def _ganrand(inp, mesh, hybrid=False):
    from latentaugment_tpu_torch.parallel import mesh as pmesh

    fns, bundle, G, _ = _walk_bundle(inp, "sg2_0")
    z = torch.from_numpy(inp["z"])
    gen = torch.Generator().manual_seed(6)
    if mesh is None:
        img, ws = fns.ganrand(bundle, z, gen)
    else:
        if hybrid:  # the ('dcn', 'data') mesh: the batch over both axes
            mesh = pmesh.get_hybrid_mesh(WORLD, devices="cpu")
            assert mesh.mesh_dim_names == ("dcn", "data") and tuple(mesh.mesh.shape) == (2, 1)
        rows = pmesh.shard_rows(B, mesh)
        img, ws = fns.ganrand(bundle, rows.take(z), gen, rows=rows)
        img, ws = rows.gather(img), rows.gather(ws)
    return dict(img=img.numpy(), ws=ws.numpy())


def _mbstd(inp, mesh):
    """D over 16 images (4 groups of 4): the rows of shard_rows, and a
    contiguous split for contrast; D over the first 4 (one group, split
    over the ranks: D gathers its epilogue input), with the gradient at
    its input."""
    from latentaugment_tpu_torch.parallel import mesh as pmesh

    _, _, _, D = _walk_bundle(inp, "sg2_0")
    x = torch.from_numpy(inp["d_batch"])
    r4 = None if mesh is None else pmesh.shard_rows(4, mesh, D.cfg.mbstd_group_size)
    take = (lambda t: t) if r4 is None else r4.take
    x4 = take(x[:4]).requires_grad_(True)
    y4 = D(x4, rows=r4)
    dx4, = torch.autograd.grad((y4 * take(torch.arange(1.0, 5.0)[:, None])).sum(), x4)
    out = dict(logits4=y4.detach(), dx4=dx4)
    if r4 is not None:
        out = dict(logits4=r4.gather(out["logits4"]), dx4=r4.gather(dx4),
                   holds4=r4.holds_groups(D.cfg.mbstd_group_size))
    out = {k: v.numpy() if isinstance(v, torch.Tensor) else v for k, v in out.items()}
    with torch.no_grad():
        if mesh is None:
            return dict(out, logits=D(x).numpy())
        rows = pmesh.shard_rows(16, mesh, D.cfg.mbstd_group_size)
        r = pmesh.data_rank(mesh)
        contiguous = torch.cat(pmesh.all_gather(D(x[r * 8:(r + 1) * 8]), mesh))
        return dict(out, logits=rows.gather(D(rows.take(x), rows=rows)).numpy(),
                    local_rows=rows.index.numpy(), contiguous=contiguous.numpy(),
                    holds=rows.holds_groups(D.cfg.mbstd_group_size))


def _project(inp, mesh, noise):
    from latentaugment_tpu_torch.models import vgg
    from latentaugment_tpu_torch.models.stylegan2 import projector
    from latentaugment_tpu_torch.parallel import mesh as pmesh

    _, _, G, _ = _walk_bundle(inp, "sg2_0")
    vgg_params = vgg.params_from_numpy(inp["vgg"])
    w_avg, w_std = _w_stats(inp)
    fn = projector.make_project_fn(G.cfg, num_steps=STEPS, pix_weight=0.5,
                                   initial_noise_factor=0.05 if noise else 0.0)
    target = torch.from_numpy(inp["target"])
    gen = torch.Generator().manual_seed(7)
    if mesh is None:
        w, d = fn(G, vgg_params, target, w_avg, w_std, gen)
    else:
        rows = pmesh.shard_rows(4, mesh)
        w, d = fn(G, vgg_params, rows.take(target), w_avg, w_std, gen, rows)
        w = rows.gather(w)
    return dict(w=w.numpy(), dists=d.numpy(), w_avg=w_avg.numpy(), w_std=float(w_std))


def _w_stats(inp):
    """The projector's start (w_avg, w_std) over the fixed z."""
    from latentaugment_tpu_torch.models.stylegan2 import projector

    _, _, G, _ = _walk_bundle(inp, "sg2_0")
    return projector.w_stats_from_z(G, torch.from_numpy(inp["z"]))


def _train_fns(inp, mesh, **kw):
    from latentaugment_tpu_torch.models.stylegan2 import networks, train

    g_cfg = networks.generator_config(z_dim=32, w_dim=32, num_mapping_layers=2, **TRAIN_NET)
    d_cfg = networks.discriminator_config(**TRAIN_NET)
    cfg = dict(batch_size=B, r1_gamma=2.5, ema_rampup=None, pl_batch_shrink=2)
    cfg.update(kw)
    fns = train.make_train_fns(g_cfg, d_cfg, train.train_config(**cfg), device="cpu",
                               mesh=mesh)
    return fns, fns.state_from_params(inp["train"]["g"], inp["train"]["d"], pl_mean=0.3)


# The JAX comparison: const noise, no augmentation, no style mixing.
JAX_TRAIN = dict(noise_mode="const", aug="noaug", style_mixing_prob=0.0)
# The 1-process comparison: every random draw on.
RANDOM_TRAIN = dict(noise_mode="random", aug="ada", aug_p=0.6, style_mixing_prob=0.9)


def _phase_values(inp, mesh, kw, pl_noise):
    """{phase: (loss, aux, {param: grad})} of the four phase losses."""
    from latentaugment_tpu_torch.parallel import mesh as pmesh

    tr = inp["train"]
    fns, state = _train_fns(inp, mesh, **kw)
    t = torch.from_numpy
    z, z2, real = t(tr["z"]), t(tr["z2"]), t(tr["real"])
    nb = B // 2
    rows = rows_pl = None
    if mesh is not None:
        rows = pmesh.shard_rows(B, mesh, state.D.cfg.mbstd_group_size)
        rows_pl = pmesh.shard_rows(nb, mesh)
    take = (lambda r, x: x) if mesh is None else (lambda r, x: r.take(x))
    p = torch.tensor(0.6)
    out = {}
    gen = torch.Generator().manual_seed(8)
    loss, aux = fns.loss_g_main(state.G, state.D, take(rows, z), take(rows, z2), None, gen, p,
                                rows)
    out["g_main"] = (loss, rows.sum(aux) if rows is not None else aux, state.G)
    noise = t(tr["pl_noise"]) if pl_noise else None
    loss, aux = fns.loss_g_pl(state.G, torch.tensor(0.3), take(rows_pl, z[:nb]),
                              take(rows_pl, z2[:nb]), None, gen,
                              pl_noise=None if noise is None else take(rows_pl, noise),
                              rows=rows_pl)
    aux = (aux[0], aux[1] if rows_pl is None else rows_pl.gather(aux[1]))
    out["g_pl"] = (loss, aux, state.G)
    loss, aux = fns.loss_d_main(state.D, state.G, take(rows, real), take(rows, z),
                                take(rows, z2), None, gen, p, rows)
    aux = aux if rows is None else tuple(rows.sum(a) for a in aux)
    out["d_main"] = (loss, aux, state.D)
    loss, aux = fns.loss_d_r1(state.D, take(rows, real), None, rows)
    out["d_r1"] = (loss, aux if rows is None else rows.sum(aux), state.D)
    res = {}
    for phase, (loss, aux, module) in out.items():
        r = rows_pl if phase == "g_pl" else rows
        grads = fns.grads(loss, module, r)
        names = [n for n, _ in module.named_parameters()]
        total = loss.detach() if r is None else r.sum(loss.detach())
        res[phase] = (float(total), [np.asarray(a.detach()) for a in
                                     (aux if isinstance(aux, tuple) else (aux,))],
                      {n: g.numpy() for n, g in zip(names, grads)})
    return res


def _r1_b4(inp, mesh):
    """Dr1 (loss, penalty and every D gradient) at batch 4: one
    minibatch-stddev group, split over the ranks."""
    from latentaugment_tpu_torch.parallel import mesh as pmesh

    fns, state = _train_fns(inp, mesh, **JAX_TRAIN)
    real = torch.from_numpy(inp["train"]["real"][:4])
    rows = None if mesh is None else pmesh.shard_rows(4, mesh, state.D.cfg.mbstd_group_size)
    loss, penalty = fns.loss_d_r1(state.D, real if rows is None else rows.take(real), None,
                                  rows)
    grads = fns.grads(loss, state.D, rows)
    loss, penalty = loss.detach(), penalty.detach()
    if rows is not None:
        loss, penalty = rows.sum(loss), rows.sum(penalty)
    names = [n for n, _ in state.D.named_parameters()]
    return dict(loss=float(loss), penalty=float(penalty),
                grads={n: g.numpy() for n, g in zip(names, grads)})


def _gen_fid(inp, mesh):
    """FID of the live generator's samples (8 at batch_gen 4: padded to a
    multiple of the ranks) against fixed real moments, on a 16-feature
    probe detector (a fixed projection of the first modality's pixels),
    which keeps the matrix root small."""
    from latentaugment_tpu_torch.metrics import frechet_inception_distance as fid_t
    from latentaugment_tpu_torch.metrics import metric_utils

    proj = torch.from_numpy(np.random.RandomState(4).randn(3 * RES * RES, 16)
                            .astype(np.float32) / RES)
    metric_utils._feature_detector_cache[("fid-probe", "cpu")] = metric_utils._Detector(
        lambda p, x: (x / 255.0).reshape(x.shape[0], -1) @ p, proj)
    _, _, G, _ = _walk_bundle(inp, "sg2_0")
    opts = metric_utils.MetricOptions(G=G, G_kwargs=dict(seed=5), device="cpu", mesh=mesh,
                                      mode_dict=dict(mode_name="MR_nonrigid_CT", mode_idx=0))
    stats = metric_utils.compute_feature_stats_for_generator(
        opts, "https://x/fid-probe.pkl", capture_all=True, capture_mean_cov=True, max_items=8,
        batch_gen=4)
    mu, sigma = stats.get_mean_cov()
    real = np.random.RandomState(6).randn(40, 16)
    fid = fid_t.fid_from_moments(real.mean(0), np.cov(real, rowvar=False), mu, sigma)
    return dict(fid=fid, feats=stats.get_all())


def _train_steps(inp, mesh):
    """One step of each phase function (the random draws on); logs and
    the state after each, and whether the replicas agreed."""
    from latentaugment_tpu_torch.utils.util_misc import check_replica_consistency

    tr = inp["train"]
    fns, state = _train_fns(inp, mesh, **RANDOM_TRAIN)
    t = torch.from_numpy
    z, z2, real = t(tr["z"]), t(tr["z2"]), t(tr["real"])
    gen = torch.Generator().manual_seed(9)
    p = torch.tensor(0.6)
    logs = {}
    for phase in ("g_main", "g_reg", "d_main", "d_reg"):
        if phase == "g_reg":
            state, lg = fns.g_reg(state, z[:B // 2], z2[:B // 2], None, gen, p)
        elif phase == "g_main":
            state, lg = fns.g_main(state, z, z2, None, gen, p)
        elif phase == "d_main":
            state, lg = fns.d_main(state, real, z, z2, None, gen, p)
        else:
            state, lg = fns.d_reg(state, real, None, gen, p)
        state = fns.ema(state, 0.9)
        for name in ("G", "D", "G_ema"):
            check_replica_consistency(state[name], mesh)
        logs[phase] = {k: float(v) for k, v in lg.items()}
    params = {f"{name}.{k}": v.detach().numpy().copy() for name in ("G", "D", "G_ema")
              for k, v in state[name].state_dict().items()}
    return dict(logs=logs, params=params, pl_mean=float(state.pl_mean))


def _resume(inp, mesh, run_root):
    """train_loop under the mesh: 2 steps straight, and 1 step, a
    snapshot, then 1 more step resumed from its training state."""
    import glob

    from latentaugment_tpu_torch.models.stylegan2 import networks, train

    g_cfg = networks.generator_config(z_dim=16, w_dim=16, num_mapping_layers=2,
                                      **dict(TRAIN_NET, channel_max=16))
    d_cfg = networks.discriminator_config(**dict(TRAIN_NET, channel_max=16))
    cfg = train.train_config(batch_size=B, aug="ada", aug_pipe="bgc", ada_interval=1,
                             ada_kimg=0.01, noise_mode="random")

    def data_iter(start=0):
        i = start
        while True:
            yield np.random.RandomState(2000 + i).rand(B, 2, 16, 16).astype(np.float32) * 2 - 1, \
                None
            i += 1

    kw = dict(log_every=100, device="cpu", mesh=mesh)
    ref = train.train_loop(g_cfg, d_cfg, data_iter(), cfg, total_kimg=0.016,
                           run_dir=os.path.join(run_root, "a"), snapshot_kimg=0, seed=11, **kw)
    run_b = os.path.join(run_root, "b")
    train.train_loop(g_cfg, d_cfg, data_iter(), cfg, total_kimg=0.008, run_dir=run_b,
                     snapshot_kimg=0.008, seed=11, **kw)
    states = sorted(glob.glob(os.path.join(run_b, "training-state-*.pt")))
    out = train.train_loop(g_cfg, d_cfg, data_iter(1), cfg, total_kimg=0.016, run_dir=run_b,
                           snapshot_kimg=0, seed=999, resume_state=states[-1], **kw)
    return dict(equal=all(torch.equal(a, b) for name in ("G", "D", "G_ema")
                          for a, b in zip(ref[name].state_dict().values(),
                                          out[name].state_dict().values())),
                n_states=len(states),
                files=sorted(os.listdir(run_b)))


def _metrics(inp, mesh):
    from latentaugment_tpu_torch.metrics import metric_utils, precision_recall
    from latentaugment_tpu_torch.models import inception, vgg
    from latentaugment_tpu_torch.parallel import stats

    params = vgg.params_from_numpy(inp["inception"])
    x = torch.from_numpy(inp["images"])
    with torch.no_grad():
        feats = metric_utils.detect(lambda v: inception.inception_features(params, v), x, mesh)
    d = precision_recall.compute_distances(inp["feat_rows"], inp["feat_cols"],
                                           col_batch_size=10, device="cpu", mesh=mesh)
    pr = precision_recall.knn_precision_recall(inp["feat_rows"], inp["feat_cols"],
                                               nhood_size=3, row_batch_size=5,
                                               col_batch_size=10, device="cpu", mesh=mesh)
    # psum_moments: each rank's own values, reduced; without a mesh, all.
    if mesh is None:
        m = stats.moments(torch.from_numpy(inp["moments"]))
    else:
        from latentaugment_tpu_torch.parallel import mesh as pmesh

        r = pmesh.data_rank(mesh)
        m = stats.psum_moments(stats.moments(torch.from_numpy(inp["moments"][r])), mesh)
    # The live generator's feature statistics (z and noise of every batch
    # drawn whole, each rank rendering its rows).
    _, _, G, _ = _walk_bundle(inp, "sg2_0")
    opts = metric_utils.MetricOptions(G=G, G_kwargs=dict(seed=3), device="cpu", mesh=mesh,
                                      mode_dict=dict(mode_name="MR_nonrigid_CT", mode_idx=0))
    metric_utils._feature_detector_cache[("inception-2015-12-05", "cpu")] = \
        metric_utils._Detector(inception.inception_features, params)
    gstats = metric_utils.compute_feature_stats_for_generator(
        opts, "https://x/inception-2015-12-05.pkl", capture_all=True, max_items=4,
        batch_gen=2)
    return dict(feats=feats.numpy(), dists=d, pr=np.array(pr), moments=m.numpy(),
                gen_feats=gstats.get_all())


def _replicas(inp, mesh):
    """check_replica_consistency: passes on equal replicas; a parameter
    one rank moved by one float32 step is found by every rank."""
    from latentaugment_tpu_torch.parallel import mesh as pmesh
    from latentaugment_tpu_torch.utils.util_misc import check_replica_consistency

    _, _, G, _ = _walk_bundle(inp, "sg2_0")
    check_replica_consistency(G, mesh)
    if mesh is None:
        return dict(caught="")
    if pmesh.data_rank(mesh) == 1:
        with torch.no_grad():
            w = G.mapping.fc0.weight
            w[0, 0] = torch.nextafter(w[0, 0], torch.tensor(1e9))
    try:
        check_replica_consistency(G, mesh)
    except RuntimeError as e:
        return dict(caught=str(e))
    return dict(caught="")


def _policy(ws_root, mesh):
    """The policy with --n_mesh_devices over a workspace: 2 batches (the
    second partial)."""
    from latentaugment_tpu_torch.augments import create_augment
    from latentaugment_tpu_torch.data import create_dataset
    from latentaugment_tpu_torch.options import AugOptions

    with open(os.path.join(ws_root, "argv.pkl"), "rb") as f:
        argv = pickle.load(f)
    extra = ["--device", "cpu"] + (["--n_mesh_devices", str(WORLD)] if mesh is not None else [])
    opt = AugOptions().parse(argv=argv + extra, install_logger=False)
    augment = create_augment(opt)
    out = []
    for data in create_dataset(opt):
        augment.set_input(data)
        augment.forward()
        o = augment.get_output()
        out.append(dict(A=o["A"], B=o["B"], w=augment.get_latent_output()["w"]))
    return out


def scenarios(inp, mesh, tmp):
    out = {}
    out["walk_uncond"] = _walk(inp, mesh, "sg2_0")
    out["walk_cond"] = _walk(inp, mesh, "sg2_3", c=inp["c"])
    out["walk_sg3"] = _walk(inp, mesh, "sg3", arch="stylegan3")
    out["walk_b4"] = _walk(inp, mesh, "sg2_0", n=4)
    out["r1_b4"] = _r1_b4(inp, mesh)
    out["gen_fid"] = _gen_fid(inp, mesh)
    out["ganrand"] = _ganrand(inp, mesh)
    out["ganrand_hybrid"] = _ganrand(inp, mesh, hybrid=True)
    out["mbstd"] = _mbstd(inp, mesh)
    out["project"] = _project(inp, mesh, noise=False)
    out["project_noise"] = _project(inp, mesh, noise=True)
    out["phases_jax"] = _phase_values(inp, mesh, JAX_TRAIN, pl_noise=True)
    out["phases_random"] = _phase_values(inp, mesh, RANDOM_TRAIN, pl_noise=False)
    out["train_steps"] = _train_steps(inp, mesh)
    out["metrics"] = _metrics(inp, mesh)
    out["replicas"] = _replicas(inp, mesh)
    root = os.path.join(tmp, "mesh" if mesh is not None else "single")
    out["resume"] = _resume(inp, mesh, os.path.join(root, "runs"))
    out["policy"] = _policy(os.path.join(root, "ws"), mesh)
    return out


WORLD4 = 4


def scenarios4(inp, mesh):
    """On a group of 4: the walk at batch 8 (2 rows a rank: D gathers),
    and FID over a mesh of ranks 0-2 (rank 3 has no rows)."""
    from torch.distributed.device_mesh import DeviceMesh

    from latentaugment_tpu_torch.parallel import mesh as pmesh

    out = dict(walk_b8=_walk(inp, mesh, "sg2_0"),
               rows_8=pmesh.shard_rows(8, mesh, 4).index.numpy())
    try:
        pmesh.shard_rows(6, mesh, 4)
    except ValueError as e:
        out["refused_6"] = str(e)
    mesh3 = DeviceMesh("cpu", [0, 1, 2], mesh_dim_names=("data",))
    if torch.distributed.get_rank() < 3:
        out["gen_fid3"] = _gen_fid(inp, mesh3)
    return out


def _worker(rank, port, tmp, world=WORLD):
    torch.set_num_threads(1)
    from latentaugment_tpu_torch.parallel import mesh as pmesh

    pmesh.init_distributed(f"localhost:{port}", world, rank, backend="gloo")
    mesh = pmesh.get_mesh(world, devices="cpu")
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = scenarios(inp, mesh, tmp) if world == WORLD else scenarios4(inp, mesh)
    with open(os.path.join(tmp, f"rank{rank}_of{world}.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    sys.path[:0] = [REPO, HERE]
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
            int(sys.argv[4]) if len(sys.argv) > 4 else WORLD)
    sys.exit(0)

# ----------------------------------------------------------------------------
# The tests (the parent side imports JAX).

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_port_common import _one_torch_thread  # noqa: E402,F401 (autouse fixture)


def _workspace(root):
    from latentaugment_tpu_torch import benchmark

    argv = benchmark.build_policy_workspace(
        root, res=RES, batch_size=B, num_epochs=2, crop_size=CROP, channel_base=256,
        channel_max=32, n_patients=2, slices_per_patient=6, step=3)
    with open(os.path.join(root, "argv.pkl"), "wb") as f:
        pickle.dump(argv, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from latentaugment_tpu_torch.parallel import mesh as pmesh

    tmp = str(tmp_path_factory.mktemp("parallel"))
    inp = _inputs(tmp)
    inp["w_stats"] = tuple(v.numpy() for v in _w_stats(inp))
    _workspace(os.path.join(tmp, "single", "ws"))
    shutil.copytree(os.path.join(tmp, "single", "ws"), os.path.join(tmp, "mesh", "ws"))
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(PYTHONPATH=REPO + os.pathsep + HERE, OMP_NUM_THREADS="1")

    def start_group(world):
        port = pmesh.free_port()
        return [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(port),
                                  tmp, str(world)], cwd=tmp, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True) for r in range(world)]

    procs = start_group(WORLD)

    # The JAX side (mostly XLA compiles) in a thread beside the 1-process run.
    box = {}

    def jax_job():
        try:
            box["out"] = _jax_side(inp)
        except BaseException as e:  # re-raised below
            box["err"] = e

    thread = threading.Thread(target=jax_job)
    thread.start()
    try:
        single = scenarios(inp, None, tmp)
        thread.join(timeout=600)
        assert not thread.is_alive(), "the JAX side did not finish"
        if "err" in box:
            raise box["err"]
        jax_out = box["out"]
        logs = [p.communicate(timeout=600)[0] for p in procs]
        # The group of 4, after the first has finished.
        procs += start_group(WORLD4)
        logs += [p.communicate(timeout=600)[0] for p in procs[WORLD:]]
        # The trainer's command line with --n_devices 2 and no process
        # group: it starts its two ranks itself (after the workers, so that
        # this fixture keeps few cores busy at a time).
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "scripts", "torch_train_sg2.py"), "--synthetic",
             "--device", "cpu", "--n_devices", str(WORLD), "--batch", str(B), "--kimg", "0.016",
             "--snap", "0.008", "--outdir", os.path.join(tmp, "cli_run")],
            cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs.append(procs[-1].communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"process {r} failed:\n{log[-6000:]}"
    ranks = {}
    for world in (WORLD, WORLD4):
        ranks[world] = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}_of{world}.pkl"), "rb") as f:
                ranks[world].append(pickle.load(f))
    return dict(inp=inp, single=single, mesh=ranks[WORLD][0], ranks=ranks[WORLD],
                ranks4=ranks[WORLD4], jax=jax_out,
                cli_run=os.path.join(tmp, "cli_run"), cli_log=logs[-1])


def _jax_side(inp):
    """The JAX package's results on the same inputs."""
    from latentaugment_tpu.augments import engine as engine_j
    from latentaugment_tpu.augments import losses as losses_j
    from latentaugment_tpu.augments import manifold as manifold_j
    from latentaugment_tpu.metrics import precision_recall as pr_j
    from latentaugment_tpu.models import inception as inc_j
    from latentaugment_tpu.models.stylegan2 import networks as net_j
    from latentaugment_tpu.models.stylegan2 import projector as proj_j
    from latentaugment_tpu.models.stylegan2 import train as train_j
    from latentaugment_tpu.models.stylegan3 import networks as net3_j
    from latentaugment_tpu.parallel import stats as stats_j

    tree = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    out = {}
    for name, key, c in (("walk_uncond", "sg2_0", None), ("walk_cond", "sg2_3", inp["c"]),
                         ("walk_sg3", "sg3", None)):
        sg3, lpips = key == "sg3", key == "sg2_0"
        if sg3:
            g_cfg = net3_j.generator_config(**SG3)
            d_cfg = net_j.discriminator_config(img_resolution=64, img_channels=2,
                                               channel_base=1024, channel_max=32)
            W, X, res, w0 = inp["W3"], inp["X3"], 64, inp["w03"]
        else:
            cfg = inp[key]["cfg"]
            g_cfg = net_j.generator_config(z_dim=W_DIM, w_dim=W_DIM, num_mapping_layers=2, **cfg)
            d_cfg = net_j.discriminator_config(**cfg)
            W, X, res, w0 = inp["W"], inp["X"], RES, inp["w0"]
        bundle = engine_j.make_bundle(
            tree(inp[key]["g"]), tree(inp[key]["d"]), tree(inp["vgg"]) if lpips else None,
            W_summary=losses_j.manifold_summary(jnp.asarray(W)),
            X_cc_summaries=[losses_j.manifold_summary(
                manifold_j.center_crop(jnp.asarray(X), res)[:, m:m + 1]) for m in range(2)],
            fea_summaries=[losses_j.manifold_summary(jnp.asarray(f)) for f in inp["feas"]]
            if lpips else None)
        weights = dict(WALK_W, w_lpips=WALK_W["w_lpips"] if lpips else 0.0)
        fns = engine_j.make_walk_fns(g_cfg, d_cfg, n_modes=2, num_epochs=K, crop_size=CROP,
                                     remat=False, **weights)
        args = (bundle, jnp.asarray(w0), jnp.asarray((2, 4), jnp.int32), jax.random.PRNGKey(0))
        if c is None:
            _, ws, traces = jax.jit(fns.walk)(*args)
        else:
            _, ws, traces = jax.jit(fns.walk)(*args, jnp.asarray(c))
        out[name] = dict(ws=np.asarray(ws), traces=jax.tree_util.tree_map(np.asarray, traces))
    g_cfg = net_j.generator_config(z_dim=W_DIM, w_dim=W_DIM, num_mapping_layers=2,
                                   **inp["sg2_0"]["cfg"])
    g0 = tree(inp["sg2_0"]["g"])
    out["ganrand_ws"] = np.asarray(jax.jit(lambda p, z: net_j.mapping_apply(p, g_cfg, z))(
        g0["mapping"], jnp.asarray(inp["z"])))
    w_avg, w_std = (np.asarray(v) for v in inp["w_stats"])
    fn = jax.jit(proj_j.make_project_fn(g_cfg, num_steps=STEPS, initial_noise_factor=0.0,
                                        pix_weight=0.5))
    w, d = fn(g0, tree(inp["vgg"]), jnp.asarray(inp["target"]), jnp.asarray(w_avg),
              jnp.float32(w_std), jax.random.PRNGKey(0))
    out["project"] = dict(w=np.asarray(w), dists=np.asarray(d))
    # The trainer's four phase losses and gradients.
    tr = inp["train"]
    t_cfg = dict(z_dim=32, w_dim=32, num_mapping_layers=2, **TRAIN_NET)
    tfns = train_j.make_train_fns(net_j.generator_config(**t_cfg),
                                  net_j.discriminator_config(**TRAIN_NET),
                                  train_j.train_config(batch_size=B, r1_gamma=2.5,
                                                       pl_batch_shrink=2, **JAX_TRAIN))
    k = jax.random.split(jax.random.PRNGKey(0), 4)
    gp, dp = tree(tr["g"]), tree(tr["d"])
    z, z2, real = jnp.asarray(tr["z"]), jnp.asarray(tr["z2"]), jnp.asarray(tr["real"])
    nb = B // 2

    def vg(f, *a):
        (loss, aux), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(*a)
        return float(loss), jax.tree_util.tree_map(np.asarray, aux), \
            jax.tree_util.tree_map(np.asarray, grads)

    out["phases"] = {
        "g_main": vg(lambda g: tfns.loss_g_main(g, dp, z, z2, None, k[0], k[1], k[2], 0.0), gp),
        "g_pl": vg(lambda g: tfns.loss_g_pl(g, jnp.float32(0.3), z[:nb], z2[:nb], None, k[0],
                                            k[1], k[3]), gp),
        "d_main": vg(lambda d: tfns.loss_d_main(d, gp, real, z, z2, None, k[0], k[1], k[2],
                                                k[3], 0.0), dp),
        "d_r1": vg(lambda d: tfns.loss_d_r1(d, real, None), dp),
    }
    out["feats"] = np.asarray(jax.jit(inc_j.inception_features)(tree(inp["inception"]),
                                                                jnp.asarray(inp["images"])))
    out["dists"] = np.asarray(pr_j.compute_distances(inp["feat_rows"], inp["feat_cols"],
                                                     col_batch_size=10))
    out["moments"] = np.asarray(stats_j.moments(jnp.asarray(inp["moments"])))
    return out


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def test_every_rank_returns_the_global_result(runs):
    a, b = runs["ranks"]
    for key in ("walk_uncond", "walk_cond", "walk_sg3", "ganrand", "project_noise"):
        for part in ("img", "ws", "w"):
            if part in a[key]:
                np.testing.assert_array_equal(a[key][part], b[key][part], err_msg=key)
    for x, y in zip(a["policy"], b["policy"]):
        np.testing.assert_array_equal(x["A"], y["A"])


@pytest.mark.parametrize("key", ["walk_uncond", "walk_cond", "walk_sg3"])
def test_walk_matches_one_process_and_jax(runs, key):
    mesh, single, want = runs["mesh"][key], runs["single"][key], runs["jax"][key]
    _close(mesh["ws"], single["ws"], 0, W_ATOL)
    _close(mesh["img"], single["img"], IMG_RTOL, 1e-5)
    for name, trace in single["traces"].items():
        _close(mesh["traces"][name], trace, 1e-5, 1e-7)
        _close(mesh["traces"][name], want["traces"][name], 1e-4, 1e-5)
    _close(mesh["ws"], want["ws"], 0, W_ATOL)
    moved = np.abs(mesh["ws"][:, :1] - runs["inp"]["w03" if key == "walk_sg3" else "w0"]).mean()
    assert moved > 5e-3, f"the walk barely moved w ({moved})"


def test_policy_with_n_mesh_devices_matches_one_process(runs):
    mesh, single = runs["mesh"]["policy"], runs["single"]["policy"]
    assert len(mesh) == len(single) == 2 and mesh[1]["A"].shape[0] == 4  # 12 slices, batch 8
    for got, want in zip(mesh, single):
        _close(got["w"], want["w"], 0, W_ATOL)
        _close(got["A"], want["A"], IMG_RTOL, 1e-5)
        _close(got["B"], want["B"], IMG_RTOL, 1e-5)


@pytest.mark.parametrize("key", ["ganrand", "ganrand_hybrid"])
def test_forward_ganrand_matches_one_process_and_jax(runs, key):
    mesh, single = runs["mesh"][key], runs["single"]["ganrand"]
    _close(mesh["img"], single["img"], IMG_RTOL, 1e-5)
    _close(mesh["ws"], single["ws"], 1e-5, 1e-6)
    _close(mesh["ws"], runs["jax"]["ganrand_ws"], 1e-4, 1e-5)


def test_minibatch_stddev_groups_stay_whole_on_a_rank(runs):
    mesh, single = runs["mesh"]["mbstd"], runs["single"]["mbstd"]
    # Rank 0 holds groups 0 and 1 of 4: rows j + 4k, k-major.
    np.testing.assert_array_equal(mesh["local_rows"], [0, 1, 4, 5, 8, 9, 12, 13])
    _close(mesh["logits"], single["logits"], 1e-5, 1e-6)
    err = np.abs(mesh["logits"] - single["logits"]).max()
    assert np.abs(mesh["contiguous"] - single["logits"]).max() > max(1e-4, 100 * err)


@pytest.mark.parametrize("world,key", [(2, "walk_b4"), (4, "walk_b8")])
def test_walk_matches_one_process_where_groups_span_ranks(runs, world, key):
    """Batch 4 on 2 ranks and 8 on 4: no rank holds a whole
    minibatch-stddev group of 4, so D gathers its epilogue input."""
    mesh = (runs["mesh"] if world == 2 else runs["ranks4"][0])[key]
    single = runs["single"]["walk_b4" if key == "walk_b4" else "walk_uncond"]
    _close(mesh["ws"], single["ws"], 0, W_ATOL)
    _close(mesh["img"], single["img"], IMG_RTOL, 1e-5)
    for name, trace in single["traces"].items():
        _close(mesh["traces"][name], trace, 1e-5, 1e-7)
    others = runs["ranks"][1:] if world == 2 else runs["ranks4"][1:]
    for other in others:
        np.testing.assert_array_equal(other[key]["ws"], mesh["ws"])
    moved = np.abs(mesh["ws"][:, :1] - runs["inp"]["w0"][:mesh["ws"].shape[0]]).mean()
    assert moved > 5e-3, f"the walk barely moved w ({moved})"


def test_shard_rows_asks_only_for_an_even_split(runs):
    r0 = runs["ranks4"][0]
    np.testing.assert_array_equal(r0["rows_8"], [0, 1])  # contiguous: 8 rows, 4 ranks
    assert "does not split over 4 ranks" in r0["refused_6"]
    assert not runs["mesh"]["mbstd"]["holds4"] and runs["mesh"]["mbstd"]["holds"]


def test_minibatch_stddev_gathers_where_groups_span_ranks(runs):
    mesh, single = runs["mesh"]["mbstd"], runs["single"]["mbstd"]
    _close(mesh["logits4"], single["logits4"], 1e-5, 1e-6)
    _close(mesh["dx4"], single["dx4"], 1e-5, 1e-7)
    assert np.abs(single["dx4"]).max() > 0


def test_dr1_step_matches_one_process_where_groups_span_ranks(runs):
    """R1 at 2 ranks x batch 4 differentiates through D's gather twice."""
    mesh, single = runs["mesh"]["r1_b4"], runs["single"]["r1_b4"]
    _close(mesh["loss"], single["loss"], LOSS_RTOL)
    _close(mesh["penalty"], single["penalty"], LOSS_RTOL)
    for name, g in single["grads"].items():
        _close(mesh["grads"][name], g, GRAD_RTOL, GRAD_ATOL)
    assert max(np.abs(g).max() for g in single["grads"].values()) > 0


@pytest.mark.parametrize("world", [2, 3])
def test_generator_fid_at_any_rank_count_matches_one_process(runs, world):
    """batch_gen 4 over 3 ranks is padded to 6, the padded rows dropped."""
    single = runs["single"]["gen_fid"]
    ranks = runs["ranks"] if world == 2 else runs["ranks4"][:3]
    key = "gen_fid" if world == 2 else "gen_fid3"
    assert "gen_fid3" not in runs["ranks4"][3]
    for r in ranks:
        assert r[key]["feats"].shape == single["feats"].shape == (8, 16)
        _close(r[key]["feats"], single["feats"], FEAT_RTOL, 1e-6)
        _close(r[key]["fid"], single["fid"], 1e-5)


def test_projector_matches_one_process_and_jax(runs):
    """Step 0's distance precedes any update (rtol 1e-5). Adam's first
    steps are lr * sign(g), so rounding of a near-0 gradient moves w by a
    whole lr (0.1 here) either way: a projected w is held at 1e-2 (ROADMAP
    section 3), and the later distances, which follow w, at 1e-3."""
    for key in ("project", "project_noise"):
        mesh, single = runs["mesh"][key], runs["single"][key]
        _close(mesh["dists"][0], single["dists"][0], 1e-5)
        _close(mesh["dists"], single["dists"], 1e-3)
        _close(mesh["w"], single["w"], 0, PROJ_W_ATOL)
    want = runs["jax"]["project"]
    _close(runs["mesh"]["project"]["dists"][0], want["dists"][0], 1e-4)
    _close(runs["mesh"]["project"]["dists"], want["dists"], 1e-3)
    _close(runs["mesh"]["project"]["w"], want["w"], 0, PROJ_W_ATOL)


@pytest.mark.parametrize("phase", ["g_main", "g_pl", "d_main", "d_r1"])
def test_trainer_phase_losses_and_gradients_match(runs, phase):
    from latentaugment_tpu_torch.models.stylegan2 import checkpoint

    for draws in ("phases_jax", "phases_random"):
        loss, aux, grads = runs["mesh"][draws][phase]
        loss1, aux1, grads1 = runs["single"][draws][phase]
        _close(loss, loss1, LOSS_RTOL)
        for a, b in zip(aux, aux1):
            _close(a, b, LOSS_RTOL, 1e-7)
        for name, g in grads1.items():
            _close(grads[name], g, GRAD_RTOL, GRAD_ATOL)
    loss_j, aux_j, grads_j = runs["jax"]["phases"][phase]
    loss, aux, grads = runs["mesh"]["phases_jax"][phase]
    _close(loss, loss_j, 1e-4)
    flat_j = checkpoint.params_to_state_dict(grads_j)
    for name, g in grads.items():
        _close(g, flat_j[name].numpy(), GRAD_RTOL, GRAD_ATOL)


def test_one_step_of_each_phase_keeps_replicas_equal_and_matches(runs):
    mesh, single = runs["mesh"]["train_steps"], runs["single"]["train_steps"]
    for phase, logs in single["logs"].items():
        for k, v in logs.items():
            _close(mesh["logs"][phase][k], v, LOSS_RTOL, 1e-7)
    _close(mesh["pl_mean"], single["pl_mean"], LOSS_RTOL)
    # Adam's first step is lr * g / (|g| + eps): a gradient within rounding
    # of 0 may step by up to 2 lr. All but a sliver agree to 1e-5.
    lr = 2.5e-3
    off = total = 0
    for name, v in single["params"].items():
        diff = np.abs(mesh["params"][name] - v)
        assert diff.max() <= 2 * lr, name
        off, total = off + int((diff > 1e-5).sum()), total + diff.size
    assert off <= 1e-3 * total, f"{off} of {total} parameters off by more than 1e-5"
    a, b = (r["train_steps"]["params"] for r in runs["ranks"])
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_train_loop_resumes_exactly_under_the_mesh(runs):
    mesh = runs["mesh"]["resume"]
    assert mesh["equal"] and mesh["n_states"] == 1
    assert "log.jsonl" in mesh["files"] and "network-snapshot-000000.pkl" in mesh["files"]
    assert runs["single"]["resume"]["equal"]


def test_detector_features_match_one_process_and_jax(runs):
    mesh, single = runs["mesh"]["metrics"], runs["single"]["metrics"]
    assert mesh["feats"].shape == (5, 2048)  # 5 images padded to 6 over 2 ranks
    _close(mesh["feats"], single["feats"], FEAT_RTOL, 1e-6)
    _close(mesh["feats"], runs["jax"]["feats"], FEAT_RTOL, 1e-5)
    _close(mesh["gen_feats"], single["gen_feats"], FEAT_RTOL, 1e-6)


def test_pr_distance_tiles_match_one_process_and_jax(runs):
    mesh, single = runs["mesh"]["metrics"], runs["single"]["metrics"]
    assert mesh["dists"].shape == (13, 27)
    _close(mesh["dists"], single["dists"], DIST_TOL, DIST_TOL)
    _close(mesh["dists"], runs["jax"]["dists"], DIST_TOL, DIST_TOL)
    np.testing.assert_array_equal(mesh["pr"], single["pr"])


def test_psum_moments_reduces_over_the_ranks(runs):
    mesh = runs["mesh"]["metrics"]["moments"]
    _close(mesh, runs["single"]["metrics"]["moments"], 1e-6)
    _close(mesh, runs["jax"]["moments"], 1e-6)
    assert mesh[0] == runs["inp"]["moments"].size


def test_check_replica_consistency_finds_a_moved_parameter(runs):
    for r in runs["ranks"]:
        assert "mapping.fc0.weight" in r["replicas"]["caught"]
    assert runs["single"]["replicas"]["caught"] == ""


def test_trainer_cli_starts_its_ranks_and_rank_0_writes(runs):
    run = runs["cli_run"]
    files = sorted(os.listdir(run))
    assert "network-snapshot-000000.pkl" in files and "log.jsonl" in files
    assert sum(f.startswith("training-state-") for f in files) == 2
    with open(os.path.join(run, "log.jsonl")) as f:
        rows = [line for line in f if line.strip()]
    assert len(rows) == 1  # one writer: rank 0's row only
    assert runs["cli_log"].count("[torch_train_sg2] done") == WORLD


def test_stats_collector_and_param_summary_match_jax(capsys):
    """The host side of parallel/stats.py and util_misc's summary table
    against the JAX package's, on the same values."""
    from latentaugment_tpu.parallel import stats as stats_j
    from latentaugment_tpu.utils import util_misc as misc_j
    from latentaugment_tpu_torch.parallel import mesh as pmesh
    from latentaugment_tpu_torch.parallel import stats as stats_t
    from latentaugment_tpu_torch.utils import util_misc as misc_t

    rng = np.random.RandomState(3)
    values = [rng.randn(*shape).astype(np.float32) for shape in ((5,), (2, 3), (1,))]
    col_j = stats_j.Collector(regex="test_torch_port_parallel/.*")
    col_t = stats_t.Collector(regex="test_torch_port_parallel/.*")
    for v in values:
        stats_j.report("test_torch_port_parallel/x", jnp.asarray(v))
        stats_t.report("test_torch_port_parallel/x", torch.from_numpy(v))
        stats_j.report0("test_torch_port_parallel/y", jnp.asarray(v), process_index=0)
        stats_t.report0("test_torch_port_parallel/y", torch.from_numpy(v), process_index=0)
        stats_t.report0("test_torch_port_parallel/z", torch.from_numpy(v), process_index=1)
    col_j.update()
    col_t.update()
    for name in ("test_torch_port_parallel/x", "test_torch_port_parallel/y"):
        assert col_t.num(name) == col_j.num(name)
        _close(col_t.mean(name), col_j.mean(name), 1e-6)
        _close(col_t.std(name), col_j.std(name), 1e-5)
    assert col_t.num("test_torch_port_parallel/x") == 12
    assert col_t.num("test_torch_port_parallel/z") == 0  # report0 on another rank
    assert col_t.as_dict()["test_torch_port_parallel/x"]["num"] == 12

    tree = {"a": {"w": np.zeros((3, 4), np.float32), "b": np.zeros(4, np.float32)},
            "c": np.zeros((2, 2, 3), np.float32)}
    total_j = misc_j.print_param_summary(tree, name="net", max_rows=2)
    out_j = capsys.readouterr().out
    total_t = misc_t.print_param_summary(tree, name="net", max_rows=2)
    assert total_t == total_j == 28 and capsys.readouterr().out == out_j
    # Without a mesh there is one replica and nothing to compare.
    misc_t.check_replica_consistency({"w": torch.zeros(3)}, None)
    padded, n = pmesh.pad_to_multiple(torch.arange(5.0)[:, None], 4)
    assert n == 5 and padded[:, 0].tolist() == [0, 1, 2, 3, 4, 4, 4, 4]


def test_init_distributed_reads_torchruns_environment_and_refusals():
    from latentaugment_tpu_torch.parallel import mesh as pmesh

    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1", MASTER_ADDR="localhost",
               MASTER_PORT=str(pmesh.free_port()), WORLD_SIZE="1", RANK="0")
    code = ("from latentaugment_tpu_torch.parallel import mesh as m\n"
            "print('GROUP', m.init_distributed(backend='gloo'))\n"
            "mesh = m.get_mesh(devices='cpu')\n"
            "print('MESH', mesh.mesh_dim_names, m.world_size(mesh), m.data_rank(mesh))\n")
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "GROUP (0, 1)" in r.stdout and "MESH ('data',) 1 0" in r.stdout
    with pytest.raises(ValueError, match="must divide"):
        pmesh.get_mesh(4, n_model=3)
    with pytest.raises(TypeError, match="DeviceMesh"):
        pmesh.check_mesh(object())
