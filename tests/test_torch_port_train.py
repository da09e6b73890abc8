"""The port's StyleGAN2(-ADA) trainer against the JAX package's, on the CPU.

One set of numpy parameters (drawn by the JAX initializers, with nonzero
noise strengths, biases and w_avg so those paths are live) goes into both
trainers. The four phase losses and every parameter gradient are compared
with const noise, no style mixing and no augmentation (all randomness
out), for an unconditional and a conditional (c_dim 3) G/D pair, at 32x32
with channel_base 512, channel_max 32, a 2-layer mapping and batch 4.
Tolerances: losses rtol 1e-4, gradients rtol 2e-3 / atol 2e-5 (the JAX
trainer's own test bounds against its torch oracle).

Then what the port's trainer does on its own: Adam's mb_ratio folding
against optax, the EMA, R1 in chunks, the buffers, the loop's exact
resume, the training state's refusal of code, the dataset, the
conditional metrics' label bank and the command line, whose snapshot the
port's policy and the JAX package's loader both read.
"""

import io
import json
import os
import pickle
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from synthetic import MODALITIES, make_image_zip

from latentaugment_tpu.models.stylegan2 import convert as convert_j
from latentaugment_tpu.models.stylegan2 import dataset as dataset_j
from latentaugment_tpu.models.stylegan2 import networks as net_j
from latentaugment_tpu.models.stylegan2 import train as train_j
from latentaugment_tpu_torch.models.stylegan2 import checkpoint as ckpt_t
from latentaugment_tpu_torch.models.stylegan2 import dataset as dataset_t
from latentaugment_tpu_torch.models.stylegan2 import networks as net_t
from latentaugment_tpu_torch.models.stylegan2 import train as train_t

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from scripts import torch_train_sg2  # noqa: E402
from test_torch_port_common import _one_torch_thread  # noqa: F401,E402 (autouse fixture)

BATCH = 4
NET = dict(img_resolution=32, img_channels=2, channel_base=512, channel_max=32)
LOSS_RTOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 2e-3, 2e-5
PHASES = ("g_main", "g_pl", "d_main", "d_r1")


def _cfg(**kw):
    base = dict(batch_size=BATCH, style_mixing_prob=0.0, noise_mode='const', aug='noaug',
                r1_gamma=2.5, pl_batch_shrink=1, ema_rampup=None)
    base.update(kw)
    return base


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _configs(c_dim, pkg):
    g = pkg.generator_config(z_dim=32, w_dim=32, num_mapping_layers=2, c_dim=c_dim, **NET)
    d = pkg.discriminator_config(c_dim=c_dim, num_mapping_layers=2, **NET)
    return g, d


def _build(c_dim):
    g_cfg_j, d_cfg_j = _configs(c_dim, net_j)
    gp = _np_tree(net_j.generator_init(jax.random.PRNGKey(3), g_cfg_j))
    dp = _np_tree(net_j.discriminator_init(jax.random.PRNGKey(4), d_cfg_j))
    rng = np.random.RandomState(5)
    gp["mapping"]["w_avg"] = rng.randn(32).astype(np.float32) * 0.1
    for block in gp["synthesis"].values():
        for conv in ("conv0", "conv1"):
            if isinstance(block, dict) and conv in block:
                block[conv]["noise_strength"] = np.float32(0.3).reshape(())
                block[conv]["bias"] = rng.randn(*block[conv]["bias"].shape).astype(np.float32) * 0.1
    z = rng.randn(BATCH, 32).astype(np.float32)
    real = rng.rand(BATCH, 2, 32, 32).astype(np.float32) * 2 - 1
    c = np.eye(c_dim, dtype=np.float32)[rng.randint(0, c_dim, BATCH)] if c_dim else None
    return dict(g_cfg_j=g_cfg_j, d_cfg_j=d_cfg_j, gp=gp, dp=dp, z=z, real=real, c=c,
                cfgs_t=_configs(c_dim, net_t))


@pytest.fixture(scope="module", params=[0, 3], ids=["uncond", "cond"])
def pair(request):
    """Both trainers on one set of parameters, and the JAX side's losses
    and gradients of the four phases (one jitted program each)."""
    b = _build(request.param)
    fns = train_j.make_train_fns(b["g_cfg_j"], b["d_cfg_j"], train_j.train_config(**_cfg()))
    k = jax.random.split(jax.random.PRNGKey(0), 4)
    gp, dp = (jax.tree_util.tree_map(jnp.asarray, t) for t in (b["gp"], b["dp"]))
    z, real = jnp.asarray(b["z"]), jnp.asarray(b["real"])
    c = None if b["c"] is None else jnp.asarray(b["c"])
    pl_mean0 = 0.3

    def vg(f, *args):
        return jax.jit(jax.value_and_grad(f, has_aux=True))(*args)

    out = {
        "g_main": vg(lambda gp: fns.loss_g_main(gp, dp, z, z, c, k[0], k[1], k[2], 0.0), gp),
        "g_pl": vg(lambda gp: fns.loss_g_pl(gp, jnp.float32(pl_mean0), z, z, c, k[0], k[1],
                                            k[3]), gp),
        "d_main": vg(lambda dp: fns.loss_d_main(dp, gp, real, z, z, c, k[0], k[1], k[2], k[3],
                                                0.0), dp),
        "d_r1": vg(lambda dp: fns.loss_d_r1(dp, real, c), dp),
    }
    b["jax"] = jax.tree_util.tree_map(np.asarray, out)
    b["pl_noise"] = np.asarray(jax.random.normal(k[3], (BATCH, 2, 32, 32))) / np.sqrt(32 * 32)
    b["pl_mean0"] = pl_mean0
    return b


def _port(b, **kw):
    fns = train_t.make_train_fns(*b["cfgs_t"], train_t.train_config(**_cfg(**kw)),
                                 device="cpu")
    return fns, fns.state_from_params(b["gp"], b["dp"])


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _port_phase(b, phase, fns, state):
    """(loss, aux, {parameter name: gradient}) of one phase on the port."""
    gen = torch.Generator()
    z, real, c = _t(b["z"]), _t(b["real"]), _t(b["c"])
    if phase == "g_main":
        module = state.G
        loss, aux = fns.loss_g_main(state.G, state.D, z, z, c, gen, 0.0)
    elif phase == "g_pl":
        module = state.G
        loss, aux = fns.loss_g_pl(state.G, torch.tensor(b["pl_mean0"]), z, z, c, gen,
                                  pl_noise=_t(b["pl_noise"].astype(np.float32)))
    elif phase == "d_main":
        module = state.D
        loss, aux = fns.loss_d_main(state.D, state.G, real, z, z, c, gen, 0.0)
    else:
        module = state.D
        loss, aux = fns.loss_d_r1(state.D, real, c)
    names = [n for n, _ in module.named_parameters()]
    return loss, aux, dict(zip(names, train_t._grads(loss, module)))


@pytest.mark.parametrize("phase", PHASES)
def test_phase_loss_and_grads_match_jax(pair, phase):
    fns, state = _port(pair)
    loss, aux, grads = _port_phase(pair, phase, fns, state)
    (loss_j, aux_j), grads_j = pair["jax"][phase]
    np.testing.assert_allclose(loss.item(), loss_j, rtol=LOSS_RTOL)
    if phase == "g_pl":
        np.testing.assert_allclose(aux[0].item(), aux_j[0], rtol=LOSS_RTOL)     # new pl_mean
        np.testing.assert_allclose(aux[1].numpy(), aux_j[1], rtol=LOSS_RTOL)    # pl_lengths
    elif phase == "d_main":
        for got, want in zip(aux, aux_j):                                      # gen, real, rt
            np.testing.assert_allclose(got.item(), want, rtol=LOSS_RTOL, atol=1e-6)
    elif phase == "d_r1":
        np.testing.assert_allclose(aux.item(), aux_j, rtol=LOSS_RTOL)          # penalty
    flat_j = ckpt_t.params_to_state_dict(grads_j)
    buffers = {k for k in flat_j if k.rsplit(".", 1)[-1] in
               ("w_avg", "resample_filter", "noise_const")}
    assert set(grads) == set(flat_j) - buffers
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), flat_j[name].numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=f"{phase} {name}")


@pytest.mark.parametrize("phase", ["g_main", "d_main"])
def test_adam_step_matches_optax(pair, phase):
    """One phase's Adam step with the JAX trainer's gradients: the port's
    optimizer against optax's adam(eps_root=0) with the mb_ratio folded
    into lr and the betas (g_reg_interval 4 for G, d_reg_interval 16 for D)."""
    cfg = train_t.train_config(**_cfg())
    interval = cfg.g_reg_interval if phase == "g_main" else cfg.d_reg_interval
    fns, state = _port(pair)
    module, opt = (state.G, state.opt_g) if phase == "g_main" else (state.D, state.opt_d)
    params_j = pair["gp"] if phase == "g_main" else pair["dp"]
    grads_j = pair["jax"][phase][1]
    flat_g = ckpt_t.params_to_state_dict(grads_j)
    ratio = interval / (interval + 1.0)
    tx = optax.adam(learning_rate=cfg.lr * ratio, b1=cfg.beta1 ** ratio,
                    b2=cfg.beta2 ** ratio, eps=cfg.eps, eps_root=0.0)
    params = jax.tree_util.tree_map(jnp.asarray, params_j)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, grads):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    for _ in range(2):
        params, opt_state = step(params, opt_state, jax.tree_util.tree_map(jnp.asarray, grads_j))
        train_t._apply(opt, module, [flat_g[n].clone() for n, _ in module.named_parameters()])
    want = ckpt_t.params_to_state_dict(_np_tree(params))
    for name, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def test_g_main_lerps_w_avg_and_buffers_stay(pair):
    """A whole sequence of the four phases moves no buffer through Adam;
    w_avg moves by its own lerp toward the batch's mean w."""
    fns, state = _port(pair, w_avg_beta=0.9)
    before = {n: b.clone() for n, b in [*state.G.named_buffers(), *state.D.named_buffers()]}
    z, real, c = _t(pair["z"]), _t(pair["real"]), _t(pair["c"])
    with torch.no_grad():
        w_mean = state.G.mapping(z, c, broadcast=False).mean(0)
    gen = torch.Generator()
    fns.g_main(state, z, z, c, gen, 0.0)
    fns.g_reg(state, z, z, c, gen, 0.0)
    fns.d_main(state, real, z, z, c, gen, 0.0)
    fns.d_reg(state, real, c, gen, 0.0)
    after = dict([*state.G.named_buffers(), *state.D.named_buffers()])
    assert before.keys() == after.keys() and len(before) > 5
    for name, b in before.items():
        if name.endswith("w_avg"):
            want = w_mean + (b - w_mean) * 0.9
            torch.testing.assert_close(after[name], want, rtol=0, atol=1e-7)
        else:
            assert torch.equal(after[name], b), name
    assert torch.isfinite(state.pl_mean) and state.pl_mean.item() != 0.0


def test_ema_lerps_params_copies_buffers_and_beta_ramps(pair):
    fns, state = _port(pair)
    with torch.no_grad():
        for p in state.G.parameters():
            p.add_(1.0)
        for b in state.G.buffers():
            b.add_(2.0)
    ema0 = {n: p.clone() for n, p in state.G_ema.named_parameters()}
    fns.ema(state, 0.75)
    for name, p in state.G_ema.named_parameters():
        torch.testing.assert_close(p, ema0[name] + 0.25, rtol=1e-6, atol=1e-6)
    for (name, b), g in zip(state.G_ema.named_buffers(), state.G.buffers()):
        assert torch.equal(b, g), name
    cfg = train_t.train_config(batch_size=BATCH, ema_kimg=10.0, ema_rampup=0.05)
    cfg_j = train_j.train_config(batch_size=BATCH, ema_kimg=10.0, ema_rampup=0.05)
    for nimg in (0, 100, 10_000_000):
        assert train_t.ema_beta(cfg, nimg) == train_j.ema_beta(cfg_j, nimg)
    assert train_t.ema_beta(cfg, 100) < train_t.ema_beta(cfg, 10_000_000) < 1.0


def test_r1_chunks_2_equals_1(pair):
    """Equal chunks give the full batch's R1 loss, penalty and gradients
    (minibatch-stddev groups of 1, so that chunking recomposes none)."""
    b = dict(pair)
    g_cfg, d_cfg = b["cfgs_t"]
    d_cfg = type(d_cfg)(dict(d_cfg), mbstd_group_size=1)
    outs = []
    for chunks in (1, 2):
        fns = train_t.make_train_fns(g_cfg, d_cfg, train_t.train_config(**_cfg(r1_chunks=chunks)),
                                     device="cpu")
        state = fns.state_from_params(b["gp"], b["dp"])
        outs.append(fns.r1_value_and_grads(state.D, _t(b["real"]), _t(b["c"])))
    ((l1, p1), g1), ((l2, p2), g2) = outs
    torch.testing.assert_close(l2, l1, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(p2, p1, rtol=1e-5, atol=1e-7)
    scale = max(g.abs().max().item() for g in g1)
    for a, b_ in zip(g1, g2):
        torch.testing.assert_close(b_, a, rtol=1e-4, atol=1e-6 * scale)
    with pytest.raises(ValueError, match="r1_chunks"):
        fns.r1_value_and_grads(state.D, _t(b["real"])[:3], None)


def test_remat_under_create_graph_equals_no_remat(pair):
    """Checkpointed blocks (non-reentrant) under the second derivatives of
    path length and R1 give the same losses and gradients, random noise
    included (a recomputed block sees the noise drawn before it)."""
    res = []
    for remat in (False, True):
        fns, state = _port(pair, remat=remat, noise_mode='random', style_mixing_prob=0.9)
        gen = torch.Generator().manual_seed(1)
        z, c = _t(pair["z"]), _t(pair["c"])
        loss_pl, _ = fns.loss_g_pl(state.G, torch.tensor(0.0), z, z, c, gen)
        loss_r1, _ = fns.loss_d_r1(state.D, _t(pair["real"]), c)
        res.append([loss_pl, loss_r1, *train_t._grads(loss_pl, state.G),
                    *train_t._grads(loss_r1, state.D)])
    for a, b in zip(*res):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# The loop, its training state, the dataset, the label bank, the CLI.

SMALL = dict(z_dim=32, w_dim=32, img_resolution=16, img_channels=2, channel_base=512,
             channel_max=32, num_mapping_layers=2)


def _loop_cfgs():
    g_cfg = net_t.generator_config(**SMALL)
    d_cfg = net_t.discriminator_config(**{k: v for k, v in SMALL.items()
                                          if k not in ("z_dim", "w_dim")})
    cfg = train_t.train_config(batch_size=4, aug='ada', aug_pipe='bgc', ada_interval=3,
                               ada_kimg=0.01, noise_mode='random', d_reg_interval=2,
                               g_reg_interval=2)
    return g_cfg, d_cfg, cfg


def _data_iter(start_batch=0):
    """Per-index batches, so a resumed run replays the stream from there."""
    i = start_batch
    while True:
        yield np.random.RandomState(1000 + i).rand(4, 2, 16, 16).astype(np.float32) * 2 - 1, None
        i += 1


def _loop(tmp, kimg, snap, seed=7, start=0, resume=None):
    g_cfg, d_cfg, cfg = _loop_cfgs()
    return train_t.train_loop(g_cfg, d_cfg, _data_iter(start), cfg, total_kimg=kimg,
                              run_dir=str(tmp), snapshot_kimg=snap, log_every=100, seed=seed,
                              resume_state=resume, device="cpu")


def _state_tensors(state):
    out = {}
    for name in ("G", "D", "G_ema"):
        out.update({f"{name}.{k}": v for k, v in state[name].state_dict().items()})
    for name in ("opt_g", "opt_d"):
        for i, s in state[name].state_dict()["state"].items():
            out.update({f"{name}.{i}.{k}": v for k, v in s.items()})
    out["pl_mean"] = state.pl_mean
    return out


def test_train_loop_resume_is_bit_exact(tmp_path):
    """Two steps, a training state, two more steps from it (with another
    seed: the saved generator wins) equal four uninterrupted steps, bit
    for bit: parameters, EMA, Adam moments, pl_mean, ADA and the draws."""
    ref = _loop(tmp_path / "a", 0.016, 0)
    _loop(tmp_path / "b", 0.008, 0.008)
    states = sorted((tmp_path / "b").glob("training-state-*.pt"))
    snaps = sorted((tmp_path / "b").glob("network-snapshot-*.pkl"))
    assert len(states) == 1 and len(snaps) == 1
    out = _loop(tmp_path / "b", 0.016, 0, seed=999, start=2, resume=str(states[-1]))
    want, got = _state_tensors(ref), _state_tensors(out)
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(want[k], got[k]), k
    rows = (tmp_path / "b" / "log.jsonl").read_text().splitlines()
    assert "Loss/G/loss" in rows[-1] and "Loss/D/real" in rows[-1]
    # A state saved under other network shapes refuses to load.
    g_big = net_t.generator_config(**dict(SMALL, channel_base=1024, channel_max=64))
    _, d_cfg, cfg = _loop_cfgs()
    with pytest.raises(ValueError, match="does not fit"):
        train_t.train_loop(g_big, d_cfg, _data_iter(), cfg, total_kimg=0.016,
                           resume_state=str(states[-1]), device="cpu")


def test_training_state_refuses_code(tmp_path):
    class Evil:
        def __reduce__(self):
            return (os.system, ("echo owned",))

    path = tmp_path / "training-state-000000001.pt"
    torch.save({"format_version": 1, "x": Evil()}, path)
    with pytest.raises(pickle.UnpicklingError):
        train_t.load_training_state(str(path))


def test_ada_controller_deferred_flush_equals_eager_and_jax():
    """The loop fetches r_t at ticks only: the deferred flush gives the
    eager trajectory and state, across a mid-window flush and a resume,
    and both equal the JAX controller's on the same r_t sequence."""
    from latentaugment_tpu.models.stylegan2.ada import AdaController as AdaJ
    from latentaugment_tpu_torch.models.stylegan2.ada import AdaController

    rts = np.random.RandomState(0).uniform(-1, 1, size=23).tolist()
    kw = dict(target=0.6, interval=4, ada_kimg=0.01, p_init=0.1)
    eager, deferred, jax_ctl = AdaController(**kw), AdaController(**kw), AdaJ(**kw)
    pending = []
    p_deferred = deferred.p
    for i, rt in enumerate(rts):
        p_eager = eager.update(rt, 16)
        assert jax_ctl.update(rt, 16) == p_eager
        pending.append(torch.tensor(rt, dtype=torch.float64))
        if deferred.will_tick(len(pending)):
            p_deferred = train_t._flush_ada(deferred, pending, 16)
        assert p_deferred == p_eager, i
        if i == 9:  # a mid-window snapshot flushes; a resume continues
            train_t._flush_ada(deferred, pending, 16)
            assert deferred.state_dict() == eager.state_dict() == jax_ctl.state_dict()
            deferred = AdaController(**kw)
            deferred.load_state_dict(eager.state_dict())
    train_t._flush_ada(deferred, pending, 16)
    assert deferred.state_dict() == eager.state_dict() == jax_ctl.state_dict()
    assert eager.p != kw["p_init"]


def test_prefetch_iter_keeps_order_and_raises():
    def gen():
        yield 1
        yield 2
        raise RuntimeError("loader boom")

    it = train_t.prefetch_iter(gen(), depth=1)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(RuntimeError, match="loader boom"):
        next(it)


def _labelled_zip(path):
    fnames = make_image_zip(str(path), n_patients=2, slices_per_patient=3)
    labels = {f: i % 3 for i, f in enumerate(fnames)}
    with zipfile.ZipFile(str(path), "a") as zf:
        zf.writestr("dataset.json", json.dumps({"labels": labels}))
    return fnames


@pytest.mark.parametrize("kw", [dict(use_labels=True, xflip=True),
                                dict(use_labels=False, max_size=4, perc_size=0.5)],
                         ids=["labels-xflip", "subset"])
def test_custom_image_folder_dataset_matches_jax(tmp_path, kw):
    _labelled_zip(tmp_path / "d.zip")
    args = dict(path=str(tmp_path / "d.zip"), modalities=MODALITIES, resolution=32, **kw)
    ds_t, ds_j = dataset_t.CustomImageFolderDataset(**args), dataset_j.CustomImageFolderDataset(**args)
    assert len(ds_t) == len(ds_j) > 0
    assert ds_t.label_shape == ds_j.label_shape and ds_t.has_labels == ds_j.has_labels
    for i in range(len(ds_j)):
        (img_t, lab_t), (img_j, lab_j) = ds_t[i], ds_j[i]
        np.testing.assert_array_equal(img_t, img_j)
        np.testing.assert_array_equal(lab_t, lab_j)
    from latentaugment_tpu.utils.util_misc import InfiniteSampler as SamplerJ
    it_t, it_j = iter(dataset_t.InfiniteSampler(7, seed=3)), iter(SamplerJ(7, seed=3))
    assert [next(it_t) for _ in range(30)] == [next(it_j) for _ in range(30)]


def test_conditional_metrics_draw_labels_from_the_dataset(tmp_path, monkeypatch):
    """The live-generator metrics of a conditional G take their labels
    from the training zip's label bank (the JAX package's rows). The
    detector is a stand-in: the labels are the point."""
    from latentaugment_tpu.metrics import metric_utils as mu_j
    from latentaugment_tpu_torch.metrics import metric_utils as mu_t

    _labelled_zip(tmp_path / "d.zip")
    dk = dict(path=str(tmp_path / "d.zip"), modalities=MODALITIES, use_labels=True)
    bank_t = mu_t._dataset_label_bank(mu_t.MetricOptions(dataset_kwargs=dk, device="cpu"), 3)
    bank_j = mu_j._dataset_label_bank(mu_j.MetricOptions(dataset_kwargs=dk), 3)
    np.testing.assert_array_equal(bank_t, bank_j)
    assert bank_t.shape == (6, 3) and (bank_t.sum(1) == 1).all()
    with pytest.raises(RuntimeError, match="labels"):
        mu_t._dataset_label_bank(mu_t.MetricOptions(dataset_kwargs=dk, device="cpu"), 4)

    g_cfg = net_t.generator_config(**dict(SMALL, c_dim=3))
    seen = []
    G = net_t.Generator(g_cfg).requires_grad_(False)
    G.mapping.embed.register_forward_hook(lambda m, inp, out: seen.append(inp[0].clone()))
    opts = mu_t.MetricOptions(G=G, G_kwargs=dict(seed=2), device="cpu", cache=False,
                              dataset_kwargs=dk)
    monkeypatch.setattr(mu_t, "get_feature_detector",
                        lambda url, device: lambda x: x.reshape(x.shape[0], -1)[:, :8])
    stats = mu_t.compute_feature_stats_for_generator(opts, "stand-in", batch_gen=2,
                                                     capture_all=True, max_items=2)
    assert stats.get_all().shape == (2, 8)
    rows = np.random.RandomState(2).randint(0, 6, 2)
    np.testing.assert_array_equal(seen[0].numpy(), bank_t[rows])


def test_cli_synthetic_snapshot_reads_in_the_policy_and_jax(tmp_path):
    """Two steps of the command line on the CPU write a snapshot (with
    training state and log) that the JAX package's loader reads as written
    and the port's policy walks from; `--resume-state` continues it."""
    from latentaugment_tpu_torch import benchmark
    from latentaugment_tpu_torch.augments import create_augment
    from latentaugment_tpu_torch.data import create_dataset
    from latentaugment_tpu_torch.options import AugOptions

    run = tmp_path / "run"
    state = torch_train_sg2.main(["--synthetic", "--device", "cpu", "--batch", "4",
                                  "--kimg", "0.008", "--snap", "0.008", "--outdir", str(run),
                                  "--aug", "ada", "--seed", "3"])
    assert torch.isfinite(state.pl_mean)
    snap = sorted(run.glob("network-snapshot-*.pkl"))[-1]
    g_params, g_cfg, d_params, d_cfg = convert_j.load_stylegan(str(snap))
    for tree, module in ((g_params, state.G_ema), (d_params, state.D)):
        flat = ckpt_t.params_to_state_dict(tree)
        assert flat.keys() == module.state_dict().keys()
        for key, v in module.state_dict().items():
            np.testing.assert_array_equal(flat[key].numpy(), v.numpy())
    assert (g_cfg.img_resolution, g_cfg.num_ws, d_cfg.img_channels) == (32, 8, 2)

    argv = benchmark.build_policy_workspace(
        str(tmp_path / "ws"), res=32, batch_size=4, num_epochs=2, crop_size=16,
        channel_base=1024, channel_max=64, n_patients=1, slices_per_patient=4, step=5,
        num_fp16_res=0)
    argv[argv.index("--model_dir") + 1] = str(snap)
    opt = AugOptions().parse(argv=argv + ["--device", "cpu"], install_logger=False)
    augment = create_augment(opt)
    augment.set_input(next(iter(create_dataset(opt))))
    augment.forward()
    out = augment.get_output()
    assert out["A"].shape == (4, 1, 32, 32) and np.isfinite(out["A"]).all()

    rs = sorted(run.glob("training-state-*.pt"))[-1]
    torch_train_sg2.main(["--synthetic", "--device", "cpu", "--kimg", "0.016", "--outdir",
                          str(run), "--resume-state", str(rs), "--snap", "0.008"])
    last = json.loads((run / "log.jsonl").read_text().splitlines()[-1])
    assert last["step"] == 4 and last["kimg"] == 0.016


def test_cli_refuses_what_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="DDP slice"):
        torch_train_sg2.main(["--synthetic", "--device", "cpu", "--n_devices", "2"])
    nvidia = tmp_path / "nvidia.pkl"
    nvidia.write_bytes(pickle.dumps({"G_ema": None, "D": None}))
    with pytest.raises(ValueError, match="not a native checkpoint"):
        torch_train_sg2.main(["--synthetic", "--device", "cpu", "--resume", str(nvidia),
                              "--outdir", str(tmp_path / "r")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            torch_train_sg2.main(["--synthetic", "--outdir", str(tmp_path / "c")])
    buf = io.BytesIO()
    torch.save({"format_version": 2}, buf)
    (tmp_path / "v2.pt").write_bytes(buf.getvalue())
    with pytest.raises(ValueError, match="format_version"):
        train_t.load_training_state(str(tmp_path / "v2.pt"))
