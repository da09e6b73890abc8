"""Parity of the port's K-step latent walk and LatentAugment policy with
the JAX package, on the CPU.

  * The walk: one set of numpy weights, manifolds, w0 and crop position
    through `make_walk_fns(...).walk` of both packages, K=3: per-step
    loss traces, the final w and the const-noise image of the final w.
  * The policy: one tiny workspace from the port's
    `build_policy_workspace`, copied so that each package builds its own
    manifold caches, through AugOptions -> create_dataset ->
    create_augment -> set_input / forward / get_output in each package,
    two batches (the second partial, so padded). The workspace's noise
    strengths are zero, so the final images (random noise in both) are
    comparable too. Once with the default LPIPS embedding and once with
    `--lpips_script lpips_tr`, the local criterion's three taps.
  * The policy's surface beside forward: the options the JAX policy
    takes, sanity_check, the engine's synthetize / broadcasting /
    snapshot_stats, and the verbose walk, whose trajectory is the fused
    walk's.

Tolerance: rtol 1e-4 on composed float32 programs (G, D and VGG16
forward and backward); atol 1e-5 on entries near 0. The final w gets
atol 1e-3, a tenth of one step's lr: the gradients agree to ~3e-5 of
their largest entry, but Adam divides by sqrt(v_hat), so where a
gradient changes sign between steps (m_hat near 0) that small difference
grows into a step difference of up to a few 1e-4. The final images are
therefore held against the other package's synthesis of the same w.
"""

import os
import pickle
import random
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentaugment_tpu.augments import create_augment as create_augment_j
from latentaugment_tpu.augments import engine as engine_j
from latentaugment_tpu.augments import losses as losses_j
from latentaugment_tpu.augments import manifold as manifold_j
from latentaugment_tpu.data import create_dataset as create_dataset_j
from latentaugment_tpu.models import vgg as vgg_j
from latentaugment_tpu.models.stylegan2 import networks as net_j
from latentaugment_tpu.options import AugOptions as AugOptions_j
from latentaugment_tpu_torch import benchmark as benchmark_t
from latentaugment_tpu_torch.augments import create_augment as create_augment_t
from latentaugment_tpu_torch.augments import engine as engine_t
from latentaugment_tpu_torch.augments import losses as losses_t
from latentaugment_tpu_torch.data import create_dataset as create_dataset_t
from latentaugment_tpu_torch.models import vgg as vgg_t
from latentaugment_tpu_torch.models.stylegan2 import checkpoint as ckpt_t
from latentaugment_tpu_torch.models.stylegan2 import networks as net_t
from latentaugment_tpu_torch.options import AugOptions as AugOptions_t
from test_torch_port_common import _one_torch_thread  # noqa: F401 (autouse fixture)

RTOL, ATOL = 1e-4, 1e-5
W_ATOL = 1e-3  # final w after K Adam steps (see the module docstring)
RES, CROP, N_MODES, B, M, K = 32, 16, 2, 4, 6, 3
WEIGHTS = dict(w_lpips=10.0, w_pix=0.1, w_latent=0.001, w_disc=0.01)
CROP_POS = (2, 4)  # valid for center_crop_size(32) = 22 and crop 16
LOSS_KEYS = ("loss_latent", "loss_disc", "loss_pix", "loss_lpips", "loss")


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _vgg_np(seed):
    rng = np.random.RandomState(seed)
    params = _np(vgg_j.init_vgg(jax.random.PRNGKey(seed)))
    params["lin"] = {t: rng.uniform(0.5, 1.5, vgg_j.LPIPS_CHANNELS[t]).astype(np.float32)
                     for t in vgg_j.LPIPS_TAPS}
    return params


@pytest.fixture(scope="module")
def walked():
    cfg = dict(img_resolution=RES, img_channels=N_MODES, channel_base=1024, channel_max=64)
    g_cfg_j = net_j.generator_config(z_dim=64, w_dim=64, num_mapping_layers=2, **cfg)
    d_cfg_j = net_j.discriminator_config(**cfg)
    g_np = _np(net_j.generator_init(jax.random.PRNGKey(7), g_cfg_j))
    d_np = _np(net_j.discriminator_init(jax.random.PRNGKey(8), d_cfg_j))
    for block in g_np["synthesis"].values():
        for conv in ("conv0", "conv1"):
            if isinstance(block, dict) and conv in block:
                block[conv]["noise_strength"] = np.float32(0.2).reshape(())
    vgg_np = _vgg_np(3)

    rng = np.random.RandomState(5)
    W = rng.randn(M, g_cfg_j.num_ws, 64).astype(np.float32) * 0.5
    X = rng.uniform(-1, 1, (M, N_MODES, RES, RES)).astype(np.float32)
    feas = [rng.randn(M, 31232).astype(np.float32) * 0.02 for _ in range(N_MODES)]
    w0 = rng.randn(B, 1, 64).astype(np.float32) * 0.5

    # JAX side.
    bundle_j = engine_j.make_bundle(
        _jnp(g_np), _jnp(d_np), _jnp(vgg_np),
        W_summary=losses_j.manifold_summary(jnp.asarray(W)),
        X_cc_summaries=[losses_j.manifold_summary(
            manifold_j.center_crop(jnp.asarray(X), RES)[:, m:m + 1]) for m in range(N_MODES)],
        fea_summaries=[losses_j.manifold_summary(jnp.asarray(f)) for f in feas])
    fns_j = engine_j.make_walk_fns(g_cfg_j, d_cfg_j, n_modes=N_MODES, num_epochs=K,
                                   crop_size=CROP, remat=False, **WEIGHTS)

    @jax.jit
    def run_j(bundle, w0):
        _, ws_aug, traces = fns_j.walk(bundle, w0, jnp.asarray(CROP_POS, jnp.int32),
                                       jax.random.PRNGKey(0))
        return ws_aug, traces

    ws_j, traces_j = run_j(bundle_j, jnp.asarray(w0))

    # Port side.
    G = net_t.Generator(net_t.generator_config(z_dim=64, w_dim=64, num_mapping_layers=2, **cfg))
    G.load_state_dict(ckpt_t.params_to_state_dict(g_np))
    D = net_t.Discriminator(net_t.discriminator_config(**cfg))
    D.load_state_dict(ckpt_t.params_to_state_dict(d_np))
    G.requires_grad_(False)
    D.requires_grad_(False)
    t = torch.from_numpy
    bundle_t = engine_t.make_bundle(
        G, D, vgg_t.params_from_numpy(vgg_np),
        W_summary=losses_t.manifold_summary(t(W)),
        X_cc_summaries=[losses_t.manifold_summary(
            engine_t.manifold.center_crop(t(X), RES)[:, m:m + 1]) for m in range(N_MODES)],
        fea_summaries=[losses_t.manifold_summary(t(f)) for f in feas])
    fns_t = engine_t.make_walk_fns(G.cfg, n_modes=N_MODES, num_epochs=K,
                                   crop_size=CROP, **WEIGHTS)
    _, ws_t, traces_t = fns_t.walk(bundle_t, t(w0), CROP_POS, torch.Generator())
    with torch.no_grad():
        img_t = G.synthesis(ws_t, noise_mode="const")
    # The JAX image of the port's final w.
    img_j = jax.jit(lambda g, ws: net_j.synthesis_apply(g, g_cfg_j, ws, noise_mode="const"))(
        bundle_j["g"]["synthesis"], jnp.asarray(ws_t.numpy()))
    return dict(w0=w0, ws_j=ws_j, traces_j=traces_j, img_j=img_j,
                ws_t=ws_t, traces_t=traces_t, img_t=img_t)


@pytest.mark.parametrize("key", LOSS_KEYS)
def test_walk_loss_traces_match_jax(walked, key):
    assert tuple(walked["traces_t"][key].shape) == (K,)
    _close(walked["traces_t"][key], walked["traces_j"][key])


def test_walk_final_w_and_image_match_jax(walked):
    moved = np.abs(walked["ws_t"][:, :1].numpy() - walked["w0"]).mean()
    assert moved > 5e-3, f"walk barely moved w ({moved})"
    _close(walked["ws_t"], walked["ws_j"], rtol=0, atol=W_ATOL)
    _close(walked["img_t"], walked["img_j"])


# ----------------------------------------------------------------------------
# The policy, end to end.

def _run_policies(root, common=()):
    """Both packages' policies over one new workspace under `root`, with
    the extra options `common` given to both."""
    argv = benchmark_t.build_policy_workspace(
        root, res=RES, batch_size=B, num_epochs=K, crop_size=CROP,
        channel_base=1024, channel_max=64, n_patients=2, slices_per_patient=3, step=5)
    vgg_path = os.path.join(root, "vgg16.pkl")
    vgg_j.save_params(_vgg_np(4), vgg_path)

    def run(flavour, extra):
        # Each package gets its own copy of the workspace's interim tree and
        # its own checkpoints dir, so neither reads the other's caches.
        interim = os.path.join(root, f"interim_{flavour}")
        shutil.copytree(os.path.join(root, "interim"), interim)
        args = list(argv) + list(common) + extra
        args[args.index("--interim_dir") + 1] = interim
        args[args.index("--checkpoints_dir") + 1] = os.path.join(root, f"ckpts_{flavour}")
        options, create_dataset, create_augment = {
            "jax": (AugOptions_j, create_dataset_j, create_augment_j),
            "torch": (AugOptions_t, create_dataset_t, create_augment_t)}[flavour]
        opt = options().parse(argv=args, install_logger=False)
        dataset = create_dataset(opt)
        augment = create_augment(opt)
        batches = []
        for data in dataset:
            augment.set_input(data)
            augment.forward()
            out = augment.get_output()
            rec = dict(out=out, w_in=augment.get_latent_input()["w"],
                       w_out=augment.get_latent_output()["w"], paths=data["A_paths"],
                       data=data)
            if flavour == "torch":
                rec["traces"] = {k: v.numpy() for k, v in augment.latent_aug.last_traces.items()}
            batches.append(rec)
        return augment, batches

    old = os.environ.get("LATENTAUGMENT_VGG16")
    os.environ["LATENTAUGMENT_VGG16"] = vgg_path
    try:
        aug_j, batches_j = run("jax", [])
        aug_t, batches_t = run("torch", ["--device", "cpu"])
    finally:
        if old is None:
            os.environ.pop("LATENTAUGMENT_VGG16")
        else:
            os.environ["LATENTAUGMENT_VGG16"] = old

    # JAX per-step losses: its walk program again on each batch's input and
    # crop position (the same host stream both engines draw from).
    crop_rng = random.Random(42 + 1)
    eng = aug_j.latent_aug
    for rec in batches_j:
        pos = manifold_j.get_params(RES, CROP, rng=crop_rng)["crop_pos"]
        w = np.repeat(rec["w_in"][:, None, :], 1, axis=1)
        w = np.concatenate([w, np.repeat(w[-1:], B - len(w), axis=0)])  # the padding
        _, _, traces = eng._walk(eng._bundle, jnp.asarray(w), jnp.asarray(pos, jnp.int32),
                                 jax.random.PRNGKey(0))
        rec["traces"] = {k: np.asarray(v) for k, v in traces.items()}
    return aug_j, batches_j, aug_t, batches_t


@pytest.fixture(scope="module")
def policies(tmp_path_factory):
    return _run_policies(str(tmp_path_factory.mktemp("policy")))


@pytest.fixture(scope="module")
def policies_tr(tmp_path_factory):
    return _run_policies(str(tmp_path_factory.mktemp("policy_tr")),
                         ["--lpips_script", "lpips_tr"])


def test_policy_batches_and_latents_match_jax(policies):
    _, batches_j, _, batches_t = policies
    assert [len(b["paths"]) for b in batches_t] == [B, 2]  # last batch padded
    for bj, bt in zip(batches_j, batches_t, strict=True):
        assert bt["paths"] == bj["paths"]
        assert bt["out"]["A"].shape == (len(bt["paths"]), 1, RES, RES)
        _close(bt["w_in"], bj["w_in"], rtol=0, atol=0)
        _close(bt["w_out"], bj["w_out"], rtol=0, atol=W_ATOL)
        assert not np.allclose(bt["w_out"], bt["w_in"])


def test_policy_data_batches_match_jax(policies):
    """The port's loader yields the JAX package's batches: same members,
    same order, the same [-1, 1] images."""
    _, batches_j, _, batches_t = policies
    for bj, bt in zip(batches_j, batches_t, strict=True):
        assert sorted(bt["data"]) == sorted(bj["data"])
        assert bt["data"]["B_paths"] == bj["data"]["B_paths"]
        for k in ("A", "B"):
            assert bt["data"][k].dtype == bj["data"][k].dtype == np.float32
            np.testing.assert_array_equal(bt["data"][k], bj["data"][k])


def test_policy_step_losses_match_jax(policies):
    _, batches_j, _, batches_t = policies
    for bj, bt in zip(batches_j, batches_t, strict=True):
        for key in LOSS_KEYS:
            _close(bt["traces"][key], bj["traces"][key])


def test_policy_images_match_jax(policies):
    """The port's output images against the JAX generator's image of the
    port's final w. The workspace's noise strengths are zero, so the
    random final noise contributes nothing."""
    aug_j, _, _, batches_t = policies
    eng = aug_j.latent_aug
    synth = jax.jit(lambda g, ws: net_j.synthesis_apply(g, eng.G_cfg, ws, noise_mode="const"))
    for bt in batches_t:
        ws = np.repeat(bt["w_out"][:, None, :], eng.num_ws, axis=1)
        img_j = np.asarray(synth(eng._bundle["g"]["synthesis"], jnp.asarray(ws)))
        for m, k in enumerate(("A", "B")):
            _close(bt["out"][k], img_j[:, m:m + 1], rtol=RTOL, atol=1e-4)


def test_policy_manifold_summaries_match_jax(policies):
    aug_j, _, aug_t, _ = policies
    ej, et = aug_j.latent_aug, aug_t.latent_aug
    pairs = [(et.W_summary, ej.W_summary)]
    pairs += list(zip(et.X_cc_summaries, ej.X_cc_summaries, strict=True))
    pairs += list(zip(et.fea_summaries, ej.fea_summaries, strict=True))
    for (mean_t, msq_t), (mean_j, msq_j) in pairs:
        _close(mean_t, mean_j)
        _close(msq_t, msq_j)


def test_policy_skips_batch_above_p_thres(policies, tmp_path):
    """p_thres 1.0 never augments: the input comes back and the latent
    accessors refuse."""
    aug_t = policies[2]
    aug_t.p_thres = 1.0
    x = np.zeros((1, 1, RES, RES), np.float32)
    aug_t.set_input({"A": x, "B": x + 0.5, "A_paths": ["p"], "B_paths": ["p"]})
    aug_t.forward()
    assert not aug_t.augmented
    np.testing.assert_array_equal(aug_t.get_output()["B"], x + 0.5)
    with pytest.raises(RuntimeError):
        aug_t.get_latent_output()


# ----------------------------------------------------------------------------
# The local LPIPS criterion (--lpips_script lpips_tr) and the policy's
# surface beside forward.

def test_tr_policy_step_losses_and_latents_match_jax(policies_tr):
    aug_j, batches_j, aug_t, batches_t = policies_tr
    assert aug_t.latent_aug.lpips_variant == aug_j.latent_aug.lpips_variant == "tr"
    for bj, bt in zip(batches_j, batches_t, strict=True):
        for key in LOSS_KEYS:
            _close(bt["traces"][key], bj["traces"][key])
        _close(bt["w_in"], bj["w_in"], rtol=0, atol=0)
        _close(bt["w_out"], bj["w_out"], rtol=0, atol=W_ATOL)
    for (mean_t, msq_t), (mean_j, msq_j) in zip(aug_t.latent_aug.fea_summaries,
                                                aug_j.latent_aug.fea_summaries, strict=True):
        assert mean_t.shape[-1] == 256 * 4 * 4 + 512 * 2 * 2 + 512  # three taps of a 16x16 crop
        _close(mean_t, mean_j)
        _close(msq_t, msq_j)


def test_feature_caches_of_the_two_lpips_variants_have_different_names(policies, policies_tr):
    """Both variants' manifold features may share one interim tree."""
    def feature_caches(aug):
        eng = aug.latent_aug
        cache_dir = os.path.join(eng.interim_dir, eng.dataset, "cache_dir")
        return sorted(f for f in os.listdir(cache_dir) if "features_jit" in f)

    script, tr = feature_caches(policies[2]), feature_caches(policies_tr[2])
    assert len(script) == len(tr) == N_MODES
    assert all("-script-features_jit" in f for f in script), script
    assert all("-tr-features_jit" in f for f in tr), tr
    assert feature_caches(policies_tr[0]) == tr  # the JAX package's names


def test_options_of_the_jax_policy_parse(tmp_path):
    """A command line the JAX policy takes runs on the port's parser, with
    the same defaults."""
    base = ["--dataroot", "x.zip", "--aug", "latent", "--model_dir", "m", "--interim_dir", "i",
            "--checkpoints_dir", str(tmp_path)]
    extra = ["--lpips_script", "lpips_tr", "--verbose_log", "true", "--exp_inv", "00002",
             "--network_pkl_inv", "network-snapshot-000100.pkl"]
    opt = AugOptions_t().gather_options(base + extra)
    assert (opt.lpips_script, opt.verbose_log, opt.exp_inv, opt.network_pkl_inv) == \
        ("lpips_tr", True, "00002", "network-snapshot-000100.pkl")
    opt_t, opt_j = AugOptions_t().gather_options(base), AugOptions_j().gather_options(base)
    for k in ("lpips_script", "verbose_log", "exp_inv", "network_pkl_inv"):
        assert getattr(opt_t, k) == getattr(opt_j, k)


def test_sanity_check_runs_and_writes_both_pictures(policies):
    from latentaugment_tpu_torch.augments import latent_aug as latent_aug_t

    aug_t, batches_t = policies[2], policies[3]
    assert latent_aug_t.map_range(500.0) == 0.0
    aug_t.p_thres = 0.0
    aug_t.set_input(batches_t[0]["data"])
    aug_t.sanity_check()
    assert aug_t.augmented
    name = os.path.splitext(os.path.basename(batches_t[0]["paths"][0]))[0]
    for f in (f"{name}.png", f"{name}aug.png"):
        assert os.path.getsize(os.path.join(aug_t.save_dir, f)) > 0
    with pytest.raises(ValueError):
        aug_t.input_sanity_check(np.zeros((1, RES, RES + 1), np.float32))
    with pytest.raises(TypeError):
        aug_t.output_sanity_check(np.zeros((1, RES, RES), np.float64))


def test_engine_synthetize_broadcasting_and_snapshot_stats(policies):
    eng = policies[2].latent_aug
    w = np.random.RandomState(0).randn(2, 1, eng.w_dim).astype(np.float32)
    ws = eng.broadcasting(w)
    assert ws.shape == (2, eng.num_ws, eng.w_dim)
    np.testing.assert_array_equal(eng.reverse_broadcasting(ws), w)
    assert tuple(eng.broadcasting(torch.from_numpy(w)).shape) == ws.shape
    with pytest.raises(ValueError):
        eng.broadcasting(ws)
    img = eng.synthetize(ws)
    assert tuple(img.shape) == (2, N_MODES, RES, RES) and torch.isfinite(img).all()
    torch.testing.assert_close(img, eng.synthetize(ws))  # the default generator is seeded
    with pytest.raises(ValueError):
        eng.synthetize(w)
    eng._record_traces({"loss": torch.arange(float(K))}, wall=1.5)
    assert eng.stats_time["last_forward_s"] == 1.5
    eng.snapshot_stats(title="recorded")
    with open(os.path.join(eng.save_dir, "recorded.jsonl")) as f:
        assert '"epoch_2"' in f.read()
    with pytest.raises(TypeError, match="DeviceMesh"):
        engine_t.define_latentaugment("latent_aug", "train", None, None, None, mesh=object())


@pytest.fixture(scope="module")
def verbose_policy(policies):
    """The port's policy again on its workspace (the caches are there),
    with --verbose_log: its first batch runs the un-fused walk."""
    aug_t, batches_t = policies[2], policies[3]
    argv = ["--dataroot", aug_t.opt.dataroot, "--checkpoints_dir",
            os.path.join(aug_t.opt.checkpoints_dir, "verbose")]
    for k, v in vars(aug_t.opt).items():
        if k in ("dataset_mode", "load_size", "batch_size", "aug", "model_dir", "interim_dir",
                 "dataset_aug", "dataset_name_aug", "dataset_w_name", "img_resolution",
                 "crop_size_aug", "init_w", "step_img", "step_w", "opt_num_epochs", "opt_lr",
                 "w_lpips", "w_pix", "w_latent", "w_disc", "num_fp16_res", "device"):
            argv += [f"--{k}", str(v)]
    opt = AugOptions_t().parse(argv=argv + ["--p_thres", "0.0", "--verbose_log", "true"],
                               install_logger=False)
    # The VGG16 weights the fused policy ran with.
    old = os.environ.get("LATENTAUGMENT_VGG16")
    os.environ["LATENTAUGMENT_VGG16"] = os.path.join(
        os.path.dirname(aug_t.opt.checkpoints_dir), "vgg16.pkl")
    try:
        aug = create_augment_t(opt)
    finally:
        if old is None:
            os.environ.pop("LATENTAUGMENT_VGG16")
        else:
            os.environ["LATENTAUGMENT_VGG16"] = old
    aug.set_input(batches_t[0]["data"])
    aug.forward()
    return aug


def test_verbose_walk_takes_the_fused_walks_trajectory(policies, verbose_policy):
    fused = policies[3][0]
    eng = verbose_policy.latent_aug
    np.testing.assert_allclose(verbose_policy.get_latent_output()["w"], fused["w_out"],
                               rtol=0, atol=1e-6)
    for key in LOSS_KEYS:
        np.testing.assert_allclose(eng.last_traces[key].numpy(), fused["traces"][key],
                                   rtol=1e-6, atol=1e-7)
        # The terms evaluated one by one are the fused loss's terms.
        np.testing.assert_allclose([eng.stats_loss[f"epoch_{e}"][key] for e in range(K)],
                                   fused["traces"][key], rtol=1e-5, atol=1e-6)
    times = eng.stats_time["epoch_0"]
    assert {"time_latent", "time_disc", "time_pix", "time_lpips", "time_epoch"} <= set(times)
    assert eng.stats_time["last_forward_s"] >= times["time_epoch"]
    for title in ("losses", "times [s]"):
        assert os.path.isfile(os.path.join(eng.save_dir, f"{title}.jsonl"))


def test_verbose_walk_snapshots_pair_next_w_with_this_image(verbose_policy):
    """At batch 1 each step leaves w_<name>_<e>.pkl, the w after step e,
    beside <name>_<e>.png, the image of the w before it."""
    from PIL import Image

    eng = verbose_policy.latent_aug
    eng._verbose_done = False
    w0 = np.random.RandomState(3).randn(1, 1, eng.w_dim).astype(np.float32) * 0.5
    eng.forward(w0, fname=["train/p/train_p_00010.pickle"])
    snaps = []
    for e in range(K):
        with open(os.path.join(eng.save_dir, f"w_train_p_00010_{e}.pkl"), "rb") as f:
            snaps.append(pickle.load(f))
        assert snaps[-1].shape == (eng.w_dim,)
    assert np.abs(snaps[0] - w0[0, 0]).max() > 1e-3  # already one step away from w0
    with torch.no_grad():
        img0 = eng.G.synthesis(eng.broadcasting(torch.from_numpy(w0)), noise_mode="const")[0]
    strip = np.clip(np.concatenate(list(img0.numpy()), axis=1), -1.0, 1.0)
    want = ((strip + 1.0) / 2.0 * 255.0).astype(np.uint8)
    got = np.asarray(Image.open(os.path.join(eng.save_dir, "train_p_00010_0.png")))
    assert got.shape == (RES, N_MODES * RES)
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------------------
# The options parser against the JAX package's: the sweep override dict
# (`parse(args=...)`) and the JAX command line's compatibility flags.

_BASE = ["--dataroot", "x.zip"]
_LATENT = ["--aug", "latent", "--model_dir", "m", "--interim_dir", "i"]
_PARSE_CASES = {
    "geometric": (["--aug", "geometric"],
                  {"n_imgs": 8, "p_thres": 0.0, "horizontal_flip": False, "affine": False,
                   "elastic_deform": True, "opt_lr": 9.0}),
    "latent": (_LATENT, {"n_imgs": 8, "p_thres": 0.0, "opt_num_epochs": 5, "opt_lr": 0.02,
                         "w_lpips": 2.0, "w_pix": 0.5, "w_latent": 0.1, "w_disc": 0.2,
                         "init_w": "inv", "truncation_psi": 0.3}),
    "rand_aug": (_LATENT + ["--rand_aug"], {"n_imgs": 8, "p_thres": 0.3, "truncation_psi": 0.5,
                                            "opt_lr": 9.0}),
}


@pytest.mark.parametrize("case", sorted(_PARSE_CASES))
def test_parse_overrides_and_name_match_jax(case, tmp_path):
    """Each augment's override keys land, the others do not, and the
    experiment name records the operating point as the JAX package's."""
    argv, args = _PARSE_CASES[case]
    argv = _BASE + argv + ["--checkpoints_dir", str(tmp_path)]
    opt_j = AugOptions_j().parse(args=dict(args), argv=argv, install_logger=False)
    opt_t = AugOptions_t().parse(args=dict(args), argv=argv, install_logger=False)
    assert opt_t.name == opt_j.name
    assert set(vars(opt_j)) <= set(vars(opt_t)), set(vars(opt_j)) - set(vars(opt_t))
    for k, v in vars(opt_j).items():
        assert getattr(opt_t, k) == v, k
    assert os.path.isdir(os.path.join(str(tmp_path), opt_t.name))
    if case == "geometric":
        assert opt_t.name == ("experiment_name-n_imgs_8-p_thres_0.0-horizontal_flip_False"
                              "-affine_False-elastic_deform_True")
        assert opt_t.elastic_deform is True and opt_t.p_thres == 0.0
    elif case == "rand_aug":
        assert opt_t.name == "experiment_name-n_imgs_8-truncation_psi_0.5"
        assert opt_t.opt_lr == 0.01  # not an override key of rand_aug
    else:
        assert (opt_t.opt_num_epochs, opt_t.init_w, opt_t.truncation_psi) == (5, "inv", 1.0)


def test_jax_compatibility_flags_parse(tmp_path):
    """The JAX command line's --gpu_ids, --verbose, --suffix and
    --gpu_ids_aug parse as there (gpu_ids: the same list of ints, which
    selects nothing); --n_mesh_devices / --n_model_devices parse. Above 1,
    --n_model_devices without --n_mesh_devices raises a ValueError naming
    it, as the JAX policy does (tests/test_torch_port_tensor_parallel.py
    walks both over four ranks), and --n_mesh_devices without a process
    group of that size raises instead of walking on one process
    (tests/test_torch_port_parallel.py walks it over two ranks)."""
    argv = _BASE + _LATENT + ["--checkpoints_dir", str(tmp_path), "--gpu_ids", "0,1",
                              "--verbose", "--suffix", "_run", "--gpu_ids_aug", "1",
                              "--n_mesh_devices", "1", "--n_model_devices", "0"]
    opt_j = AugOptions_j().parse(argv=argv, install_logger=False)
    opt_t = AugOptions_t().parse(argv=argv, install_logger=False)
    for k in ("gpu_ids", "verbose", "suffix", "gpu_ids_aug", "n_mesh_devices", "n_model_devices"):
        assert getattr(opt_t, k) == getattr(opt_j, k), k
    assert opt_t.gpu_ids == [0, 1] and opt_t.verbose is True
    for flag, err, match in (("--n_mesh_devices", RuntimeError, "torchrun"),
                             ("--n_model_devices", ValueError, "n_mesh_devices")):
        opt = AugOptions_t().parse(argv=argv + [flag, "2", "--device", "cpu"],
                                   install_logger=False)
        with pytest.raises(err, match=match):
            create_augment_t(opt)


# ----------------------------------------------------------------------------
# The policy's remaining paths: rand_aug / forward_ganrand, soft_aug with
# alpha, lower_bound_clip.

@pytest.fixture(scope="module")
def rand_aug_policies(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("rand_aug"))
    argv = benchmark_t.build_policy_workspace(
        root, res=RES, batch_size=B, num_epochs=K, crop_size=CROP, channel_base=1024,
        channel_max=64, n_patients=1, slices_per_patient=4, step=5)
    argv += ["--rand_aug", "--truncation_psi", "0.7"]
    out = {}
    for flavour, options, create, extra in (
            ("jax", AugOptions_j, create_augment_j, []),
            ("torch", AugOptions_t, create_augment_t, ["--device", "cpu"])):
        args = list(argv) + extra
        args[args.index("--checkpoints_dir") + 1] = os.path.join(root, f"ckpts_{flavour}")
        opt = options().parse(argv=args, install_logger=False)
        out[flavour] = (create(opt), opt)
    return out


def test_rand_aug_ganrand_matches_jax(rand_aug_policies):
    """The same z through both engines' forward_ganrand (truncation 0.7):
    the same ws and, the workspace's noise strengths being zero, the same
    images; the port's policy in rand_aug mode returns the ganrand of its
    own seeded z, with no paths."""
    (aug_j, _), (aug_t, opt_t) = rand_aug_policies["jax"], rand_aug_policies["torch"]
    eng_j, eng_t = aug_j.latent_aug, aug_t.latent_aug
    assert opt_t.opt_num_epochs == 0 and eng_t.w_disc == eng_t.w_lpips == 0.0
    z = np.random.RandomState(8).randn(B, eng_t.z_dim).astype(np.float32)
    img_j, ws_j = eng_j.forward_ganrand(z, key=jax.random.PRNGKey(1))
    img_t, ws_t = eng_t.forward_ganrand(z)
    _close(ws_t, ws_j)
    _close(img_t, img_j, atol=1e-4)

    x = np.full((B, 1, RES, RES), 0.25, np.float32)
    paths = [f"train/p/train_p_{i:05d}.pickle" for i in range(B)]
    aug_t.set_input({"A": x, "B": x, "A_paths": paths, "B_paths": paths})
    aug_t.forward()
    out, lat = aug_t.get_output(), aug_t.get_latent_output()
    z_t = torch.randn((B, eng_t.z_dim), generator=torch.Generator().manual_seed(opt_t.seed))
    img_j, ws_j = eng_j.forward_ganrand(z_t.numpy(), key=jax.random.PRNGKey(1))
    assert aug_t.augmented and lat["paths"] == ""
    _close(lat["w"], np.asarray(ws_j)[:, 0])
    for m, k in enumerate(("A", "B")):
        _close(out[k], np.asarray(img_j)[:, m:m + 1], atol=1e-4)


def test_soft_aug_blends_like_jax():
    """soft_aug with alpha 0.3: the final w is alpha * walked + (1 - alpha)
    * w0, in both packages."""
    cfg = dict(img_resolution=16, img_channels=N_MODES, channel_base=1024, channel_max=64)
    g_cfg_j = net_j.generator_config(z_dim=64, w_dim=64, num_mapping_layers=2, **cfg)
    d_cfg_j = net_j.discriminator_config(**cfg)
    g_np = _np(net_j.generator_init(jax.random.PRNGKey(1), g_cfg_j))
    d_np = _np(net_j.discriminator_init(jax.random.PRNGKey(2), d_cfg_j))
    rng = np.random.RandomState(3)
    W = rng.randn(M, g_cfg_j.num_ws, 64).astype(np.float32) * 0.5
    w0 = rng.randn(B, 1, 64).astype(np.float32) * 0.5
    weights = dict(w_lpips=0.0, w_pix=0.0, w_latent=0.001, w_disc=0.01)
    alpha = 0.3
    bundle_j = engine_j.make_bundle(_jnp(g_np), _jnp(d_np),
                                    W_summary=losses_j.manifold_summary(jnp.asarray(W)))
    fns_j = engine_j.make_walk_fns(g_cfg_j, d_cfg_j, n_modes=N_MODES, num_epochs=K, crop_size=8,
                                   remat=False, soft_aug=True, alpha=alpha, **weights)
    _, ws_j, _ = jax.jit(fns_j.walk)(bundle_j, jnp.asarray(w0), jnp.asarray((0, 0), jnp.int32),
                                     jax.random.PRNGKey(0))
    G = net_t.Generator(net_t.generator_config(z_dim=64, w_dim=64, num_mapping_layers=2, **cfg))
    G.load_state_dict(ckpt_t.params_to_state_dict(g_np))
    D = net_t.Discriminator(net_t.discriminator_config(**cfg))
    D.load_state_dict(ckpt_t.params_to_state_dict(d_np))
    bundle_t = engine_t.make_bundle(G.requires_grad_(False), D.requires_grad_(False),
                                    W_summary=losses_t.manifold_summary(torch.from_numpy(W)))
    ws = {}
    for soft in (True, False):
        fns = engine_t.make_walk_fns(G.cfg, n_modes=N_MODES, num_epochs=K, crop_size=8,
                                     soft_aug=soft, alpha=alpha, **weights)
        ws[soft] = fns.walk(bundle_t, torch.from_numpy(w0), (0, 0), torch.Generator())[1]
    _close(ws[True], ws_j, rtol=0, atol=W_ATOL)
    blend = alpha * ws[False][:, :1] + (1 - alpha) * torch.from_numpy(w0)
    _close(ws[True][:, :1], blend, rtol=0, atol=1e-6)
    assert (ws[False] - ws[True]).abs().max() > 1e-3


@pytest.mark.parametrize("clip", [True, False], ids=["lower_bound_clip", "no_clip"])
def test_lower_bound_clip_matches_jax(clip, tmp_path):
    """Outputs under -1 are clipped to -1 with --lower_bound_clip, as in the
    JAX policy (val phase: the input comes back, clipped)."""
    argv = _BASE + _LATENT + ["--checkpoints_dir", str(tmp_path), "--phase", "val",
                              "--load_size", "8"] + (["--lower_bound_clip"] if clip else [])
    x = np.random.RandomState(4).uniform(-1.5, 1.0, (2, 1, 8, 8)).astype(np.float32)
    data = {"A": x, "B": x * 0.5 - 0.8, "A_paths": ["a", "b"], "B_paths": ["a", "b"]}
    outs = []
    for options, create, extra in ((AugOptions_j, create_augment_j, []),
                                   (AugOptions_t, create_augment_t, ["--device", "cpu"])):
        aug = create(options().parse(argv=argv + extra, install_logger=False))
        aug.set_input(data)
        aug.forward()
        outs.append(aug.get_output())
    for k in ("A", "B"):
        np.testing.assert_array_equal(outs[1][k], outs[0][k])
        assert (outs[1][k].min() >= -1.0) == clip
