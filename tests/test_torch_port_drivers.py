"""The port's sweep drivers (scripts/torch_backbone*.py) against the JAX
package's (backbone*.py), on the CPU, on one workspace that both read.

The workspace is the port's `build_policy_workspace` at 32x32 with tiny
G and D and a saved LPIPS VGG16 (as tests/test_torch_port_walk.py builds
its own); each package gets its own copy of the interim tree and its own
checkpoints directory, so neither reads the other's caches. The JAX
scripts run as tests/test_backbones.py runs them, on the CPU, the port's
with `--device cpu`, both with LATENTAUGMENT_N_IMGS at two batches.

  * backbone_latentaug: the dumped files match by name and keys, `img`
    (the batches as read) is bit-equal, `latent` (the inverted w) equal;
    `latent_aug` is the port's walk of those inputs bit for bit, and
    `img_aug` within the walk tests' image tolerance, rtol 1e-4 / atol
    1e-4, of the JAX generator's image of the port's walked w (the
    workspace's noise strengths are zero).

    The two walked w are not held to the walk tests' atol 1e-3: the
    drivers' operating point takes K=6 Adam steps, and w ends up to 2.2e-2
    apart on 10-17% of its coordinates. The walk's objective at the port's
    w and at the JAX package's w agree to OBJECTIVE_RTOL (measured
    4.2e-4), against a walk that moves it by 8%; and
    test_latentaug_walk_spread_is_the_packages_own shows the spread to be
    the walk's own: the step-0 gradients agree, the first step's
    differences are sign flips of gradients within rounding of 0, and the
    JAX package's walk of w moved by one float32 step leaves its own w
    past 1e-3 too (batch 1: 12% of the coordinates, beside the packages'
    17%; on batch 0 the packages' 2.2e-2 follows two first-step sign
    flips, which that nudge did not make).
  * backbone_sg2aug and backbone_geoaug: the files, keys and shapes of the
    JAX scripts' dumps; the values equal the port's policy called
    directly on the same batches (that policy is held to the JAX one in
    test_torch_port_walk.py and test_torch_port_geometric.py).
"""

import os
import pickle
import random
import runpy
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentaugment_tpu.augments import create_augment as create_augment_j
from latentaugment_tpu.models import vgg as vgg_j
from latentaugment_tpu.models.stylegan2 import convert as convert_j
from latentaugment_tpu.models.stylegan2 import networks as net_j
from latentaugment_tpu.options import AugOptions as AugOptions_j
from latentaugment_tpu_torch import benchmark
from latentaugment_tpu_torch.augments import create_augment, manifold
from latentaugment_tpu_torch.data import create_dataset
from latentaugment_tpu_torch.options import AugOptions
from test_torch_port_common import _one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from scripts import torch_backbone_geoaug, torch_backbone_latentaug, torch_backbone_sg2aug  # noqa: E402

RES, B = 32, 4
N_IMGS = 2 * B
IMG_RTOL, IMG_ATOL = 1e-4, 1e-4  # an image of a w (tests/test_torch_port_walk.py)
OBJECTIVE_RTOL = 1e-3            # the walk's objective at the two walked w
W_ATOL = 1e-3                    # a walked w (tests/test_torch_port_walk.py, K=3)
GRAD_RTOL = 1e-4                 # the step-0 gradient at w, of its max
KINK_RTOL = 1e-2                 # on a sample with an activation at a kink
K_SWEEP = torch_backbone_latentaug.params_space["opt_num_epochs"][0]


def _vgg_np(seed):
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    vgg_j.init_vgg(jax.random.PRNGKey(seed)))
    params["lin"] = {t: rng.uniform(0.5, 1.5, vgg_j.LPIPS_CHANNELS[t]).astype(np.float32)
                     for t in vgg_j.LPIPS_TAPS}
    return params


def _read_dumps(outdir):
    """{subdir: {file: unpickled}} of a driver's experiment directory."""
    dumps = {}
    for sub in sorted(os.listdir(outdir)):
        path = os.path.join(outdir, sub)
        if os.path.isdir(path):
            dumps[sub] = {}
            for f in sorted(os.listdir(path)):
                with open(os.path.join(path, f), "rb") as fh:
                    dumps[sub][f] = pickle.load(fh)
    return dumps


def _run_jax_script(script, argv):
    """A JAX driver in this process on the CPU, as a CLI with `argv`."""
    saved = sys.argv, sys.stdout, sys.stderr
    sys.argv = [script] + list(argv)
    try:
        with jax.default_device(jax.devices("cpu")[0]):
            runpy.run_path(os.path.join(REPO, script), run_name="__main__")
    finally:
        sys.argv, sys.stdout, sys.stderr = saved


def _experiment_dir(checkpoints_dir, tag):
    (d,) = [d for d in os.listdir(checkpoints_dir) if tag in d]
    return os.path.join(checkpoints_dir, d)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("drivers"))
    argv = benchmark.build_policy_workspace(
        root, res=RES, batch_size=B, num_epochs=3, crop_size=16, channel_base=1024,
        channel_max=64, n_patients=2, slices_per_patient=5, step=5)
    vgg_path = os.path.join(root, "vgg16.pkl")
    vgg_j.save_params(_vgg_np(4), vgg_path)
    return root, argv, vgg_path


def _argv_for(workspace, flavour, extra=()):
    root, argv, _ = workspace
    interim = os.path.join(root, f"interim_{flavour}")
    if not os.path.isdir(interim):
        shutil.copytree(os.path.join(root, "interim"), interim)
    args = list(argv) + list(extra)
    args[args.index("--interim_dir") + 1] = interim
    ckpts = os.path.join(root, f"ckpts_{flavour}")
    args[args.index("--checkpoints_dir") + 1] = ckpts
    return args, ckpts


@pytest.fixture
def env(workspace, monkeypatch):
    monkeypatch.setenv("LATENTAUGMENT_N_IMGS", str(N_IMGS))
    monkeypatch.setenv("LATENTAUGMENT_VGG16", workspace[2])


def _both(workspace, jax_script, torch_main, tag, extra=()):
    argv_j, ckpts_j = _argv_for(workspace, "jax", ["--name", tag, *extra])
    argv_t, ckpts_t = _argv_for(workspace, "torch", ["--name", tag, *extra, "--device", "cpu"])
    _run_jax_script(jax_script, argv_j)
    got = torch_main(argv_t, install_logger=False)
    return (_experiment_dir(ckpts_j, tag), _experiment_dir(ckpts_t, tag), got, argv_t)


def _same_layout(dumps_t, dumps_j):
    assert sorted(dumps_t) == sorted(dumps_j)
    for sub in dumps_j:
        assert sorted(dumps_t[sub]) == sorted(dumps_j[sub]), sub
        for f in dumps_j[sub]:
            bt, bj = dumps_t[sub][f], dumps_j[sub][f]
            assert sorted(bt) == sorted(bj), (sub, f)
            for k in bj:
                if isinstance(bj[k], np.ndarray):
                    assert np.asarray(bt[k]).shape == bj[k].shape, (sub, f, k)


@pytest.fixture(scope="module")
def latentaug(workspace):
    """Both LatentAugment sweeps over the workspace, the port's walk engine
    and the JAX package's at the sweep's operating point, and the crops the
    engines drew (the sanity check's batch first)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LATENTAUGMENT_N_IMGS", str(N_IMGS))
        mp.setenv("LATENTAUGMENT_VGG16", workspace[2])
        outdir_j, outdir_t, got, _ = _both(
            workspace, "backbone_latentaug.py", torch_backbone_latentaug.main, "lat_drv")
        engines = []
        for flavour, options, create in (("torch", AugOptions, create_augment),
                                         ("jax", AugOptions_j, create_augment_j)):
            args, _ = _argv_for(workspace, flavour, ["--name", "lat_drv", "--opt_num_epochs",
                                                     str(K_SWEEP)]
                                + (["--device", "cpu"] if flavour == "torch" else []))
            engines.append(create(options().parse(argv=args, install_logger=False)).latent_aug)
    crop_rng = random.Random(42 + 1)
    crops = [manifold.get_params(RES, 16, rng=crop_rng)["crop_pos"] for _ in range(3)]
    return dict(outdir_j=outdir_j, outdir_t=outdir_t, got=got, dumps_j=_read_dumps(outdir_j),
                dumps_t=_read_dumps(outdir_t), engine=engines[0], engine_j=engines[1],
                crops=crops)


def test_latentaug_driver_dumps_match_jax(workspace, latentaug):
    outdir_t, (outdir, times) = latentaug["outdir_t"], latentaug["got"]
    assert outdir == outdir_t and len(times) == 1 + N_IMGS // B  # the sanity check's batch too
    dumps_j, dumps_t = latentaug["dumps_j"], latentaug["dumps_t"]
    _same_layout(dumps_t, dumps_j)
    assert sorted(dumps_t["img"]) == ["img_0", "img_1"]
    assert sorted(dumps_t["latent_aug"]) == ["w_aug_0", "w_aug_1"]
    for f, bj in dumps_j["img"].items():
        bt = dumps_t["img"][f]
        assert bt["A_paths"] == bj["A_paths"]
        for k in ("A", "B"):
            assert bt[k].dtype == bj[k].dtype
            np.testing.assert_array_equal(bt[k], bj[k])
    for f, wj in dumps_j["latent"].items():
        np.testing.assert_array_equal(dumps_t["latent"][f]["w"], wj["w"])
        assert dumps_t["latent"][f]["paths"] == wj["paths"]
    # latent_aug: the port's walk of the dumped inputs at the crops the
    # engine drew (the sanity check's batch first), bit for bit; its
    # objective there equals the objective at the JAX package's w.
    engine, crops = latentaug["engine"], latentaug["crops"]
    for i in range(N_IMGS // B):
        w0 = torch.from_numpy(dumps_t["latent"][f"w_{i}"]["w"][:, None, :])
        _, ws, _ = engine._fns.walk(engine._bundle, w0, crops[1 + i], torch.Generator())
        np.testing.assert_array_equal(dumps_t["latent_aug"][f"w_aug_{i}"]["w"],
                                      ws[:, 0].numpy())

        def objective(w):
            w = torch.from_numpy(np.ascontiguousarray(w[:, None, :]))
            with torch.no_grad():
                return float(engine._fns.loss_fn(engine._bundle, w, crops[1 + i])[0])

        at_t = objective(dumps_t["latent_aug"][f"w_aug_{i}"]["w"])
        at_j = objective(dumps_j["latent_aug"][f"w_aug_{i}"]["w"])
        at_0 = objective(dumps_t["latent"][f"w_{i}"]["w"])
        assert abs(at_t - at_j) <= OBJECTIVE_RTOL * abs(at_j)
        assert abs(at_j - at_0) > 50 * abs(at_t - at_j)
    # img_aug: the JAX generator's image of the port's walked w.
    g_params, g_cfg, _, _ = convert_j.load_stylegan(
        workspace[1][workspace[1].index("--model_dir") + 1])
    synth = jax.jit(lambda ws: net_j.synthesis_apply(g_params["synthesis"], g_cfg, ws,
                                                     noise_mode="const"))
    for i in range(N_IMGS // B):
        w = dumps_t["latent_aug"][f"w_aug_{i}"]["w"]
        img = np.asarray(synth(jnp.asarray(np.repeat(w[:, None, :], g_cfg.num_ws, axis=1))))
        out = dumps_t["img_aug"][f"img_aug_{i}"]
        for m, k in enumerate(("A", "B")):
            np.testing.assert_allclose(out[k], img[:, m:m + 1], rtol=IMG_RTOL, atol=IMG_ATOL)
        assert not np.allclose(out["A"], dumps_j["img"][f"img_{i}"]["A"])


def test_latentaug_walk_spread_is_the_packages_own(latentaug):
    """Why the two walked w are not held to W_ATOL, with the JAX package as
    its own witness.

    The step-0 gradient at w: the port's is the JAX package's within
    GRAD_RTOL of its max on every sample but at most one per batch, and
    within KINK_RTOL on that one. (Measured: batch 1 6.6e-6; batch 0
    3.6e-3 on sample 1 and 2.2e-5 on the rest. On that sample an
    activation of G sits at a kink, lrelu's 0 or the clamp, within
    rounding: the gradients of the pixel, LPIPS and D terms with respect to
    the image agree to 2e-6, and the JAX package's compiled gradient is
    3.6e-3 from its own op-by-op gradient, which the port's meets to 3.0e-5.
    The op-by-op JAX gradient is not computed here: it takes a minute.)
    Adam's first step is lr * sign(g), so a coordinate whose gradient lies
    within that rounding of 0 steps by lr one way in one package and the
    other way in the other: every coordinate of the first step's w more
    than W_ATOL apart is such a sign flip. The walk amplifies from there:
    the JAX package's walk of w moved by one float32 step (signs seeded)
    leaves its own walked w past W_ATOL too (measured 4.6e-3 on 12% of the
    coordinates of batch 1, beside port vs JAX 5.1e-3 on 17%)."""
    eng, eng_j, crops = latentaug["engine"], latentaug["engine_j"], latentaug["crops"]
    dumps_j, dumps_t = latentaug["dumps_j"], latentaug["dumps_t"]
    grad_j = jax.jit(jax.grad(lambda w, bundle, pos: eng_j._fns.loss_fn(w, bundle, pos)[0]))
    step_j = jax.jit(eng_j._fns.adam_step)
    rng = np.random.RandomState(0)
    past = []
    for i in range(N_IMGS // B):
        w0 = dumps_j["latent"][f"w_{i}"]["w"][:, None, :]
        pos, pos_j = crops[1 + i], jnp.asarray(crops[1 + i], jnp.int32)
        g_j = np.asarray(grad_j(jnp.asarray(w0), eng_j._bundle, pos_j))
        w_leaf = torch.from_numpy(w0.copy()).requires_grad_(True)
        g_t, = torch.autograd.grad(eng._fns.loss_fn(eng._bundle, w_leaf, pos)[0], w_leaf)
        g_t = g_t.numpy()
        per_sample = (np.abs(g_t - g_j) / np.abs(g_j).max()).reshape(B, -1).max(axis=1)
        assert (per_sample > GRAD_RTOL).sum() <= 1 and per_sample.max() <= KINK_RTOL, per_sample

        zeros = np.zeros_like(w0)
        w1_t = eng._fns.adam_step(eng._bundle, tuple(torch.from_numpy(a.copy())
                                                     for a in (w0, zeros, zeros)), 0, pos)[0][0]
        w1_j = np.asarray(step_j(eng_j._bundle, tuple(jnp.asarray(a) for a in (w0, zeros, zeros)),
                                 jnp.float32(0), pos_j)[0][0])
        apart = np.abs(w1_t.numpy() - w1_j) > W_ATOL
        assert (np.sign(g_t[apart]) != np.sign(g_j[apart])).all()

        signs = np.where(rng.rand(*w0.shape) < 0.5, -np.inf, np.inf).astype(np.float32)
        w_nudged = np.asarray(eng_j._walk(eng_j._bundle, jnp.asarray(np.nextafter(w0, signs)),
                                          pos_j, jax.random.PRNGKey(0))[1][:, 0])
        w_aug_j = dumps_j["latent_aug"][f"w_aug_{i}"]["w"]
        d_jj = np.abs(w_nudged - w_aug_j)
        d_tj = np.abs(dumps_t["latent_aug"][f"w_aug_{i}"]["w"] - w_aug_j)
        print(f"batch {i}: step-0 gradient port vs JAX by sample {per_sample}; first step "
              f"{apart.sum()} coordinates apart, all sign flips; walked w, JAX vs JAX from w "
              f"moved by one float32 step {d_jj.max():.2e} ({(d_jj > W_ATOL).mean():.2%} past "
              f"{W_ATOL}), port vs JAX {d_tj.max():.2e} ({(d_tj > W_ATOL).mean():.2%})")
        past.append((d_jj > W_ATOL).mean())
    assert max(past) > 0



def _policy_outputs(argv, n_batches, latents=False):
    """The port's policy called directly, as the drivers call it: the
    sanity check's batch first, then n_batches batches."""
    opt = AugOptions().parse(argv=argv, install_logger=False)
    dataset = create_dataset(opt)
    augment = create_augment(opt)
    augment.set_input(next(iter(dataset)))
    augment.sanity_check()
    outs = []
    for i, data in enumerate(dataset):
        if i >= n_batches:
            break
        augment.set_input(data)
        augment.forward()
        outs.append((augment.get_output(),
                     augment.get_latent_output() if latents else None))
    return outs


def test_sg2aug_driver_dumps_match_jax_and_the_policy(workspace, env):
    outdir_j, outdir_t, runs, argv_t = _both(
        workspace, "backbone_sg2aug.py", torch_backbone_sg2aug.main, "sg2_drv", ["--rand_aug"])
    assert [r[0] for r in runs] == [outdir_t]
    dumps_j, dumps_t = _read_dumps(outdir_j), _read_dumps(outdir_t)
    _same_layout(dumps_t, dumps_j)
    assert sorted(dumps_t["latent_aug"]) == ["w_aug_0", "w_aug_1"] and not dumps_t["latent"]
    ref = _policy_outputs(argv_t, N_IMGS // B, latents=True)
    for i, (out, lat) in enumerate(ref):
        got = dumps_t["img_aug"][f"img_aug_{i}"]
        for k in ("A", "B"):
            assert got[k].shape == (B, 1, RES, RES)
            np.testing.assert_array_equal(got[k], out[k])
        np.testing.assert_array_equal(dumps_t["latent_aug"][f"w_aug_{i}"]["w"], lat["w"])


def test_geoaug_driver_dumps_match_jax_and_the_policy(workspace, env):
    root, argv, _ = workspace
    geo = ["--dataroot", argv[argv.index("--dataroot") + 1], "--dataset_mode", "pelvis",
           "--load_size", str(RES), "--batch_size", str(B), "--aug", "geometric"]
    argv_j = geo + ["--checkpoints_dir", os.path.join(root, "geo_j"), "--name", "geo_drv"]
    argv_t = geo + ["--checkpoints_dir", os.path.join(root, "geo_t"), "--name", "geo_drv",
                    "--device", "cpu"]
    _run_jax_script("backbone_geoaug.py", argv_j)
    outdir, times = torch_backbone_geoaug.main(argv_t, install_logger=False)
    assert len(times) == 1 + N_IMGS // B
    outdir_j = _experiment_dir(os.path.join(root, "geo_j"), "geo_drv")
    assert os.path.basename(outdir) == os.path.basename(outdir_j)  # the same operating point
    dumps_j, dumps_t = _read_dumps(outdir_j), _read_dumps(outdir)
    _same_layout(dumps_t, dumps_j)
    assert sorted(dumps_t["img_aug"]) == ["img_aug_0", "img_aug_1"]
    for f, bj in dumps_j["img"].items():
        np.testing.assert_array_equal(dumps_t["img"][f]["A"], bj["A"])
    ref = _policy_outputs(argv_t + ["--p_thres", "0.0", "--horizontal_flip", "--affine",
                                    "--elastic_deform"], N_IMGS // B)
    for i, (out, _) in enumerate(ref):
        for k in ("A", "B"):
            np.testing.assert_array_equal(dumps_t["img_aug"][f"img_aug_{i}"][k], out[k])
