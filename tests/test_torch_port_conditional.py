"""The port's conditional walk (c_dim > 0) against the JAX package's, on
the CPU (counterpart: tests/test_conditional_walk.py, without its sharded
case, which is the mesh's).

Labels `c` [B, c_dim] reach the projection discriminator inside the walk
and the mapping for z input (`z_to_w`, `ganrand`); the engine's
`forward` / `forward_ganrand` take them and refuse labels an
unconditional checkpoint would ignore. 16x16, channel_base 1024,
channel_max 64, c_dim 3, K=3, no VGG (the labels' path is D and the
mapping).

Tolerance: the walked w atol 1e-3 (a tenth of one step's lr, as in
test_torch_port_walk.py); mapped w and ganrand images rtol 1e-4.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentaugment_tpu.augments import engine as engine_j
from latentaugment_tpu.models.stylegan2 import projector as proj_j
from latentaugment_tpu.options import AugOptions as AugOptions_j
from latentaugment_tpu_torch import benchmark
from latentaugment_tpu_torch.augments import engine as engine_t
from latentaugment_tpu_torch.models.stylegan2 import projector as proj_t
from latentaugment_tpu_torch.options import AugOptions as AugOptions_t
from test_torch_port_common import _one_torch_thread  # noqa: F401 (autouse fixture)

RES, C_DIM, N_MODES, K = 16, 3, 2, 3
W_ATOL = 1e-3
CPU = torch.device("cpu")
WEIGHTS = ["--w_pix", "0.1", "--w_lpips", "0.0", "--w_latent", "0.001", "--w_disc", "0.05"]


def _one_hot(labels):
    return np.eye(C_DIM, dtype=np.float32)[np.asarray(labels)]


@pytest.fixture(scope="module")
def cond_setup():
    return benchmark.build_synthetic_setup(
        CPU, res=RES, channel_base=1024, channel_max=64, num_epochs=K, crop_size=8,
        w_pix=0.1, w_lpips=0.0, w_latent=0.001, w_disc=0.05, manifold_items=16, c_dim=C_DIM)


def test_conditional_walk_runs_and_depends_on_labels(cond_setup):
    fns, bundle, g_cfg = cond_setup
    w0 = torch.randn([4, 1, g_cfg.w_dim], generator=torch.Generator().manual_seed(1)) * 0.1
    c_a, c_b = torch.from_numpy(_one_hot([0, 1, 2, 0])), torch.from_numpy(_one_hot([2, 0, 1, 1]))

    def walk(c):
        return fns.walk(bundle, w0, (1, 2), torch.Generator().manual_seed(2), c)

    img_a, ws_a, traces_a = walk(c_a)
    _, ws_a2, _ = walk(c_a)
    _, ws_b, _ = walk(c_b)
    assert torch.isfinite(img_a).all() and tuple(traces_a["loss_disc"].shape) == (K,)
    assert torch.equal(ws_a, ws_a2)  # deterministic given the labels
    assert (ws_a - ws_b).abs().max() > 0  # the projection D steers per label
    with pytest.raises(ValueError, match="c_dim"):  # the conditional D needs them
        fns.walk(bundle, w0, (1, 2), torch.Generator())


def test_conditional_mapping_paths(cond_setup):
    fns, bundle, g_cfg = cond_setup
    z = torch.randn([4, g_cfg.z_dim], generator=torch.Generator().manual_seed(3))
    w_a = fns.z_to_w(bundle, z, torch.from_numpy(_one_hot([0, 0, 1, 2])))
    w_b = fns.z_to_w(bundle, z, torch.from_numpy(_one_hot([1, 1, 0, 0])))
    assert tuple(w_a.shape) == (4, 1, g_cfg.w_dim) and (w_a - w_b).abs().max() > 0
    img, ws = fns.ganrand(bundle, z, torch.Generator().manual_seed(4),
                          torch.from_numpy(_one_hot([0, 1, 2, 0])))
    assert tuple(img.shape) == (4, N_MODES, RES, RES) and torch.isfinite(img).all()
    with pytest.raises(ValueError, match="c_dim"):  # a clear error, not a silent wrong answer
        fns.z_to_w(bundle, z)


def test_unconditional_signature_unchanged():
    fns, bundle, g_cfg = benchmark.build_synthetic_setup(
        CPU, res=RES, channel_base=1024, channel_max=64, num_epochs=2, crop_size=8, w_pix=0.0,
        w_lpips=0.0, w_latent=0.0, w_disc=0.05)
    w0 = torch.randn([4, 1, g_cfg.w_dim], generator=torch.Generator().manual_seed(1)) * 0.1
    img, ws, traces = fns.walk(bundle, w0, (1, 2), torch.Generator().manual_seed(2))
    assert torch.isfinite(img).all() and set(traces) == {"loss_disc", "loss"}


def _engines(root, c_dim):
    """The JAX and the port engine over one workspace with a native
    checkpoint of this c_dim, each with its own copy of the interim tree."""
    argv = benchmark.build_policy_workspace(
        root, res=RES, batch_size=4, num_epochs=K, crop_size=8, channel_base=1024,
        channel_max=64, n_patients=1, slices_per_patient=4, step=5, c_dim=c_dim) + WEIGHTS
    out = {}
    for flavour, options, extra in (("jax", AugOptions_j, []), ("torch", AugOptions_t,
                                                                  ["--device", "cpu"])):
        interim = os.path.join(root, f"interim_{flavour}")
        shutil.copytree(os.path.join(root, "interim"), interim)
        args = list(argv) + extra
        args[args.index("--interim_dir") + 1] = interim
        args[args.index("--checkpoints_dir") + 1] = os.path.join(root, f"ckpts_{flavour}")
        opt = options().parse(argv=args, install_logger=False)
        save_dir = os.path.join(root, f"save_{flavour}")
        os.makedirs(save_dir)
        out[flavour] = (engine_j.define_latentaugment("latent_aug", "train", opt, save_dir)
                        if flavour == "jax" else
                        engine_t.define_latentaugment("latent_aug", "train", opt, save_dir, CPU))
    return out["jax"], out["torch"]


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    return _engines(str(tmp_path_factory.mktemp("cond")), C_DIM)


def test_engine_forward_with_labels_matches_jax(engines):
    eng_j, eng_t = engines
    rng = np.random.RandomState(0)
    w = rng.randn(4, 1, eng_t.w_dim).astype(np.float32) * 0.1
    c_a, c_b = _one_hot([0, 1, 2, 0]), _one_hot([2, 0, 1, 1])
    key = jax.random.PRNGKey(5)
    # Both engines draw their crops from one seeded host stream, in turn.
    for c in (c_a, c_b):
        _, ws_j = eng_j.forward(w, key=key, c=c)
        _, ws_t = eng_t.forward(w, c=c)
        np.testing.assert_allclose(ws_t.numpy(), np.asarray(ws_j), rtol=0, atol=W_ATOL)
        assert np.abs(ws_t.numpy()[:, 0] - w[:, 0]).max() > 5e-3  # the walk moved
    _, ws_a = eng_t.forward(w, c=c_a)
    _, ws_b = eng_t.forward(w, c=c_b)
    assert (ws_a - ws_b).abs().max() > 0  # the labels steer the walk
    # z input: the labels also feed the mapping.
    z = rng.randn(4, eng_t.z_dim).astype(np.float32)
    w_t = eng_t._fns.z_to_w(eng_t._bundle, torch.from_numpy(z), torch.from_numpy(c_a))
    w_j = eng_j._cond_fn("z_to_w")(eng_j._bundle, jnp.asarray(z), jnp.asarray(c_a))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=1e-4, atol=1e-5)
    img_z, _ = eng_t.forward(z, c=c_a)
    assert torch.isfinite(img_z).all()


def test_engine_ganrand_with_labels_matches_jax(engines):
    """The workspace's noise strengths are zero, so the random final noise
    adds nothing and the images compare."""
    eng_j, eng_t = engines
    z = np.random.RandomState(1).randn(4, eng_t.z_dim).astype(np.float32)
    c = _one_hot([1, 2, 0, 1])
    img_j, ws_j = eng_j.forward_ganrand(z, key=jax.random.PRNGKey(2), c=c)
    img_t, ws_t = eng_t.forward_ganrand(z, c=c)
    np.testing.assert_allclose(ws_t.numpy(), np.asarray(ws_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), rtol=1e-4, atol=1e-4)


def test_engine_refuses_mis_shaped_or_missing_labels(engines):
    eng_t = engines[1]
    z = np.zeros((2, eng_t.z_dim), np.float32)
    with pytest.raises(ValueError, match="one-hot"):
        eng_t.forward(z, c=np.ones((2, C_DIM + 1), np.float32))
    with pytest.raises(ValueError, match="one-hot"):
        eng_t.forward_ganrand(z, c=np.ones((3, C_DIM), np.float32))
    with pytest.raises(ValueError, match="c_dim"):  # a conditional checkpoint needs labels
        eng_t.forward(z)


def test_labels_for_an_unconditional_checkpoint_are_refused(tmp_path):
    argv = benchmark.build_policy_workspace(
        str(tmp_path), res=RES, batch_size=4, num_epochs=1, crop_size=8, channel_base=1024,
        channel_max=64, n_patients=1, slices_per_patient=4, step=5) + WEIGHTS
    opt = AugOptions_t().parse(argv=argv + ["--device", "cpu"], install_logger=False)
    eng = engine_t.define_latentaugment("latent_aug", "train", opt, str(tmp_path), CPU)
    w = np.zeros((2, 1, eng.w_dim), np.float32)
    for call in (lambda: eng.forward(w, c=_one_hot([0, 1])),
                 lambda: eng.forward_ganrand(w[:, 0], c=_one_hot([0, 1]))):
        with pytest.raises(ValueError, match="unconditional"):
            call()
    img, ws = eng.forward(w)  # the unconditional signature is unchanged
    assert tuple(ws.shape) == (2, eng.num_ws, eng.w_dim) and torch.isfinite(img).all()


def test_w_stats_over_labels_match_jax(engines):
    """Both packages' w_stats over the JAX package's own z and uniform
    one-hot label draws; the port's seeded draws of its own are
    reproducible and average over the labels too."""
    eng_j, eng_t = engines
    n, key = 256, jax.random.PRNGKey(3)
    w_avg_j, w_std_j = proj_j.w_stats(eng_j.G_params["mapping"], eng_j.G_cfg, key, n_samples=n)
    zk, ck = jax.random.split(key)
    z = np.asarray(jax.random.normal(zk, (n, eng_j.G_cfg.z_dim)))
    c = np.asarray(jax.nn.one_hot(jax.random.randint(ck, (n,), 0, C_DIM), C_DIM))
    w_avg_t, w_std_t = proj_t.w_stats_from_z(eng_t.G, torch.from_numpy(z), torch.from_numpy(c))
    np.testing.assert_allclose(w_avg_t.numpy(), np.asarray(w_avg_j), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(w_std_t), float(w_std_j), rtol=1e-5)
    a = proj_t.w_stats(eng_t.G, torch.Generator().manual_seed(5), n_samples=64)
    b = proj_t.w_stats(eng_t.G, torch.Generator().manual_seed(5), n_samples=64)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and a[1] > 0
    # One label throughout gives another average.
    one = proj_t.w_stats_from_z(eng_t.G, torch.from_numpy(z),
                                torch.from_numpy(_one_hot(np.zeros(n, int))))
    assert (one[0] - w_avg_t).abs().max() > 1e-4
