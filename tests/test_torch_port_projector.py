"""Parity of the port's W-space projector with the JAX package, on the
CPU, and its command line end to end.

One set of numpy generator and VGG16 weights and one numpy target batch
go through `make_project_fn` of both packages with the exploration noise
off (random draws cannot agree between the frameworks). Tolerances: the
per-step distances rtol 1e-4 (composed float32 programs). The projected w
after 6 steps gets atol 1e-2, a tenth of one step at the projector's lr
of 0.1, by the rule that gives the walk (lr 0.01) its 1e-3: Adam divides
by sqrt(v_hat), so where a gradient entry is near 0 its rounding decides
the step's sign. Measured max |port - jax|: 4.2e-3 with pix_weight 0,
1.5e-3 with pix_weight 0.5. The schedule is held against the JAX
package's float32 formula at every step of a 1000-step run.
"""

import json
import os
import pickle
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from synthetic import MODALITIES, RES, build_workspace

from latentaugment_tpu.models import vgg as vgg_j
from latentaugment_tpu.models.stylegan2 import networks as net_j
from latentaugment_tpu.models.stylegan2 import projector as proj_j
from latentaugment_tpu_torch.augments import create_augment, manifold
from latentaugment_tpu_torch.data import create_dataset
from latentaugment_tpu_torch.data import write_tozip
from latentaugment_tpu_torch.models import vgg as vgg_t
from latentaugment_tpu_torch.models.stylegan2 import checkpoint as ckpt_t
from latentaugment_tpu_torch.models.stylegan2 import networks as net_t
from latentaugment_tpu_torch.models.stylegan2 import projector as proj_t
from latentaugment_tpu_torch.options import AugOptions

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from scripts.torch_project_dataset import main as project_main  # noqa: E402
from test_torch_port_common import _one_torch_thread  # noqa: F401 (autouse fixture)

STEPS, B = 6, 3
W_ATOL = 1e-2  # see the module docstring


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def tiny():
    cfg = dict(z_dim=32, w_dim=32, img_resolution=RES, img_channels=2, channel_base=512,
               channel_max=64, num_mapping_layers=2)
    g_cfg_j = net_j.generator_config(**cfg)
    g_np = _np(net_j.generator_init(jax.random.PRNGKey(0), g_cfg_j))
    vgg_np = _np(vgg_j.init_vgg(jax.random.PRNGKey(1)))
    G = net_t.Generator(net_t.generator_config(**cfg))
    G.load_state_dict(ckpt_t.params_to_state_dict(g_np))
    G.requires_grad_(False)
    target = np.random.RandomState(2).uniform(-1, 1, (B, 2, RES, RES)).astype(np.float32)
    return dict(g_cfg_j=g_cfg_j, g_j=jax.tree_util.tree_map(jnp.asarray, g_np),
                vgg_j=jax.tree_util.tree_map(jnp.asarray, vgg_np), G=G,
                vgg_t=vgg_t.params_from_numpy(vgg_np), target=target)


@pytest.fixture(scope="module")
def stats(tiny):
    """w_avg and w_std of both packages over the JAX package's own z draws."""
    n, key = 256, jax.random.PRNGKey(3)
    w_avg_j, w_std_j = proj_j.w_stats(tiny["g_j"]["mapping"], tiny["g_cfg_j"], key, n_samples=n)
    z = np.array(jax.random.normal(jax.random.split(key)[0], (n, tiny["g_cfg_j"].z_dim)))
    w_avg_t, w_std_t = proj_t.w_stats_from_z(tiny["G"], torch.from_numpy(z))
    return (w_avg_j, w_std_j), (w_avg_t, w_std_t), z


def test_w_stats_on_fed_z_match_jax(tiny, stats):
    (w_avg_j, w_std_j), (w_avg_t, w_std_t), z = stats
    assert tuple(w_avg_t.shape) == (1, 1, 32) and w_std_t.ndim == 0
    np.testing.assert_allclose(w_avg_t.numpy(), np.asarray(w_avg_j), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(w_std_t), float(w_std_j), rtol=1e-5)
    # The root of the total squared deviation per sample, not a per-coordinate std.
    with torch.no_grad():
        w = tiny["G"].mapping(torch.from_numpy(z), broadcast=False).numpy()
    assert np.isclose(float(w_std_t), np.sqrt(((w - w.mean(0)) ** 2).sum() / len(z)), rtol=1e-5)
    assert float(w_std_t) > 2 * w.std(axis=0).mean()
    # Seeded draws of its own.
    a = proj_t.w_stats(tiny["G"], torch.Generator().manual_seed(5), n_samples=64)
    b = proj_t.w_stats(tiny["G"], torch.Generator().manual_seed(5), n_samples=64)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and a[1] > 0


def test_schedule_matches_the_jax_formula_at_every_step():
    """The JAX scan computes lr and the noise scale in float32 (its `t`
    is a float32 array): double precision agrees to float32 rounding."""
    n = 1000
    t_frac = jnp.arange(n, dtype=jnp.float32) / n
    noise_j = 0.05 * jnp.square(jnp.maximum(0.0, 1.0 - t_frac / 0.75))
    ramp = jnp.minimum(1.0, (1.0 - t_frac) / 0.25)
    ramp = (0.5 - 0.5 * jnp.cos(ramp * jnp.pi)) * jnp.minimum(1.0, t_frac / 0.05)
    lr_j = 0.1 * ramp
    lr_t, noise_t = zip(*(proj_t.schedule(t, n) for t in range(n)))
    np.testing.assert_allclose(lr_t, np.asarray(lr_j), rtol=2e-5, atol=1e-8)
    np.testing.assert_allclose(noise_t, np.asarray(noise_j), rtol=2e-5, atol=1e-9)
    assert lr_t[0] == 0.0 and lr_t[50] == pytest.approx(0.1) and lr_t[749] == pytest.approx(0.1)
    assert 0 < lr_t[999] < lr_t[900] < 0.1
    assert noise_t[0] == 0.05 and noise_t[750] == 0.0 and noise_t[999] == 0.0


@pytest.fixture(scope="module")
def projected(tiny, stats):
    """{pix_weight: (jax (w, dists), port (w, dists))}, noise off."""
    (w_avg_j, w_std_j), (w_avg_t, w_std_t), _ = stats
    out = {}
    for pix_weight in (0.0, 0.5):
        kw = dict(num_steps=STEPS, initial_noise_factor=0.0, pix_weight=pix_weight)
        fn_j = jax.jit(proj_j.make_project_fn(tiny["g_cfg_j"], **kw))
        w_j, d_j = fn_j(tiny["g_j"], tiny["vgg_j"], jnp.asarray(tiny["target"]), w_avg_j,
                        w_std_j, jax.random.PRNGKey(0))
        fn_t = proj_t.make_project_fn(tiny["G"].cfg, **kw)
        w_t, d_t = fn_t(tiny["G"], tiny["vgg_t"], torch.from_numpy(tiny["target"]), w_avg_t,
                        w_std_t, None)
        out[pix_weight] = ((np.asarray(w_j), np.asarray(d_j)), (w_t.numpy(), d_t.numpy()))
    return out


@pytest.mark.parametrize("pix_weight", [0.0, 0.5])
def test_projection_matches_jax(projected, stats, pix_weight):
    (w_j, d_j), (w_t, d_t) = projected[pix_weight]
    assert w_t.shape == (B, 1, 32) and d_t.shape == (STEPS,)
    np.testing.assert_allclose(d_t, d_j, rtol=1e-4)
    np.testing.assert_allclose(w_t, w_j, rtol=0, atol=W_ATOL)
    assert np.abs(w_t - stats[1][0].numpy()).mean() > 0.05  # it left w_avg
    assert d_t[-1] < d_t[1]  # and descended (step 0 has lr 0)


def test_pix_weight_adds_the_pixel_term(projected):
    assert projected[0.5][1][1][0] > projected[0.0][1][1][0]


@pytest.mark.parametrize("remat,checkpoint_feats", [(True, False), (False, True), (True, True)])
def test_remat_and_checkpoint_feats_keep_the_values(tiny, stats, projected, remat,
                                                    checkpoint_feats):
    _, (w_avg_t, w_std_t), _ = stats
    fn = proj_t.make_project_fn(tiny["G"].cfg, num_steps=STEPS, initial_noise_factor=0.0,
                                pix_weight=0.5, remat=remat, checkpoint_feats=checkpoint_feats)
    w, d = fn(tiny["G"], tiny["vgg_t"], torch.from_numpy(tiny["target"]), w_avg_t, w_std_t)
    np.testing.assert_allclose(d.numpy(), projected[0.5][1][1], rtol=1e-6)
    np.testing.assert_allclose(w.numpy(), projected[0.5][1][0], rtol=0, atol=1e-5)


def test_exploration_noise_is_drawn_from_the_given_generator(tiny, stats):
    _, (w_avg_t, w_std_t), _ = stats
    fn = proj_t.make_project_fn(tiny["G"].cfg, num_steps=3)
    target = torch.from_numpy(tiny["target"])

    def run(seed):
        return fn(tiny["G"], tiny["vgg_t"], target, w_avg_t, w_std_t,
                  torch.Generator().manual_seed(seed))[0]

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_broadcast_rows():
    w = torch.arange(6, dtype=torch.float32).reshape(2, 1, 3)
    rows = proj_t.broadcast_rows(w, 4)
    assert len(rows) == 2 and rows[1].shape == (4, 3) and rows[1].dtype == np.float32
    np.testing.assert_array_equal(rows[1], np.tile([3.0, 4.0, 5.0], (4, 1)))


def test_write_tozip_command_line(tmp_path):
    src = tmp_path / "src"
    for patient, name in (("p0", "a.pickle"), ("p0", "b.pickle"), ("p1", "c.pickle"),
                          ("p1", "notes.txt")):
        (src / patient).mkdir(parents=True, exist_ok=True)
        (src / patient / name).write_bytes(b"x")
    (src / "stray.pickle").write_bytes(b"x")
    splits = tmp_path / "splits.json"
    splits.write_text(json.dumps({"train": ["p0"], "val": ["p1"]}))
    dest = str(tmp_path / "out.zip")
    write_tozip.main(["--source_dir", str(src), "--dest_zip", dest, "--splits_json",
                      str(splits)])
    with zipfile.ZipFile(dest) as zf:
        assert sorted(zf.namelist()) == ["train/p0/a.pickle", "train/p0/b.pickle",
                                         "val/p1/c.pickle"]
    write_tozip.write_to_zip(str(src), dest, default_split="test")
    with zipfile.ZipFile(dest) as zf:
        assert all(n.startswith("test/") for n in zf.namelist())


@pytest.fixture(scope="module")
def inverted(tmp_path_factory):
    """The port's projector command line on the synthetic workspace (a
    checkpoint the JAX package wrote): 12 slices at batch 5, so the last
    batch is partial."""
    ws = build_workspace(tmp_path_factory.mktemp("project"))
    ws["dest_zip"] = os.path.join(ws["interim"], ws["dataset"], "SynthSet-projected.zip")
    ws["records"] = project_main([
        "--checkpoint", ws["ckpt"], "--data_zip", ws["img_zip"], "--split", "train",
        "--modalities", ",".join(MODALITIES), "--resolution", str(RES), "--num_steps", "4",
        "--batch_size", "5", "--w_avg_samples", "64",
        "--outdir", os.path.join(ws["interim"], "temp-projector"),
        "--dest_zip", ws["dest_zip"], "--device", "cpu"])
    return ws


def test_cli_inversion_zip_is_member_exact_with_the_image_zip(inverted):
    with zipfile.ZipFile(inverted["dest_zip"]) as zf:
        assert sorted(zf.namelist()) == sorted(inverted["fnames"])
    assert [r["n"] for r in inverted["records"]] == [5, 5, 2]
    assert all(len(r["dists"]) == 4 and np.isfinite(r["dists"]).all()
               for r in inverted["records"])
    g_cfg = inverted["g_cfg"]
    ds = manifold.LatentCodeDataset(inverted["dest_zip"], split="train", w_dim=g_cfg.w_dim,
                                    num_ws=g_cfg.num_ws)
    codes = np.stack([ds[i][0] for i in range(len(ds))])
    assert codes.shape == (12, g_cfg.num_ws, g_cfg.w_dim)
    assert np.array_equal(codes, np.repeat(codes[:, :1], g_cfg.num_ws, axis=1))
    # Every slice went its own way from w_avg, the padded batch's too.
    assert len({c[0].tobytes() for c in codes}) == 12


def test_policy_reads_the_inversion_zip(inverted):
    argv = list(inverted["argv"])
    argv[argv.index("--dataset_w_name") + 1] = "SynthSet-projected"
    argv += ["--init_w", "inv", "--p_thres", "0.0", "--device", "cpu", "--serial_batches"]
    opt = AugOptions().parse(argv=argv, install_logger=False)
    augment = create_augment(opt)
    data = next(iter(create_dataset(opt)))
    augment.set_input(data)
    augment.forward()
    assert augment.augmented and augment.get_output()["A"].shape == (2, 1, RES, RES)
    with zipfile.ZipFile(inverted["dest_zip"]) as zf:
        want = np.stack([pickle.loads(zf.read(p))[0] for p in data["A_paths"]])
    np.testing.assert_array_equal(augment.get_latent_input()["w"], want)
    assert not np.allclose(augment.get_latent_output()["w"], want)


def test_cli_refuses_what_is_not_ported(inverted, tmp_path):
    base = ["--checkpoint", inverted["ckpt"], "--data_zip", inverted["img_zip"],
            "--resolution", str(RES), "--outdir", str(tmp_path / "out")]
    with pytest.raises(ValueError, match="divisible"):
        project_main(base + ["--n_devices", "3", "--batch_size", "4", "--device", "cpu"])
    with pytest.raises(ValueError, match="asked for"):
        project_main(base[:4] + ["--resolution", "64", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            project_main(base)
    assert not os.path.exists(tmp_path / "out")
