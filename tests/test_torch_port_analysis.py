"""The port's analysis tools and host helpers against the JAX package's,
on the CPU: the same numpy inputs through both, compared exactly.

  * `analysis.hpo`: one seed gives the same trials (values and params).
  * `analysis.umap_analysis`: the PCA embedding (umap-learn is not
    installed) and `manifold_coverage`'s points and labels; the latent
    loaders.
  * `analysis.pr_analysis`: the metric records read from jsonl files, the
    scatter and the image grids written.
  * `analysis.create_gif`: the GIFs' frames.
  * `utils.util_reports` and `utils.util_io`: files written, strings and
    colors returned.
  * `analysis.sg2_metrics_analysis` (the sweep over dumped experiments)
    and one `analysis.sg2_metrics_opt` trial run end to end at 32x32 on
    the CPU (`device="cpu"`).
"""

import os
import pickle
import zipfile

import numpy as np
import pytest
from PIL import Image

from latentaugment_tpu.analysis import create_gif as gif_j
from latentaugment_tpu.analysis import hpo as hpo_j
from latentaugment_tpu.analysis import pr_analysis as pr_j
from latentaugment_tpu.analysis import sg2_metrics_analysis as sma_j
from latentaugment_tpu.analysis import umap_analysis as umap_j
from latentaugment_tpu.utils import util_io as io_j
from latentaugment_tpu.utils import util_reports as rep_j
from latentaugment_tpu_torch import benchmark
from latentaugment_tpu_torch.analysis import create_gif as gif_t
from latentaugment_tpu_torch.analysis import hpo as hpo_t
from latentaugment_tpu_torch.analysis import pr_analysis as pr_t
from latentaugment_tpu_torch.analysis import sg2_metrics_analysis as sma_t
from latentaugment_tpu_torch.analysis import sg2_metrics_opt as smo_t
from latentaugment_tpu_torch.analysis import umap_analysis as umap_t
from latentaugment_tpu_torch.analysis import umap_plot as umap_plot_t
from latentaugment_tpu_torch.utils import util_io as io_t
from latentaugment_tpu_torch.utils import util_reports as rep_t
from test_torch_port_common import _one_torch_thread  # noqa: F401 (autouse fixture)


def _pixels(path):
    """Every frame of an image file as uint8 arrays."""
    img = Image.open(path)
    frames = []
    for i in range(getattr(img, "n_frames", 1)):
        img.seek(i)
        frames.append(np.asarray(img.convert("RGB")))
    return frames


# ----------------------------------------------------------------------------
# hpo

def _objective(trial):
    a = trial.suggest_categorical("w_lpips", [0, 0.1, 1, 10])
    b = trial.suggest_float("opt_lr", 1e-3, 1e-1, log=True)
    c = trial.suggest_float("alpha", 0.0, 1.0)
    d = trial.suggest_int("opt_num_epochs", 3, 9)
    if d == 9:
        raise ValueError("a failing trial")
    return a * b + c - d


@pytest.mark.parametrize("seed", [0, 42])
def test_hpo_same_seed_same_trials(seed, tmp_path):
    studies = []
    for hpo in (hpo_j, hpo_t):
        study = hpo.create_study(directions=["maximize"], seed=seed)
        assert isinstance(study, hpo.SimpleStudy)  # optuna is not installed
        study.optimize(_objective, n_trials=6, catch=(ValueError,))
        study.optimize(_objective, n_trials=3, catch=(ValueError,))  # a resumed study
        studies.append(study)
    sj, st = studies
    assert st.trials == sj.trials and len(st.trials) == 9
    assert st.best_params == sj.best_params and st.best_value == sj.best_value
    path = str(tmp_path / "study.pickle")
    st.save(path)
    assert hpo_t.SimpleStudy.load(path).trials == st.trials
    df_t = st.trials_dataframe(attrs=("number", "value", "params", "state"))
    df_j = sj.trials_dataframe(attrs=("number", "value", "params", "state"))
    assert df_t.equals(df_j)
    minimize = hpo_t.SimpleStudy(directions=["minimize"], seed=seed)
    minimize.trials = list(st.trials)
    assert minimize.best_value == min(t["value"] for t in st.trials if t["value"] is not None)


# ----------------------------------------------------------------------------
# umap_analysis / umap_plot

def test_pca_embedding_and_coverage_match_jax(tmp_path):
    rng = np.random.RandomState(3)
    inverted = rng.randn(40, 14, 16).astype(np.float32)
    sets = {"LatentAugment": rng.randn(30, 14, 16).astype(np.float32),
            "random GAN": rng.randn(20, 16).astype(np.float32)}
    emb_j, emb_t = umap_j.make_embedder(seed=1), umap_t.make_embedder(seed=1)
    np.testing.assert_array_equal(emb_t.fit_transform(inverted[:, 0]),
                                  emb_j.fit_transform(inverted[:, 0]))
    np.testing.assert_array_equal(emb_t.components_, emb_j.components_)
    out_j = umap_j.manifold_coverage(inverted, sets, str(tmp_path / "j.png"))
    out_t = umap_t.manifold_coverage(inverted, sets, str(tmp_path / "t.png"))
    np.testing.assert_array_equal(out_t[1], out_j[1])
    assert out_t[2] == out_j[2] and len(out_t[2]) == 90
    assert out_t[0] == str(tmp_path / "t.png") and os.path.getsize(out_t[0]) > 0
    assert _pixels(out_t[0])[0].shape == _pixels(out_j[0])[0].shape
    # Interactive: bokeh is not installed, so the static plot is written.
    got = umap_t.manifold_coverage(inverted, sets, str(tmp_path / "i.png"), interactive=True)
    assert got[0] == str(tmp_path / "i.png") and os.path.isfile(got[0])
    np.testing.assert_array_equal(umap_t.flatten_ws(inverted), umap_j.flatten_ws(inverted))
    assert umap_plot_t.manifold_coverage is umap_t.manifold_coverage


def test_latent_loaders_match_jax(tmp_path):
    rng = np.random.RandomState(4)
    d = tmp_path / "latent_aug"
    d.mkdir()
    for i in range(3):
        io_t.write_pickle({"w": rng.randn(4, 16).astype(np.float32), "paths": []},
                          str(d / f"w_aug_{i}"))
    io_t.write_pickle({"w": rng.randn(16).astype(np.float32), "paths": []}, str(d / "w_aug_3"))
    np.testing.assert_array_equal(umap_t.load_latents_from_dir(str(d)),
                                  umap_j.load_latents_from_dir(str(d)))
    np.testing.assert_array_equal(umap_t.load_latents_from_dir(str(d), max_items=6),
                                  umap_j.load_latents_from_dir(str(d), max_items=6))
    got, want = umap_t.fromdir_tolist(str(d)), umap_j.fromdir_tolist(str(d))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["w"], b["w"])


# ----------------------------------------------------------------------------
# pr_analysis

def _metric_files(run_dir):
    rng = np.random.RandomState(5)
    for exp in ("expA-opt_lr_3e-05-w_pix_0.1", "expB-opt_lr_0.01-w_pix_1"):
        entries = [dict(metric=m, mode=mode, value=(
            {"fid50k_full": float(rng.rand() * 100)} if m == "fid50k_full" else
            {"pr50k3_full_precision": float(rng.rand()), "pr50k3_full_recall": float(rng.rand())}))
            for mode in ("MR_nonrigid_CT", "MR_MR_T2") for m in ("fid50k_full", "pr50k3_full")]
        with open(os.path.join(run_dir, f"metric-{exp}.jsonl"), "at") as f:
            f.write(__import__("json").dumps({exp: entries}, indent=3) + "\n")
            f.write(__import__("json").dumps(dict(entries[1], experiment=exp)) + "\n")


def test_pr_analysis_matches_jax(tmp_path):
    _metric_files(str(tmp_path))
    df_t, df_j = pr_t.load_metric_jsonl(str(tmp_path)), pr_j.load_metric_jsonl(str(tmp_path))
    assert len(df_t) == 10 and df_t.equals(df_j)
    for mode in (None, "MR_MR_T2"):
        out = pr_t.precision_recall_scatter(df_t, str(tmp_path / f"t{mode}.png"), mode=mode)
        want = pr_j.precision_recall_scatter(df_j, str(tmp_path / f"j{mode}.png"), mode=mode)
        assert out == str(tmp_path / f"t{mode}.png") and want is not None
        assert _pixels(out)[0].shape == _pixels(want)[0].shape
    assert pr_t.precision_recall_scatter(df_t[df_t["metric"] == "fid50k_full"],
                                         str(tmp_path / "none.png")) is None
    assert pr_t.generate_mapping(5) == pr_j.generate_mapping(5)
    exp = tmp_path / "exp"
    (exp / "img_aug").mkdir(parents=True)
    rng = np.random.RandomState(6)
    for i in range(3):
        io_t.write_pickle({"A": rng.rand(3, 1, 16, 16).astype(np.float32) * 2 - 1},
                          str(exp / "img_aug" / f"img_aug_{i}"))
    got = pr_t.dump_image_grids(str(exp), str(tmp_path / "grids_t"))
    want = pr_j.dump_image_grids(str(exp), str(tmp_path / "grids_j"))
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == 2 and all(os.path.getsize(p) > 0 for p in got)


def test_parse_experiment_name_matches_jax():
    for name in ("policy-n_imgs_64-opt_lr_3e-05-opt_num_epochs_6-w_latent_0.001-w_pix_0.1"
                 "-w_lpips_10-w_disc_0.01",
                 "x-n_imgs_8-p_thres_0.0-horizontal_flip_False-affine_True-elastic_deform_True",
                 "x-n_imgs_8-truncation_psi_0.7", "no-keys-here"):
        assert sma_t.parse_experiment_name(name) == sma_j.parse_experiment_name(name)
    assert sma_t.parse_experiment_name("e-opt_lr_3e-05-w_pix_1")["opt_lr"] == "3e-05"


# ----------------------------------------------------------------------------
# create_gif

def _snapshots(d, rng):
    for name in ("train_p_00010", "train_p_00015"):
        for e in range(3):
            x = (rng.rand(16, 32) * 255).astype(np.uint8)
            Image.fromarray(x, mode="L").save(os.path.join(d, f"{name}_{e}.png"))


def test_create_gif_frames_match_jax(tmp_path):
    rng = np.random.RandomState(7)
    dirs = {}
    for k in ("j", "t"):
        dirs[k] = tmp_path / k
        dirs[k].mkdir()
    _snapshots(str(dirs["j"]), rng)
    for f in os.listdir(dirs["j"]):
        (dirs["t"] / f).write_bytes((dirs["j"] / f).read_bytes())
    got = gif_t.create_gif(str(dirs["t"]), duration_ms=100)
    want = gif_j.create_gif(str(dirs["j"]), duration_ms=100)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == 2
    for a, b in zip(got, want):
        fa, fb = _pixels(a), _pixels(b)
        assert len(fa) == len(fb) == 3
        for x, y in zip(fa, fb):
            np.testing.assert_array_equal(x, y)
    # The image-beside-latent animation and the text stamp.
    for e in range(2):
        latent = Image.fromarray((rng.rand(8, 8) * 255).astype(np.uint8), mode="L")
        for k in ("j", "t"):
            latent.save(str(dirs[k] / f"latent_{e}.png"))
    hj = gif_j.create_gif_hstack(str(dirs["j"]), latent_size=(16, 16))
    ht = gif_t.create_gif_hstack(str(dirs["t"]), latent_size=(16, 16))
    for x, y in zip(_pixels(ht), _pixels(hj)):
        np.testing.assert_array_equal(x, y)
    a = gif_t.add_text_to_image(Image.new("RGB", (64, 32)), "step 3")
    b = gif_j.add_text_to_image(Image.new("RGB", (64, 32)), "step 3")
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ----------------------------------------------------------------------------
# util_reports / util_io

def test_util_reports_match_jax(tmp_path):
    rng = np.random.RandomState(8)
    imgs = (rng.rand(5, 1, 12, 12) * 2.4 - 1.2).astype(np.float32)
    pt = rep_t.dump_images(str(tmp_path / "t"), imgs, "s")
    pj = rep_j.dump_images(str(tmp_path / "j"), imgs, "s")
    assert [os.path.basename(p) for p in pt] == [os.path.basename(p) for p in pj]
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(_pixels(a)[0], _pixels(b)[0])
    assert rep_t.embeddable_image(imgs[0]) == rep_j.embeddable_image(imgs[0])
    np.testing.assert_array_equal(rep_t.get_cmap(7)(np.arange(7)), rep_j.get_cmap(7)(np.arange(7)))
    for fn, args in (("scatter_plot", (rng.randn(20, 2), ["a"] * 10 + ["b"] * 10)),
                     ("image_grid", (imgs,))):
        a = getattr(rep_t, fn)(*args, save_path=str(tmp_path / f"t_{fn}.png"))
        b = getattr(rep_j, fn)(*args, save_path=str(tmp_path / f"j_{fn}.png"))
        np.testing.assert_array_equal(_pixels(a)[0], _pixels(b)[0])
    hist = {"loss_G": [3.0, 2.0, 1.5], "loss_D": [1.0, 1.2, 0.9]}
    a = rep_t.plot_training(hist, str(tmp_path / "pt"), title="losses")
    b = rep_j.plot_training(hist, str(tmp_path / "pj"), title="losses")
    np.testing.assert_array_equal(_pixels(a)[0], _pixels(b)[0])
    a = rep_t.show_activation(imgs[None, :, 0].repeat(2, 0).transpose(1, 0, 2, 3),
                              "L1", str(tmp_path / "at"))
    assert os.path.isfile(a)
    out = rep_t.scatter_plot_interactive(rng.randn(6, 2), ["x"] * 6,
                                         save_path=str(tmp_path / "b.html"))
    assert out == str(tmp_path / "b.png")  # bokeh is not installed: the static plot


def test_scatter_plot_without_matplotlib_draws_with_pil(tmp_path, monkeypatch):
    """Where matplotlib is not installed the coverage plot is still written:
    the labels' points as dots of their colors."""
    def no_matplotlib():
        raise ImportError("No module named 'matplotlib'")

    monkeypatch.setattr(rep_t, "_plt", no_matplotlib)
    points = np.array([[0.0, 0.0], [1.0, 1.0], [0.5, 0.2]])
    out = rep_t.scatter_plot(points, ["a", "a", "b"], save_path=str(tmp_path / "s.png"))
    img = _pixels(out)[0]
    assert img.shape == (800, 800, 3)
    colors = {tuple(c) for c in img.reshape(-1, 3)}
    assert {(255, 255, 255), (31, 119, 180), (255, 127, 14)} <= colors
    inverted = np.random.RandomState(9).randn(12, 16)
    got = umap_t.manifold_coverage(inverted, {"LatentAugment": inverted + 1},
                                   str(tmp_path / "cov.png"))
    assert got[0] == str(tmp_path / "cov.png") and os.path.isfile(got[0])


def test_util_io_matches_jax(tmp_path):
    obj = {"A": np.arange(6, dtype=np.float32).reshape(2, 3), "paths": ["p0", "p1"]}
    for name, io in (("t", io_t), ("j", io_j)):
        io.write_pickle(obj, str(tmp_path / f"{name}.pkl"))
        io.write_pickle_atomic(obj, str(tmp_path / f"{name}_atomic.pkl"))
        io.write_json({"a": [1, 2]}, str(tmp_path / f"{name}.json"))
        io.append_jsonl({"k": 1}, str(tmp_path / f"{name}.jsonl"))
        io.append_jsonl({"k": 2}, str(tmp_path / f"{name}.jsonl"))
        io.write_list_to_file(["x", 3], str(tmp_path / f"{name}.txt"))
    for suffix in (".pkl", "_atomic.pkl", ".json", ".jsonl", ".txt"):
        assert (tmp_path / f"t{suffix}").read_bytes() == (tmp_path / f"j{suffix}").read_bytes()
    got = io_t.read_pickle(str(tmp_path / "t.pkl"))
    np.testing.assert_array_equal(got["A"], obj["A"])
    assert io_t.read_json(str(tmp_path / "t.json")) == {"a": [1, 2]}
    assert io_t.read_file_to_list(str(tmp_path / "t.txt")) == ["x\n", "3\n"]
    assert io_t.get_string_datetime() == io_j.get_string_datetime()
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]
    patient = tmp_path / "patients" / "patient007"
    patient.mkdir(parents=True)
    for s in ("s0.pickle", "s1.pickle"):
        (patient / s).write_bytes(b"x")
    names = {}
    for name, io in (("t", io_t), ("j", io_j)):
        with zipfile.ZipFile(str(tmp_path / f"{name}.zip"), "w") as zf:
            io.add_to_zip(zf, str(patient), "train")
        names[name] = sorted(zipfile.ZipFile(str(tmp_path / f"{name}.zip")).namelist())
    assert names["t"] == names["j"] == ["train/patient007/s0.pickle", "train/patient007/s1.pickle"]


# ----------------------------------------------------------------------------
# sg2_metrics_analysis and one sg2_metrics_opt trial, end to end at 32x32

@pytest.fixture(scope="module")
def metrics_workspace(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("metrics_ws"))
    argv = benchmark.build_policy_workspace(
        root, res=32, batch_size=4, num_epochs=2, crop_size=16, channel_base=256,
        channel_max=32, n_patients=1, slices_per_patient=8, step=5)
    return root, argv


def test_sg2_metrics_sweep_and_one_tuning_trial(metrics_workspace, tmp_path, monkeypatch):
    monkeypatch.setenv("LATENTAUGMENT_CACHE_DIR", str(tmp_path / "cache"))
    root, argv = metrics_workspace
    argv = argv + ["--device", "cpu"]
    data_zip = argv[argv.index("--dataroot") + 1]
    ckpts = argv[argv.index("--checkpoints_dir") + 1]
    monkeypatch.setattr(smo_t, "PARAM_SPACE", {
        "w_lpips": [1.0], "w_pix": [0.1], "w_latent": [0.001],
        "w_disc": [0.01], "opt_num_epochs": [2], "opt_lr": [0.01]})
    study = hpo_t.SimpleStudy(seed=0)
    kept = {}

    def objective(trial):
        opt = smo_t.dump_imgs(trial, n_imgs=8, argv=argv)
        exp = os.path.join(opt.checkpoints_dir, opt.name)
        kept["dumps"] = sorted(os.listdir(os.path.join(exp, "img_aug")))
        # The sweep over the dumped experiment, before the trial scores
        # (and deletes) it.
        kept["sweep"] = sma_t.sweep(ckpts, "n_imgs_8", data_zip, "MR_nonrigid_CT,MR_MR_T2",
                                    resolution=32, split="train", batch_size=4, device="cpu")
        # precision/recall only: the sweep scored FID, whose 2048x2048
        # matrix root takes the host ~10 s a call.
        precision, recall = smo_t.calc_pr(opt, metrics_name=["pr50k3_full"],
                                          eval_split="train")
        return recall

    study.optimize(objective, n_trials=1)
    assert kept["dumps"] == ["img_aug_0", "img_aug_1"]
    (exp, entries), = kept["sweep"].items()
    assert [(e["metric"], e["mode"]) for e in entries] == [
        ("fid50k_full", "MR_nonrigid_CT"), ("pr50k3_full", "MR_nonrigid_CT"),
        ("fid50k_full", "MR_MR_T2"), ("pr50k3_full", "MR_MR_T2")]
    assert all(np.isfinite(v) for e in entries for v in e["value"].values())
    assert entries[0]["params"]["w_lpips"] == "1.0"
    value = study.trials[0]["value"]
    assert study.trials[0]["state"] == "COMPLETE" and 0.0 <= value <= 1.0
    # Both scored the experiment into metric jsonl files; the trial then
    # deleted its dump.
    assert os.path.isfile(os.path.join(ckpts, f"metric-{exp}.jsonl"))
    assert not os.path.isdir(os.path.join(ckpts, exp))
    df = pr_t.load_metric_jsonl(ckpts)
    assert len(df) == 6 and set(df["mode"]) == {"MR_nonrigid_CT", "MR_MR_T2"}
