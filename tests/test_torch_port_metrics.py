"""Parity of the port's detectors and FID / precision-recall metrics with
the JAX package, on the CPU.

Detector weights are numpy trees given to both packages (InceptionV3
with non-trivial batchnorm statistics; the VGG16 detector head); images,
features and the dumped augmented batches come from numpy seeds.
Tolerances: single functions max |port - jax| / max |jax| <= 1e-5,
composed networks <= 1e-4. FID and PR values agree on fed features; on
features that each package extracts itself they inherit the detectors'
1e-4 (FID amplifies it through the matrix square root of a rank-deficient
covariance product, so it gets rtol 1e-3; PR counts are equal).
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from synthetic import MODALITIES, RES, build_workspace

from latentaugment_tpu import metrics as metrics_j
from latentaugment_tpu.metrics import frechet_inception_distance as fid_j
from latentaugment_tpu.metrics import metric_utils as mu_j
from latentaugment_tpu.metrics import precision_recall as pr_j
from latentaugment_tpu.models import inception as inc_j
from latentaugment_tpu.models import vgg as vgg_j
from latentaugment_tpu_torch import metrics as metrics_t
from latentaugment_tpu_torch.metrics import frechet_inception_distance as fid_t
from latentaugment_tpu_torch.metrics import metric_utils as mu_t
from latentaugment_tpu_torch.metrics import precision_recall as pr_t
from latentaugment_tpu_torch.models import inception as inc_t
from latentaugment_tpu_torch.models import vgg as vgg_t
from latentaugment_tpu_torch.models.stylegan2 import checkpoint as ckpt_t
from latentaugment_tpu_torch.models.stylegan2 import networks as net_t
from latentaugment_tpu_torch.utils import util_url
from test_torch_port_common import _one_torch_thread  # noqa: F401 (autouse fixture)

TOL_FN, TOL_NET = 1e-5, 1e-4
CPU = torch.device("cpu")


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _rel_err(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ----------------------------------------------------------------------------
# Detectors

@pytest.fixture(scope="module")
def inception_np():
    """The JAX package's seeded InceptionV3 with every batchnorm given
    seeded statistics, scale and shift of its own."""
    tree = _np(inc_j.init_inception(seed=3))
    rng = np.random.RandomState(4)

    def perturb(node):
        for k, v in node.items():
            if k == "bn":
                c = v["weight"].shape[0]
                v["weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                v["bias"] = rng.uniform(-0.2, 0.2, c).astype(np.float32)
                v["running_mean"] = rng.uniform(-0.3, 0.3, c).astype(np.float32)
                v["running_var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
            elif isinstance(v, dict):
                perturb(v)

    perturb(tree)
    return tree


@pytest.fixture(scope="module")
def vgg_detector_np():
    tree = _np(vgg_j.init_vgg(jax.random.PRNGKey(5), lpips_lin=False))
    rng = np.random.default_rng(6)
    for name, n_out, n_in in (("fc6", 4096, 512 * 7 * 7), ("fc7", 4096, 4096)):
        w = rng.standard_normal((n_out, n_in), dtype=np.float32) * np.float32(np.sqrt(2.0 / n_in))
        tree[name] = {"weight": w, "bias": rng.uniform(-0.1, 0.1, n_out).astype(np.float32)}
    return tree


@pytest.fixture(scope="module")
def detectors(inception_np, vgg_detector_np):
    """Both packages' detector registries hold the same weights while this
    module's tests run; the JAX package's registry is restored after."""
    saved = dict(mu_j._feature_detector_cache)
    pairs = {}
    for name, fn_j, fn_t, tree in (
            ("inception-2015-12-05", inc_j.inception_features, inc_t.inception_features,
             inception_np),
            ("vgg16", vgg_j.detector_features, vgg_t.detector_features, vgg_detector_np)):
        det_j = mu_j._Detector(fn_j, _jnp(tree))
        det_t = mu_t._Detector(fn_t, vgg_t.params_from_numpy(tree))
        mu_j._feature_detector_cache[name] = det_j
        mu_t._feature_detector_cache[(name, "cpu")] = det_t
        pairs[name] = (det_j, det_t)
    yield pairs
    mu_j._feature_detector_cache.clear()
    mu_j._feature_detector_cache.update(saved)
    mu_t._feature_detector_cache.clear()


@pytest.mark.parametrize("src,tol", [(64, TOL_FN), (320, 2e-5), (299, 0.0)])
def test_resize_bilinear_matches_jax(src, tol):
    """An enlargement (64 -> 299), a reduction (320 -> 299, anti-aliased in
    both) and the identity. The reduction sums up to three weighted taps
    per axis in another order than jax.image.resize: measured 1.2e-5 of
    the largest value, so it gets 2e-5."""
    x = np.random.RandomState(src).uniform(0, 255, (2, 3, src, src)).astype(np.float32)
    got = inc_t._resize_bilinear(torch.from_numpy(x), 299)
    want = inc_j._resize_bilinear(jnp.asarray(x), 299)
    err = _rel_err(got, want)
    print(f"resize {src} -> 299: max err / max |jax| = {err:.3e}")
    assert err <= tol


def test_avgpool_divides_by_the_count_of_real_pixels():
    x = np.random.RandomState(0).randn(2, 3, 6, 7).astype(np.float32)
    got = inc_t._avgpool(torch.from_numpy(x))
    assert _rel_err(got, inc_j._avgpool(jnp.asarray(x))) <= TOL_FN
    ones = inc_t._avgpool(torch.ones(1, 1, 4, 4))
    assert torch.equal(ones, torch.ones(1, 1, 4, 4))  # corners too


def test_inception_features_match_jax(detectors):
    det_j, det_t = detectors["inception-2015-12-05"]
    x = np.random.RandomState(1).uniform(0, 255, (2, 3, RES, RES)).astype(np.float32)
    want = np.asarray(det_j(x))
    got = det_t(torch.from_numpy(x))
    assert got.shape == (2, 2048) and not got.requires_grad
    assert np.abs(want).max() > 1e-3
    assert _rel_err(got, want) <= TOL_NET


def test_inception_seeded_init_and_state_dict_converter(inception_np, tmp_path):
    a, b = inc_t.init_inception(seed=1), inc_t.init_inception(seed=1)
    w = "Mixed_6c", "branch7x7dbl_3", "conv", "weight"
    assert torch.equal(a[w[0]][w[1]][w[2]][w[3]], b[w[0]][w[1]][w[2]][w[3]])
    assert not torch.equal(a[w[0]][w[1]][w[2]][w[3]],
                           inc_t.init_inception(seed=2)[w[0]][w[1]][w[2]][w[3]])
    flat_j = jax.tree_util.tree_leaves_with_path(inception_np)
    flat_t = jax.tree_util.tree_leaves_with_path(vgg_t.params_to_numpy(a))
    assert [(p, v.shape) for p, v in flat_t] == [(p, v.shape) for p, v in flat_j]
    # torchvision's keys are the tree's paths joined with dots.
    state = {".".join(k.key for k in path): leaf for path, leaf in flat_j}
    state["fc.weight"] = np.zeros((1000, 2048), np.float32)  # dropped
    state["Mixed_5b.branch1x1.bn.num_batches_tracked"] = np.int64(7)  # dropped
    out_path = str(tmp_path / "inception.pkl")
    got = inc_t.convert_torchvision_state(state, out_path=out_path, strict=True)
    for (_, g), (_, w_) in zip(jax.tree_util.tree_leaves_with_path(vgg_t.params_to_numpy(got)),
                               flat_j, strict=True):
        np.testing.assert_array_equal(g, w_)
    loaded = inc_t.get_inception(out_path)
    assert torch.equal(loaded["Conv2d_1a_3x3"]["bn"]["running_var"],
                       got["Conv2d_1a_3x3"]["bn"]["running_var"])
    with pytest.raises(KeyError):
        inc_t.convert_torchvision_state({"Mixed_9z.branch.conv.weight": np.zeros(1)}, strict=True)
    with pytest.raises(ValueError, match="shape mismatch"):
        inc_t.convert_torchvision_state({"Conv2d_1a_3x3.conv.weight": np.zeros((1, 1))})
    # A file that is no converted tree falls back to the seeded init.
    with open(out_path, "wb") as f:
        pickle.dump({"something": np.zeros(1)}, f)
    fallback = inc_t.get_inception(out_path, seed=1)
    assert torch.equal(fallback[w[0]][w[1]][w[2]][w[3]], a[w[0]][w[1]][w[2]][w[3]])


@pytest.mark.parametrize("size", [32, 64, 250])
def test_vgg_detector_features_match_jax(detectors, size):
    """32 -> a 1x1 trunk output, nearest-upsampled to 7x7; 250 -> 7x7;
    64 -> 2x2."""
    det_j, det_t = detectors["vgg16"]
    x = np.random.RandomState(size).uniform(0, 255, (2, 3, size, size)).astype(np.float32)
    want = np.asarray(det_j(x))
    got = det_t(torch.from_numpy(x))
    assert got.shape == (2, 4096)
    assert _rel_err(got, want) <= TOL_NET


@pytest.mark.parametrize("hw", [(1, 1), (2, 3), (7, 7), (10, 9), (14, 21)])
def test_adaptive_avg_pool_matches_jax(hw):
    x = np.random.RandomState(sum(hw)).randn(2, 3, *hw).astype(np.float32)
    got = vgg_t._adaptive_avg_pool(torch.from_numpy(x), 7)
    assert _rel_err(got, vgg_j._adaptive_avg_pool(jnp.asarray(x), 7)) <= TOL_FN


def test_vgg_detector_seeded_init_and_save_load(tmp_path):
    trunk = vgg_t.init_vgg(3, lpips_lin=False)
    path = str(tmp_path / "vgg.pkl")
    vgg_t.save_params(trunk, path)
    back = vgg_t.load_params(path, require=("conv1_1", "conv5_3"))
    assert torch.equal(back["conv3_2"]["weight"], trunk["conv3_2"]["weight"])
    with pytest.raises(ValueError, match="fc6"):
        vgg_t.load_params(path, require=("conv1_1", "fc6", "fc7"))
    # The JAX package reads the same file.
    np.testing.assert_array_equal(np.asarray(vgg_j.load_params(path)["conv3_2"]["bias"]),
                                  trunk["conv3_2"]["bias"].numpy())


# ----------------------------------------------------------------------------
# Host-side statistics and the metric formulas, on fed arrays

def test_feature_stats_match_jax(tmp_path):
    x = np.random.RandomState(7).randn(100, 16).astype(np.float32)
    stats_j = mu_j.FeatureStats(capture_all=True, capture_mean_cov=True, max_items=90)
    stats_t = mu_t.FeatureStats(capture_all=True, capture_mean_cov=True, max_items=90)
    for lo in range(0, 100, 32):
        stats_j.append(x[lo:lo + 32])
        stats_t.append(torch.from_numpy(x[lo:lo + 32]) if lo else x[lo:lo + 32])
    assert stats_t.num_items == stats_j.num_items == 90 and stats_t.is_full()
    np.testing.assert_array_equal(stats_t.get_all(), stats_j.get_all())
    for got, want in zip(stats_t.get_mean_cov(), stats_j.get_mean_cov()):
        np.testing.assert_array_equal(got, want)
    path = str(tmp_path / "stats.pkl")
    stats_t.save(path)
    np.testing.assert_array_equal(mu_t.FeatureStats.load(path).get_mean_cov()[1],
                                  stats_j.get_mean_cov()[1])
    with pytest.raises(ValueError):
        stats_t.set_num_features(17)
    with pytest.raises(RuntimeError):
        mu_t.FeatureStats(capture_all=True).get_mean_cov()


def test_fid_from_moments_matches_jax():
    rng = np.random.RandomState(8)
    a, b = rng.randn(40, 12), rng.randn(50, 12) * 1.5 + 0.3
    moments = (a.mean(0), np.cov(a.T, bias=True), b.mean(0), np.cov(b.T, bias=True))
    got, want = fid_t.fid_from_moments(*moments), fid_j.fid_from_moments(*moments)
    assert got == want and got > 0
    assert abs(fid_t.fid_from_moments(*moments[:2], *moments[:2])) < 1e-6


def test_compute_distances_match_jax():
    rng = np.random.RandomState(9)
    rows, cols = rng.randn(13, 64).astype(np.float32), rng.randn(27, 64).astype(np.float32)
    got = pr_t.compute_distances(rows, cols, col_batch_size=10, device="cpu")
    want = pr_j.compute_distances(rows, cols, col_batch_size=10)
    assert _rel_err(got, want) <= TOL_FN
    # A point's distance to itself: the clamp before the root keeps it finite.
    assert np.isfinite(pr_t.compute_distances(rows * 100, rows * 100, device="cpu")).all()
    with pytest.raises(TypeError, match="DeviceMesh"):
        pr_t.compute_distances(rows, cols, device="cpu", mesh=object())


@pytest.mark.parametrize("shift,nhood", [(0.0, 3), (0.8, 3), (100.0, 3), (0.5, 99)])
def test_knn_precision_recall_match_jax(shift, nhood):
    rng = np.random.RandomState(10)
    real = rng.randn(60, 8).astype(np.float32)
    gen = rng.randn(50, 8).astype(np.float32) * 0.7 + shift
    got = pr_t.knn_precision_recall(real, gen, nhood_size=nhood, row_batch_size=25,
                                    col_batch_size=20, device="cpu")
    want = pr_j.knn_precision_recall(real, gen, nhood_size=nhood, row_batch_size=25,
                                     col_batch_size=20)
    assert got == want
    if shift == 100.0:
        assert got == (0.0, 0.0)
    assert pr_t.knn_precision_recall(real[:1], gen, device="cpu") == (0.0, 0.0)


def test_progress_monitor_and_registry():
    seen = []
    mon = mu_t.ProgressMonitor(tag="t", num_items=10, flush_interval=4, verbose=False,
                               progress_fn=lambda cur, total: seen.append((cur, total)))
    sub = mon.sub(tag="s", num_items=10, flush_interval=4, rel_lo=0.5, rel_hi=1.0)
    for n in (2, 4, 9, 10):
        sub.update(n)
    assert seen == [(0, 1000), (500.0, 1000), (700.0, 1000), (950.0, 1000), (1000.0, 1000)]
    with pytest.raises(ValueError):
        sub.update(11)
    assert metrics_t.list_valid_metrics() == metrics_j.list_valid_metrics()
    assert metrics_t.is_valid_metric("pr50k3_full") and not metrics_t.is_valid_metric("kid")
    with pytest.raises(ValueError, match="unknown metric"):
        metrics_t.calc_metric("kid", device="cpu")
    assert mu_t.format_time(59.6) == "1m 00s" == mu_j.format_time(59.6)


def test_cache_root_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv("LATENTAUGMENT_CACHE_DIR", raising=False)
    assert util_url.cache_dir().endswith(os.path.join(".cache", "latentaugment_tpu_torch"))
    monkeypatch.setenv("LATENTAUGMENT_CACHE_DIR", str(tmp_path))
    url = fid_t.DETECTOR_URL
    assert util_url.is_url(url) and not util_url.is_url("/local/file.pkl")
    path = util_url.url_cache_path(url)
    assert os.path.dirname(path) == str(tmp_path)
    assert path.endswith("_inception-2015-12-05.pkl") and len(os.path.basename(path)) == 32 + 25
    assert util_url.make_cache_dir_path("gan-metrics", "x.pkl") == \
        str(tmp_path / "gan-metrics" / "x.pkl")
    assert fid_t.DETECTOR_URL == fid_j.DETECTOR_URL and pr_t.DETECTOR_URL == pr_j.DETECTOR_URL


# ----------------------------------------------------------------------------
# calc_metric end to end

@pytest.fixture(scope="module")
def metric_ws(tmp_path_factory):
    """The synthetic workspace (12 real slices) plus 4 dumped augmented
    batches of 2."""
    root = tmp_path_factory.mktemp("metrics")
    ws = build_workspace(root)
    rng = np.random.RandomState(11)
    ws["aug_dir"] = os.path.join(str(root), "dumps")
    os.makedirs(os.path.join(ws["aug_dir"], "img_aug"))
    for i in range(4):
        batch = {k: rng.rand(2, 1, RES, RES).astype(np.float32) * 2.4 - 1.2 for k in "AB"}
        with open(os.path.join(ws["aug_dir"], "img_aug", f"img_aug_{i}"), "wb") as f:
            pickle.dump(batch, f)
    ws["common"] = dict(
        dataset_kwargs=dict(path=ws["img_zip"], split="train", modalities=MODALITIES,
                            resolution=RES),
        dataset_kwargs_gen=dict(dataroot=ws["aug_dir"], aug_name="synth_aug"),
        cache=False)
    return ws


def test_calc_metric_fid_matches_jax(detectors, metric_ws, tmp_path):
    mode = dict(mode_name="MR_MR_T2", mode_idx=1)
    want = metrics_j.calc_metric("fid50k_full", mode_dict=mode, **metric_ws["common"])
    got = metrics_t.calc_metric("fid50k_full", mode_dict=mode, device="cpu",
                                **metric_ws["common"])
    assert got.metric == "fid50k_full" and got.results.fid50k_full > 0
    np.testing.assert_allclose(got.results.fid50k_full, want.results.fid50k_full, rtol=1e-3)
    metrics_t.report_metric(got, mode=mode["mode_name"], run_dir=str(tmp_path))
    assert os.path.isfile(tmp_path / f"metric-{mode['mode_name']}-fid50k_full.jsonl")


def test_calc_metric_pr_matches_jax(detectors, metric_ws):
    mode = dict(mode_name="MR_nonrigid_CT", mode_idx=0)
    want = metrics_j.calc_metric("pr50k3_full", mode_dict=mode, **metric_ws["common"]).results
    got = metrics_t.calc_metric("pr50k3_full", mode_dict=mode, device="cpu",
                                **metric_ws["common"]).results
    assert got.pr50k3_full_precision == want.pr50k3_full_precision
    assert got.pr50k3_full_recall == want.pr50k3_full_recall
    assert 0.0 <= got.pr50k3_full_precision <= 1.0 and 0.0 <= got.pr50k3_full_recall <= 1.0


@pytest.mark.parametrize("mode", [dict(mode_name="MR_nonrigid_CT", mode_idx=0),
                                  dict(mode_name="MR_MR_T2", mode_idx=1)])
def test_feature_stats_of_both_sources_match_jax(detectors, metric_ws, mode):
    """What the metrics are made of: the dataset's features (raw [0,255])
    and the dumps' (x * 127.5 + 128, clipped: the dumps reach +-1.2)."""
    opts_j = mu_j.MetricOptions(mode_dict=mode, **metric_ws["common"])
    opts_t = mu_t.MetricOptions(mode_dict=mode, device="cpu", **metric_ws["common"])
    for name in ("compute_feature_stats_for_dataset", "compute_feature_stats_for_aug_dataset"):
        want = getattr(mu_j, name)(opts_j, pr_j.DETECTOR_URL, capture_all=True).get_all()
        got = getattr(mu_t, name)(opts_t, pr_t.DETECTOR_URL, capture_all=True).get_all()
        assert got.shape == want.shape == ((12, 4096) if "for_dataset" in name else (8, 4096))
        assert _rel_err(got, want) <= TOL_NET
    capped = mu_t.compute_feature_stats_for_aug_dataset(opts_t, pr_t.DETECTOR_URL,
                                                        capture_all=True, max_items=3)
    assert capped.get_all().shape == (3, 4096)


def test_md5_cache_keeps_and_keys_the_stats(detectors, metric_ws, monkeypatch, tmp_path):
    monkeypatch.setenv("LATENTAUGMENT_CACHE_DIR", str(tmp_path))
    common = dict(metric_ws["common"], cache=True)
    opts = mu_t.MetricOptions(mode_dict=dict(mode_name="MR_nonrigid_CT", mode_idx=0),
                              device="cpu", **common)
    first = mu_t.compute_feature_stats_for_dataset(opts, pr_t.DETECTOR_URL, capture_all=True)
    files = os.listdir(tmp_path / "gan-metrics")
    assert len(files) == 1 and files[0].startswith("SynthSet-images-MR_nonrigid_CT-vgg16-")
    again = mu_t.compute_feature_stats_for_dataset(opts, pr_t.DETECTOR_URL, capture_all=True)
    np.testing.assert_array_equal(again.get_all(), first.get_all())
    mu_t.compute_feature_stats_for_dataset(opts, pr_t.DETECTOR_URL, capture_all=True,
                                           max_items=5)
    assert len(os.listdir(tmp_path / "gan-metrics")) == 2  # max_items is part of the key


def test_live_generator_metrics_and_what_raises(detectors, metric_ws):
    g_params, g_cfg, _, _ = ckpt_t.load_stylegan(metric_ws["ckpt"])
    G = net_t.Generator(g_cfg)
    G.load_state_dict(ckpt_t.params_to_state_dict(g_params))
    G.requires_grad_(False)
    opts = mu_t.MetricOptions(G=G, G_kwargs=dict(seed=1, truncation_psi=0.7), device="cpu",
                              dataset_kwargs=metric_ws["common"]["dataset_kwargs"], cache=False,
                              mode_dict=dict(mode_name="MR_nonrigid_CT", mode_idx=0))
    stats = mu_t.compute_feature_stats_for_generator(opts, pr_t.DETECTOR_URL, batch_gen=4,
                                                     capture_all=True, max_items=6)
    feats = stats.get_all()
    assert feats.shape == (6, 4096) and np.isfinite(feats).all()
    again = mu_t.compute_feature_stats_for_generator(opts, pr_t.DETECTOR_URL, batch_gen=4,
                                                     capture_all=True, max_items=6)
    np.testing.assert_array_equal(again.get_all(), feats)  # seeded z and noise
    # With no dumps named, the generated side of a metric is the generator.
    mean, cov = mu_t.compute_feature_stats_for_generated(
        opts, fid_t.DETECTOR_URL, capture_mean_cov=True, max_items=5).get_mean_cov()
    assert mean.shape == (2048,) and cov.shape == (2048, 2048) and np.isfinite(cov).all()
    precision, recall = pr_t.compute_pr(opts, max_real=None, num_gen=8, nhood_size=3,
                                        row_batch_size=5, col_batch_size=5)
    assert 0.0 <= precision <= 1.0 and 0.0 <= recall <= 1.0

    with pytest.raises(TypeError, match="DeviceMesh"):
        mu_t.MetricOptions(device="cpu", mesh=object())
    # A conditional generator's labels come from the dataset when asked
    # for; a zip without labels then raises instead of drawing uniformly.
    G.cfg.c_dim = 3
    opts.dataset_kwargs.use_labels = True
    with pytest.raises(RuntimeError, match="labels"):
        mu_t.compute_feature_stats_for_generator(opts, pr_t.DETECTOR_URL, capture_all=True,
                                                 max_items=2)
    G.cfg.c_dim = 0
    del opts.dataset_kwargs["use_labels"]
    with pytest.raises(NotImplementedError, match="Unknown detector"):
        mu_t.get_feature_detector("https://example.com/resnet50.pkl", "cpu")
    if not torch.cuda.is_available():
        # Every compute entry of the metrics is on the card unless told otherwise.
        feats = np.zeros((4, 8), np.float32)
        for call in (mu_t.MetricOptions,
                     lambda: mu_t.get_feature_detector(fid_t.DETECTOR_URL),
                     lambda: pr_t.compute_distances(feats, feats),
                     lambda: pr_t.knn_precision_recall(feats, feats, nhood_size=1)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
