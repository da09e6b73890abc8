"""Parity of the port's LPIPS backbones and perceptual criteria with the
JAX package, on the CPU.

Weights are made once by the JAX package's seeded inits (with the 'lin'
weights replaced by seeded non-trivial ones) and carried across as numpy
trees; inputs come from numpy seeds. Tolerance: max |port - jax| over
max |jax| <= 1e-5 for single functions and <= 1e-4 for composed networks
(AlexNet, SqueezeNet, VGG16 / VGG19 taps and what is built on them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from latentaugment_tpu.augments.criteria import lpips as lpips_j
from latentaugment_tpu.augments.criteria import nst as nst_j
from latentaugment_tpu.models import lpips_backbones as bb_j
from latentaugment_tpu.models import vgg as vgg_j
from latentaugment_tpu_torch.augments.criteria import LPIPS, NSTLoss, gram_matrix
from latentaugment_tpu_torch.augments.criteria import lpips as lpips_t
from latentaugment_tpu_torch.augments.criteria import nst as nst_t
from latentaugment_tpu_torch.models import lpips_backbones as bb_t
from latentaugment_tpu_torch.models import vgg as vgg_t
from test_torch_port_common import _one_torch_thread  # noqa: F401 (autouse fixture)

TOL_FN, TOL_NET = 1e-5, 1e-4
NETS = ("vgg", "alex", "squeeze")


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _rel_err(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _images(seed, n=2, size=64):
    return np.random.RandomState(seed).uniform(-1, 1, (n, 3, size, size)).astype(np.float32)


@pytest.fixture(scope="module")
def trees():
    """numpy param trees and lin weights per backbone."""
    rng = np.random.RandomState(11)
    params = {"vgg": _np(vgg_j.init_vgg(jax.random.PRNGKey(1))),
              "alex": _np(bb_j.init_alexnet(jax.random.PRNGKey(2))),
              "squeeze": _np(bb_j.init_squeezenet(jax.random.PRNGKey(3))),
              "vgg19": _np(vgg_j.init_vgg(jax.random.PRNGKey(4), plan=vgg_j.VGG19_PLAN,
                                          lpips_lin=False))}
    channels = {"vgg": {t: vgg_j.LPIPS_CHANNELS[t] for t in lpips_j.DEFAULT_TARGET_LAYERS},
                "alex": bb_j.ALEX_CHANNELS, "squeeze": bb_j.SQUEEZE_CHANNELS}
    # Some weights negative: both packages clamp them at 0.
    lin = {net: {t: rng.uniform(-0.2, 1.5, c).astype(np.float32) for t, c in ch.items()}
           for net, ch in channels.items()}
    return params, lin


@pytest.fixture(scope="module")
def criteria(trees):
    params, lin = trees
    return {net: (lpips_j.LPIPS(net, params=_jnp(params[net]), lin=_jnp(lin[net])),
                  LPIPS(net, params=vgg_t.params_from_numpy(params[net]),
                        lin=vgg_t.params_from_numpy(lin[net]), device="cpu"))
            for net in NETS}


@pytest.mark.parametrize("size", [5, 6, 7, 8, 13, 16, 31])
def test_maxpool_ceil_mode_matches_jax_and_torch(size):
    x = np.random.RandomState(size).randn(2, 3, size, size + 1).astype(np.float32)
    got = bb_t._maxpool(torch.from_numpy(x), ceil_mode=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(bb_j._maxpool(jnp.asarray(x),
                                                                        ceil_mode=True)))
    torch.testing.assert_close(got, F.max_pool2d(torch.from_numpy(x), 3, 2, ceil_mode=True),
                               rtol=0, atol=0)
    floor = bb_t._maxpool(torch.from_numpy(x))
    np.testing.assert_array_equal(floor.numpy(), np.asarray(bb_j._maxpool(jnp.asarray(x))))


@pytest.mark.parametrize("net,size", [("alex", 64), ("alex", 67), ("squeeze", 64),
                                      ("squeeze", 61)])
def test_backbone_taps_match_jax(trees, net, size):
    params, _ = trees
    fn_j, fn_t = {"alex": (bb_j.alexnet_taps, bb_t.alexnet_taps),
                  "squeeze": (bb_j.squeezenet_taps, bb_t.squeezenet_taps)}[net]
    x = _images(5, size=size)
    want = fn_j(_jnp(params[net]), jnp.asarray(x))
    got = fn_t(vgg_t.params_from_numpy(params[net]), torch.from_numpy(x))
    assert list(got) == list(want)
    for tap in want:
        assert _rel_err(got[tap], want[tap]) <= TOL_NET, tap


def test_vgg19_taps_match_jax(trees):
    params, _ = trees
    taps = nst_j.STYLE_LAYERS + [nst_j.CONTENT_LAYER]
    x = (_images(6, size=32) + 1.0) * 127.5
    want = vgg_j.vgg_features(_jnp(params["vgg19"]), jnp.asarray(x), plan=vgg_j.VGG19_PLAN,
                              taps=taps)
    got = vgg_t.vgg_features(vgg_t.params_from_numpy(params["vgg19"]), torch.from_numpy(x),
                             plan=vgg_t.VGG19_PLAN, taps=taps)
    for tap in taps:
        assert _rel_err(got[tap], want[tap]) <= TOL_NET, tap
    assert vgg_t.VGG19_PLAN == vgg_j.VGG19_PLAN
    seeded = vgg_t.init_vgg(0, plan=vgg_t.VGG19_PLAN, lpips_lin=False)
    assert "lin" not in seeded and seeded["conv5_4"]["weight"].shape == (512, 512, 3, 3)


def test_embedding_from_params_and_lpips_distance_match_jax(trees):
    params, lin = trees
    x, y = _images(7), _images(8)
    want = lpips_j.embedding_from_params(_jnp(params["vgg"]), _jnp(lin["vgg"]), jnp.asarray(x))
    got = lpips_t.embedding_from_params(vgg_t.params_from_numpy(params["vgg"]),
                                        vgg_t.params_from_numpy(lin["vgg"]),
                                        torch.from_numpy(x))
    assert _rel_err(got, want) <= TOL_NET
    x255, y255 = (x + 1) * 127.5, (y + 1) * 127.5
    want = vgg_j.lpips_distance(_jnp(params["vgg"]), jnp.asarray(x255), jnp.asarray(y255))
    got = vgg_t.lpips_distance(vgg_t.params_from_numpy(params["vgg"]),
                               torch.from_numpy(x255), torch.from_numpy(y255))
    assert _rel_err(got, want) <= TOL_NET


@pytest.mark.parametrize("net", NETS)
def test_lpips_forward_matches_jax(criteria, net):
    crit_j, crit_t = criteria[net]
    x, y = _images(1), _images(2)
    assert _rel_err(crit_t(x, y), crit_j(x, y)) <= TOL_NET


@pytest.mark.parametrize("net", NETS)
def test_lpips_embedding_matches_jax(criteria, net):
    crit_j, crit_t = criteria[net]
    x = _images(3)
    assert _rel_err(crit_t.embedding(x), crit_j.embedding(x)) <= TOL_NET


@pytest.mark.parametrize("net", NETS)
def test_lpips_forward_tr_matches_jax(criteria, net):
    crit_j, crit_t = criteria[net]
    x, manifold = _images(4), _images(5, n=3)
    feat_j = crit_j.extract_features(manifold)
    feat_np = [np.array(f) for f in feat_j]
    for got, want in zip(crit_t.extract_features(manifold), feat_np, strict=True):
        assert _rel_err(got, want) <= TOL_NET
    want = np.asarray(crit_j.forward_tr(x, feat_j))
    got = crit_t.forward_tr(x, feat_np)
    assert got.ndim == 0 and _rel_err(got, want) <= TOL_NET


@pytest.mark.parametrize("net", NETS)
def test_squared_l2_of_embeddings_is_the_lpips_distance(criteria, net):
    """What the engine relies on: the walk's manifold loss is a squared L2
    between embeddings."""
    crit_t = criteria[net][1]
    x, y = _images(6), _images(7)
    d = (crit_t.embedding(x) - crit_t.embedding(y)).square().sum(dim=1)
    torch.testing.assert_close(d, crit_t.forward(x, y), rtol=1e-4, atol=1e-7)


def test_lpips_default_weights_and_unknown_backbone():
    crit = LPIPS("alex", device="cpu")
    assert crit.target_layers == bb_t.ALEX_TAPS
    assert all(torch.equal(crit.lin[t], torch.ones(bb_t.ALEX_CHANNELS[t])) for t in crit.lin)
    again = LPIPS("alex", device="cpu")
    torch.testing.assert_close(crit.params["conv3"]["weight"], again.params["conv3"]["weight"],
                               rtol=0, atol=0)  # seeded init
    tree = vgg_t.init_vgg(0)
    tree["lin"]["conv4_3"] = torch.full([512], 0.5)
    assert torch.equal(LPIPS("vgg", params=tree, device="cpu").lin["conv4_3"],
                       tree["lin"]["conv4_3"])
    assert torch.equal(lpips_t.default_lin(tree)["conv4_3"], tree["lin"]["conv4_3"])
    with pytest.raises(NotImplementedError):
        LPIPS("resnet", device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host without CUDA")
@pytest.mark.parametrize("build", [lambda: LPIPS("alex"), lambda: nst_t.VGG19Net(),
                                   lambda: NSTLoss()],
                         ids=["LPIPS", "VGG19Net", "NSTLoss"])
def test_criteria_default_to_the_card_and_raise_without_it(build):
    """A criterion built without `device` is on 'cuda': with no CUDA that
    raises, it does not compute on the CPU."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()


def test_criteria_refuse_a_tensor_on_another_device():
    """Nothing is copied between devices silently: a tensor that lies
    elsewhere than the criterion raises; host arrays are placed."""
    crit = LPIPS("alex", device="cpu")
    net = nst_t.VGG19Net(device="cpu")
    x = torch.zeros([1, 3, 32, 32], device="meta")
    for call in (lambda: crit.extract_features(x), lambda: crit.embedding(x),
                 lambda: crit(x, x), lambda: net(x),
                 lambda: crit.forward_tr(np.zeros((1, 3, 32, 32), np.float32),
                                         [torch.zeros([1, 64, 7, 7], device="meta")] * 5)):
        with pytest.raises(ValueError, match="lies on meta"):
            call()
    assert crit.embedding(np.zeros((1, 3, 32, 32), np.float32)).device.type == "cpu"


def test_gram_matrix_and_nst_loss_match_jax(trees):
    params, _ = trees
    rng = np.random.RandomState(9)
    a = rng.randn(2, 5, 4, 6).astype(np.float32)
    assert _rel_err(gram_matrix(torch.from_numpy(a)), nst_j.gram_matrix(jnp.asarray(a))) <= TOL_FN
    x, style, content = ((_images(s, size=32) + 1.0) * 127.5 for s in (10, 11, 12))
    loss_j = nst_j.NSTLoss(nst_j.VGG19Net(params=_jnp(params["vgg19"])), style_weight=1e3)
    loss_t = NSTLoss(nst_t.VGG19Net(params=vgg_t.params_from_numpy(params["vgg19"]),
                                    device="cpu"), style_weight=1e3)
    want = np.asarray(loss_j(x, style, content))
    got = loss_t(x, style, content)
    assert got.ndim == 0 and _rel_err(got, want) <= TOL_NET


@pytest.mark.parametrize("net", ["alex", "squeeze"])
def test_torchvision_state_dict_converters_match_jax(trees, net):
    """A state dict with torchvision's key names lands on the same leaves
    in both packages; a wrong shape or an unknown layer raises."""
    params, _ = trees
    tree = params[net]
    if net == "alex":
        idx = {"conv1": 0, "conv2": 3, "conv3": 6, "conv4": 8, "conv5": 10}
        state = {f"features.{i}.{leaf}": tree[name][leaf] + 1.0
                 for name, i in idx.items() for leaf in ("weight", "bias")}
        conv_j, conv_t = bb_j.convert_torchvision_alexnet, bb_t.convert_torchvision_alexnet
    else:
        idx = {"fire2": 3, "fire3": 4, "fire4": 6, "fire5": 7, "fire6": 9, "fire7": 10,
               "fire8": 11, "fire9": 12}
        state = {f"features.0.{leaf}": tree["conv1"][leaf] + 1.0 for leaf in ("weight", "bias")}
        state.update({f"features.{i}.{part}.{leaf}": tree[name][part][leaf] + 1.0
                      for name, i in idx.items()
                      for part in ("squeeze", "expand1x1", "expand3x3")
                      for leaf in ("weight", "bias")})
        conv_j, conv_t = bb_j.convert_torchvision_squeezenet, bb_t.convert_torchvision_squeezenet
    state["classifier.1.weight"] = np.zeros((3, 3), np.float32)  # ignored
    want, got = _np(conv_j(state)), vgg_t.params_to_numpy(conv_t(state))
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (_, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_array_equal(g, w)
    key = next(iter(state))
    with pytest.raises(ValueError, match="shape mismatch"):
        conv_t({key: np.zeros((1, 2), np.float32)})
    with pytest.raises(KeyError):
        conv_t({"features.99.weight": np.zeros((1,), np.float32)})
