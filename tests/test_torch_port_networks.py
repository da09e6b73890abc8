"""Parity of the port's StyleGAN2 G/D, checkpoint bridge and LPIPS VGG with
the JAX package, on the CPU.

One set of numpy parameters (drawn by the JAX initializers, with nonzero
noise strengths and w_avg so those paths are live) goes into both
packages; the image, the logits and the gradients with respect to ws and
to the image are compared with const noise. Small networks: 32x32,
channel_base 1024, channel_max 64, a 2-layer mapping.

Tolerance: rtol 1e-4 for composed networks in float32 (tens of layers,
summation order differs); the bfloat16 test is loose (bf16 rounds at
other places in the two frameworks) and checks the plumbing.
"""

import importlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentaugment_tpu.models import vgg as vgg_j
from latentaugment_tpu.models.stylegan2 import convert as convert_j
from latentaugment_tpu.models.stylegan2 import networks as net_j
from latentaugment_tpu_torch.models import vgg as vgg_t
from latentaugment_tpu_torch.models.stylegan2 import checkpoint as ckpt_t
from latentaugment_tpu_torch.models.stylegan2 import networks as net_t
from test_torch_port_common import _one_torch_thread  # noqa: F401 (autouse fixture)

RTOL, ATOL = 1e-4, 1e-5
CFG = dict(img_resolution=32, img_channels=2, channel_base=1024, channel_max=64)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol, atol=atol)


def _build(num_fp16_res=0):
    g_cfg_j = net_j.generator_config(z_dim=64, w_dim=64, num_mapping_layers=2,
                                     num_fp16_res=num_fp16_res, **CFG)
    d_cfg_j = net_j.discriminator_config(num_fp16_res=num_fp16_res, **CFG)
    g_params = _np_tree(net_j.generator_init(jax.random.PRNGKey(0), g_cfg_j))
    d_params = _np_tree(net_j.discriminator_init(jax.random.PRNGKey(1), d_cfg_j))
    rng = np.random.RandomState(0)
    g_params["mapping"]["w_avg"] = rng.randn(64).astype(np.float32) * 0.1
    for name, block in g_params["synthesis"].items():
        for conv in ("conv0", "conv1"):
            if isinstance(block, dict) and conv in block:
                block[conv]["noise_strength"] = np.float32(0.37).reshape(())
                block[conv]["bias"] = rng.randn(*block[conv]["bias"].shape).astype(np.float32) * 0.1
    g_cfg_t = net_t.generator_config(z_dim=64, w_dim=64, num_mapping_layers=2,
                                     num_fp16_res=num_fp16_res, **CFG)
    d_cfg_t = net_t.discriminator_config(num_fp16_res=num_fp16_res, **CFG)
    G = net_t.Generator(g_cfg_t)
    G.load_state_dict(ckpt_t.params_to_state_dict(g_params))
    D = net_t.Discriminator(d_cfg_t)
    D.load_state_dict(ckpt_t.params_to_state_dict(d_params))
    G.requires_grad_(False)
    D.requires_grad_(False)
    return dict(g_cfg_j=g_cfg_j, d_cfg_j=d_cfg_j, g_params=g_params,
                d_params=d_params, G=G, D=D)


@pytest.fixture(scope="module")
def nets():
    return _build()


def test_configs_match(nets):
    for k in ("block_resolutions", "channels", "num_ws"):
        assert nets["G"].cfg[k] == nets["g_cfg_j"][k]
        if k != "num_ws":
            assert nets["D"].cfg[k] == nets["d_cfg_j"][k]


def test_state_dict_keys_are_jax_tree_paths(nets):
    want = set(ckpt_t.params_to_state_dict(nets["g_params"]))
    assert set(nets["G"].state_dict()) == want
    assert "synthesis.b4.conv1.weight" in want
    want_d = set(ckpt_t.params_to_state_dict(nets["d_params"]))
    assert set(nets["D"].state_dict()) == want_d


@pytest.mark.parametrize("psi", [1.0, 0.7])
def test_mapping_matches_jax(nets, psi):
    z = np.random.RandomState(1).randn(4, 64).astype(np.float32)
    ws_j = net_j.mapping_apply(nets["g_params"]["mapping"], nets["g_cfg_j"],
                               jnp.asarray(z), truncation_psi=psi)
    with torch.no_grad():
        ws_t = nets["G"].mapping(torch.from_numpy(z), truncation_psi=psi)
    _close(ws_t, ws_j)


def _value_and_vjp_j(fn, params, x, dy):
    """fn(params, x) and its cotangent w.r.t. x, in one jitted JAX program
    (op-by-op dispatch of a whole network is slow on the CPU)."""
    def run(params, x, dy):
        y, vjp = jax.vjp(lambda x: fn(params, x), x)
        return y, vjp(dy)[0]
    return jax.jit(run)(_jnp_tree(params), jnp.asarray(x), jnp.asarray(dy))


@pytest.mark.parametrize("noise_mode", ["const", "none"])
def test_synthesis_and_ws_grad_match_jax(nets, noise_mode):
    rng = np.random.RandomState(2)
    ws = rng.randn(2, nets["g_cfg_j"].num_ws, 64).astype(np.float32)
    dy = rng.randn(2, 2, 32, 32).astype(np.float32)
    img_j, g_j = _value_and_vjp_j(
        lambda p, ws: net_j.synthesis_apply(p, nets["g_cfg_j"], ws, noise_mode=noise_mode),
        nets["g_params"]["synthesis"], ws, dy)
    ws_t = torch.from_numpy(ws).requires_grad_(True)
    img_t = nets["G"].synthesis(ws_t, noise_mode=noise_mode)
    assert tuple(img_t.shape) == (2, 2, 32, 32)
    _close(img_t, img_j)
    g_t, = torch.autograd.grad(img_t, ws_t, torch.from_numpy(dy))
    _close(g_t, g_j, rtol=RTOL, atol=1e-4)


def test_synthesis_remat_is_exact(nets):
    ws = torch.from_numpy(np.random.RandomState(3).randn(2, nets["g_cfg_j"].num_ws, 64)
                          .astype(np.float32)).requires_grad_(True)
    grads = []
    for remat in (False, 16):
        img = nets["G"].synthesis(ws, remat=remat)
        grads.append(torch.autograd.grad(img.square().sum(), ws)[0])
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)


def test_discriminator_and_img_grad_match_jax(nets):
    rng = np.random.RandomState(4)
    img = rng.randn(4, 2, 32, 32).astype(np.float32)
    dy = rng.randn(4, 1).astype(np.float32)
    logits_j, g_j = _value_and_vjp_j(
        lambda p, img: net_j.discriminator_apply(p, nets["d_cfg_j"], img),
        nets["d_params"], img, dy)
    img_t = torch.from_numpy(img).requires_grad_(True)
    logits_t = nets["D"](img_t)
    assert tuple(logits_t.shape) == (4, 1)
    _close(logits_t, logits_j)
    g_t, = torch.autograd.grad(logits_t, img_t, torch.from_numpy(dy))
    _close(g_t, g_j)


def test_minibatch_stddev_needs_whole_groups(nets):
    with pytest.raises(ValueError):
        nets["D"](torch.zeros(6, 2, 32, 32))


def test_bf16_block_plumbing():
    """num_fp16_res=2: blocks 32 and 16 of G and D run in bfloat16, the
    rest and torgb in float32; outputs agree with JAX loosely."""
    n = _build(num_fp16_res=2)
    rng = np.random.RandomState(5)
    ws = rng.randn(4, n["g_cfg_j"].num_ws, 64).astype(np.float32)
    dtypes = {}
    hooks = [getattr(n["G"].synthesis, f"b{r}").conv1.register_forward_hook(
        lambda m, i, o, r=r: dtypes.__setitem__(("G", r), o.dtype)) for r in (4, 8, 16, 32)]
    hooks += [getattr(n["D"], f"b{r}").register_forward_hook(
        lambda m, i, o, r=r: dtypes.__setitem__(("D", r), o.dtype)) for r in (8, 16, 32)]
    hooks += [n["G"].synthesis.b32.torgb.register_forward_hook(
        lambda m, i, o: dtypes.__setitem__(("G", "torgb"), o.dtype))]
    with torch.no_grad():
        img_t = n["G"].synthesis(torch.from_numpy(ws))
        logits_t = n["D"](img_t)
    for h in hooks:
        h.remove()
    bf16, f32 = torch.bfloat16, torch.float32
    assert dtypes == {("G", 4): f32, ("G", 8): f32, ("G", 16): bf16, ("G", 32): bf16,
                      ("D", 8): f32, ("D", 16): bf16, ("D", 32): bf16,
                      ("G", "torgb"): f32}
    assert img_t.dtype == f32 and logits_t.dtype == f32

    @jax.jit
    def run_j(g, d, ws):
        img = net_j.synthesis_apply(g, n["g_cfg_j"], ws)
        return img, net_j.discriminator_apply(d, n["d_cfg_j"], img)

    img_j, logits_j = run_j(_jnp_tree(n["g_params"]["synthesis"]), _jnp_tree(n["d_params"]),
                            jnp.asarray(ws))
    scale = float(np.abs(np.asarray(img_j)).max())
    _close(img_t, img_j, rtol=0.05, atol=0.05 * scale)
    _close(logits_t, logits_j, rtol=0.1, atol=0.1 * float(np.abs(np.asarray(logits_j)).max()))


def test_checkpoint_round_trip_with_jax(nets, tmp_path):
    """JAX save_checkpoint -> port load_stylegan, and port save_checkpoint ->
    JAX load_stylegan, bit-exact."""
    path_j = str(tmp_path / "from_jax.pkl")
    convert_j.save_checkpoint(path_j, nets["g_params"], nets["g_cfg_j"],
                              nets["d_params"], nets["d_cfg_j"])
    g_params, g_cfg, d_params, d_cfg = ckpt_t.load_stylegan(path_j)
    assert g_cfg.num_ws == nets["g_cfg_j"].num_ws and d_cfg.channels == nets["d_cfg_j"].channels
    for k, v in ckpt_t.params_to_state_dict(g_params).items():
        torch.testing.assert_close(v, nets["G"].state_dict()[k], rtol=0, atol=0)

    path_t = str(tmp_path / "from_port.pkl")
    ckpt_t.save_checkpoint(path_t, nets["G"], nets["D"])
    g2, g2_cfg, d2, d2_cfg = convert_j.load_stylegan(path_t)
    assert g2_cfg.num_ws == nets["g_cfg_j"].num_ws
    for a, b in ((g2, nets["g_params"]), (d2, nets["d_params"])):
        la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
        assert len(la) == len(lb)
        for x, y in zip(la, lb):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_checkpoint_loader_refuses_code(tmp_path):
    path = str(tmp_path / "evil.pkl")
    with open(path, "wb") as f:
        pickle.dump({"G": {"params": {}, "cfg": {}}, "x": importlib.import_module}, f)
    with pytest.raises(pickle.UnpicklingError):
        ckpt_t.load_stylegan(path)


def test_conditional_and_sg3_raise():
    """A conditional StyleGAN2 builds (the trainer takes labels), but the
    walk's conditional branch is not ported and raises; the arch dispatch
    returns the alias-free module for 'stylegan3' and StyleGAN2 otherwise."""
    from latentaugment_tpu_torch.augments import engine

    g_cfg = net_t.generator_config(c_dim=3, **CFG)
    assert "mapping.embed.weight" in net_t.Generator(g_cfg).state_dict()
    with pytest.raises(NotImplementedError, match="conditional branch"):
        engine.make_walk_fns(g_cfg, n_modes=2, w_pix=0.1, w_lpips=1.0, w_latent=0.0,
                             w_disc=0.0)
    from latentaugment_tpu_torch.models import networks_for
    from latentaugment_tpu_torch.models.stylegan3 import networks as net3_t
    assert networks_for({"arch": "stylegan3"}) is net3_t
    assert networks_for({}) is net_t and networks_for(net_t.generator_config(**CFG)) is net_t


@pytest.mark.parametrize("input_range", ["0_255", "unit"])
def test_lpips_features_match_jax(input_range):
    """LPIPS VGG16 embedding on 16x16 crops, same numpy params."""
    rng = np.random.RandomState(6)
    params = _np_tree(vgg_j.init_vgg(jax.random.PRNGKey(3)))
    params["lin"] = {t: rng.uniform(0.5, 1.5, vgg_j.LPIPS_CHANNELS[t]).astype(np.float32)
                     for t in vgg_j.LPIPS_TAPS}
    x = (rng.rand(4, 3, 16, 16) * 255.0).astype(np.float32)
    f_j = jax.jit(lambda p, x: vgg_j.lpips_features(p, x, input_range=input_range))(
        _jnp_tree(params), jnp.asarray(x))
    f_t = vgg_t.lpips_features(vgg_t.params_from_numpy(params), torch.from_numpy(x),
                               input_range=input_range)
    assert tuple(f_t.shape) == tuple(f_j.shape)
    _close(f_t, f_j)


def test_vgg_load_params_reads_jax_pickle(tmp_path):
    params = vgg_j.init_vgg(jax.random.PRNGKey(4))
    path = str(tmp_path / "vgg.pkl")
    vgg_j.save_params(params, path)
    loaded = vgg_t.load_params(path, require=("conv1_1", "conv5_3"))
    np.testing.assert_array_equal(loaded["conv3_2"]["weight"].numpy(),
                                  np.asarray(params["conv3_2"]["weight"]))
    assert set(loaded["lin"]) == set(vgg_j.LPIPS_TAPS)
