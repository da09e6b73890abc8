"""Parity of the port's alias-free (StyleGAN3) slice with the JAX package,
on the CPU: the filter designer, the plain `filtered_lrelu` (against the
JAX package's fused Pallas kernel, run in interpret mode as
tests/test_engine_extras.py runs it, and against its decomposed form),
the layer plan, the input plane and each kind of layer, the synthesis
network, the K=3 walk through `benchmark.build_synthetic_setup`, the
checkpoint bridge, and the policy engine's remat default.

Inputs come from numpy seeds; JAX parameters are carried into the port
with `params_to_state_dict`. Every filter test uses random asymmetric
taps (the Kaiser filters are symmetric, so a flipped-tap bug would not
show with them) and both values of `flip_filter`.

Tolerances: single ops rtol 1e-5 against the decomposed form (1e-4
against the fused kernel, as JAX's own test holds it, since it sums in
band-matrix order), gradients rtol 1e-4; composed float32 networks rtol
1e-4; the walked w atol 1e-3, a tenth of one Adam step (see
test_torch_port_walk.py).
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentaugment_tpu import benchmark as benchmark_j
from latentaugment_tpu.augments import engine as engine_j
from latentaugment_tpu.models.stylegan2 import convert as convert_j
from latentaugment_tpu.models.stylegan3 import filters as filters_j
from latentaugment_tpu.models.stylegan3 import networks as net3_j
from latentaugment_tpu.ops.filtered_lrelu import filtered_lrelu as flrelu_j
from latentaugment_tpu_torch import benchmark as benchmark_t
from latentaugment_tpu_torch.augments import create_augment as create_augment_t
from latentaugment_tpu_torch.augments import engine as engine_t
from latentaugment_tpu_torch.data import create_dataset as create_dataset_t
from latentaugment_tpu_torch.models import networks_for
from latentaugment_tpu_torch.models.stylegan2 import checkpoint as ckpt_t
from latentaugment_tpu_torch.models.stylegan3 import filters as filters_t
from latentaugment_tpu_torch.models.stylegan3 import networks as net3_t
from latentaugment_tpu_torch.ops import filtered_lrelu as fl_t
from latentaugment_tpu_torch.options import AugOptions as AugOptions_t
from test_torch_port_common import _one_torch_thread  # noqa: F401 (autouse fixture)

RTOL, ATOL = 1e-4, 1e-5
W_ATOL = 1e-3
SMALL = dict(img_resolution=64, img_channels=2, num_layers=6, channel_base=2048,
             channel_max=64, num_fp16_res=0, z_dim=64, w_dim=64)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol, atol=atol)


# ----------------------------------------------------------------------------
# Filters

def _filter_specs():
    specs = []
    for radial in (False, True):
        cfg = net3_j.generator_config(use_radial_filters=radial, conv_kernel=1 if radial else 3)
        for layer in cfg.layers:
            specs.append((layer.up_taps, layer.in_cutoff, layer.in_half_width * 2,
                          layer.tmp_sampling_rate, False))
            specs.append((layer.down_taps, layer.out_cutoff, layer.out_half_width * 2,
                          layer.tmp_sampling_rate, layer.down_radial))
    return specs


@pytest.mark.parametrize("radial", [False, True], ids=["1d", "radial"])
def test_filters_match_jax_bit_for_bit(radial):
    specs = [s for s in _filter_specs() if s[4] == radial]
    assert specs and any(s[0] > 1 for s in specs)
    for taps, cutoff, width, fs, rad in specs:
        got = filters_t.design_lowpass_filter(taps, cutoff, width, fs, radial=rad)
        want = filters_j.design_lowpass_filter(taps, cutoff, width, fs, radial=rad)
        if want is None:
            assert got is None
            continue
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.ndim == (2 if rad else 1)
        np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------------------
# filtered_lrelu: the plain version against the JAX package

# The walk's geometries (SG3-T 256 plan) at a few pixels and channels:
# (input HxW, up taps, down taps, up, down, padding, gain, slope, clamp).
GEOMETRIES = {
    "L0 up2 pad(9,8)": ((12, 11), 12, 12, 2, 2, (9, 8, 9, 8), None, 0.2, 0.7),
    "L3 up4 crop(-6,-9)": ((16, 15), 24, 12, 4, 2, (-6, -9, -6, -9), None, 0.2, 0.7),
    "L13 critical crop(-11,-12)": ((30, 29), 12, 12, 2, 2, (-11, -12, -11, -12), None, 0.2, 0.7),
    "toRGB": ((10, 9), 1, 1, 1, 1, (0, 0, 0, 0), 1.0, 1.0, 0.7),
}


def _flrelu_inputs(geo, seed):
    (h, w), tu, td = geo[:3]
    rs = np.random.RandomState(seed)
    x = rs.randn(2, 3, h, w).astype(np.float32)
    fu = rs.randn(tu).astype(np.float32) if tu > 1 else None
    fd = rs.randn(td).astype(np.float32) if td > 1 else None
    b = rs.randn(3).astype(np.float32)
    return x, fu, fd, b, rs


@pytest.mark.parametrize("clamped", [False, True], ids=["noclamp", "clamp"])
@pytest.mark.parametrize("flip", [False, True], ids=["conv", "corr"])
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_plain_filtered_lrelu_matches_jax(name, flip, clamped):
    geo = GEOMETRIES[name]
    _, _, _, up, down, padding, gain, slope, clamp = geo
    clamp = clamp if clamped else None
    x, fu, fd, b, rs = _flrelu_inputs(geo, seed=len(name) + 2 * flip + clamped)
    kw = dict(up=up, down=down, padding=padding, gain=gain, slope=slope, clamp=clamp,
              flip_filter=flip)

    def j(a):
        return None if a is None else jnp.asarray(a)

    def t(a):
        return None if a is None else torch.from_numpy(a)

    def run_j(impl, x, b):
        return flrelu_j(x, j(fu), j(fd), b, impl=impl, **kw)

    y_dec, vjp = jax.vjp(lambda x, b: run_j('xla', x, b), jnp.asarray(x), jnp.asarray(b))
    y_fused = run_j('pallas_fused', jnp.asarray(x), jnp.asarray(b))
    xt = torch.from_numpy(x).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    y_t = fl_t.filtered_lrelu(xt, t(fu), t(fd), bt, **kw)
    assert tuple(y_t.shape) == y_dec.shape == y_fused.shape
    if clamped:  # the clamp engages
        assert float(np.abs(np.asarray(y_dec)).max()) > 0.9 * clamp
    scale = float(np.abs(np.asarray(y_dec)).max())
    _close(y_t, y_dec, rtol=1e-5, atol=1e-5 * scale)
    _close(y_t, y_fused, rtol=1e-4, atol=1e-4 * scale)

    dy = rs.randn(*y_dec.shape).astype(np.float32)
    gx_j, gb_j = vjp(jnp.asarray(dy))
    gx_t, gb_t = torch.autograd.grad(y_t, (xt, bt), torch.from_numpy(dy))
    _close(gx_t, gx_j, atol=1e-4 * float(np.abs(np.asarray(gx_j)).max()))
    _close(gb_t, gb_j, atol=1e-4 * float(np.abs(np.asarray(gb_j)).max()))


def test_plain_filtered_lrelu_takes_2d_filters():
    """The radial (SG3-R) filters are 2-D; the plain version takes them as
    JAX's decomposed path does."""
    rs = np.random.RandomState(11)
    x = rs.randn(2, 3, 9, 8).astype(np.float32)
    fu, fd = rs.randn(4, 4).astype(np.float32), rs.randn(6, 6).astype(np.float32)
    b = rs.randn(3).astype(np.float32)
    kw = dict(up=2, down=2, padding=(3, 4, 2, 5), clamp=0.8)
    y_j = flrelu_j(jnp.asarray(x), jnp.asarray(fu), jnp.asarray(fd), jnp.asarray(b),
                   impl='xla', **kw)
    y_t = fl_t.filtered_lrelu(torch.from_numpy(x), torch.from_numpy(fu), torch.from_numpy(fd),
                              torch.from_numpy(b), **kw)
    _close(y_t, y_j, rtol=1e-5, atol=1e-5 * float(np.abs(np.asarray(y_j)).max()))


def test_filtered_lrelu_argument_checks():
    x = torch.zeros(1, 2, 8, 8)
    with pytest.raises(ValueError):
        fl_t.filtered_lrelu(x, b=torch.zeros(3))
    with pytest.raises(ValueError):
        fl_t.filtered_lrelu(x, impl='pallas_fused')
    with pytest.raises(ValueError):
        fl_t.filtered_lrelu(x, fu=torch.ones(12), up=2, padding=-8)  # nothing left


# ----------------------------------------------------------------------------
# Layer plan, input plane, layers, synthesis

@pytest.mark.parametrize("kw", [SMALL, {}, dict(use_radial_filters=True, conv_kernel=1)],
                         ids=["small", "sg3t-256", "sg3r-256"])
def test_generator_config_matches_jax(kw):
    cfg_j, cfg_t = net3_j.generator_config(**kw), net3_t.generator_config(**kw)
    assert set(cfg_t) == set(cfg_j)
    for k in cfg_j:
        if k == "layers":
            assert len(cfg_t.layers) == len(cfg_j.layers)
            for lt, lj in zip(cfg_t.layers, cfg_j.layers):
                assert dict(lt) == dict(lj)
        else:
            assert cfg_t[k] == cfg_j[k], k


@pytest.fixture(scope="module")
def small_gen():
    """Small alias-free G (JAX init, random affine/bias/magnitude/transform
    so those paths are live), carried into the port."""
    cfg_j = net3_j.generator_config(**SMALL)
    params = _np_tree(net3_j.generator_init(jax.random.PRNGKey(0), cfg_j))
    rng = np.random.RandomState(0)
    syn = params["synthesis"]
    syn["input"]["affine"]["weight"] = rng.randn(4, 64).astype(np.float32) * 0.3
    syn["input"]["affine"]["bias"] = np.asarray([1.0, 0.2, 0.1, -0.3], np.float32)
    syn["input"]["transform"] = np.asarray([[0.8, -0.6, 0.3], [0.6, 0.8, -0.2], [0, 0, 1]],
                                           np.float32)
    for layer in cfg_j.layers:
        lp = syn[layer.name]
        lp["bias"] = rng.randn(*lp["bias"].shape).astype(np.float32) * 0.2
        lp["magnitude_ema"] = np.float32(rng.uniform(0.5, 2.0)).reshape(())
    G = net3_t.Generator(net3_t.generator_config(**SMALL))
    G.load_state_dict(ckpt_t.params_to_state_dict(params))
    G.requires_grad_(False)
    return cfg_j, params, G


def test_state_dict_keys_are_jax_tree_paths(small_gen):
    _, params, G = small_gen
    assert set(G.state_dict()) == set(ckpt_t.params_to_state_dict(params))
    assert "synthesis.L6_64_2.up_filter" not in G.state_dict()  # toRGB: identity filters
    assert G.state_dict()["synthesis.L0_36_64.magnitude_ema"].shape == ()
    assert G.state_dict()["synthesis.input.transform"].shape == (3, 3)


@pytest.mark.parametrize("override", [False, True], ids=["stored", "override"])
def test_input_plane_matches_jax(small_gen, override):
    cfg_j, params, G = small_gen
    w = np.random.RandomState(1).randn(3, 64).astype(np.float32)
    transform = np.asarray([[0, -1, 0.5], [1, 0, 0.25], [0, 0, 1]], np.float32) if override else None
    x_j = net3_j.input_apply(_jnp_tree(params["synthesis"]["input"]), cfg_j, jnp.asarray(w),
                             transform=transform)
    with torch.no_grad():
        x_t = G.synthesis.input(torch.from_numpy(w), transform=transform)
    assert tuple(x_t.shape) == x_j.shape == (3, 64, 36, 36)
    _close(x_t, x_j, rtol=1e-5, atol=1e-5 * float(np.abs(np.asarray(x_j)).max()))


@pytest.mark.parametrize("idx", [0, 2, 5, 6], ids=["up2", "up4", "critical", "torgb"])
def test_layer_matches_jax(small_gen, idx):
    cfg_j, params, G = small_gen
    layer = cfg_j.layers[idx]
    rs = np.random.RandomState(10 + idx)
    x = rs.randn(2, layer.in_channels, layer.in_size, layer.in_size).astype(np.float32)
    w = rs.randn(2, 64).astype(np.float32)
    y_j = jax.jit(lambda p, x, w: net3_j.layer_apply(p, cfg_j, layer, x, w))(
        _jnp_tree(params["synthesis"][layer.name]), jnp.asarray(x), jnp.asarray(w))
    with torch.no_grad():
        y_t = getattr(G.synthesis, layer.name)(torch.from_numpy(x), torch.from_numpy(w))
    assert tuple(y_t.shape) == y_j.shape == (2, layer.out_channels, layer.out_size, layer.out_size)
    _close(y_t, y_j, rtol=1e-5, atol=1e-5 * float(np.abs(np.asarray(y_j)).max()))


def test_synthesis_and_ws_grad_match_jax(small_gen):
    cfg_j, params, G = small_gen
    rng = np.random.RandomState(2)
    ws = rng.randn(2, cfg_j.num_ws, 64).astype(np.float32)
    dy = rng.randn(2, 2, 64, 64).astype(np.float32)

    def run(p, ws, dy):
        img, vjp = jax.vjp(lambda ws: net3_j.synthesis_apply(p, cfg_j, ws), ws)
        return img, vjp(dy)[0]

    img_j, g_j = jax.jit(run)(_jnp_tree(params["synthesis"]), jnp.asarray(ws), jnp.asarray(dy))
    ws_t = torch.from_numpy(ws).requires_grad_(True)
    img_t = G.synthesis(ws_t, noise_mode="random", generator=torch.Generator())
    assert tuple(img_t.shape) == (2, 2, 64, 64) and img_t.dtype == torch.float32
    _close(img_t, img_j, atol=1e-4 * float(np.abs(np.asarray(img_j)).max()))
    g_t, = torch.autograd.grad(img_t, ws_t, torch.from_numpy(dy))
    _close(g_t, g_j, atol=1e-4 * float(np.abs(np.asarray(g_j)).max()))


def test_synthesis_remat_is_exact(small_gen):
    _, _, G = small_gen
    ws = torch.from_numpy(np.random.RandomState(3).randn(2, G.cfg.num_ws, 64)
                          .astype(np.float32)).requires_grad_(True)
    grads = [torch.autograd.grad(G.synthesis(ws, remat=remat).square().sum(), ws)[0]
             for remat in (False, 84)]
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)


def test_bf16_layers_are_chosen_from_the_live_cfg():
    """num_fp16_res is read at forward time: with 2, the layers whose
    sampling rate is within 2 doublings of 64 (rate 32 and 64) and toRGB
    run in bfloat16, the first two in float32; the image is float32."""
    G = net3_t.Generator(net3_t.generator_config(**SMALL))
    ws = torch.randn(2, G.cfg.num_ws, 64)
    dtypes = {}
    for layer in G.cfg.layers:
        getattr(G.synthesis, layer.name).register_forward_hook(
            lambda m, i, o, name=layer.name: dtypes.__setitem__(name, o.dtype))
    G.cfg.num_fp16_res = 2
    with torch.no_grad():
        img = G.synthesis(ws)
    f32, bf16 = torch.float32, torch.bfloat16
    assert [dtypes[layer.name] for layer in G.cfg.layers] == [f32, f32] + [bf16] * 5
    assert img.dtype == f32 and torch.isfinite(img).all()


# ----------------------------------------------------------------------------
# The walk, through benchmark.build_synthetic_setup(arch="stylegan3")

@pytest.fixture(scope="module")
def sg3_walked():
    setup = dict(res=64, channel_base=2048, channel_max=64, num_epochs=3, crop_size=16,
                 w_pix=0.1, w_lpips=0.0, w_latent=0.001, w_disc=0.05, manifold_items=16,
                 num_fp16_res=0, arch="stylegan3", num_layers=6, z_dim=64, w_dim=64)
    fns_j, bundle_j, g_cfg_j = benchmark_j.build_synthetic_setup(remat=False, **setup)
    fns_t, bundle_t, g_cfg_t = benchmark_t.build_synthetic_setup(torch.device("cpu"), **setup)
    assert g_cfg_t.arch == "stylegan3" and isinstance(bundle_t["G"], net3_t.Generator)
    # The JAX set-up's weights and summaries, carried into the port's bundle.
    bundle_t["G"].load_state_dict(ckpt_t.params_to_state_dict(_np_tree(bundle_j["g"])))
    bundle_t["D"].load_state_dict(ckpt_t.params_to_state_dict(_np_tree(bundle_j["d"])))
    for k in ("W_summary", "X_cc_summaries"):
        bundle_t[k] = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                             bundle_j[k])
    w0 = np.random.RandomState(4).randn(4, 1, 64).astype(np.float32) * 0.5
    crop = (1, 2)
    _, ws_j, traces_j = jax.jit(fns_j.walk)(bundle_j, jnp.asarray(w0),
                                            jnp.asarray(crop, jnp.int32), jax.random.PRNGKey(0))
    img_t, ws_t, traces_t = fns_t.walk(bundle_t, torch.from_numpy(w0), crop, torch.Generator())
    return dict(w0=w0, ws_j=ws_j, traces_j=traces_j, ws_t=ws_t, traces_t=traces_t,
                img_t=img_t)


@pytest.mark.parametrize("key", ["loss_latent", "loss_disc", "loss_pix", "loss"])
def test_sg3_walk_loss_traces_match_jax(sg3_walked, key):
    assert tuple(sg3_walked["traces_t"][key].shape) == (3,)
    _close(sg3_walked["traces_t"][key], sg3_walked["traces_j"][key])


def test_sg3_walk_final_w_matches_jax(sg3_walked):
    moved = np.abs(sg3_walked["ws_t"][:, :1].numpy() - sg3_walked["w0"]).mean()
    assert moved > 5e-3, f"walk barely moved w ({moved})"
    _close(sg3_walked["ws_t"], sg3_walked["ws_j"], rtol=0, atol=W_ATOL)
    assert sg3_walked["img_t"].shape == (4, 2, 64, 64)
    assert torch.isfinite(sg3_walked["img_t"]).all()


# ----------------------------------------------------------------------------
# Checkpoints and dispatch

def test_sg3_checkpoint_round_trip_with_jax(small_gen, tmp_path):
    """JAX save_checkpoint -> port load_stylegan -> port save_checkpoint ->
    JAX load_stylegan: the arch tag, the cfg and every array survive."""
    cfg_j, params, _ = small_gen
    path_j = str(tmp_path / "from_jax.pkl")
    convert_j.save_checkpoint(path_j, params, cfg_j)
    g_params, g_cfg, d_params, d_cfg = ckpt_t.load_stylegan(path_j)
    assert g_cfg.arch == "stylegan3" and d_params is None and d_cfg is None
    G = networks_for(g_cfg).Generator(g_cfg)
    assert isinstance(G, net3_t.Generator)
    G.load_state_dict(ckpt_t.params_to_state_dict(g_params))

    path_t = str(tmp_path / "from_port.pkl")
    ckpt_t.save_checkpoint(path_t, G)
    g2, g2_cfg, _, _ = convert_j.load_stylegan(path_t)
    assert g2_cfg.arch == "stylegan3"
    for k in convert_j._cfg_kwargs(cfg_j, kind="G"):
        assert g2_cfg[k] == cfg_j[k], k
    la, lb = jax.tree_util.tree_leaves_with_path(g2), jax.tree_util.tree_leaves_with_path(params)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (_, a), (_, b) in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ----------------------------------------------------------------------------
# The policy engine's remat default (the JAX engine's _remat_setting)

@pytest.fixture(scope="module")
def remat_policies(tmp_path_factory):
    """The port's policy on a 64x64 workspace (where num_fp16_res is kept)
    for each generator family and --num_fp16_res 0 / 4; one batch walked."""
    out = {}
    for arch, over in (("stylegan2", {}), ("stylegan3", dict(num_layers=4, w_dim=64, z_dim=64))):
        root = str(tmp_path_factory.mktemp(f"remat_{arch}"))
        ch = dict(channel_base=256, channel_max=16) if arch == "stylegan2" else \
            dict(channel_base=512, channel_max=16)
        argv = benchmark_t.build_policy_workspace(
            root, res=64, batch_size=2, num_epochs=2, crop_size=16, n_patients=1,
            slices_per_patient=2, step=5, arch=arch, **ch, **over)
        for n16 in (0, 4):
            opt = AugOptions_t().parse(
                argv=argv + ["--device", "cpu", "--num_fp16_res", str(n16)],
                install_logger=False)
            augment = create_augment_t(opt)
            out[arch, n16] = (opt, augment, next(iter(create_dataset_t(opt))))
    return out


@pytest.mark.parametrize("arch", ["stylegan2", "stylegan3"])
@pytest.mark.parametrize("n16", [0, 4])
def test_policy_remat_default_matches_jax_engine(remat_policies, arch, n16):
    opt, augment, _ = remat_policies[arch, n16]
    eng = augment.latent_aug
    assert eng.G_cfg.get("arch", "stylegan2") == arch
    assert eng.G_cfg.num_fp16_res == n16
    want = engine_j.LatentAugEngine._remat_setting(
        types.SimpleNamespace(_opt_ref=opt, G_cfg=eng.G_cfg))
    assert eng._fns.remat is want is (n16 == 0)
    # A remat given in the options wins, read as the JAX engine reads it.
    for given in ("false", "True", "128", 64, True):
        opt2 = types.SimpleNamespace(remat=given)
        assert eng._remat_setting(opt2) == engine_j.LatentAugEngine._remat_setting(
            types.SimpleNamespace(_opt_ref=opt2, G_cfg=eng.G_cfg))


@pytest.mark.parametrize("arch", ["stylegan2", "stylegan3"])
def test_policy_remat_walk_equals_no_remat(remat_policies, arch):
    """float32 policy (--num_fp16_res 0): the walk with remat, as the
    engine now runs it, walks w exactly as the walk without it; and the
    policy runs end to end on the family's checkpoint."""
    opt, augment, data = remat_policies[arch, 0]
    eng = augment.latent_aug
    assert eng._fns.remat is True
    augment.set_input(data)
    augment.forward()
    out = augment.get_output()
    assert out["A"].shape == (2, 1, 64, 64) and np.isfinite(out["A"]).all()
    w0 = torch.from_numpy(augment.get_latent_input()["w"][:, None, :])
    no_remat = engine_t.make_walk_fns(
        eng.G_cfg, n_modes=len(eng.modalities), w_pix=eng.w_pix, w_lpips=eng.w_lpips,
        w_latent=eng.w_latent, w_disc=eng.w_disc, num_epochs=eng.num_epochs,
        opt_lr=eng.opt_lr, crop_size=eng.crop_size, preprocess=eng.preprocess, remat=False)
    walked = [fns.walk(eng._bundle, w0, (3, 5), torch.Generator())[1]
              for fns in (eng._fns, no_remat)]
    assert not torch.equal(walked[0][:, :1], w0)
    torch.testing.assert_close(walked[0], walked[1], rtol=0, atol=0)
    assert os.path.isfile(opt.model_dir)
