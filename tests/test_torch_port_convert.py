"""Parity of the port's checkpoint converters with the JAX package's, on
the CPU, over in-process stand-ins of the real files:

  * NVIDIA persistence pickles (`reference_oracles.persistence_pickle_bytes`
    over the NVIDIA-faithful GeneratorT / DiscriminatorT, 32x32,
    channel_base 1024, channel_max 64, 2 mapping layers), unconditional and
    with c_dim 3: the same bytes through both packages' `load_stylegan`
    give equal trees and configs, and the port's G and D on them match the
    JAX package's and the oracle modules;
  * TF-era pickles: `dnnlib.tflib.network.Network` objects pickled in the
    wire format, through both `legacy` converters;
  * an alias-free payload dispatched by its class name;
  * a TorchScript VGG16 with LPIPS heads;
  * the tampered pickles the JAX tests refuse;
  * the command lines: `scripts/torch_convert_checkpoint.py`,
    `scripts/torch_verify_real_weights.py --device cpu`, and
    `scripts/torch_project_dataset.py` on an NVIDIA pickle.

Tolerance: converted arrays rtol 0, atol 0; composed networks rtol 1e-4
(atol 1e-4 on images of unit scale, 1e-5 elsewhere).
"""

import contextlib
import importlib
import io
import json
import os
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_oracles as oracle
from latentaugment_tpu.models import vgg as vgg_j
from latentaugment_tpu.models.stylegan2 import convert as convert_j
from latentaugment_tpu.models.stylegan2 import legacy as legacy_j
from latentaugment_tpu.models.stylegan2 import networks as net_j
from latentaugment_tpu_torch.models import networks_for, vgg as vgg_t
from latentaugment_tpu_torch.models.stylegan2 import checkpoint as ckpt_t
from latentaugment_tpu_torch.models.stylegan2 import convert as convert_t
from latentaugment_tpu_torch.models.stylegan2 import legacy as legacy_t
from latentaugment_tpu_torch.models.stylegan2 import networks as net_t
from latentaugment_tpu_torch.models.stylegan3 import networks as net3_t
from test_torch_port_common import _one_torch_thread  # noqa: F401 (autouse fixture)

# The ops packages export the function upfirdn2d under the module's name.
up_j = importlib.import_module("latentaugment_tpu.ops.upfirdn2d")
up_t = importlib.import_module("latentaugment_tpu_torch.ops.upfirdn2d")

RTOL = 1e-4
RES, CH, W_DIM, C_DIM = 32, 64, 64, 3


def _flat(tree):
    return {k: v.numpy() for k, v in ckpt_t.params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _assert_same_tree(got, want):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys(), got.keys() ^ want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _assert_same_cfg(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        if k == "layers":
            assert [dict(a) for a in got[k]] == [dict(b) for b in want[k]]
        else:
            assert got[k] == want[k], k


def _oracle_pair(c_dim=0, conv_clamp=256.0, seed=0):
    torch.manual_seed(seed)
    g = oracle.GeneratorT(z_dim=64, c_dim=c_dim, w_dim=W_DIM, img_resolution=RES, img_channels=2,
                          mapping_kwargs={"num_layers": 2},
                          synthesis_kwargs={"channel_base": 1024, "channel_max": CH,
                                            "conv_clamp": conv_clamp})
    d = oracle.DiscriminatorT(c_dim=c_dim, img_resolution=RES, img_channels=2, channel_base=1024,
                              channel_max=CH, conv_clamp=conv_clamp,
                              mapping_kwargs={"num_layers": 2})
    with torch.no_grad():  # live truncation and noise paths
        g.mapping.w_avg.copy_(torch.randn_like(g.mapping.w_avg) * 0.1)
        for m in g.modules():
            if isinstance(m, oracle.SynthesisLayerT):
                m.noise_strength.fill_(0.37)
    return g.eval(), d.eval()


def _g_apply_j(params, cfg, z, c, **kw):
    """The JAX generator, jitted (one compile, not one per op)."""
    fn = jax.jit(lambda p, z, c: net_j.generator_apply(p, cfg, z, c, **kw))
    return fn(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(z),
              None if c is None else jnp.asarray(c))


def _d_apply_j(params, cfg, img, c):
    fn = jax.jit(lambda p, x, c: net_j.discriminator_apply(p, cfg, x, c))
    return fn(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(img),
              None if c is None else jnp.asarray(c))


def _port_modules(g_params, g_cfg, d_params, d_cfg):
    G = networks_for(g_cfg).Generator(g_cfg)
    G.load_state_dict(ckpt_t.params_to_state_dict(g_params))  # strict: every name, every shape
    D = None
    if d_params is not None:
        D = net_t.Discriminator(d_cfg)
        D.load_state_dict(ckpt_t.params_to_state_dict(d_params))
    return G, D


@pytest.fixture(scope="module", params=["unconditional", "conditional", "clamp_engaged"])
def nvidia(request):
    """One oracle pair, its NVIDIA wire-format bytes, and both packages'
    conversions of those bytes."""
    c_dim = C_DIM if request.param == "conditional" else 0
    g, d = _oracle_pair(c_dim, conv_clamp=0.3 if request.param == "clamp_engaged" else 256.0,
                        seed=3 if request.param == "clamp_engaged" else 0)
    data = oracle.persistence_pickle_bytes({"G_ema": g, "D": d})
    return dict(kind=request.param, c_dim=c_dim, g=g, d=d, data=data,
                jax=convert_j.load_stylegan(io.BytesIO(data)),
                port=ckpt_t.load_stylegan(io.BytesIO(data)))


def test_nvidia_pickle_converts_to_the_jax_trees(nvidia):
    (gj, gcj, dj, dcj), (gt, gct, dt, dct) = nvidia["jax"], nvidia["port"]
    _assert_same_tree(gt, gj)
    _assert_same_tree(dt, dj)
    _assert_same_cfg(gct, gcj)
    _assert_same_cfg(dct, dcj)
    assert (gct.c_dim, dct.c_dim, gct.num_mapping_layers) == (nvidia["c_dim"],) * 2 + (2,)
    # The per-layer 2-D resample buffers became one 1-D 4-tap filter: the
    # kernel's separable variants take only that shape.
    for f in (gt["synthesis"]["resample_filter"], dt["resample_filter"]):
        np.testing.assert_allclose(f, [0.125, 0.375, 0.375, 0.125], rtol=1e-6)
    assert gt["mapping"]["w_avg"].shape == (W_DIM,) and np.abs(gt["mapping"]["w_avg"]).max() > 0
    assert gt["synthesis"]["b8"]["conv0"]["noise_strength"].shape == ()


@pytest.mark.parametrize("noise_mode,psi", [("const", 1.0), ("none", 1.0), ("const", 0.7)])
def test_generator_on_converted_params_matches_jax_and_oracle(nvidia, noise_mode, psi):
    gt, gct, _, _ = nvidia["port"]
    gj, gcj, _, _ = nvidia["jax"]
    G, _ = _port_modules(*nvidia["port"])
    rng = np.random.RandomState(1)
    z = rng.randn(4, 64).astype(np.float32)
    c = np.eye(C_DIM, dtype=np.float32)[rng.randint(0, C_DIM, 4)] if nvidia["c_dim"] else None
    tc = None if c is None else torch.from_numpy(c)
    with torch.no_grad():
        img_t = G(torch.from_numpy(z), tc, truncation_psi=psi, noise_mode=noise_mode).numpy()
        img_o = nvidia["g"](torch.from_numpy(z), tc, truncation_psi=psi,
                            noise_mode=noise_mode).numpy()
    assert img_t.shape == (4, 2, RES, RES) and np.abs(img_o).max() > 0.05
    np.testing.assert_allclose(img_t, img_o, rtol=RTOL, atol=1e-4)
    if nvidia["kind"] == "unconditional" or (noise_mode, psi) == ("const", 1.0):
        # The JAX generator too (each case is one more compile of it).
        img_j = _g_apply_j(gj, gcj, z, c, truncation_psi=psi, noise_mode=noise_mode)
        np.testing.assert_allclose(img_t, np.asarray(img_j), rtol=RTOL, atol=1e-4)
    if nvidia["kind"] == "clamp_engaged" and noise_mode == "const" and psi == 1.0:
        # The clamp engaged: the same weights without it give another image.
        for m in G.modules():
            if getattr(m, "conv_clamp", None) is not None:
                m.conv_clamp = 256.0
        with torch.no_grad():
            wide = G(torch.from_numpy(z), noise_mode=noise_mode).numpy()
        assert np.abs(wide - img_t).max() > 1e-3


def test_discriminator_on_converted_params_matches_jax_and_oracle(nvidia):
    _, _, dj, dcj = nvidia["jax"]
    _, D = _port_modules(*nvidia["port"])
    rng = np.random.RandomState(5)
    img = rng.randn(8, 2, RES, RES).astype(np.float32)
    c = np.eye(C_DIM, dtype=np.float32)[rng.randint(0, C_DIM, 8)] if nvidia["c_dim"] else None
    tc = None if c is None else torch.from_numpy(c)
    with torch.no_grad():
        got = D(torch.from_numpy(img), tc).numpy()
        want_o = nvidia["d"](torch.from_numpy(img), tc).numpy()
    want_j = np.asarray(_d_apply_j(dj, dcj, img, c))
    scale = np.abs(want_o).max()
    assert got.shape == (8, 1) and scale > 0
    np.testing.assert_allclose(got, want_j, rtol=RTOL, atol=1e-5 * scale)
    np.testing.assert_allclose(got, want_o, rtol=RTOL, atol=1e-5 * scale)


@pytest.mark.parametrize("f", [np.outer([1, 3, 3, 1], [1, 3, 3, 1]) / 64.0, np.eye(4),
                               np.outer([1, 2, 1], [1, 3, 1]), np.array([1.0, 2.0, 1.0]),
                               np.ones((2, 3))], ids=["rank1", "eye", "asymmetric", "1d", "3x2"])
def test_separable_factor_matches_jax(f):
    got, want = up_t.separable_factor(f), up_j.separable_factor(f)
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(got, want)


def test_payload_keeps_module_internals_and_submodules_inert(nvidia):
    obj = convert_t.load_network_pickle(io.BytesIO(nvidia["data"]))
    state = obj["G_ema"]["state"]
    assert state["training"] is False and "_modules" in state
    sub = state["_modules"]["mapping"]
    assert isinstance(sub, convert_t._PersistencePayload)
    assert sub["module_src"].startswith("#")  # the embedded source was not run


# ----------------------------------------------------------------------------
# TF-era pickles

@contextlib.contextmanager
def _fake_dnnlib():
    """A `dnnlib.tflib.network.Network` class for pickling stand-ins in
    the TF-era wire format (NEWOBJ of that global, then its state)."""
    names = ("dnnlib", "dnnlib.tflib", "dnnlib.tflib.network")
    saved = {n: sys.modules.get(n) for n in names}
    mods = {n: types.ModuleType(n) for n in names}

    class Network:
        def __init__(self, **state):
            self.__dict__.update(state)

    Network.__module__, Network.__qualname__ = "dnnlib.tflib.network", "Network"
    mods["dnnlib.tflib.network"].Network = Network
    mods["dnnlib"].tflib = mods["dnnlib.tflib"]
    mods["dnnlib.tflib"].network = mods["dnnlib.tflib.network"]
    sys.modules.update(mods)
    try:
        yield Network
    finally:
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m


def _tf_generator_vars(rng, c_dim, nmap=2, img_ch=2):
    def r(*shape):
        return np.asarray(rng.randn(*shape), np.float32)

    mapping = [(f"Dense{i}/weight", r(W_DIM * (2 if i == 0 and c_dim else 1), W_DIM))
               for i in range(nmap)] + [(f"Dense{i}/bias", r(W_DIM)) for i in range(nmap)]
    if c_dim:
        mapping += [("LabelEmbed/weight", r(c_dim, W_DIM)), ("LabelEmbed/bias", r(W_DIM))]
    syn = [("4x4/Const/const", r(1, CH, 4, 4)), ("noise0", r(1, 1, 4, 4))]

    def layer(prefix):
        return [(f"{prefix}/weight", r(3, 3, CH, CH) * 0.3), (f"{prefix}/bias", r(CH) * 0.1),
                (f"{prefix}/noise_strength", r()), (f"{prefix}/mod_weight", r(W_DIM, CH)),
                (f"{prefix}/mod_bias", r(CH) * 0.1)]

    syn += layer("4x4/Conv")
    res = 4
    while res < RES:
        res *= 2
        lg = int(np.log2(res))
        syn += layer(f"{res}x{res}/Conv0_up") + layer(f"{res}x{res}/Conv1")
        syn += [(f"noise{lg * 2 - 5}", r(1, 1, res, res)), (f"noise{lg * 2 - 4}", r(1, 1, res, res))]
    for res in (2 ** i for i in range(2, int(np.log2(RES)) + 1)):
        syn += [(f"{res}x{res}/ToRGB/weight", r(1, 1, CH, img_ch)),
                (f"{res}x{res}/ToRGB/bias", r(img_ch)),
                (f"{res}x{res}/ToRGB/mod_weight", r(W_DIM, CH)),
                (f"{res}x{res}/ToRGB/mod_bias", r(CH) * 0.1)]
    return [("dlatent_avg", r(W_DIM))], mapping, syn


def _tf_discriminator_vars(rng, c_dim, n_map=2, out_dim=None, embed=True, img_ch=2):
    def r(*shape):
        return np.asarray(rng.randn(*shape), np.float32)

    cmap = CH if c_dim else 0
    v = []
    res = RES
    while res > 4:
        if res == RES:
            v += [(f"{res}x{res}/FromRGB/weight", r(1, 1, img_ch, CH)),
                  (f"{res}x{res}/FromRGB/bias", r(CH))]
        v += [(f"{res}x{res}/Conv0/weight", r(3, 3, CH, CH)), (f"{res}x{res}/Conv0/bias", r(CH)),
              (f"{res}x{res}/Conv1_down/weight", r(3, 3, CH, CH)),
              (f"{res}x{res}/Conv1_down/bias", r(CH)), (f"{res}x{res}/Skip/weight", r(1, 1, CH, CH))]
        res //= 2
    out_dim = out_dim or (cmap or 1)
    v += [("4x4/Conv/weight", r(3, 3, CH + 1, CH)), ("4x4/Conv/bias", r(CH)),
          ("4x4/Dense0/weight", r(CH * 16, CH)), ("4x4/Dense0/bias", r(CH)),
          ("Output/weight", r(CH, out_dim)), ("Output/bias", r(out_dim))]
    if c_dim and embed:
        v += [("LabelEmbed/weight", r(c_dim, cmap)), ("LabelEmbed/bias", r(cmap))]
        v += [item for i in range(n_map) for item in
              ((f"Mapping{i}/weight", r(cmap, cmap)), (f"Mapping{i}/bias", r(cmap)))]
    return v


def _tf_pickle(c_dim, **d_kw):
    """(G, D, Gs) in the TF-era wire format, and the generator's variables."""
    rng = np.random.RandomState(11 + c_dim)
    top, mapping, syn = _tf_generator_vars(rng, c_dim)
    g_kw = dict(latent_size=W_DIM, dlatent_size=W_DIM, resolution=RES, num_channels=2,
                label_size=c_dim, fmap_base=CH * RES // 2, fmap_max=CH, mapping_layers=2,
                conv_clamp=256)
    d_kw_static = dict(resolution=RES, num_channels=2, label_size=c_dim, fmap_base=CH * RES // 2,
                       fmap_max=CH, mbstd_group_size=4, mbstd_num_features=1)
    with _fake_dnnlib() as Network:
        def net(variables, components=None, **kw):
            return Network(version=4, name="net", static_kwargs=kw, variables=variables,
                           components=components or {})

        gs = net(top, {"mapping": net(mapping), "synthesis": net(syn)}, **g_kw)
        d = net(_tf_discriminator_vars(rng, c_dim, **d_kw), **d_kw_static)
        return pickle.dumps((gs, d, gs), protocol=4)


@pytest.fixture(scope="module", params=[0, C_DIM], ids=["unconditional", "conditional"])
def tf_pickle(request):
    return request.param, _tf_pickle(request.param)


def test_tf_pickle_converts_to_the_jax_trees(tf_pickle):
    c_dim, data = tf_pickle
    nets_j = legacy_j.load_network_pkl(io.BytesIO(data))
    nets_t = legacy_t.load_network_pkl(io.BytesIO(data))
    for key in ("G_ema", "D"):
        _assert_same_tree(nets_t[key][0], nets_j[key][0])
        _assert_same_cfg(nets_t[key][1], nets_j[key][1])
    # The policy's loader dispatches the same bytes to the TF path.
    gt, gct, dt, dct = ckpt_t.load_stylegan(io.BytesIO(data))
    _assert_same_tree(gt, nets_j["G_ema"][0])
    _assert_same_tree(dt, nets_j["D"][0])
    assert gct.c_dim == dct.c_dim == c_dim and gct.conv_clamp == 256


def test_tf_networks_run_like_the_jax_ones(tf_pickle):
    c_dim, data = tf_pickle
    g_params, g_cfg, d_params, d_cfg = ckpt_t.load_stylegan(io.BytesIO(data))
    G, D = _port_modules(g_params, g_cfg, d_params, d_cfg)
    rng = np.random.RandomState(2)
    z = rng.randn(4, W_DIM).astype(np.float32)
    c = np.eye(C_DIM, dtype=np.float32)[[0, 2, 1, 0]] if c_dim else None
    tc = None if c is None else torch.from_numpy(c)
    with torch.no_grad():
        img_t = G(torch.from_numpy(z), tc).numpy()
        logits_t = D(torch.from_numpy(img_t), tc).numpy()
    img_j = np.asarray(_g_apply_j(g_params, g_cfg, z, c))
    logits_j = np.asarray(_d_apply_j(d_params, d_cfg, img_t, c))
    scale = np.abs(img_j).max()
    assert np.isfinite(img_t).all() and scale > 0
    np.testing.assert_allclose(img_t, img_j, rtol=RTOL, atol=1e-5 * scale)
    np.testing.assert_allclose(logits_t, logits_j, rtol=RTOL,
                               atol=1e-5 * np.abs(logits_j).max())


@pytest.mark.parametrize("layout,match", [
    ("g_without_embed", "LabelEmbed"), ("d_without_embed", "LabelEmbed"),
    ("d_output_not_cmap", "Output width"), ("d_embed_not_cmap", "LabelEmbed width")])
def test_malformed_conditional_tf_layouts_raise_in_both(layout, match):
    data = _tf_pickle(C_DIM, **{"d_without_embed": dict(embed=False),
                                "d_output_not_cmap": dict(out_dim=CH + 1),
                                "d_embed_not_cmap": dict(n_map=0)}.get(layout, {}))
    stubs_t = legacy_t._LegacyUnpickler(io.BytesIO(data)).load()
    stubs_j = legacy_j._LegacyUnpickler(io.BytesIO(data)).load()
    if layout == "g_without_embed":
        for stubs in (stubs_t, stubs_j):
            comp = stubs[2]["components"]["mapping"]
            comp["variables"] = [(n, v) for n, v in comp["variables"] if "LabelEmbed" not in n]
        pairs = ((legacy_t.convert_tf_generator, stubs_t[2]),
                 (legacy_j.convert_tf_generator, stubs_j[2]))
    else:
        if layout == "d_embed_not_cmap":  # LabelEmbed wider than the projection head
            for stubs in (stubs_t, stubs_j):
                stubs[1]["variables"] = [
                    (n, np.zeros((C_DIM, CH + 1), np.float32) if n == "LabelEmbed/weight" else v)
                    for n, v in stubs[1]["variables"]]
        pairs = ((legacy_t.convert_tf_discriminator, stubs_t[1]),
                 (legacy_j.convert_tf_discriminator, stubs_j[1]))
    for convert, stub in pairs:
        with pytest.raises(ValueError, match=match):
            convert(stub)


# ----------------------------------------------------------------------------
# Alias-free (StyleGAN3) payloads

SG3 = dict(img_resolution=64, img_channels=2, num_layers=6, channel_base=2048, channel_max=64,
           z_dim=64, w_dim=64, num_fp16_res=0)


@pytest.mark.parametrize("filters", ["stored", "designed"])
def test_sg3_payload_dispatches_on_class_name(tmp_path, filters):
    cfg = net3_t.generator_config(**SG3)
    G = net3_t.Generator(cfg, seed=4)
    with torch.no_grad():  # live input transform and magnitudes
        G.synthesis.input.transform.copy_(torch.tensor([[0.8, -0.6, 0.3], [0.6, 0.8, -0.2],
                                                        [0.0, 0.0, 1.0]]))
        for layer in cfg.layers:
            getattr(G.synthesis, layer.name).magnitude_ema.fill_(1.7)
    state = {k: v.numpy() for k, v in G.state_dict().items()}
    state["synthesis.input.transform"] = state["synthesis.input.transform"].reshape(9)
    if filters == "designed":
        state = {k: v for k, v in state.items() if not k.endswith(("up_filter", "down_filter"))}
    payload = {"class_name": "training.networks_stylegan3.Generator",
               "init_kwargs": {"z_dim": 64, "c_dim": 0, "w_dim": 64, "img_resolution": 64,
                               "img_channels": 2, "channel_base": 2048, "channel_max": 64,
                               "num_layers": 6, "mapping_kwargs": {"num_layers": 2},
                               "magnitude_ema_beta": 0.999},
               "state": state}
    path = str(tmp_path / "sg3.pkl")
    with open(path, "wb") as f:
        pickle.dump({"G_ema": payload}, f)
    gt, gct, dt, dct = ckpt_t.load_stylegan(path)
    gj, gcj, _, _ = convert_j.load_stylegan(path)
    assert gct.arch == "stylegan3" and dt is None and dct is None
    _assert_same_tree(gt, gj)
    _assert_same_cfg(gct, gcj)
    G2, _ = _port_modules(gt, gct, None, None)
    z = torch.randn([2, 64], generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert torch.equal(G2(z), G(z))  # the native generator's image, bit for bit


# ----------------------------------------------------------------------------
# TorchScript VGG16

@pytest.fixture(scope="module")
def ts_vgg(tmp_path_factory):
    from test_converters_realistic import _TSVGG16

    torch.manual_seed(0)
    mod = _TSVGG16().eval()
    path = str(tmp_path_factory.mktemp("ts") / "vgg16.pt")
    torch.jit.script(mod).save(path)
    return mod, path


def _script_taps(mod, x):
    plan = [it[0] for it in vgg_t.VGG16_PLAN if it != "M"]
    out, i = {}, 0
    with torch.no_grad():
        h = torch.from_numpy(x)
        for layer in mod.layers:
            h = layer(h)
            if isinstance(layer, torch.nn.ReLU):
                if plan[i] in vgg_t.LPIPS_TAPS:
                    out[plan[i]] = h.clone()
                i += 1
    return out


def test_convert_torchscript_matches_jax_and_the_script_module(ts_vgg, tmp_path):
    mod, path = ts_vgg
    out = str(tmp_path / "vgg16_lpips.pkl")
    params = vgg_t.convert_torchscript(path, out)
    _assert_same_tree(params, vgg_j.convert_torchscript(path))
    assert vgg_t.load_params(out, require=("conv1_1", "conv5_3"))["lin"].keys() == \
        set(vgg_t.LPIPS_TAPS)
    rs = np.random.RandomState(1)
    x, y = rs.randn(2, 3, 32, 32).astype(np.float32), rs.randn(2, 3, 32, 32).astype(np.float32)
    p = vgg_t.params_from_numpy(params)
    acts = vgg_t.vgg_features(p, torch.from_numpy(x), taps=vgg_t.LPIPS_TAPS, input_range="unit")
    tx, ty = _script_taps(mod, x), _script_taps(mod, y)
    for tap in vgg_t.LPIPS_TAPS:
        torch.testing.assert_close(acts[tap], tx[tap], rtol=RTOL, atol=1e-5)
    # LPIPS through the embedding against richzhang's formula on the
    # script module's activations.
    want = torch.zeros(2)
    for tap in vgg_t.LPIPS_TAPS:
        na = tx[tap] / (tx[tap].square().sum(1, keepdim=True) + 1e-10).sqrt()
        nb = ty[tap] / (ty[tap].square().sum(1, keepdim=True) + 1e-10).sqrt()
        lin = torch.from_numpy(params["lin"][tap]).reshape(1, -1, 1, 1)
        want += (lin * (na - nb).square()).sum(1).mean(dim=(1, 2))
    got = vgg_t.lpips_distance(p, torch.from_numpy(x), torch.from_numpy(y), input_range="unit")
    torch.testing.assert_close(got, want, rtol=RTOL, atol=1e-6)


# ----------------------------------------------------------------------------
# Tampered pickles

class _EvilEval:
    def __reduce__(self):
        return (eval, ("__import__('os').getcwd()",))


class _EvilSystem:
    def __reduce__(self):
        return (os.system, ("true",))


@pytest.mark.parametrize("evil", [_EvilEval, _EvilSystem])
@pytest.mark.parametrize("loader", [
    "jax_convert", "port_convert", "port_checkpoint", "jax_legacy", "port_legacy"])
def test_unpicklers_refuse_code(loader, evil):
    data = pickle.dumps({"G_ema": evil(), "G": {"params": {}}}, protocol=4)
    load = {"jax_convert": convert_j.load_network_pickle,
            "port_convert": convert_t.load_network_pickle,
            "port_checkpoint": ckpt_t.load_stylegan,
            "jax_legacy": legacy_j.load_network_pkl,
            "port_legacy": legacy_t.load_network_pkl}[loader]
    with pytest.raises(pickle.UnpicklingError, match="(?i)blocked unpickle"):
        load(io.BytesIO(data))


@pytest.mark.parametrize("unpickler", [convert_j._RestrictedUnpickler,
                                       convert_t._RestrictedUnpickler,
                                       legacy_t._LegacyUnpickler],
                         ids=["jax", "port", "port_legacy"])
def test_find_class_refuses_builtins_and_wildcard_torch(unpickler):
    u = unpickler(io.BytesIO(b""))
    for mod, name in [("builtins", "eval"), ("builtins", "exec"), ("builtins", "getattr"),
                      ("os", "system"), ("torch.serialization", "load"),
                      ("torch.hub", "load_state_dict_from_url"), ("numpy", "load"),
                      ("subprocess", "Popen")]:
        with pytest.raises(pickle.UnpicklingError):
            u.find_class(mod, name)
    import collections

    assert u.find_class("collections", "OrderedDict") is collections.OrderedDict
    assert u.find_class("torch._utils", "_rebuild_tensor_v2") is torch._utils._rebuild_tensor_v2
    for mod in ("numpy.core.multiarray", "numpy._core.multiarray"):
        assert callable(u.find_class(mod, "_reconstruct"))
    # The numpy-only loader of native files stays numpy-only.
    with pytest.raises(pickle.UnpicklingError):
        ckpt_t._NumpyUnpickler(io.BytesIO(b"")).find_class("torch._utils", "_rebuild_tensor_v2")


def test_torch_tensors_survive_the_allow_list():
    t = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
         "p": torch.nn.Parameter(torch.ones(3))}
    out = convert_t.load_network_pickle(io.BytesIO(pickle.dumps(t, protocol=2)))
    np.testing.assert_array_equal(out["w"].numpy(), np.arange(6, dtype=np.float32).reshape(2, 3))
    np.testing.assert_array_equal(out["p"].detach().numpy(), 1.0)
    with pytest.raises(ValueError, match="neither a native checkpoint"):
        ckpt_t.load_stylegan(io.BytesIO(pickle.dumps({"G_ema": None, "D": None})))


# ----------------------------------------------------------------------------
# The command lines

def test_convert_checkpoint_cli(tmp_path, ts_vgg, tf_pickle):
    from scripts import torch_convert_checkpoint as cli

    g, d = _oracle_pair()
    src = tmp_path / "network-snapshot.pkl"
    src.write_bytes(oracle.persistence_pickle_bytes({"G_ema": g, "D": d}))
    for source, name in ((src, "nvidia"), (None, "tf")):
        if source is None:
            source = tmp_path / "tf.pkl"
            source.write_bytes(tf_pickle[1])
        dest = str(tmp_path / f"{name}_native.pkl")
        assert cli.main(["stylegan", "--source", str(source), "--dest", dest]) == 0
        want = ckpt_t.load_stylegan(str(source))
        got = ckpt_t.load_pickle(dest)  # native: the numpy-only loader reads it
        assert ckpt_t.is_native(got)
        _assert_same_tree(got["G"]["params"], want[0])
        _assert_same_tree(got["D"]["params"], want[2])
    dest = str(tmp_path / "vgg.pkl")
    assert cli.main(["vgg16", "--source", ts_vgg[1], "--dest", dest]) == 0
    _assert_same_tree(ckpt_t.load_pickle(dest), vgg_t.convert_torchscript(ts_vgg[1]))

    from latentaugment_tpu_torch.models import inception

    ref = inception.init_inception(seed=1)
    state = {".".join(path): torch.full(v.shape, float(i))
             for i, (path, v) in enumerate(_leaves(ref))}
    state["fc.weight"] = torch.zeros(1000, 2048)
    torch.save(state, str(tmp_path / "inception_v3.pth"))
    dest = str(tmp_path / "inception.pkl")
    assert cli.main(["inception", "--source", str(tmp_path / "inception_v3.pth"),
                     "--dest", dest]) == 0
    got = inception.get_inception(dest)
    for i, (path, _) in enumerate(_leaves(ref)):
        node = got
        for k in path:
            node = node[k]
        assert torch.all(node == float(i)), path


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_verify_real_weights_cli_on_the_cpu(tmp_path, ts_vgg, capsys):
    from scripts import torch_verify_real_weights as cli

    g, d = _oracle_pair(c_dim=C_DIM)
    pkl = tmp_path / "network-snapshot.pkl"
    pkl.write_bytes(oracle.persistence_pickle_bytes({"G_ema": g, "D": d}))
    outdir = str(tmp_path / "converted")
    rc = cli.main(["--vgg16", ts_vgg[1], "--network_pkl", str(pkl), "--outdir", outdir,
                   "--device", "cpu"])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    checks = {(r["artifact"], r["check"]): r for r in rows if "artifact" in r}
    verdict = rows[-1]
    assert rc == 0 and verdict["verdict"] == "pass" and verdict["failed"] == 0, rows
    assert checks[("vgg16", "forward_parity")]["max_rel_err"] < 1e-4
    assert checks[("vgg16", "lpips_distance_parity")]["status"] == "pass"
    ing = checks[("network_pkl", "ingest_and_synthesize")]
    assert ing["status"] == "pass" and ing["has_discriminator"] and ing["arch"] == "stylegan2"
    assert checks[("network_pkl", "discriminator_forward")]["status"] == "pass"
    # Executing the pickle's embedded code is opt-in: skipped by default.
    assert checks[("network_pkl", "torch_golden")]["status"] == "skipped"
    assert checks[("inception", "all")]["status"] == "skipped"
    assert os.path.isfile(os.path.join(outdir, "vgg16_lpips.pkl"))
    assert cli.main(["--outdir", outdir, "--device", "cpu"]) == 1  # nothing given
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["verdict"] == "fail"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["--vgg16", ts_vgg[1], "--outdir", outdir])


def test_projector_cli_takes_an_nvidia_pickle(tmp_path):
    from synthetic import MODALITIES, make_image_zip

    from scripts.torch_project_dataset import main as project_main

    g, d = _oracle_pair()
    pkl = tmp_path / "network-snapshot.pkl"
    pkl.write_bytes(oracle.persistence_pickle_bytes({"G_ema": g, "D": d}))
    img_zip = str(tmp_path / "imgs.zip")
    make_image_zip(img_zip, n_patients=1, slices_per_patient=2)
    records = project_main([
        "--checkpoint", str(pkl), "--data_zip", img_zip, "--modalities", ",".join(MODALITIES),
        "--resolution", str(RES), "--num_steps", "2", "--batch_size", "2", "--w_avg_samples", "16",
        "--outdir", str(tmp_path / "tp"), "--device", "cpu"])
    assert [r["n"] for r in records] == [2] and np.isfinite(records[0]["dists"]).all()
    assert len(os.listdir(tmp_path / "tp")) == 1  # one patient directory of inverted codes
