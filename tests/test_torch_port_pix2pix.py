"""The port's pix2pix consumer (models/pix2pix.py, utils/util_pix2pix.py,
examples/torch_train_pix2pix.py) against the JAX package's.

Same numpy parameters (the JAX init carried over with
`params_from_jax`) and inputs, 32x32, depth 3: G and D forward at rtol
1e-5; one train step's losses and both gradients at rtol 1e-4; the
parameters after one step as stated in `test_one_step_updates_like_jax`;
the image helpers exactly. The worked example runs two steps on the
port's synthetic workspace.
"""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentaugment_tpu.models import pix2pix as p2p_j
from latentaugment_tpu.utils import util_pix2pix as util_j
from latentaugment_tpu_torch.models import pix2pix as p2p_t
from latentaugment_tpu_torch.utils import util_pix2pix as util_t
from test_torch_port_common import _one_torch_thread  # noqa: F401 (autouse fixture)

CFG = dict(base_channels=8, depth=3, d_layers=3)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def setup():
    cfg_j = p2p_j.pix2pix_config(**CFG)
    cfg_t = p2p_t.pix2pix_config(**CFG)
    params = _np_tree(p2p_j.init_all(jax.random.PRNGKey(0), cfg_j))
    # Nonzero biases, so that the bias path is compared too.
    rng = np.random.RandomState(3)
    for net in params.values():
        for leaf in jax.tree_util.tree_leaves(net, is_leaf=lambda x: isinstance(x, dict)
                                              and "b" in x):
            leaf["b"] = rng.randn(*leaf["b"].shape).astype(np.float32) * 0.05
    a = rng.rand(2, 1, 32, 32).astype(np.float32) * 2 - 1
    b = rng.rand(2, 1, 32, 32).astype(np.float32) * 2 - 1
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, params=params, a=a, b=b)


def _nets(setup):
    return p2p_t.params_from_jax(setup["params"], setup["cfg_t"])


def test_params_from_jax_takes_every_parameter(setup):
    nets = _nets(setup)
    assert p2p_t.count_params(nets) == p2p_j.count_params(setup["params"])
    flat = p2p_t._jax_state_dict(setup["params"])
    assert set(flat) == set(nets.state_dict())
    for k, v in nets.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), flat[k].numpy())


def test_generator_and_discriminator_match_jax(setup):
    nets, params, cfg = _nets(setup), setup["params"], setup["cfg_j"]
    a, b = setup["a"], setup["b"]
    with torch.no_grad():
        y_t = nets["G"](torch.from_numpy(a)).numpy()
        d_t = nets["D"](torch.from_numpy(a), torch.from_numpy(b)).numpy()
    y_j = np.asarray(p2p_j.generator_apply(params["G"], cfg, jnp.asarray(a)))
    d_j = np.asarray(p2p_j.discriminator_apply(params["D"], cfg, jnp.asarray(a), jnp.asarray(b)))
    assert y_t.shape == (2, 1, 32, 32) and d_t.shape == d_j.shape == (2, 1, 3, 3)
    np.testing.assert_allclose(y_t, y_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5, atol=1e-6)


def _jax_losses_and_grads(setup):
    """The JAX step's two value_and_grads (pix2pix.py:165-182)."""
    params, cfg = setup["params"], setup["cfg_j"]
    a, b = jnp.asarray(setup["a"]), jnp.asarray(setup["b"])

    def d_loss_fn(d_params):
        fake = p2p_j.generator_apply(params["G"], cfg, a)
        real_logits = p2p_j.discriminator_apply(d_params, cfg, a, b)
        fake_logits = p2p_j.discriminator_apply(d_params, cfg, a, jax.lax.stop_gradient(fake))
        return 0.5 * (p2p_j._mse(real_logits, 1.0) + p2p_j._mse(fake_logits, 0.0))

    def g_loss_fn(g_params):
        fake = p2p_j.generator_apply(g_params, cfg, a)
        fake_logits = p2p_j.discriminator_apply(params["D"], cfg, a, fake)
        l1 = jnp.mean(jnp.abs(fake - b))
        return p2p_j._mse(fake_logits, 1.0) + cfg.lambda_l1 * l1, l1

    d_loss, d_grads = jax.value_and_grad(d_loss_fn)(params["D"])
    (g_loss, l1), g_grads = jax.value_and_grad(g_loss_fn, has_aux=True)(params["G"])
    return ({"loss_G": float(g_loss), "loss_D": float(d_loss), "loss_L1": float(l1)},
            p2p_t._jax_state_dict(_np_tree(g_grads)), p2p_t._jax_state_dict(_np_tree(d_grads)))


def test_losses_and_gradients_match_jax(setup):
    nets = _nets(setup)
    metrics, g_grads, d_grads = p2p_t.losses_and_grads(
        setup["cfg_t"], nets, torch.from_numpy(setup["a"]), torch.from_numpy(setup["b"]))
    want, g_want, d_want = _jax_losses_and_grads(setup)
    for k, v in want.items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=1e-4)
    for name, grads, want_grads in (("G", g_grads, g_want), ("D", d_grads, d_want)):
        names = [n for n, _ in nets[name].named_parameters()]
        assert len(names) == len(grads) == len(want_grads)
        for n, g in zip(names, grads):
            w = want_grads[n].numpy()
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max())


def test_one_step_updates_like_jax(setup):
    """Both packages' full step from the same parameters. Adam's first
    step is lr * m / (sqrt(v) + eps) = lr * g / (|g| + eps / sqrt(1 -
    beta2)), lr * sign(g) wherever |g| is well above 3.2e-7: a gradient
    within rounding of 0 may step a coordinate by lr either way (ROADMAP
    §3). So the parameters after the step agree to 1e-6 wherever the JAX
    gradient's magnitude is above 1e-5 of its tensor's largest, and
    within 2 lr everywhere; the metrics are the pre-update losses."""
    cfg_j, cfg_t = setup["cfg_j"], setup["cfg_t"]
    nets = _nets(setup)
    opt_state = p2p_t.opt_init(nets)
    metrics = p2p_t.make_train_step(cfg_t)(nets, opt_state, torch.from_numpy(setup["a"]),
                                           torch.from_numpy(setup["b"]))
    params_j = jax.tree_util.tree_map(jnp.asarray, setup["params"])
    new_j, state_j, metrics_j = p2p_j.make_train_step(cfg_j)(
        params_j, p2p_j.opt_init(params_j), jnp.asarray(setup["a"]), jnp.asarray(setup["b"]))
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(metrics_j[k]), rtol=1e-4)
    assert opt_state["G"]["t"] == opt_state["D"]["t"] == int(state_j["G"]["t"]) == 1
    _, g_want, d_want = _jax_losses_and_grads(setup)
    grads = {**{f"G.{k}": v for k, v in g_want.items()}, **{f"D.{k}": v for k, v in d_want.items()}}
    new_j = p2p_t._jax_state_dict(_np_tree(new_j))
    lr = cfg_t.lr
    for k, v in nets.state_dict().items():
        got, want, g = v.numpy(), new_j[k].numpy(), np.abs(grads[k].numpy())
        assert np.abs(got - want).max() <= 2 * lr + 1e-6, k
        live = g > 1e-5 * g.max()
        np.testing.assert_allclose(got[live], want[live], rtol=0, atol=1e-6, err_msg=k)
    # Every tensor moved by about lr: the step happened.
    moved = [k for k, v in nets.state_dict().items()
             if np.abs(v.numpy() - p2p_t._jax_state_dict(setup["params"])[k].numpy()).max()
             > 0.5 * lr]
    assert len(moved) == len(nets.state_dict())


def test_util_pix2pix_matches_jax(setup, tmp_path):
    rng = np.random.RandomState(5)
    for shape in [(2, 1, 16, 16), (3, 16, 16), (1, 3, 8, 12), (16, 16)]:
        x = rng.rand(*shape).astype(np.float32) * 2.4 - 1.2
        want = util_j.tensor2im(x)
        np.testing.assert_array_equal(util_t.tensor2im(x), want)
        np.testing.assert_array_equal(util_t.tensor2im(torch.from_numpy(x)), want)
    img = util_t.tensor2im(rng.rand(1, 1, 16, 24).astype(np.float32))
    for ratio in (1.0, 1.5, 0.5):
        util_j.save_image(img, str(tmp_path / f"j{ratio}.png"), aspect_ratio=ratio)
        util_t.save_image(img, str(tmp_path / f"t{ratio}.png"), aspect_ratio=ratio)
        assert (tmp_path / f"j{ratio}.png").read_bytes() == (tmp_path / f"t{ratio}.png").read_bytes()
    nets = _nets(setup)
    flat = {k: v.numpy() for k, v in nets.state_dict().items()}
    outs = []
    for fn, arg in ((util_j.diagnose_network, flat), (util_t.diagnose_network, flat),
                    (util_t.diagnose_network, nets), (util_t.diagnose_network, nets.state_dict()),
                    (util_j.print_numpy, flat["G.out.weight"]),
                    (util_t.print_numpy, torch.from_numpy(flat["G.out.weight"]))):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ret = fn(arg) if fn not in (util_j.print_numpy, util_t.print_numpy) \
                else fn(arg, shp=True)
        outs.append((ret, buf.getvalue().replace("G+D", "")))
    assert outs[0] == outs[1] == outs[2] == outs[3] and outs[0][0] > 0
    assert outs[4] == outs[5] and "shape," in outs[4][1]
    dirs = [str(tmp_path / "a" / "b"), str(tmp_path / "c")]
    util_t.mkdirs(dirs)
    util_t.mkdirs(str(tmp_path / "d"))
    util_t.mkdir(dirs[1])
    assert all(os.path.isdir(d) for d in dirs + [str(tmp_path / "d")])


def test_example_trains_on_augmented_batches(tmp_path, monkeypatch):
    """examples/torch_train_pix2pix.py --synthetic --device cpu
    --pix2pix_steps 2: two policy walks at 32x32, two pix2pix steps,
    finite losses and parameters."""
    import tempfile

    import examples.torch_train_pix2pix as ex

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    nets, history = ex.main(["--synthetic", "--device", "cpu", "--pix2pix_steps", "2"])
    assert len(history) == 2
    for h in history:
        assert all(np.isfinite(h[k]) for k in ("loss_G", "loss_D", "loss_L1"))
        assert h["walk_s"] > 0 and h["step_s"] > 0
    assert all(torch.isfinite(p).all() for p in nets.parameters())
    assert nets["G"].out.weight.device.type == "cpu"


def test_example_on_cuda_without_cuda_raises(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: --device cuda is valid here")
    import tempfile

    import examples.torch_train_pix2pix as ex

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ex.main(["--synthetic", "--pix2pix_steps", "1"])
