"""Second derivatives and filter gradients of the port's three kernel ops
against the JAX package, on the CPU (where each wrapper runs its plain
version; the kernels' own autograd wiring is held in
test_torch_port_emulation.py, the kernels on the card in the `gpu`-marked
tests and chip_smoke.py phase 1c).

  * bias_act (K1): each smooth activation, with bias, with and without
    the clamp: the second derivative (w.r.t. x, b and the first
    cotangent) against `jax.vjp` of `jax.vjp` of the JAX `bias_act`.
  * upfirdn2d (K2): dx and the filter cotangent against the JAX Pallas
    op's custom VJP (`impl='pallas'`, interpret mode), which computes df
    from the XLA path.
  * filtered_lrelu (K3): the second derivative (w.r.t. the first
    cotangent and both filters) and dfu / dfd against the JAX fused op
    (`impl='pallas_fused'`, interpret mode, as test_torch_port_sg3.py
    runs it), whose VJP is the decomposed form's.
  * a tiny alias-free (SG3-T) synthesis network: the path-length
    penalty's gradient w.r.t. every weight, the pattern of `loss_g_pl`
    (models/stylegan2/train.py), against JAX's grad of grad.

Inputs come from numpy seeds. Tolerances: ops 1e-5 (of the largest
magnitude), the network 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentaugment_tpu.models.stylegan3 import networks as net3_j
from latentaugment_tpu.ops.bias_act import bias_act as bias_act_j
from latentaugment_tpu.ops.upfirdn2d import upfirdn2d as upfirdn2d_j
from latentaugment_tpu.ops.filtered_lrelu import filtered_lrelu as flrelu_j
from latentaugment_tpu_torch.models.stylegan2 import checkpoint as ckpt_t
from latentaugment_tpu_torch.models.stylegan3 import networks as net3_t
from latentaugment_tpu_torch.ops import bias_act as ba_t
from latentaugment_tpu_torch.ops import filtered_lrelu as fl_t
from latentaugment_tpu_torch.ops import upfirdn2d as up_t
from test_torch_port_common import _one_torch_thread  # noqa: F401 (autouse fixture)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want, rtol):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(float(np.abs(want).max()), 1e-30))


# ----------------------------------------------------------------------------
# K1: the smooth activations

@pytest.mark.parametrize("clamp", [None, 0.5], ids=["noclamp", "clamp"])
@pytest.mark.parametrize("act", ["tanh", "sigmoid", "elu", "selu", "softplus", "swish"])
def test_bias_act_second_derivative_matches_jax(act, clamp):
    rs = np.random.RandomState(len(act) + 2 * (clamp is not None))
    x, dy1, dy2 = (rs.randn(3, 5, 4, 6).astype(np.float32) for _ in range(3))
    b, db2 = rs.randn(5).astype(np.float32), rs.randn(5).astype(np.float32)

    def first_j(x, b, dy1):
        _, vjp = jax.vjp(lambda x, b: bias_act_j(x, b, act=act, clamp=clamp), x, b)
        return vjp(dy1)

    (gx_j, gb_j), vjp2 = jax.vjp(first_j, *map(jnp.asarray, (x, b, dy1)))
    want = (gx_j, gb_j) + vjp2((jnp.asarray(dy2), jnp.asarray(db2)))

    xt, bt, d1 = (_t(a).requires_grad_(True) for a in (x, b, dy1))
    y = ba_t.bias_act(xt, bt, act=act, clamp=clamp)
    gx, gb = torch.autograd.grad(y, (xt, bt), d1, create_graph=True)
    got = (gx, gb) + torch.autograd.grad((gx * _t(dy2)).sum() + (gb * _t(db2)).sum(),
                                         (xt, bt, d1))
    if clamp is not None:  # the clamp engages
        assert float((y.detach().abs() >= clamp).float().mean()) > 0.02
    for k, r in zip(got, want):
        _close(k, r, 1e-5)


# ----------------------------------------------------------------------------
# K2: the filter cotangent

UPFIRDN_CASES = {
    "blur 4 taps, pad 1, gain 4": ([2, 3, 11, 10], 4, dict(padding=1, gain=4)),
    "down 2, 4 taps, corr": ([2, 2, 12, 13], 4, dict(down=2, padding=(1, 2, 0, 1),
                                                    flip_filter=True)),
    "up 2, 12 taps, crop": ([1, 2, 9, 8], 12, dict(up=2, padding=(4, 5, -1, 3), gain=4)),
}


@pytest.mark.parametrize("name", list(UPFIRDN_CASES))
def test_upfirdn2d_filter_gradient_matches_jax_pallas(name):
    shape, taps, kw = UPFIRDN_CASES[name]
    rs = np.random.RandomState(len(name))
    x = rs.randn(*shape).astype(np.float32)
    f = rs.randn(taps).astype(np.float32) / taps  # asymmetric: a flip would show
    y_j, vjp = jax.vjp(lambda x, f: upfirdn2d_j(x, f, impl="pallas", **kw),
                       jnp.asarray(x), jnp.asarray(f))
    dy = rs.randn(*y_j.shape).astype(np.float32)
    gx_j, gf_j = vjp(jnp.asarray(dy))
    xt, ft = _t(x).requires_grad_(True), _t(f).requires_grad_(True)
    y_t = up_t.upfirdn2d(xt, ft, **kw)
    gx_t, gf_t = torch.autograd.grad(y_t, (xt, ft), _t(dy))
    _close(y_t, y_j, 1e-5)
    _close(gx_t, gx_j, 1e-5)
    _close(gf_t, gf_j, 1e-5)


# ----------------------------------------------------------------------------
# K3: second order and the filter cotangents

# (input HxW, up taps, down taps, up, down, padding, gain, slope, clamp)
FLRELU_CASES = {
    "L0 up2 pad(9,8), clamp": ((12, 11), 12, 12, 2, 2, (9, 8, 9, 8), None, 0.2, 0.7),
    "L3 up4 crop(-6,-9)": ((16, 15), 24, 12, 4, 2, (-6, -9, -6, -9), None, 0.2, None),
}


@pytest.mark.parametrize("name", list(FLRELU_CASES))
def test_filtered_lrelu_second_order_and_filter_grads_match_jax(name):
    """First order: dx, db, dfu, dfd. Second order, the derivative of
    <dx, dy2> + <db, db2> w.r.t. the first cotangent dy1 (the linearised
    forward), fu and fd. JAX differentiates its fused op's VJP (the
    decomposed form's, traced) again."""
    (h, w), tu, td, up, down, padding, gain, slope, clamp = FLRELU_CASES[name]
    # The default gain given as a number: the JAX op computes it with jnp,
    # which a jit cannot read.
    kw = dict(up=up, down=down, padding=padding, gain=np.sqrt(2.0) if gain is None else gain,
              slope=slope, clamp=clamp)
    rs = np.random.RandomState(len(name))
    x = rs.randn(2, 3, h, w).astype(np.float32)
    fu = rs.randn(tu).astype(np.float32) / np.sqrt(tu / up)
    fd = rs.randn(td).astype(np.float32) / np.sqrt(td)
    b = rs.randn(3).astype(np.float32) * 0.3

    def first_j(x, fu, fd, b, dy1):
        _, vjp = jax.vjp(lambda *a: flrelu_j(*a, impl="pallas_fused", **kw), x, fu, fd, b)
        return vjp(dy1)

    @jax.jit
    def both_j(x, fu, fd, b, dy1, dy2, db2):
        first, vjp2 = jax.vjp(first_j, x, fu, fd, b, dy1)
        return first, vjp2((dy2, jnp.zeros_like(fu), jnp.zeros_like(fd), db2))

    y_shape = fl_t.filtered_lrelu(_t(x), _t(fu), _t(fd), _t(b), **kw).shape
    dy1 = rs.randn(*y_shape).astype(np.float32)
    dy2 = rs.randn(*x.shape).astype(np.float32)
    db2 = rs.randn(3).astype(np.float32)
    first, second = both_j(*map(jnp.asarray, (x, fu, fd, b, dy1, dy2, db2)))

    xt, fut, fdt, bt, d1 = (_t(a).requires_grad_(True) for a in (x, fu, fd, b, dy1))
    y_t = fl_t.filtered_lrelu(xt, fut, fdt, bt, **kw)
    if clamp is not None:  # the clamp engages
        assert float(y_t.detach().abs().max()) > 0.9 * clamp
    got1 = torch.autograd.grad(y_t, (xt, fut, fdt, bt), d1, create_graph=True)
    got2 = torch.autograd.grad((got1[0] * _t(dy2)).sum() + (got1[3] * _t(db2)).sum(),
                               (fut, fdt, d1))
    for k, r in zip(got1, first):
        _close(k, r, 1e-5)
    for k, r in zip(got2, (second[1], second[2], second[4])):
        _close(k, r, 1e-5)
    # d/dx and d/db of the first-order gradient are zero almost everywhere.
    assert not np.asarray(second[0]).any() and not np.asarray(second[3]).any()


# ----------------------------------------------------------------------------
# A tiny SG3-T synthesis network differentiated twice

TINY = dict(img_resolution=16, img_channels=2, num_layers=4, channel_base=512, channel_max=16,
            num_fp16_res=0, z_dim=16, w_dim=16)


def test_sg3t_path_length_gradient_matches_jax():
    """`loss_g_pl`'s pattern on the synthesis network: pl_grads = d
    sum(img * noise) / d ws with its graph, the penalty
    mean((|pl_grads| - pl_mean)^2), and its gradient w.r.t. every weight
    of the network; float32, rtol 1e-4 (of each weight's largest)."""
    cfg_j = net3_j.generator_config(**TINY)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                    net3_j.generator_init(jax.random.PRNGKey(1), cfg_j))
    rng = np.random.RandomState(3)
    for layer in cfg_j.layers:  # live biases, so that K3's bias slot matters
        lp = params["synthesis"][layer.name]
        lp["bias"] = rng.randn(*lp["bias"].shape).astype(np.float32) * 0.2
    ws = rng.randn(2, cfg_j.num_ws, TINY["w_dim"]).astype(np.float32)
    noise = (rng.randn(2, 2, 16, 16) / 16).astype(np.float32)
    pl_mean = 0.3

    def penalty_j(p):
        pl_grads = jax.grad(lambda ws: jnp.sum(net3_j.synthesis_apply(p, cfg_j, ws) * noise))(
            jnp.asarray(ws))
        lengths = jnp.sqrt(jnp.mean(jnp.sum(jnp.square(pl_grads), axis=2), axis=1))
        return jnp.mean(jnp.square(lengths - pl_mean))

    pen_j, grads_j = jax.jit(jax.value_and_grad(penalty_j))(jax.tree_util.tree_map(
        jnp.asarray, params["synthesis"]))

    G = net3_t.Generator(net3_t.generator_config(**TINY))
    G.load_state_dict(ckpt_t.params_to_state_dict(params))
    ws_t = _t(ws).requires_grad_(True)
    img = G.synthesis(ws_t)
    pl_grads, = torch.autograd.grad((img * _t(noise)).sum(), ws_t, create_graph=True)
    lengths = pl_grads.square().sum(dim=2).mean(dim=1).sqrt()
    pen_t = (lengths - pl_mean).square().mean()
    names = [n for n, p in G.synthesis.named_parameters()]
    grads_t = torch.autograd.grad(pen_t, [p for _, p in G.synthesis.named_parameters()])
    _close(pen_t, pen_j, 1e-4)
    flat_j = ckpt_t.params_to_state_dict(jax.tree_util.tree_map(np.asarray, grads_j))
    assert len(names) > 4 * len(cfg_j.layers)
    for name, g in zip(names, grads_t):
        _close(g, flat_j[name], 1e-4)
