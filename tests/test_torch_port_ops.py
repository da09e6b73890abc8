"""Parity of the PyTorch port's ops with the JAX package, on the CPU.

Inputs come from np.random.RandomState and go through the JAX function
and its counterpart in `latentaugment_tpu_torch.ops`, in float32. Where
the JAX op reaches a Pallas kernel, it runs in interpret mode as the JAX
package's own tests run it (tests/test_ops.py). On CPU tensors the
port's wrappers run their plain PyTorch versions; the kernels themselves
are compared with those on the card (chip_smoke.py and
tests/test_torch_port_kernels.py).

Tolerance: rtol 1e-5 on values and gradients of single ops (float32,
same algorithm, different summation order), atol 1e-6 for entries near 0.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentaugment_tpu.augments import losses as losses_j
from latentaugment_tpu.augments import manifold as manifold_j
from latentaugment_tpu.ops import adam as adam_j
from latentaugment_tpu.ops import modulated_conv as modconv_j
from latentaugment_tpu_torch.augments import losses as losses_t
from latentaugment_tpu_torch.augments import manifold as manifold_t
from latentaugment_tpu_torch.ops import adam as adam_t
from latentaugment_tpu_torch.ops import bias_act as bias_act_t
from latentaugment_tpu_torch.ops import conv2d_resample as c2r_t
from latentaugment_tpu_torch.ops import modulated_conv as modconv_t
from latentaugment_tpu_torch.ops import upfirdn2d as upfirdn_t
from test_torch_port_common import _one_torch_thread  # noqa: F401 (autouse fixture)

# latentaugment_tpu.ops re-exports functions under their modules' names.
bias_act_j = importlib.import_module("latentaugment_tpu.ops.bias_act")
c2r_j = importlib.import_module("latentaugment_tpu.ops.conv2d_resample")
upfirdn_j = importlib.import_module("latentaugment_tpu.ops.upfirdn2d")

RTOL, ATOL = 1e-5, 1e-6


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _vjp_j(fn, args, dy):
    """JAX cotangents of fn(*args) against dy."""
    _, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in args])
    return vjp(jnp.asarray(dy))


def _vjp_t(fn, args, dy):
    ts = [_t(a, grad=True) for a in args]
    y = fn(*ts)
    return torch.autograd.grad(y, ts, torch.from_numpy(dy))


# ----------------------------------------------------------------------------
# bias_act: values against the Pallas kernel (interpret mode). JAX cannot
# differentiate through pallas_call in reverse mode, so dx is held against
# the JAX package's XLA path, which is what its autodiff runs.

@pytest.mark.parametrize("act", sorted(bias_act_j.activation_funcs))
@pytest.mark.parametrize("clamp", [None, 0.5])
def test_bias_act_matches_jax(act, clamp):
    rng = np.random.RandomState(0)
    x, b = _rand(rng, 2, 5, 4, 3), _rand(rng, 5)
    kw = dict(act=act, clamp=clamp)
    y_j = bias_act_j.bias_act(jnp.asarray(x), jnp.asarray(b), impl="fused", **kw)
    y_t = bias_act_t.bias_act(_t(x), _t(b), **kw)
    _close(y_t, y_j)

    dy = _rand(rng, *x.shape)
    gx_j, gb_j = _vjp_j(lambda x, b: bias_act_j.bias_act(x, b, impl="ref", **kw),
                        (x, b), dy)
    gx_t, gb_t = _vjp_t(lambda x, b: bias_act_t.bias_act(x, b, **kw), (x, b), dy)
    _close(gx_t, gx_j)
    _close(gb_t, gb_j, rtol=1e-4, atol=1e-5)  # a sum over 24 entries per channel


def test_bias_act_fc_shape_and_gain():
    """[N, C] rows (the FC layers) with an explicit gain and alpha."""
    rng = np.random.RandomState(1)
    x, b = _rand(rng, 4, 7), _rand(rng, 7)
    kw = dict(act="lrelu", alpha=0.1, gain=0.7, clamp=1.0)
    y_j = bias_act_j.bias_act(jnp.asarray(x), jnp.asarray(b), impl="fused", **kw)
    _close(bias_act_t.bias_act(_t(x), _t(b), **kw), y_j)


# ----------------------------------------------------------------------------
# upfirdn2d: the Pallas kernel (interpret mode, custom VJP) against the
# port's plain version, values and dx.

UPFIRDN_CASES = [
    dict(up=1, down=1, padding=(2, 1, 2, 1), flip_filter=False, gain=4),
    dict(up=2, down=1, padding=(2, 1, 2, 1), flip_filter=False, gain=4),
    dict(up=1, down=2, padding=(1, 1, 1, 1), flip_filter=True, gain=1),
    dict(up=2, down=2, padding=(2, 2, 2, 2), flip_filter=False, gain=4),
    dict(up=1, down=1, padding=(-1, 2, 1, -2), flip_filter=True, gain=1),
    dict(up=2, down=1, padding=(0, -1, 1, -1), flip_filter=False, gain=4),
    dict(up=1, down=2, padding=(-1, 0, 0, -1), flip_filter=False, gain=2),
]


@pytest.mark.parametrize("case", UPFIRDN_CASES,
                         ids=[f"up{c['up']}-down{c['down']}-pad{c['padding']}-flip{c['flip_filter']}"
                              for c in UPFIRDN_CASES])
def test_upfirdn2d_matches_pallas(case):
    rng = np.random.RandomState(2)
    x = _rand(rng, 2, 3, 8, 8)
    f_np = np.asarray(upfirdn_j.setup_filter([1, 3, 3, 1], separable=True))
    f_t = upfirdn_t.setup_filter([1, 3, 3, 1], separable=True)
    _close(f_t, f_np, rtol=0, atol=0)

    y_j = upfirdn_j.upfirdn2d(jnp.asarray(x), jnp.asarray(f_np), impl="pallas", **case)
    y_t = upfirdn_t.upfirdn2d(_t(x), f_t, **case)
    assert tuple(y_t.shape) == tuple(y_j.shape)
    _close(y_t, y_j)

    dy = _rand(rng, *y_j.shape)
    gx_j, = _vjp_j(lambda x: upfirdn_j.upfirdn2d(x, jnp.asarray(f_np), impl="pallas", **case),
                   (x,), dy)
    gx_t, = _vjp_t(lambda x: upfirdn_t.upfirdn2d(x, f_t, **case), (x,), dy)
    _close(gx_t, gx_j)


@pytest.mark.parametrize("wrapper", ["filter2d", "upsample2d", "downsample2d"])
def test_resample_wrappers_2d_filter(wrapper):
    """The convenience wrappers with a 2-D (non-separable) filter, against
    the JAX package's reference path."""
    rng = np.random.RandomState(3)
    x = _rand(rng, 1, 2, 8, 8)
    f_np = np.asarray(upfirdn_j.setup_filter([1, 3, 3, 1]))
    assert f_np.ndim == 2
    y_j = getattr(upfirdn_j, wrapper)(jnp.asarray(x), jnp.asarray(f_np), impl="ref")
    y_t = getattr(upfirdn_t, wrapper)(_t(x), upfirdn_t.setup_filter([1, 3, 3, 1]))
    _close(y_t, y_j)


# ----------------------------------------------------------------------------
# conv2d_resample and modulated_conv2d: values, dx and (conv) dw.

CONV_CASES = [
    dict(k=3, up=1, down=1, flip_weight=True),
    dict(k=3, up=2, down=1, flip_weight=False),   # G conv0 (transposed conv)
    dict(k=3, up=1, down=2, flip_weight=True),    # D conv1 (blur + stride 2)
    dict(k=1, up=1, down=2, flip_weight=True),    # D skip (down=2 FIR first)
    dict(k=1, up=2, down=1, flip_weight=False),   # 1x1 up (conv first)
    dict(k=3, up=2, down=2, flip_weight=False),
]


@pytest.mark.parametrize("case", CONV_CASES,
                         ids=[f"k{c['k']}-up{c['up']}-down{c['down']}" for c in CONV_CASES])
def test_conv2d_resample_matches_jax(case):
    rng = np.random.RandomState(4)
    k, up, down = case["k"], case["up"], case["down"]
    x, w = _rand(rng, 2, 4, 8, 8), _rand(rng, 6, 4, k, k)
    f_np = np.asarray(upfirdn_j.setup_filter([1, 3, 3, 1], separable=True))
    f_t = upfirdn_t.setup_filter([1, 3, 3, 1], separable=True)
    kw = dict(up=up, down=down, padding=k // 2, flip_weight=case["flip_weight"])

    def fj(x, w):
        return c2r_j.conv2d_resample(x, w, f=jnp.asarray(f_np), **kw)

    def ft(x, w):
        return c2r_t.conv2d_resample(x, w, f=f_t, **kw)

    y_j = fj(jnp.asarray(x), jnp.asarray(w))
    y_t = ft(_t(x), _t(w))
    assert tuple(y_t.shape) == tuple(y_j.shape)
    _close(y_t, y_j, rtol=1e-5, atol=1e-5)
    dy = _rand(rng, *y_j.shape)
    for g_t, g_j in zip(_vjp_t(ft, (x, w), dy), _vjp_j(fj, (x, w), dy)):
        _close(g_t, g_j, rtol=1e-4, atol=1e-4)  # sums of up to 8*8*2*6 products


@pytest.mark.parametrize("demodulate,up,noise", [(True, 1, True), (True, 2, False),
                                                 (False, 1, False)])
def test_modulated_conv2d_matches_jax(demodulate, up, noise):
    rng = np.random.RandomState(5)
    k = 3 if demodulate else 1
    x, w = _rand(rng, 2, 4, 8, 8), _rand(rng, 6, 4, k, k)
    s = _rand(rng, 2, 4) + 1.0
    n = _rand(rng, 8 * up, 8 * up) if noise else None
    f_np = np.asarray(upfirdn_j.setup_filter([1, 3, 3, 1], separable=True))
    f_t = upfirdn_t.setup_filter([1, 3, 3, 1], separable=True)
    kw = dict(up=up, padding=k // 2, demodulate=demodulate, flip_weight=(up == 1))

    def fj(x, s):
        return modconv_j.modulated_conv2d(
            x, jnp.asarray(w), s, noise=None if n is None else jnp.asarray(n),
            resample_filter=jnp.asarray(f_np), **kw)

    def ft(x, s):
        return modconv_t.modulated_conv2d(
            x, _t(w), s, noise=None if n is None else _t(n), resample_filter=f_t, **kw)

    y_j = fj(jnp.asarray(x), jnp.asarray(s))
    _close(ft(_t(x), _t(s)), y_j, rtol=1e-5, atol=1e-5)
    dy = _rand(rng, *y_j.shape)
    for g_t, g_j in zip(_vjp_t(ft, (x, s), dy), _vjp_j(fj, (x, s), dy)):
        _close(g_t, g_j, rtol=1e-4, atol=1e-4)


# ----------------------------------------------------------------------------
# Adam, losses, crops.

def test_adam_step_matches_jax():
    rng = np.random.RandomState(6)
    w, m, g = _rand(rng, 3, 1, 8), _rand(rng, 3, 1, 8), _rand(rng, 3, 1, 8)
    v = np.abs(_rand(rng, 3, 1, 8))
    for t in (0, 4):
        out_j = adam_j.adam_step(*(jnp.asarray(a) for a in (w, m, v, g)), t, 0.01)
        out_t = adam_t.adam_step(*(_t(a) for a in (w, m, v, g)), t, 0.01)
        for a_t, a_j in zip(out_t, out_j):
            _close(a_t, a_j)


def test_losses_match_jax():
    rng = np.random.RandomState(7)
    X, Y = _rand(rng, 6, 2, 5), _rand(rng, 3, 2, 5)
    mean_j, msq_j = losses_j.manifold_summary(jnp.asarray(X))
    mean_t, msq_t = losses_t.manifold_summary(_t(X))
    _close(mean_t, mean_j)
    _close(msq_t, msq_j)
    for normalize in (True, False):
        _close(losses_t.l2_mean_loss(_t(Y), mean_t, msq_t, normalize),
               losses_j.l2_mean_loss(jnp.asarray(Y), mean_j, msq_j, normalize))
    logits = _rand(rng, 4, 1)
    _close(losses_t.disc_softplus_loss(_t(logits)),
           losses_j.disc_softplus_loss(jnp.asarray(logits)))


@pytest.mark.parametrize("res,crop,pos", [(256, 64, (5, 100)), (32, 16, (2, 4)),
                                          (33, 8, (0, 3))])
def test_crops_match_jax(res, crop, pos):
    """Centre crop (half-to-even offset: top 38 at 256) and the random crop."""
    x = np.arange(2 * res * res, dtype=np.float32).reshape(1, 2, res, res)
    _close(manifold_t.center_crop(_t(x), res), manifold_j.center_crop(jnp.asarray(x), res),
           rtol=0, atol=0)
    if res == 256:
        assert manifold_t.center_crop(_t(x), res)[0, 0, 0, 0] == x[0, 0, 38, 38]
    tj = manifold_j.get_transform(res, crop, "center_random_crop")
    tt = manifold_t.get_transform(res, crop, "center_random_crop")
    _close(tt(_t(x), pos), tj(jnp.asarray(x), jnp.asarray(pos, jnp.int32)), rtol=0, atol=0)


def test_crop_position_stream_matches_jax():
    import random

    a, b = random.Random(43), random.Random(43)
    for _ in range(5):
        assert manifold_t.get_params(256, 64, rng=a) == manifold_j.get_params(256, 64, rng=b)


def test_cpu_tensor_runs_plain_version_without_launching():
    """On CPU tensors the wrappers take the plain versions: no launch is
    counted and no kernel library is built."""
    before = (dict(bias_act_t.launches), dict(upfirdn_t.launches))
    x = torch.randn(1, 2, 8, 8)
    bias_act_t.bias_act(x, torch.zeros(2), act="lrelu", clamp=1.0)
    upfirdn_t.upsample2d(x, upfirdn_t.setup_filter([1, 3, 3, 1], separable=True))
    assert (bias_act_t.launches, upfirdn_t.launches) == before
    with pytest.raises(ValueError):
        bias_act_t.bias_act(x, impl="fused")
