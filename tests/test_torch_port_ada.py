"""The port's ADA pipe (models/stylegan2/ada.py) against the JAX package's,
on the CPU.

The two packages draw different random numbers from the same seed, so
the parity test takes every draw from JAX's keys in JAX's op order,
hands them to the port's application (`apply_ada_draws`) and holds the
result to JAX's `apply_ada` at 1e-5 of its largest value (float32
sampling positions, summed in another order, times the image's slope).
The rest holds the pipe's own semantics: identity at p = 0, a flip at
p = 1 of xflip, gradients with respect to the image, and draws that
depend on the generator only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentaugment_tpu.models.stylegan2 import ada as ada_j
from latentaugment_tpu_torch.models.stylegan2 import ada as ada_t
from test_torch_port_common import _one_torch_thread  # noqa: F401 (autouse fixture)

TOL = 1e-5


def _jax_draws(key, p, cfg, shape, xint_max=ada_t.STRENGTHS['xint_max']):
    """The draws of latentaugment_tpu's apply_ada, key for key, as the
    port's draw dict."""
    n, c = shape[:2]
    keys = iter(jax.random.split(key, 32))
    p = jnp.float32(p)

    def gate(op):
        return jax.random.bernoulli(next(keys), jnp.clip(p * cfg[op], 0.0, 1.0), (n,))

    def uniform(size, lo=-np.pi, hi=np.pi):
        return jax.random.uniform(next(keys), size, minval=lo, maxval=hi)

    def normal(size):
        return jax.random.normal(next(keys), size)

    def rotate():
        p_rot = 1.0 - jnp.sqrt(jnp.clip(1.0 - p * cfg['rotate'], 0.0, 1.0))
        return jax.random.bernoulli(next(keys), p_rot, (n,)), uniform((n,))

    d = {}
    if any(cfg[k] for k in ada_t._GEOM_OPS):
        if cfg['xflip']:
            d['xflip'] = (gate('xflip'),)
        if cfg['rotate90']:
            d['rotate90'] = (gate('rotate90'), jax.random.randint(next(keys), (n,), 0, 4))
        if cfg['xint']:
            d['xint'] = (gate('xint'), uniform((n, 2), -xint_max, xint_max))
        if cfg['scale']:
            d['scale'] = (gate('scale'), normal((n,)))
        if cfg['rotate']:
            d['rotate'] = rotate()
        if cfg['aniso']:
            d['aniso'] = (gate('aniso'), uniform((n,)), normal((n,)))
        if cfg['rotate']:
            d['rotate2'] = rotate()
        if cfg['xfrac']:
            d['xfrac'] = (gate('xfrac'), normal((n, 2)))
    if cfg['brightness']:
        d['brightness'] = (gate('brightness'), normal((n,)))
    if cfg['contrast']:
        d['contrast'] = (gate('contrast'), normal((n,)))
    if c == 3 and (cfg['lumaflip'] or cfg['hue'] or cfg['saturation']):
        if cfg['lumaflip']:
            d['lumaflip'] = (gate('lumaflip'),)
        if cfg['hue']:
            d['hue'] = (gate('hue'), uniform((n,)))
        if cfg['saturation']:
            d['saturation'] = (gate('saturation'), normal((n,)))
    if cfg['noise']:
        d['noise'] = (gate('noise'), normal((n,)), normal(tuple(shape)))
    if cfg['cutout']:
        d['cutout'] = (gate('cutout'), uniform((n, 2), 0.0, 1.0))
    return {k: tuple(torch.from_numpy(np.array(a)) for a in v) for k, v in d.items()}


CASES = {
    "bgc 2ch p0.6": ("bgc", {}, 2, 0.6),
    "bgcfnc 2ch p1": ("bgcfnc", {}, 2, 1.0),
    "bgc 3ch p0.7": ("bgc", {}, 3, 0.7),
    "color 3ch p1": ("color", {}, 3, 1.0),
    "geom x2 2ch p0.4": ("geom", dict(rotate=2.0, aniso=0.5), 2, 0.4),
}


@pytest.mark.parametrize("name", list(CASES))
def test_application_of_jax_draws_matches_apply_ada(name):
    spec, over, c, p = CASES[name]
    cfg = ada_t.pipe_config(spec, **over)
    assert cfg == ada_j.pipe_config(spec, **over)
    x = np.random.RandomState(len(name)).randn(6, c, 16, 16).astype(np.float32)
    key = jax.random.PRNGKey(len(name) + 1)
    want = np.asarray(jax.jit(lambda x: ada_j.apply_ada(x, key, p, cfg))(jnp.asarray(x)))
    d = _jax_draws(key, p, cfg, x.shape)
    assert d and any(v[0].any() for v in d.values())  # some op fires
    got = ada_t.apply_ada_draws(torch.from_numpy(x), d, cfg).numpy()
    assert np.abs(got - x).max() > 1e-2
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_draws_follow_the_pipe_and_the_generator():
    """The port's own draws: every op of the preset (and the luma ops only
    for 3 channels), gates at the given p, the same draws for the same
    generator state, p as a device scalar."""
    cfg = ada_t.pipe_config('bgcfnc')
    for c, luma in ((2, False), (3, True)):
        d = ada_t.draw_ada(torch.Generator().manual_seed(0), (64, c, 8, 8), 1.0, cfg)
        assert ('hue' in d) == luma and {'xflip', 'rotate2', 'noise', 'cutout'} <= set(d)
        assert all(v[0].dtype == torch.bool for v in d.values())
        assert d['xflip'][0].all() and d['noise'][2].shape == (64, c, 8, 8)
    d0 = ada_t.draw_ada(torch.Generator().manual_seed(0), (64, 2, 8, 8), 0.0, cfg)
    assert not any(v[0].any() for v in d0.values())
    x = torch.randn(8, 2, 16, 16, generator=torch.Generator().manual_seed(1))
    a = ada_t.apply_ada(x, torch.Generator().manual_seed(5), torch.tensor(0.5), cfg)
    b = ada_t.apply_ada(x, torch.Generator().manual_seed(5), 0.5, cfg)
    assert torch.equal(a, b) and not torch.equal(a, x)
    with pytest.raises(ValueError, match="unknown ADA"):
        ada_t.pipe_config('bgc', wavelet=1)


def test_identity_at_p0_and_xflip_at_p1():
    x = torch.from_numpy(np.random.RandomState(0).randn(3, 2, 16, 16).astype(np.float32))
    gen = torch.Generator().manual_seed(1)
    out = ada_t.apply_ada(x, gen, 0.0, ada_t.pipe_config('bgcfnc'))
    torch.testing.assert_close(out, x, rtol=1e-5, atol=1e-5)
    out = ada_t.apply_ada(x, gen, 1.0, ada_t.pipe_config(None, xflip=1))
    torch.testing.assert_close(out, x.flip(-1), rtol=1e-4, atol=1e-5)


def test_differentiable_wrt_image():
    x = torch.randn(2, 2, 16, 16, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    y = ada_t.apply_ada(x, torch.Generator().manual_seed(3), 0.7, ada_t.pipe_config('bgc'))
    g, = torch.autograd.grad(y.square().sum(), x)
    assert torch.isfinite(g).all() and g.abs().sum() > 0
