"""Parity of the port's GeometricAugment with the JAX package, on the CPU.

The deterministic cores `affine_warp` and `elastic_warp` go through both
packages on the same numpy inputs and fixed parameters (tolerance: max
|port - jax| <= 1e-5 for images in [-1, 1]); `F.grid_sample` is held
against the JAX package's `ops.grid_sample` on grids that leave the image
by more than one period. The random wrappers draw from different
generators in the two frameworks, so they are tested for what they
promise: p_thres 1 returns the input, p_thres 0 transforms every sample,
val / test is the identity.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from latentaugment_tpu.augments import geometric_aug as geo_j
from latentaugment_tpu.ops import grid_sample as grid_sample_j
from latentaugment_tpu_torch.augments import create_augment
from latentaugment_tpu_torch.augments import geometric_aug as geo_t
from latentaugment_tpu_torch.options import AugOptions
from test_torch_port_common import _one_torch_thread  # noqa: F401 (autouse fixture)

TOL = 1e-5
RES = 32


def _batch(seed, n=3, c=2, h=RES, w=RES):
    return np.random.RandomState(seed).uniform(-1, 1, (n, c, h, w)).astype(np.float32)


def _max_err(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    return np.abs(got - want).max()


@pytest.mark.parametrize("h,w", [(8, 8), (7, 12)])
def test_grid_sample_reflection_matches_jax_far_outside_the_image(h, w):
    """Reflection about -0.5 / size - 0.5, then the clip: on grids up to
    3.5 image widths outside, more than one period of the reflection."""
    rng = np.random.RandomState(h)
    x = rng.randn(2, 3, h, w).astype(np.float32)
    grid = rng.uniform(-8.0, 8.0, (2, 9, 11, 2)).astype(np.float32)
    got = F.grid_sample(torch.from_numpy(x), torch.from_numpy(grid), mode="bilinear",
                        padding_mode="reflection", align_corners=False)
    want = grid_sample_j(jnp.asarray(x), jnp.asarray(grid), padding_mode="reflection",
                         align_corners=False)
    assert _max_err(got, want) <= TOL * np.abs(x).max()


@pytest.mark.parametrize("angles,shifts", [
    ([3.0, -3.0, 0.0], [[0.0, 0.0], [1.6, -1.6], [-0.7, 1.1]]),
    ([30.0, -30.0, 30.0], [[0.0, 0.0], [0.0, 0.0], [4.0, -3.0]]),
    ([0.0, 0.0, 0.0], [[1.0, 0.0], [0.0, -2.0], [31.0, 40.0]]),
])
def test_affine_warp_matches_jax(angles, shifts):
    x = _batch(1)
    angles, shifts = np.asarray(angles, np.float32), np.asarray(shifts, np.float32)
    got = geo_t.affine_warp(torch.from_numpy(x), torch.from_numpy(angles),
                            torch.from_numpy(shifts))
    want = geo_j.affine_warp(jnp.asarray(x), jnp.asarray(angles), jnp.asarray(shifts))
    assert _max_err(got, want) <= TOL


def test_affine_warp_non_square_matches_jax():
    x = _batch(2, h=24, w=40)
    angles = np.asarray([10.0, -3.0, 3.0], np.float32)
    shifts = np.asarray([[2.0, -1.0], [0.5, 0.5], [-3.0, 0.0]], np.float32)
    got = geo_t.affine_warp(torch.from_numpy(x), angles, shifts)
    want = geo_j.affine_warp(jnp.asarray(x), jnp.asarray(angles), jnp.asarray(shifts))
    assert _max_err(got, want) <= TOL


@pytest.mark.parametrize("kw", [dict(), dict(kernel_size=9, sigma=2.0, alpha=4.0),
                                dict(kernel_size=63, sigma=8.0, alpha=30.0)])
def test_elastic_warp_matches_jax(kw):
    """The third setting drives the grid into its clamp at +-1."""
    x = _batch(3)
    noise = np.random.RandomState(4).uniform(-1, 1, (3, 2, RES, RES)).astype(np.float32)
    got = geo_t.elastic_warp(torch.from_numpy(x), torch.from_numpy(noise), **kw)
    want = geo_j.elastic_warp(jnp.asarray(x), jnp.asarray(noise), **kw)
    assert _max_err(got, want) <= TOL
    if kw:
        assert np.abs(got.numpy() - x).max() > 1e-2  # it did warp


def test_random_wrappers_keep_or_transform_every_sample():
    x = torch.from_numpy(_batch(5, n=6))
    gen = torch.Generator().manual_seed(0)
    for fn, args in ((geo_t.random_hflip, ()), (geo_t.random_affine, (3.0, 0.05)),
                     (geo_t.random_elastic, (9, 2.0, 4.0))):
        assert torch.equal(fn(gen, x, 0.0, *args), x)
        out = fn(gen, x, 1.0, *args)
        assert out.shape == x.shape and out.dtype == x.dtype
        changed = (out != x).flatten(1).any(dim=1)
        assert changed.all(), fn.__name__
    torch.testing.assert_close(geo_t.random_hflip(gen, x, 1.0), x.flip(-1), rtol=0, atol=0)
    # Same seed, same draws.
    a = geo_t.random_affine(torch.Generator().manual_seed(7), x, 0.5, 3.0, 0.05)
    b = geo_t.random_affine(torch.Generator().manual_seed(7), x, 0.5, 3.0, 0.05)
    assert torch.equal(a, b)


def _policy(tmp_path, *extra, phase="train"):
    argv = ["--dataroot", "unused.zip", "--checkpoints_dir", str(tmp_path), "--load_size",
            str(RES), "--aug", "geometric", "--device", "cpu", "--phase", phase, *extra]
    return create_augment(AugOptions().parse(argv=argv, install_logger=False))


def _data(seed, n=4):
    a, b = _batch(seed, n=n, c=1), _batch(seed + 1, n=n, c=1)
    paths = [f"train/p/train_p_{i:05d}.pickle" for i in range(n)]
    return {"A": a, "B": b, "A_paths": paths, "B_paths": paths}


def test_policy_through_the_registry(tmp_path):
    data = _data(6)
    all_on = ("--horizontal_flip", "--affine", "--elastic_deform")

    aug = _policy(tmp_path, *all_on, "--p_thres", "0.0")
    assert type(aug).__name__ == "GeometricAugment" and aug.rotate_limit == 3
    aug.set_input(data)
    aug.forward()
    out = aug.get_output()
    for k, src in (("A", data["A"]), ("B", data["B"])):
        assert out[k].shape == src.shape and out[k].dtype == np.float32
        assert np.isfinite(out[k]).all()
        assert all(np.abs(out[k][i] - src[i]).max() > 1e-3 for i in range(len(src)))
    assert out["A_paths"] == out["B_paths"] == data["A_paths"]
    assert len(aug.stats_time) == 1
    # A and B of one sample get the same warp: a flip alone shows it.
    flip = _policy(tmp_path, "--horizontal_flip", "--p_thres", "0.0")
    flip.set_input(data)
    flip.forward()
    np.testing.assert_array_equal(flip.get_output()["A"], data["A"][..., ::-1])
    np.testing.assert_array_equal(flip.get_output()["B"], data["B"][..., ::-1])

    keep = _policy(tmp_path, *all_on, "--p_thres", "1.0")
    keep.set_input(data)
    keep.forward()
    np.testing.assert_array_equal(keep.get_output()["A"], data["A"])
    np.testing.assert_array_equal(keep.get_output()["B"], data["B"])


@pytest.mark.parametrize("phase", ["val", "test"])
def test_policy_is_the_identity_outside_training(tmp_path, phase):
    aug = _policy(tmp_path, "--horizontal_flip", "--affine", "--elastic_deform",
                  "--p_thres", "0.0", phase=phase)
    data = _data(8)
    aug.set_input(data)
    aug.forward()
    np.testing.assert_array_equal(aug.get_output()["B"], data["B"])


def test_policy_sanity_check_and_bad_input(tmp_path):
    aug = _policy(tmp_path, "--affine", "--p_thres", "0.0")
    aug.set_input(_data(9))
    aug.sanity_check()
    for f in ("train_p_00000.png", "train_p_00000aug.png"):
        assert os.path.getsize(os.path.join(aug.save_dir, f)) > 0
    bad = _data(9)
    bad["B_paths"] = list(reversed(bad["B_paths"]))
    with pytest.raises(ValueError):
        aug.set_input(bad)
    with pytest.raises(NotImplementedError):
        _policy(tmp_path, phase="predict")
    if not torch.cuda.is_available():
        argv = ["--dataroot", "unused.zip", "--checkpoints_dir", str(tmp_path), "--aug",
                "geometric"]
        opt = AugOptions().parse(argv=argv, install_logger=False)
        assert opt.device == "cuda"
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            create_augment(opt)
