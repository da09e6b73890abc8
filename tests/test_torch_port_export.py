"""The port's torch.export serving export (scripts/torch_export_model.py)
against the JAX package's generator and discriminator.

A 32x32 StyleGAN2 G from JAX parameters (nonzero w_avg and noise
strengths), carried into the port's module with the checkpoint bridge
(`params_to_state_dict`) and written, with a seeded D of the port, as
the port's native checkpoint.
The G is exported on the CPU with a symbolic batch, saved, loaded and
called at batches 2 and 3 of one artifact, against JAX
`generator_apply(..., noise_mode='const', truncation_psi=psi)` on the
same z at rtol 1e-4, for psi 1 and 0.7; the z are RandomState(7)'s, so
the served images of `examples/torch_serve_generator.py` for seed 7 are
held to JAX too. D exports at a concrete batch only; a conditional G
takes (z, c).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentaugment_tpu.models.stylegan2 import networks as net_j
from latentaugment_tpu_torch.models.stylegan2 import checkpoint as ckpt_t
from latentaugment_tpu_torch.models.stylegan2 import networks as net_t
from scripts.torch_export_model import build_export, input_shapes
from scripts.torch_export_model import main as export_main
from test_torch_port_common import _one_torch_thread  # noqa: F401 (autouse fixture)

RTOL, ATOL = 1e-4, 1e-5
CFG = dict(img_resolution=32, img_channels=2, channel_base=1024, channel_max=64)
PSIS = (1.0, 0.7)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("export")
    g_cfg = net_j.generator_config(z_dim=32, w_dim=32, num_mapping_layers=2, **CFG)
    g_params = _np_tree(net_j.generator_init(jax.random.PRNGKey(0), g_cfg))
    rng = np.random.RandomState(0)
    g_params["mapping"]["w_avg"] = rng.randn(32).astype(np.float32) * 0.5
    for block in g_params["synthesis"].values():
        for conv in ("conv0", "conv1"):
            if isinstance(block, dict) and conv in block:
                block[conv]["noise_strength"] = np.float32(0.37).reshape(())
    G = net_t.Generator(net_t.generator_config(z_dim=32, w_dim=32, num_mapping_layers=2, **CFG))
    G.load_state_dict(ckpt_t.params_to_state_dict(g_params))
    # D, held to the port's own eager D here, keeps the port's seeded init
    # (tests/test_torch_port_networks.py holds that D to JAX's).
    D = net_t.Discriminator(net_t.discriminator_config(**CFG), seed=1).requires_grad_(False)
    ckpt = str(d / "ckpt.pkl")
    ckpt_t.save_checkpoint(ckpt, G, D)
    # The served z of seed 7 (examples/serve_generator.py:119).
    z = np.random.RandomState(7).randn(3, 32).astype(np.float32)
    want = {psi: np.asarray(net_j.generator_apply(
        jax.tree_util.tree_map(jnp.asarray, g_params), g_cfg, jnp.asarray(z),
        truncation_psi=psi, noise_mode="const")) for psi in PSIS}
    arts, programs = {}, {}
    for psi in PSIS:
        arts[psi] = str(d / f"g_psi{psi}.pt2")
        export_main(["--checkpoint", ckpt, "--out", arts[psi], "--truncation", str(psi),
                     "--device", "cpu"])
        programs[psi] = torch.export.load(arts[psi])
    return dict(ckpt=ckpt, z=z, want=want, arts=arts, programs=programs, D=D, dir=d)


@pytest.mark.parametrize("psi", PSIS)
def test_generator_export_matches_jax_at_two_batches(setup, psi):
    program = setup["programs"][psi]
    (lead, z_dim), = input_shapes(program)
    assert not isinstance(lead, int) and z_dim == 32
    g = program.module()
    for b in (2, 3):
        with torch.no_grad():
            got = g(torch.from_numpy(setup["z"][:b])).numpy()
        assert got.dtype == np.float32 and got.shape == (b, 2, 32, 32)
        np.testing.assert_allclose(got, setup["want"][psi][:b], rtol=RTOL, atol=ATOL)


def test_truncation_is_baked_in(setup):
    outs = [setup["programs"][psi].module()(torch.from_numpy(setup["z"])) for psi in PSIS]
    assert (outs[0] - outs[1]).abs().max() > 1e-3


def test_served_images_match_jax(setup):
    """generate(n=3, seed=7) pads to bucket 4 and trims: the images are
    JAX's on RandomState(7)'s z."""
    from examples.torch_serve_generator import GeneratorService

    svc = GeneratorService(setup["arts"][1.0], buckets=(1, 2, 4), device="cpu")
    np.testing.assert_allclose(svc.generate(3, seed=7), setup["want"][1.0], rtol=RTOL,
                               atol=ATOL)


def test_discriminator_export_concrete_batch(setup):
    out = str(setup["dir"] / "d.pt2")
    export_main(["--checkpoint", setup["ckpt"], "--out", out, "--which", "d", "--batch", "4",
                 "--device", "cpu"])
    program = torch.export.load(out)
    assert input_shapes(program) == [(4, 2, 32, 32)]
    img = torch.from_numpy(np.random.RandomState(9).rand(4, 2, 32, 32).astype(np.float32) * 2 - 1)
    with torch.no_grad():
        np.testing.assert_allclose(program.module()(img).numpy(), setup["D"](img).numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_discriminator_export_requires_batch(setup, tmp_path):
    with pytest.raises(ValueError, match="concrete"):
        export_main(["--checkpoint", setup["ckpt"], "--out", str(tmp_path / "d.pt2"),
                     "--which", "d", "--device", "cpu"])
    assert not os.path.exists(tmp_path / "d.pt2")


def test_conditional_generator_export(tmp_path):
    cfg = net_t.generator_config(z_dim=16, w_dim=16, c_dim=2, num_mapping_layers=2, **CFG)
    G = net_t.Generator(cfg, seed=3).requires_grad_(False)
    ckpt = str(tmp_path / "cond.pkl")
    ckpt_t.save_checkpoint(ckpt, G)
    program = build_export(ckpt, device="cpu")
    shapes = input_shapes(program)
    assert [s[1] for s in shapes] == [16, 2] and not isinstance(shapes[0][0], int)
    z = torch.from_numpy(np.random.RandomState(1).randn(3, 16).astype(np.float32))
    c = torch.eye(2)[[0, 1, 0]]
    got = program.module()(z, c)
    with torch.no_grad():
        np.testing.assert_allclose(got.numpy(), G(z, c, noise_mode="const").numpy(),
                                   rtol=1e-5, atol=1e-6)
    swapped = program.module()(z, torch.eye(2)[[1, 0, 1]])
    assert (got - swapped).abs().max() > 1e-4  # the labels matter through the program


def test_export_on_cuda_without_cuda_raises(setup, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: --device cuda is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_main(["--checkpoint", setup["ckpt"], "--out", str(tmp_path / "g.pt2")])
