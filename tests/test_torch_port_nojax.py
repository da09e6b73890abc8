"""The PyTorch port runs without JAX: in a fresh interpreter, importing the
port, running its policy and an alias-free generator on the CPU loads no
`jax` module and nothing of the JAX package `latentaugment_tpu`. And `--device cuda` without CUDA
raises instead of running on the CPU."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import sys, tempfile
import numpy as np
import latentaugment_tpu_torch
from latentaugment_tpu_torch import augments, benchmark, data, models, options, utils
from latentaugment_tpu_torch.models.stylegan3 import filters, networks as sg3
from latentaugment_tpu_torch.ops import filtered_lrelu
from latentaugment_tpu_torch.augments import create_augment
from latentaugment_tpu_torch.data import create_dataset
from latentaugment_tpu_torch.options import AugOptions

root = tempfile.mkdtemp(dir=sys.argv[1])
argv = benchmark.build_policy_workspace(
    root, res=32, batch_size=4, num_epochs=2, crop_size=16, channel_base=256,
    channel_max=32, n_patients=1, slices_per_patient=4, step=5)
opt = AugOptions().parse(argv=argv + ["--device", "cpu"], install_logger=False)
augment = create_augment(opt)
data = next(iter(create_dataset(opt)))
augment.set_input(data)
augment.forward()
out = augment.get_output()
assert out["A"].shape == (4, 1, 32, 32) and np.isfinite(out["A"]).all()
assert not np.allclose(augment.get_latent_output()["w"], augment.get_latent_input()["w"])
# The alias-free generator (plain filtered_lrelu on the CPU).
import torch
G = sg3.Generator(sg3.generator_config(img_resolution=32, num_layers=3, channel_base=256,
                                       channel_max=8, z_dim=16, w_dim=16))
with torch.no_grad():
    assert torch.isfinite(G(torch.randn(2, 16))).all()
loaded = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib"))
                or m == "latentaugment_tpu" or m.startswith("latentaugment_tpu."))
assert "latentaugment_tpu_torch.data.pelvis_dataset" in sys.modules
print("LOADED", loaded)
"""


def test_port_policy_runs_without_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", _CHILD, str(tmp_path)], cwd=str(tmp_path),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, f"stdout:\n{r.stdout[-3000:]}\nstderr:\n{r.stderr[-3000:]}"
    assert "LOADED []" in r.stdout, r.stdout[-2000:]


def test_device_cuda_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: --device cuda is valid here")
    from latentaugment_tpu_torch import benchmark
    from latentaugment_tpu_torch.augments import create_augment
    from latentaugment_tpu_torch.options import AugOptions

    argv = benchmark.build_policy_workspace(
        str(tmp_path), res=16, batch_size=4, num_epochs=1, crop_size=8,
        channel_base=256, channel_max=32, n_patients=1, slices_per_patient=4, step=5)
    opt = AugOptions().parse(argv=argv, install_logger=False)
    assert opt.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_augment(opt)
    # Nothing was built on the CPU in its place: no manifold caches.
    assert not os.path.exists(os.path.join(str(tmp_path), "interim", "PolicyBench",
                                           "cache_dir"))
