"""The PyTorch port runs without JAX: in a fresh interpreter, importing
every module of the port and its projector and trainer scripts, and
running its policies, its projector and trainer command lines, an
alias-free generator, a metric, the LatentAugment sweep driver, the
one-command pipeline, an export and the pix2pix nets on the CPU loads no
`jax` module, no `click` and nothing of the JAX package
`latentaugment_tpu`. No source file of the port, nor `chip_smoke.py`,
nor the port's scripts and examples, names such an import. And
`--device cuda` without CUDA raises instead of running on the CPU."""

import ast
import glob
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import importlib, os, pkgutil, sys, tempfile
import numpy as np
import latentaugment_tpu_torch
for m in pkgutil.walk_packages(latentaugment_tpu_torch.__path__, "latentaugment_tpu_torch."):
    importlib.import_module(m.name)
for name in ("augments.criteria.lpips", "augments.criteria.nst", "augments.geometric_aug",
             "data.write_tozip", "metrics.frechet_inception_distance",
             "metrics.metric_main_mi_multimodal", "metrics.metric_utils",
             "metrics.precision_recall", "models.inception", "models.lpips_backbones",
             "models.stylegan2.projector", "models.stylegan2.train", "models.stylegan2.ada",
             "models.stylegan2.dataset", "utils.util_url", "utils.util_io",
             "utils.util_reports", "analysis.hpo", "analysis.umap_analysis",
             "analysis.umap_plot", "analysis.pr_analysis", "analysis.create_gif",
             "analysis.sg2_metrics_analysis", "analysis.sg2_metrics_opt"):
    assert "latentaugment_tpu_torch." + name in sys.modules, name
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
# The classical policy, the projector's command line and a metric.
gopt = AugOptions().parse(argv=["--dataroot", "x.zip", "--checkpoints_dir", root, "--aug",
                                "geometric", "--affine", "--elastic_deform", "--p_thres", "0",
                                "--device", "cpu", "--load_size", "32"], install_logger=False)
geo = create_augment(gopt)
geo.set_input(data)
geo.forward()
assert geo.get_output()["B"].shape == (4, 1, 32, 32)
from scripts.torch_project_dataset import main as project_main
inv = os.path.join(root, "inv.zip")
project_main(["--checkpoint", argv[argv.index("--model_dir") + 1], "--data_zip",
              argv[argv.index("--dataroot") + 1], "--resolution", "32", "--num_steps", "2",
              "--batch_size", "4", "--w_avg_samples", "16", "--outdir",
              os.path.join(root, "proj"), "--dest_zip", inv, "--device", "cpu"])
assert os.path.getsize(inv) > 0
from scripts.torch_train_sg2 import main as train_main
run = os.path.join(root, "train")
train_main(["--synthetic", "--device", "cpu", "--batch", "4", "--kimg", "0.004", "--snap",
            "0.004", "--outdir", run, "--aug", "ada"])
assert any(f.startswith("network-snapshot-") for f in os.listdir(run))
# The LatentAugment sweep driver (one batch) and the pipeline's command line.
os.environ["LATENTAUGMENT_N_IMGS"] = "4"
import scripts.torch_backbone, scripts.torch_backbone_geoaug, scripts.torch_backbone_sg2aug
from scripts.torch_backbone_latentaug import main as latentaug_main
outdir, times = latentaug_main(argv + ["--device", "cpu", "--name", "nojax_driver"],
                               install_logger=False)
assert sorted(os.listdir(os.path.join(outdir, "latent_aug"))) == ["w_aug_0"] and len(times) == 2
from scripts.torch_run_pipeline import main as pipeline_main
tempfile.tempdir = root
pipe_out, results, _ = pipeline_main(["--synthetic", "--cpu", "--n_imgs", "2"])
assert len(results) == 4 and os.path.isfile(os.path.join(pipe_out, "pipeline_metrics.json"))
# Export, serving, the dynamics check and pix2pix (their modules only, and one export).
import scripts.torch_check_train_run, scripts.torch_sustained_train
import examples.torch_serve_generator, examples.torch_train_pix2pix
from latentaugment_tpu_torch.models import pix2pix
from latentaugment_tpu_torch.utils import util_pix2pix
from scripts.torch_export_model import build_export
program = build_export(argv[argv.index("--model_dir") + 1], device="cpu")
assert program.module()(torch.zeros(2, 512)).shape == (2, 2, 32, 32)
nets = pix2pix.init_all(0, pix2pix.pix2pix_config(base_channels=4, depth=2, d_layers=2))
assert pix2pix.count_params(nets) > 0 and util_pix2pix.tensor2im(np.zeros((1, 8, 8))).shape == (8, 8, 3)
from latentaugment_tpu_torch.metrics import precision_recall
rng = np.random.RandomState(0)
p, r = precision_recall.knn_precision_recall(rng.randn(20, 8), rng.randn(20, 8), device="cpu")
assert 0.0 <= p <= 1.0 and 0.0 <= r <= 1.0
from latentaugment_tpu_torch.augments.criteria import LPIPS
assert LPIPS("squeeze", device="cpu")(np.zeros((1, 3, 32, 32), np.float32),
                                      np.ones((1, 3, 32, 32), np.float32)).shape == (1,)
loaded = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "click"
                or m == "latentaugment_tpu" or m.startswith("latentaugment_tpu."))
assert "latentaugment_tpu_torch.data.pelvis_dataset" in sys.modules
print("LOADED", loaded)
"""


def test_port_policy_runs_without_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"  # the suite's workers share few cores
    r = subprocess.run([sys.executable, "-c", _CHILD, str(tmp_path)], cwd=str(tmp_path),
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, f"stdout:\n{r.stdout[-3000:]}\nstderr:\n{r.stderr[-3000:]}"
    assert "LOADED []" in r.stdout, r.stdout[-2000:]


def _port_sources():
    files = glob.glob(os.path.join(REPO, "latentaugment_tpu_torch", "**", "*.py"), recursive=True)
    files += glob.glob(os.path.join(REPO, "scripts", "torch_*.py"))
    files += glob.glob(os.path.join(REPO, "examples", "torch_*.py"))
    return sorted(files) + [os.path.join(REPO, "chip_smoke.py")]


def test_no_source_of_the_port_imports_jax_click_or_the_jax_package():
    files = _port_sources()
    names = {os.path.relpath(f, REPO) for f in files}
    assert {"chip_smoke.py", "scripts/torch_project_dataset.py", "scripts/torch_train_sg2.py",
            "latentaugment_tpu_torch/models/stylegan2/train.py",
            "latentaugment_tpu_torch/metrics/metric_utils.py",
            "latentaugment_tpu_torch/augments/geometric_aug.py",
            "latentaugment_tpu_torch/models/stylegan2/convert.py",
            "latentaugment_tpu_torch/models/stylegan2/legacy.py",
            "latentaugment_tpu_torch/models/stylegan3/convert.py",
            "scripts/torch_convert_checkpoint.py", "scripts/torch_verify_real_weights.py",
            "scripts/torch_backbone.py", "scripts/torch_backbone_latentaug.py",
            "scripts/torch_backbone_sg2aug.py", "scripts/torch_backbone_geoaug.py",
            "scripts/torch_run_pipeline.py", "latentaugment_tpu_torch/utils/util_io.py",
            "latentaugment_tpu_torch/utils/util_reports.py",
            "latentaugment_tpu_torch/analysis/hpo.py",
            "latentaugment_tpu_torch/analysis/sg2_metrics_opt.py",
            "latentaugment_tpu_torch/analysis/umap_analysis.py",
            "scripts/torch_check_train_run.py", "scripts/torch_sustained_train.py",
            "scripts/torch_export_model.py", "examples/torch_serve_generator.py",
            "examples/torch_train_pix2pix.py", "latentaugment_tpu_torch/models/pix2pix.py",
            "latentaugment_tpu_torch/utils/util_pix2pix.py"} <= names
    banned = ("jax", "jaxlib", "click", "latentaugment_tpu")
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in banned, f"{path}:{node.lineno} imports {mod}"


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
    from latentaugment_tpu_torch.models.stylegan2 import networks, train
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.make_train_fns(networks.generator_config(img_resolution=16),
                             networks.discriminator_config(img_resolution=16),
                             train.train_config())
    # The sweep drivers default to --device cuda, as the policies do.
    import sys
    sys.path.insert(0, REPO)
    from scripts import torch_backbone_latentaug
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_backbone_latentaug.main(argv, install_logger=False)
    # Nothing was built on the CPU in its place: no manifold caches.
    assert not os.path.exists(os.path.join(str(tmp_path), "interim", "PolicyBench",
                                           "cache_dir"))
