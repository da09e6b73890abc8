"""scripts/torch_run_pipeline.py, the port's one-command loop, on the CPU
at 32x32: a seeded synthetic workspace (the port's own
`build_policy_workspace`), StyleGAN2 training for a few ticks, inversion
(2 steps), the walk and its dumps, FID and precision/recall per
modality, the PCA coverage plot and the trajectory GIFs; and
`carry_vgg_env`, which keeps the LPIPS VGG16 of the original layout once
--train points model_dir at a snapshot file."""

import json
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

from test_torch_port_common import _one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from scripts import torch_run_pipeline  # noqa: E402


def test_pipeline_trains_projects_walks_scores_and_plots(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setenv("LATENTAUGMENT_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.delenv("LATENTAUGMENT_VGG16", raising=False)
    outdir, results, seconds = torch_run_pipeline.main([
        "--synthetic", "--device", "cpu", "--n_imgs", "4", "--batch_size", "2",
        "--train", "--train_kimg", "0.008", "--train_batch", "4",
        "--project", "--project_steps", "2", "--project_batch", "4"])
    out = capsys.readouterr().out
    print(seconds)
    assert outdir.startswith(str(tmp_path))
    assert list(seconds) == ["workspace", "train", "project", "augment", "metrics", "coverage",
                             "gif"]
    # Training wrote a snapshot that replaced the checkpoint; the projector
    # inverted the split against it and the walk read its zip.
    train_dir = os.path.join(outdir, "train")
    assert any(f.startswith("network-snapshot-") for f in os.listdir(train_dir))
    assert "[pipeline] trained snapshot" in out and "-projected.zip" in out
    interim = os.path.join(os.path.dirname(os.path.dirname(outdir)), "interim")
    assert any(f.endswith("-projected.zip") for d in os.listdir(interim)
               for f in os.listdir(os.path.join(interim, d)))
    # Two batches walked and dumped with their latents.
    assert sorted(os.listdir(os.path.join(outdir, "img_aug"))) == ["img_aug_0", "img_aug_1"]
    assert sorted(os.listdir(os.path.join(outdir, "latent_aug"))) == \
        ["latent_aug_0", "latent_aug_1"]
    with open(os.path.join(outdir, "pipeline_metrics.json")) as f:
        metrics = json.load(f)
    assert [(r["metric"], r["mode"]) for r in metrics] == [
        ("fid50k_full", "MR_nonrigid_CT"), ("pr50k3_full", "MR_nonrigid_CT"),
        ("fid50k_full", "MR_MR_T2"), ("pr50k3_full", "MR_MR_T2")]
    assert all(np.isfinite(v) for r in metrics for v in r["results"].values())
    assert [(m, mo) for m, mo, _ in results] == [(r["metric"], r["mode"]) for r in metrics]
    assert os.path.getsize(os.path.join(outdir, "umap_coverage.png")) > 0
    # The verbose walk ran at batch 2, which writes no snapshots, so the
    # first slice was walked again at batch 1: one GIF of its K=2 steps.
    gifs = [f for f in os.listdir(outdir) if f.endswith(".gif")]
    assert len(gifs) == 1 and "[pipeline] trajectory GIFs" in out
    from PIL import Image
    assert Image.open(os.path.join(outdir, gifs[0])).n_frames == 2
    assert "DONE" in out


def test_pipeline_refuses_what_it_cannot_run(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with pytest.raises(SystemExit, match="--train produces a StyleGAN2 snapshot"):
        torch_run_pipeline.main(["--synthetic", "--arch", "stylegan3", "--train",
                                 "--device", "cpu"])
    with pytest.raises(SystemExit, match="--device cuda conflicts with --cpu"):
        torch_run_pipeline.main(["--synthetic", "--cpu", "--device", "cuda"])
    monkeypatch.setenv("LATAUG_PIPELINE_FORCE_CPU", "1")
    with pytest.raises(SystemExit, match="--device cuda conflicts"):
        torch_run_pipeline.main(["--synthetic", "--device", "cuda"])
    monkeypatch.delenv("LATAUG_PIPELINE_FORCE_CPU")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            torch_run_pipeline.main(["--synthetic"])  # --device defaults to cuda
    assert os.listdir(str(tmp_path)) == []  # nothing was built


def test_carry_vgg_env_survives_model_dir_overwrite(tmp_path, monkeypatch):
    """--train replaces opt.model_dir by a snapshot file: the LPIPS VGG16 is
    found in the original layout first and pinned in the environment."""
    layout = tmp_path / "models"
    layout.mkdir()
    vgg = layout / "vgg16_lpips.pkl"
    vgg.write_bytes(b"x")
    monkeypatch.delenv("LATENTAUGMENT_VGG16", raising=False)
    assert torch_run_pipeline.carry_vgg_env(str(layout)) == str(vgg)
    assert os.environ["LATENTAUGMENT_VGG16"] == str(vgg)
    # A variable already set wins.
    monkeypatch.setenv("LATENTAUGMENT_VGG16", "/explicit.pkl")
    assert torch_run_pipeline.carry_vgg_env(str(layout)) == "/explicit.pkl"
    # No VGG16 in the layout: None, and the environment is left alone.
    monkeypatch.delenv("LATENTAUGMENT_VGG16", raising=False)
    assert torch_run_pipeline.carry_vgg_env(str(tmp_path / "empty")) is None
    assert "LATENTAUGMENT_VGG16" not in os.environ
