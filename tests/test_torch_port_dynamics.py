"""The port's training-dynamics check and sustained-run driver
(scripts/torch_check_train_run.py, scripts/torch_sustained_train.py)
against the JAX package's scripts/check_train_run.py and
scripts/sustained_train.py.

check_rows must give the JAX verdict on every input: the same summary
dict where the run passes, the same AssertionError message where it
fails, on the committed TPU runs, the committed negative control and
every crafted-row case of tests/test_train_dynamics.py. The phantom
dataset must be the JAX one byte for byte for one seed. The plot is
written with or without matplotlib, and one CPU smoke run of the driver
reaches the check.
"""

import io
import os
import pickle
import subprocess
import sys
import zipfile

import numpy as np
import pytest

from scripts import check_train_run as jax_check
from scripts import sustained_train as jax_sustained
from scripts import torch_check_train_run as port_check
from scripts import torch_sustained_train as port_sustained
from test_torch_port_common import _one_torch_thread  # noqa: F401 (autouse fixture)
from test_train_dynamics import _rows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _separated_riding():
    rows = _rows(d_real_slope=+0.0005)
    for r in rows:
        r["Loss/D/real"] = min(r["Loss/D/real"] - 0.55, 0.6)
    return rows


def _exploding_d_gen():
    rows = _rows(rt=1.0, d_real_slope=-0.02)
    for i, r in enumerate(rows):
        r["Loss/D/gen"] = 30.0 * (i + 1)
        r["Loss/D/real"] = 1e-12
    return rows


def _artifact(name):
    return lambda: jax_check.load_log(os.path.join(REPO, "artifacts", name))


# (rows, check_rows keyword arguments): test_train_dynamics.py's crafted
# cases and the committed runs.
CASES = {
    "healthy": (_rows, dict(expect_kimg=1.0)),
    "nonfinite": (lambda: _rows(nan_at=17), {}),
    "d_not_learning": (lambda: _rows(d_real_slope=+0.01), {}),
    "d_separated_riding": (_separated_riding, {}),
    "ada_wrong_direction": (lambda: _rows(rt=0.95, dp=-0.002), {}),
    "ada_below_target_p_falls": (lambda: _rows(rt=0.1, dp=-0.001, p0=0.5), {}),
    "ada_below_target_p_rises": (lambda: _rows(rt=0.1, dp=+0.002), {}),
    "ada_saturated_cap": (lambda: _rows(rt=0.95, dp=0.0, p0=1.0), {}),
    "short_run": (lambda: _rows(n=2), {}),
    "kimg_coverage": (_rows, dict(expect_kimg=100.0)),
    "exploding_d_gen": (_exploding_d_gen, dict(expect_kimg=1.0)),
    "no_ada": (lambda: _rows(rt=0.95, dp=-0.002), dict(require_ada=False)),
    "sustained_train_r4": (_artifact("sustained_train_r4"), dict(expect_kimg=10.0)),
    "sustained_train_r5_128": (_artifact("sustained_train_r5_128"), dict(expect_kimg=10.0)),
    "negative_control_r5": (_artifact("negative_control_r5"), dict(expect_kimg=0.6)),
}


def _verdict(check_rows, rows, kw):
    try:
        return "pass", check_rows(rows, **kw)
    except AssertionError as e:
        return "fail", str(e)


@pytest.mark.parametrize("case", list(CASES))
def test_check_rows_gives_the_jax_verdict(case):
    make, kw = CASES[case]
    want = _verdict(jax_check.check_rows, make(), kw)
    got = _verdict(port_check.check_rows, make(), kw)
    assert got == want


def test_committed_runs_keep_their_verdicts():
    """The negative control fails with its named reason, the TPU runs pass
    with D separated, and the port's loader reads the same rows."""
    for name in ("sustained_train_r4", "sustained_train_r5_128", "negative_control_r5"):
        path = os.path.join(REPO, "artifacts", name)
        assert port_check.load_log(path) == jax_check.load_log(path)
    with pytest.raises(AssertionError, match="D/gen exploded"):
        port_check.check_rows(port_check.load_log(
            os.path.join(REPO, "artifacts", "negative_control_r5")), expect_kimg=0.6)
    for name in ("sustained_train_r4", "sustained_train_r5_128"):
        s = port_check.check_rows(port_check.load_log(os.path.join(REPO, "artifacts", name)),
                                  expect_kimg=10.0)
        assert s["d_real_last"] < 0.7 and s["kimg"] >= 10.0


@pytest.mark.parametrize("res", [32, 64])
def test_phantom_zip_is_the_jax_one(tmp_path, res):
    paths = {}
    for name, mod in (("jax", jax_sustained), ("port", port_sustained)):
        paths[name] = str(tmp_path / f"{name}.zip")
        mod.make_phantom_zip(paths[name], res, n_patients=2, slices_per_patient=3, seed=0)
    with zipfile.ZipFile(paths["jax"]) as zj, zipfile.ZipFile(paths["port"]) as zp:
        assert zj.namelist() == zp.namelist() and len(zj.namelist()) == 6
        for name in zj.namelist():
            assert zj.read(name) == zp.read(name)
        img = pickle.load(io.BytesIO(zp.read(zp.namelist()[0])))
    assert sorted(img) == sorted(port_sustained.MODALITIES)
    assert all(v.shape == (res, res) and 0 <= v.min() and v.max() <= 255 for v in img.values())


_PLOT_CHILD = r"""
import sys
sys.modules["matplotlib"] = None  # import matplotlib raises ImportError
from scripts import torch_check_train_run as c
rows = c.load_log(sys.argv[1])
print(c.plot(rows, sys.argv[2]))
assert "matplotlib" not in [m for m in sys.modules if sys.modules[m] is not None]
"""


@pytest.mark.parametrize("matplotlib", ["absent", "present"])
def test_plot_writes_dynamics_png(tmp_path, matplotlib):
    from PIL import Image

    run = os.path.join(REPO, "artifacts", "sustained_train_r4")
    out = str(tmp_path / "dynamics.png")
    if matplotlib == "absent":
        env = dict(os.environ, PYTHONPATH=REPO)
        r = subprocess.run([sys.executable, "-c", _PLOT_CHILD, run, out], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr[-2000:]
    else:
        pytest.importorskip("matplotlib")
        assert port_check.plot(port_check.load_log(run), out) == out
    with Image.open(out) as img:
        assert img.format == "PNG" and img.size[0] > 400 and img.size[1] > 400
        assert len(img.convert("RGB").getcolors(1 << 20)) > 3  # curves drawn, not a blank page


def test_check_main_writes_summary_and_plot(tmp_path, capsys):
    run = tmp_path / "run"
    run.mkdir()
    (run / "log.jsonl").write_bytes(
        open(os.path.join(REPO, "artifacts", "sustained_train_r4", "log.jsonl"), "rb").read())
    s = port_check.main([str(run), "--kimg", "10"])
    assert s["plot"] == str(run / "dynamics.png") and os.path.isfile(s["plot"])
    assert '"rows": 32' in capsys.readouterr().out


def test_sustained_smoke_run_reaches_the_check(tmp_path, capsys):
    """The driver end to end at the smoke point on the CPU, cut to 0.16
    kimg (40 steps at batch 4: the check's 4 log rows): phantom dataset ->
    torch_train_sg2 -> the dynamics check -> artifacts."""
    art = str(tmp_path / "art")
    summary = port_sustained.main(["--smoke", "--device", "cpu", "--kimg", "0.16",
                                   "--artifacts", art])
    assert "[sustained] OK" in capsys.readouterr().out
    assert summary["rows"] == 4 and summary["kimg"] == pytest.approx(0.16)
    for f in ("log.jsonl", "dynamics.png", "summary.json"):
        assert os.path.isfile(os.path.join(art, f))
    rows = port_check.load_log(art)
    assert all(np.isfinite(r["Loss/G/loss"]) for r in rows)


def test_sustained_on_cuda_without_cuda_raises(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("CUDA is available: --device cuda is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_sustained.main(["--smoke", "--kimg", "0.01", "--artifacts", str(tmp_path)])
