"""The correctness check catches what would make the timed path wrong:
a run driven on the CPU at tiny sizes (the port's plain path), with the
timed path broken underneath, reads `correct` false under the cell's own
limits; and the control (the reference one precision step lower) fails
them too."""

import time

import numpy as np
import pytest
import torch

import tiny
from harness import check, spec, workspace
from reference import nets


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(workload, tmp, seed=9):
    import run

    cname, tname = tiny.CELLS[workload]
    return run.run_cell(tiny.BENCH, "fault-" + workload, tiny.config(cname), tiny.traffic(tname),
                        spec.limits(workload), seed, 0.2, False, device="cpu",
                        t_start=time.perf_counter(), work_root=str(tmp))[0]


def _state_unchanged(monkeypatch):
    from latentaugment_tpu_torch.augments import engine

    monkeypatch.setattr(engine, "_adam_update", lambda w, m, v, g, t, lr: (w, m, v))


def _half_batch(monkeypatch):
    from latentaugment_tpu_torch.augments import losses

    l2, disc = losses.l2_mean_loss, losses.disc_softplus_loss
    monkeypatch.setattr(losses, "l2_mean_loss",
                        lambda y, *a, **k: l2(y[:y.shape[0] // 2], *a, **k))
    monkeypatch.setattr(losses, "disc_softplus_loss", lambda x: disc(x[:x.shape[0] // 2]))


def _answer_altered(monkeypatch):
    from latentaugment_tpu_torch.augments.latent_aug import LatentAugment

    forward = LatentAugment.forward

    def altered(self):
        forward(self)
        self.real_AB_aug = np.roll(self.real_AB_aug, 1, axis=0)

    monkeypatch.setattr(LatentAugment, "forward", altered)


def _codes_altered(monkeypatch):
    from latentaugment_tpu_torch.augments.latent_aug import LatentAugment

    forward = LatentAugment.forward

    def altered(self):
        forward(self)
        self.w_AB_aug = np.roll(self.w_AB_aug, 1, axis=0)

    monkeypatch.setattr(LatentAugment, "forward", altered)


def _d_zeroed(monkeypatch):
    from latentaugment_tpu_torch.augments import losses

    disc = losses.disc_softplus_loss
    monkeypatch.setattr(losses, "disc_softplus_loss", lambda x: disc(torch.zeros_like(x)))


FAULTS = [("sg3t-walk-b16", f)
          for f in (_state_unchanged, _half_batch, _answer_altered, _codes_altered, _d_zeroed)]
FAULTS += [(w, f) for w in ("sg2-sample-b256", "sg3t-sample-b64")
           for f in (_answer_altered, _codes_altered)]


@pytest.mark.parametrize("workload,fault", FAULTS, ids=lambda x: getattr(x, "__name__", x))
def test_fault_reads_not_correct(workload, fault, monkeypatch, tmp_path):
    fault(monkeypatch)
    assert _run(workload, tmp_path)["correct"] is False


@pytest.mark.parametrize("workload", list(tiny.CELLS))
def test_control_fails_the_limits(workload, tmp_path):
    cname, tname = tiny.CELLS[workload]
    cfg, traffic = tiny.config(cname, res=64, num_fp16_res=4), tiny.traffic(tname)
    root = str(tmp_path)
    dev = torch.device("cpu")
    _, _, files, (names, imgs) = workspace.write_workspace(root, cfg, traffic, 21, dev)
    staged = workspace.stage_batches(names, imgs, traffic["batch"], traffic["staged_batches"])
    plan = check.sample_plan(traffic, 21)
    gaps = check.answers(None, files, cfg, traffic, plan, staged, 1, workspace.traffic_seed(21),
                         dev, candidate=check.Candidate(nets.Precision("control")))
    ok, _ = check.judge(gaps, spec.limits(workload))
    assert not ok, gaps


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cells' own sizes")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", list(tiny.CELLS))
def test_control_fails_the_limits_at_the_cells_size(workload, card):
    import control

    _, cfg, traffic, limits = spec.cell(spec.benchmark(tiny.ROOT), workload)
    ok, _ = check.judge(control.control_readings(workload, cfg, traffic, 31, card), limits)
    assert not ok


@pytest.mark.gpu
@pytest.mark.parametrize("fault", ["half", "d_zero"])
def test_walk_faults_fail_the_limits_at_the_cells_size(fault, card):
    import control

    workload = "sg3t-walk-b16"
    _, cfg, traffic, limits = spec.cell(spec.benchmark(tiny.ROOT), workload)
    gaps = control.control_readings(workload, cfg, traffic, 31, card, fault=fault)
    ok, _ = check.judge(gaps, limits)
    assert not ok, gaps
