"""The layer profiler of the port's walk (`latentaugment_tpu_torch.profile_walk`)
runs on the CPU at a small size: every layer time and the walk's are
positive, and its JSON file holds one record per --impl. Device times
need the card and are not checked here."""

import json

import pytest

from latentaugment_tpu_torch import profile_walk
from test_torch_port_common import _one_torch_thread  # noqa: F401 (autouse fixture)

SMALL = ["--device", "cpu", "--batch", "4", "--res", "32", "--channel_base", "256",
         "--channel_max", "32", "--crop_size", "16", "--num_epochs", "2", "--reps", "1"]


def test_profile_walk_runs_small_on_cpu(tmp_path):
    out = tmp_path / "profile.json"
    assert profile_walk.main(SMALL + ["--out", str(out)]) == 0
    results = json.loads(out.read_text())
    assert sorted(results) == ["auto", "ref"]
    for impl, r in results.items():
        assert r["impl"] == impl and r["num_epochs"] == 2
        for layer in ("G", "D", "VGG"):
            assert r[f"{layer}_fwd_ms"] > 0 and r[f"{layer}_fwd_bwd_ms"] > 0
        assert r["adam_step_ms"] > 0 and r["walk_ms"] > 0
        assert r["profiled_walk_wall_ms"] > 0
        assert "idle_share" not in r  # no device on the CPU


def test_profile_walk_runs_sg3_small_on_cpu(tmp_path):
    """--arch stylegan3 profiles the alias-free walk (batch given here; its
    default is 16)."""
    out = tmp_path / "profile_sg3.json"
    assert profile_walk.main(SMALL + ["--arch", "stylegan3", "--impl", "auto",
                                      "--out", str(out)]) == 0
    r = json.loads(out.read_text())["auto"]
    assert r["arch"] == "stylegan3" and r["batch"] == 4
    assert r["G_fwd_bwd_ms"] > 0 and r["walk_ms"] > 0


@pytest.mark.parametrize("name,kind", [
    ("void filtered_lrelu_kernel<__nv_bfloat16>(...)", "K3 filtered_lrelu"),
    ("void upfirdn2d_kernel<__nv_bfloat16>(__nv_bfloat16 const*, ...)", "K2 upfirdn2d"),
    ("bias_act_bwd", "K1 bias_act"),
    ("void at::native::conv_depthwise2d_forward_kernel<2, float, int>(...)",
     "plain FIR (depthwise conv)"),
    ("void cudnn::engines_precompiled::nhwcToNchwKernel<float, float>(...)",
     "cuDNN layout transforms"),
    ("void cudnn::detail::dgrad_engine<float, 512, 6, 5, 3, 3, 3, false>(...)",
     "cuDNN conv dgrad"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>(...)", "elementwise"),
    ("Memcpy DtoD (Device -> Device)", "memcpy/memset"),
    ("some_other_kernel", "other"),
])
def test_kernel_kinds(name, kind):
    assert profile_walk.kind_of(name) == kind
