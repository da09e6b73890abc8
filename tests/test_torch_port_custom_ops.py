"""The kernels' registered custom ops (`latentaugment_torch::*`), through
which every launch of K1, K2 and K3 goes and which `torch.export`
records.

Each op's fake version (what export traces) must give the output shape
and dtype of the plain version, from shapes alone, at the walks' shapes:
both run on `meta` tensors, so the full-size cases cost nothing. The ops
exist after importing `latentaugment_tpu_torch.ops` alone, have no CPU
kernel (a CPU tensor raises), and the wrappers hand a CUDA tensor that
needs no gradient to the op itself (traced here on fake CUDA tensors,
which need no card). The autograd Functions around the ops are held in
tests/test_torch_port_emulation.py.
"""

import math
import os
import subprocess
import sys

import pytest
import torch

from latentaugment_tpu_torch.models.stylegan3 import networks as net3
from latentaugment_tpu_torch.ops import bias_act as ba
from latentaugment_tpu_torch.ops import filtered_lrelu as fl
from latentaugment_tpu_torch.ops import upfirdn2d as up
from test_torch_port_common import _one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = ("bias_act_fwd", "bias_act_bwd", "bias_act_grad2", "upfirdn2d", "filtered_lrelu_fwd",
       "filtered_lrelu_bwd", "filtered_lrelu_lin")
META = torch.device("meta")
bf16, f32 = torch.bfloat16, torch.float32


def _op(name):
    return getattr(torch.ops.latentaugment_torch, name)


def _same(got, want):
    assert got.device.type == "meta" and tuple(got.shape) == tuple(want.shape)
    assert got.dtype == want.dtype


# K1 at the SG2 walk's shapes (chip_smoke phase 1): (shape, dtype, act, clamp).
BIAS_ACT_CASES = {
    "G conv 256x256 lrelu clamp bf16": ([32, 128, 256, 256], bf16, "lrelu", 256.0),
    "G conv 256x256 lrelu clamp f32": ([32, 128, 256, 256], f32, "lrelu", 256.0),
    "D skip 128x128 linear": ([32, 256, 128, 128], bf16, "linear", -1.0),
    "mapping / D FC [32,512]": ([32, 512], f32, "lrelu", -1.0),
    "tanh (x kept for the backward)": ([8, 64, 32, 32], bf16, "tanh", -1.0),
}


@pytest.mark.parametrize("case", list(BIAS_ACT_CASES))
def test_bias_act_fakes_match_the_plain_version(case):
    shape, dtype, act, clamp = BIAS_ACT_CASES[case]
    x = torch.empty(shape, device=META, dtype=dtype)
    b = torch.empty([shape[1]], device=META, dtype=dtype)
    spec = ba.activation_funcs[act]
    cfg = (1, act, spec.def_alpha, spec.def_gain, clamp)
    want = ba._bias_act_ref(x, b, 1, *cfg[1:])
    y = _op("bias_act_fwd")(x, b, *cfg)
    _same(y, want)
    saved_x = x if act not in ba._ACTS_FROM_Y else None
    _same(_op("bias_act_bwd")(y, saved_x, b, y, *cfg, "bias_act_bwd"), x)
    if saved_x is not None:  # a smooth activation's second derivative: (ddy, dv)
        for got, want in zip(_op("bias_act_grad2")(y, y, x, b, y, *cfg),
                             ba._bias_act_grad2_ref(y, y, x, b, y, *cfg)):
            _same(got, want)


_F4 = up.setup_filter([1, 3, 3, 1], separable=True)
# K2 at the SG2 walk's shapes and SG3-R's radial 2-D filter:
# (shape, dtype, filter, up, down, padding, gain).
UPFIRDN2D_CASES = {
    "G blur after up-conv (257->256)": ([32, 128, 257, 257], bf16, _F4, 1, 1, 1, 4),
    "D blur before stride-2 (256->257)": ([32, 128, 256, 256], bf16, _F4, 1, 1, 2, 1),
    "D 1x1 skip down=2 (256->128)": ([32, 128, 256, 256], bf16, _F4, 1, 2, 1, 1),
    "skip-image upsample2d (128->256)": ([32, 2, 128, 128], f32, _F4, 2, 1, (2, 1, 2, 1), 4),
    "SG3-R L10 radial 12x12 down 2": ([16, 512, 562, 562], bf16, torch.ones([12, 12]), 1, 2, 0,
                                      1),
    "SG3-R L10 24 taps up 4": ([16, 512, 148, 148], bf16, torch.ones([24]), 4, 1,
                               (-6, -9, -6, -9), 16),
}


@pytest.mark.parametrize("case", list(UPFIRDN2D_CASES))
def test_upfirdn2d_fake_matches_the_plain_version(case):
    shape, dtype, f, u, d, padding, gain = UPFIRDN2D_CASES[case]
    x = torch.empty(shape, device=META, dtype=dtype)
    fm = f.to(META)
    want = up._upfirdn2d_ref(x, fm, u, d, padding, False, gain)
    got = _op("upfirdn2d")(x, fm, list(up._parse_scaling(u)), list(up._parse_scaling(d)),
                           list(up._parse_padding(padding)), False, float(gain))
    _same(got, want)
    # The backward launch: up and down swapped, the padding transposed.
    p = up.transposed_padding(shape, got.shape, up._get_filter_size(f), up._parse_scaling(u),
                              up._parse_scaling(d), up._parse_padding(padding))
    dx = _op("upfirdn2d")(got, fm, list(up._parse_scaling(d)), list(up._parse_scaling(u)),
                          list(p), True, float(gain))
    _same(dx, x)


# K3 at the SG3-T walk's layers (chip_smoke phase 1b).
FLRELU_CASES = {"L10 up4 crop(-6,-9)": ("L10", [16, 256, 150, 150], bf16),
                "L8 up2 pad(9,8)": ("L8", [16, 512, 150, 150], bf16),
                "toRGB": ("L14", [16, 2, 256, 256], bf16),
                "L0 f32": ("L0", [16, 512, 38, 38], f32)}


@pytest.mark.parametrize("case", list(FLRELU_CASES))
def test_filtered_lrelu_fakes_match_the_plain_version(case):
    lname, shape, dtype = FLRELU_CASES[case]
    layer = {lay.name.split("_")[0]: lay for lay in net3.generator_config().layers}[lname]
    fu, fd = (None if f is None else torch.as_tensor(f, device=META)
              for f in net3._layer_filters(layer))
    lo, hi = layer.padding
    padding = (lo, hi, lo, hi)
    gain, slope = (1.0, 1.0) if layer.is_torgb else (math.sqrt(2.0), 0.2)
    x = torch.empty(shape, device=META, dtype=dtype)
    b = torch.empty([shape[1]], device=META, dtype=dtype)
    args = (layer.up_factor, layer.down_factor, list(padding), gain, slope, 256.0, False)
    want = fl._filtered_lrelu_ref(x, fu, fd, b, layer.up_factor, layer.down_factor, padding,
                                  gain, slope, 256.0, False)
    rec_want = fl._record_ref(x, fu, b, layer.up_factor, padding, gain, slope, 256.0, False)
    y, record = _op("filtered_lrelu_fwd")(x, fu, fd, b, *args, True)
    _same(y, want)
    _same(record, rec_want)
    y, none = _op("filtered_lrelu_fwd")(x, fu, fd, b, *args, False)
    _same(y, want)
    assert tuple(none.shape) == (0,) and none.dtype == torch.uint8
    dx = _op("filtered_lrelu_bwd")(want, record, fu, fd, list(shape[2:]), layer.up_factor,
                                   layer.down_factor, list(padding), gain, slope, False)
    _same(dx, x)
    # The linearised forward (the backward's derivative): the forward's shape.
    ddy = _op("filtered_lrelu_lin")(x, b, record, fu, fd, layer.up_factor, layer.down_factor,
                                    list(padding), gain, slope, False)
    _same(ddy, want)


def test_fakes_refuse_what_the_kernels_refuse():
    x = torch.empty([2, 3, 16, 16], device=META, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _op("upfirdn2d")(x, _F4.to(META), [1, 1], [1, 1], [1, 1, 1, 1], False, 1.0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        _op("filtered_lrelu_fwd")(x, None, None, None, 1, 1, [0, 0, 0, 0], 1.0, 0.2, None,
                                  False, False)
    with pytest.raises(NotImplementedError, match="1-D"):
        _op("filtered_lrelu_fwd")(x.float(), torch.empty([4, 4], device=META), None, None, 2,
                                  1, [1, 1, 1, 1], 1.0, 0.2, None, False, False)


def test_ops_are_registered_by_importing_ops_alone():
    child = ("import sys, torch\n"
             "import latentaugment_tpu_torch.ops\n"
             f"for name in {OPS!r}:\n"
             "    print(getattr(torch.ops.latentaugment_torch, name).default._schema)\n"
             "assert 'latentaugment_tpu_torch.models' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", child], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.count("latentaugment_torch::") == len(OPS)


@pytest.mark.parametrize("name", OPS)
def test_op_on_a_cpu_tensor_raises(name):
    x = torch.zeros([1, 2, 8, 8])
    f = torch.ones([4]) / 4
    args = {
        "bias_act_fwd": (x, None, 1, "lrelu", 0.2, 1.0, -1.0),
        "bias_act_bwd": (x, None, None, x, 1, "lrelu", 0.2, 1.0, -1.0, "bias_act_bwd"),
        "bias_act_grad2": (x, x, x, None, x, 1, "tanh", 0.0, 1.0, -1.0),
        "upfirdn2d": (x, f, [1, 1], [1, 1], [1, 2, 1, 2], False, 1.0),
        "filtered_lrelu_fwd": (x, None, None, None, 1, 1, [0, 0, 0, 0], 1.0, 0.2, None, False,
                               False),
        "filtered_lrelu_bwd": (x, torch.zeros([2, 8, 2], dtype=torch.uint8), None, None,
                               [8, 8], 1, 1, [0, 0, 0, 0], 1.0, 0.2, False),
        "filtered_lrelu_lin": (x, None, torch.zeros([2, 8, 2], dtype=torch.uint8), None, None,
                               1, 1, [0, 0, 0, 0], 1.0, 0.2, False),
    }[name]
    n = {k: dict(c) for k, c in (("ba", ba.launches), ("up", up.launches),
                                 ("fl", fl.launches))}
    with pytest.raises(NotImplementedError, match="CPU"):
        _op(name)(*args)
    assert n == {k: dict(c) for k, c in (("ba", ba.launches), ("up", up.launches),
                                         ("fl", fl.launches))}


def _traced_targets(fn, *shapes, requires_grad=False):
    """The ops a call of `fn` on fake CUDA tensors of `shapes` records."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        args = [torch.empty(s, device="cuda").requires_grad_(requires_grad) for s in shapes]
        gm = make_fx(fn, tracing_mode="fake")(*args)
    return {str(n.target) for n in gm.graph.nodes if n.op == "call_function"}


@pytest.mark.parametrize("kernel", ["bias_act", "upfirdn2d", "filtered_lrelu"])
def test_wrappers_hand_cuda_tensors_to_the_ops(kernel):
    """Under no_grad (as `torch.export` traces a served program) the op
    itself is recorded; the plain versions' ops are not."""
    fn, shapes, op = {
        "bias_act": (lambda x, b: ba.bias_act(x, b, act="lrelu", clamp=256),
                     ([4, 8, 16, 16], [8]), "bias_act_fwd"),
        "upfirdn2d": (lambda x: up.upfirdn2d(x, _F4.to(x.device), padding=1, gain=4),
                      ([4, 8, 17, 17],), "upfirdn2d"),
        "filtered_lrelu": (lambda x: fl.filtered_lrelu(x, torch.ones([12], device=x.device),
                                                       torch.ones([12], device=x.device),
                                                       up=2, down=2, padding=(9, 8, 9, 8)),
                           ([4, 8, 38, 38],), "filtered_lrelu_fwd"),
    }[kernel]
    with torch.no_grad():
        targets = _traced_targets(fn, *shapes)
    assert f"latentaugment_torch.{op}.default" in targets
    assert not any("convolution" in t or "leaky_relu" in t for t in targets)
