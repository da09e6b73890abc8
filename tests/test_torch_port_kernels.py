"""The port's hand-written kernels against their plain PyTorch versions, on
the card. Marked `gpu`; they skip where there is no CUDA device. Run on
the machine with the card (--noconftest leaves out the suite's JAX set-up):

    python -m pytest tests/test_torch_port_kernels.py -m gpu --noconftest -q

Tolerances, as max |kernel - plain| / max |plain|: 1e-5 in float32
(TF32 off on the plain side), 1e-2 in bfloat16 and 2e-2 for bf16
gradients (the plain version rounds to bf16 after every op, three or four
of them in a gradient; the kernels round once). The clamp is tested in
float32 only: in bf16 the plain version clamps the rounded value and lets
the gradient through at |y| == clamp, while the kernel masks on the saved
output (|y| < clamp), so rounding ties differ by design.
"""

import pytest
import torch

from latentaugment_tpu_torch.ops import bias_act as ba
from latentaugment_tpu_torch.ops import upfirdn2d as up

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
TOL_GRAD = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1e-30)).item()


def _fwd_bwd(fn, x, dy, impl):
    x = x.detach().requires_grad_(True)
    y = fn(x, impl)
    dx, = torch.autograd.grad(y, x, dy)
    return y, dx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("act", sorted(ba.activation_funcs))
def test_bias_act_kernel_matches_plain(cuda, act, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn([4, 24, 9, 7], generator=g, device=cuda).to(dtype)
    b = torch.randn([24], generator=g, device=cuda).to(dtype)
    dy = torch.randn(x.shape, generator=g, device=cuda).to(dtype)
    for clamp in ((None, 0.5) if dtype == torch.float32 else (None,)):
        def fn(x, impl):
            return ba.bias_act(x, b, act=act, clamp=clamp, impl=impl)
        n = dict(ba.launches)
        y_k, dx_k = _fwd_bwd(fn, x, dy, "auto")
        assert ba.launches["bias_act_fwd"] == n["bias_act_fwd"] + 1
        assert ba.launches["bias_act_bwd"] == n["bias_act_bwd"] + 1
        y_r, dx_r = _fwd_bwd(fn, x, dy, "ref")
        assert y_k.dtype == dtype and dx_k.dtype == dtype
        assert _rel_err(y_k, y_r) <= TOL[dtype], (act, clamp)
        assert _rel_err(dx_k, dx_r) <= TOL_GRAD[dtype], (act, clamp)


@pytest.mark.parametrize("act", ["relu", "lrelu"])
def test_bias_act_kernel_negative_gain(cuda, act):
    """The rectifiers' backward reads the sign of x + b from the saved
    output; a negative gain flips that sign."""
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn([4, 24, 9, 7], generator=g, device=cuda)
    b = torch.randn([24], generator=g, device=cuda)
    dy = torch.randn(x.shape, generator=g, device=cuda)
    for clamp in (None, 0.5):
        def fn(x, impl):
            return ba.bias_act(x, b, act=act, gain=-1.5, clamp=clamp, impl=impl)
        y_k, dx_k = _fwd_bwd(fn, x, dy, "auto")
        y_r, dx_r = _fwd_bwd(fn, x, dy, "ref")
        assert _rel_err(y_k, y_r) <= TOL[torch.float32], clamp
        assert _rel_err(dx_k, dx_r) <= TOL_GRAD[torch.float32], clamp


def test_bias_act_kernel_fc_rows_and_bias_grad(cuda):
    x = torch.randn([32, 512], device=cuda, requires_grad=True)
    b = torch.randn([512], device=cuda, requires_grad=True)
    outs = []
    for impl in ("auto", "ref"):
        y = ba.bias_act(x, b, act="lrelu", impl=impl)
        outs.append((y,) + torch.autograd.grad(y.square().sum(), (x, b)))
    for k, r in zip(*outs):
        assert _rel_err(k, r) <= 1e-5


UPFIRDN_CASES = [
    dict(up=1, down=1, padding=(1, 1, 1, 1), gain=4),       # G blur after the up-conv
    dict(up=1, down=1, padding=(2, 2, 2, 2), gain=1),       # D blur before the stride-2 conv
    dict(up=1, down=2, padding=(1, 1, 1, 1), gain=1),       # D 1x1 skip
    dict(up=2, down=1, padding=(2, 1, 2, 1), gain=4),       # skip-image upsample2d
    dict(up=2, down=2, padding=(-1, 3, 0, 2), gain=2, flip_filter=True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", UPFIRDN_CASES, ids=lambda c: f"up{c['up']}-down{c['down']}-pad{c['padding']}")
@pytest.mark.parametrize("separable", [True, False], ids=["sep", "2d"])
def test_upfirdn2d_kernel_matches_plain(cuda, case, dtype, separable):
    f = up.setup_filter([1, 3, 3, 1], device=cuda, separable=separable)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn([3, 5, 17, 13], generator=g, device=cuda).to(dtype)

    def fn(x, impl):
        return up.upfirdn2d(x, f, impl=impl, **case)

    y_r = fn(x, "ref")
    dy = torch.randn(y_r.shape, generator=g, device=cuda).to(dtype)
    n = up.launches["upfirdn2d"]
    y_k, dx_k = _fwd_bwd(fn, x, dy, "auto")
    assert up.launches["upfirdn2d"] == n + 2  # forward and backward
    y_r, dx_r = _fwd_bwd(fn, x, dy, "ref")
    assert y_k.shape == y_r.shape and dx_k.shape == x.shape
    assert _rel_err(y_k, y_r) <= TOL[dtype]
    assert _rel_err(dx_k, dx_r) <= TOL_GRAD[dtype]


def test_kernels_refuse_what_they_do_not_take(cuda):
    f = up.setup_filter([1, 3, 3, 1], device=cuda, separable=True)
    with pytest.raises(TypeError):
        up.upfirdn2d(torch.zeros([1, 1, 8, 8], device=cuda, dtype=torch.float16), f)
    with pytest.raises(ValueError):
        up.upfirdn2d(torch.zeros([1, 1, 8, 8], device=cuda), f.clone().requires_grad_(True))
    # K2 unrolls at most 4 taps per axis; a larger filter is refused.
    f8 = up.setup_filter([1, 3, 3, 1, 1, 3, 3, 1], device=cuda, separable=True)
    n = up.launches["upfirdn2d"]
    with pytest.raises(NotImplementedError, match="4 taps"):
        up.upfirdn2d(torch.zeros([1, 1, 16, 16], device=cuda), f8)
    assert up.launches["upfirdn2d"] == n
