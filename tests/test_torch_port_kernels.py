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

filtered_lrelu (K3) is held at 2e-2 in bfloat16 for values too: K3 rounds
once, the plain version at each of its four stages. Its backward is held
against the plain backward at the plain version's own sign/clamp record
(`_record_ref`): lrelu's derivative jumps at 0, and where an up-rate value
lies within rounding of 0 the two sides may take different branches (in
bf16 about one pixel in a thousand), which moves single gradients by a
good part of their range. K3's own record (2 bits per up-rate pixel, four
pixels per byte; compared unpacked) may differ from the plain one only on
such a sliver of pixels, and the public path must equal the backward
kernel at K3's own record.
"""

import pytest
import torch

from latentaugment_tpu_torch.ops import bias_act as ba
from latentaugment_tpu_torch.ops import filtered_lrelu as fl
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


# The separable variants at the walk's map sizes with an odd row length
# (rows start at 2-byte offsets): (x shape, arguments, forward variant,
# backward variant).
UPFIRDN_VARIANT_CASES = {
    "u1d1": ([2, 3, 257, 257], dict(padding=1, gain=4), "u1d1", "u1d1"),
    "u1d2": ([2, 3, 257, 257], dict(down=2, padding=1), "u1d2", "u2d1"),
    "u2d1": ([2, 3, 129, 129], dict(up=2, padding=(2, 1, 2, 1), gain=4), "u2d1", "u1d2"),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(UPFIRDN_VARIANT_CASES))
def test_upfirdn2d_variants_at_walk_shapes(cuda, name, dtype):
    shape, kw, fwd_variant, bwd_variant = UPFIRDN_VARIANT_CASES[name]
    f = up.setup_filter([1, 3, 3, 1], device=cuda, separable=True)
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)

    def fn(x, impl):
        return up.upfirdn2d(x, f, impl=impl, **kw)

    y_r = fn(x, "ref")
    assert y_r.shape[-1] % 2 == 1 or shape[-1] % 2 == 1
    dy = torch.randn(y_r.shape, generator=g, device=cuda).to(dtype)
    n = dict(up.variant_launches)
    y_k, dx_k = _fwd_bwd(fn, x, dy, "auto")
    want = dict(n)
    want[fwd_variant] += 1
    want[bwd_variant] += 1
    assert up.variant_launches == want
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
    # K2's run-time generic instantiation takes at most 64 taps per axis;
    # a larger filter is refused before any launch.
    f65 = up.setup_filter([1.0] * 65, device=cuda, separable=True)
    n = up.launches["upfirdn2d"]
    with pytest.raises(NotImplementedError, match="64 taps"):
        up.upfirdn2d(torch.zeros([1, 1, 80, 80], device=cuda), f65)
    assert up.launches["upfirdn2d"] == n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["radial 12x12 down 2", "24 taps up 4"])
def test_upfirdn2d_runtime_taps_match_plain(cuda, case, dtype):
    """K2 on StyleGAN3-R's filters (the R plan's L10 at a few channels):
    the radial filter through `generic` with its tap count at run time,
    the 1-D 24-tap up filter through `sepn`; 1e-5 in float32, 1e-2 in
    bfloat16, forward and backward."""
    g = torch.Generator(device=cuda).manual_seed(3)
    if case.startswith("radial"):
        f = torch.randn([12, 12], generator=g, device=cuda) / 12
        shape, kw, variant = [2, 8, 562, 562], dict(down=2), "generic"
    else:
        f = torch.randn([24], generator=g, device=cuda) / 24
        shape, kw = [2, 8, 148, 148], dict(up=4, padding=(-2, -5, -2, -5), gain=16)
        variant = "sepn"
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)

    def fn(x, impl):
        return up.upfirdn2d(x, f, impl=impl, **kw)

    n = up.variant_launches[variant]
    with torch.no_grad():
        dy = torch.randn(fn(x, "ref").shape, generator=g, device=cuda).to(dtype)
    y_k, dx_k = _fwd_bwd(fn, x, dy, "auto")
    y_r, dx_r = _fwd_bwd(fn, x, dy, "ref")
    assert up.variant_launches[variant] == n + 2
    assert _rel_err(y_k, y_r) <= TOL[dtype]
    assert _rel_err(dx_k, dx_r) <= TOL[dtype]


# `sepn` at the R plan's sizes (a few channels): (taps, input shape,
# arguments); each backward is `sepn` at the swapped rates.
SEPN_GPU_CASES = {
    "up 2, 12 taps, L11": (12, [2, 4, 276, 276], dict(up=2, padding=(11, 10, 11, 10), gain=4)),
    "up 2, 12 taps, odd width, corr": (12, [1, 3, 35, 41],
                                       dict(up=2, padding=(11, 9, 10, 11), gain=4,
                                            flip_filter=True)),
    "up 4, 24 taps, L10": (24, [2, 4, 148, 148], dict(up=4, padding=(-2, -5, -2, -5), gain=16)),
    "down 2, 12 taps, crop": (12, [2, 4, 562, 561], dict(down=2, padding=(-1, 2, 3, -2))),
    "down 4, 24 taps, odd width, corr": (24, [1, 3, 97, 101],
                                         dict(down=4, padding=(4, 3, 5, 6), flip_filter=True)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(SEPN_GPU_CASES))
def test_upfirdn2d_sepn_matches_plain(cuda, case, dtype):
    """K2's staged polyphase variant against the plain version: 1e-5 in
    float32, 1e-2 in bfloat16, forward and backward, both through
    `sepn`."""
    taps, shape, kw = SEPN_GPU_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(5)
    f = torch.randn([taps], generator=g, device=cuda) / taps
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)

    def fn(x, impl):
        return up.upfirdn2d(x, f, impl=impl, **kw)

    n = dict(up.variant_launches)
    with torch.no_grad():
        dy = torch.randn(fn(x, "ref").shape, generator=g, device=cuda).to(dtype)
    y_k, dx_k = _fwd_bwd(fn, x, dy, "auto")
    y_r, dx_r = _fwd_bwd(fn, x, dy, "ref")
    torch.cuda.synchronize()
    assert up.variant_launches == dict(n, sepn=n["sepn"] + 2)
    assert y_k.shape == y_r.shape and dx_k.shape == x.shape
    assert _rel_err(y_k, y_r) <= TOL[dtype]
    assert _rel_err(dx_k, dx_r) <= TOL[dtype]


def _second_order(fn, x, dy1, dy2, impl):
    """R1's and path length's pattern: g = d<fn(x), dy1>/dx with its graph,
    then d<g, dy2>/d(x, dy1) (a missing derivative as zeros)."""
    x = x.detach().requires_grad_(True)
    dy1 = dy1.detach().requires_grad_(True)
    g, = torch.autograd.grad(fn(x, impl), x, dy1, create_graph=True)
    gx, gdy = torch.autograd.grad(g, (x, dy1), dy2, allow_unused=True)
    return g, torch.zeros_like(x) if gx is None else gx, gdy


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("act, clamp, dtype", [
    ("lrelu", 256.0, F32), ("lrelu", None, F32), ("lrelu", None, BF16), ("relu", 0.5, F32),
    ("linear", None, F32), ("linear", None, BF16)])
def test_bias_act_second_derivative_matches_plain(cuda, act, clamp, dtype):
    """The rectifiers' dx is linear in dy: its derivative launches the
    backward kernel again, counted as bias_act_bwd2 (the clamp engaged in
    float32 only, as above)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x, dy1, dy2 = (torch.randn([4, 24, 9, 7], generator=g, device=cuda).to(dtype)
                   for _ in range(3))
    x = x * (300.0 if clamp == 256.0 else 1.0)
    b = torch.randn([24], generator=g, device=cuda).to(dtype)

    def fn(x, impl):
        return ba.bias_act(x, b, act=act, clamp=clamp, impl=impl)

    n = dict(ba.launches)
    got = _second_order(fn, x, dy1, dy2, "auto")
    assert ba.launches == {"bias_act_fwd": n["bias_act_fwd"] + 1,
                           "bias_act_bwd": n["bias_act_bwd"] + 1,
                           "bias_act_bwd2": n["bias_act_bwd2"] + 1}
    want = _second_order(fn, x, dy1, dy2, "ref")
    for k, r in zip(got, want):
        assert k.dtype == dtype and _rel_err(k, r) <= TOL_GRAD[dtype]
    assert not got[1].any()


def test_bias_act_second_derivative_of_a_smooth_activation_raises(cuda):
    x = torch.randn([2, 3, 4, 4], device=cuda, requires_grad=True)
    y = ba.bias_act(x, None, act="swish")
    g, = torch.autograd.grad(y.sum(), x, create_graph=True)
    with pytest.raises(NotImplementedError, match="impl='ref'"):
        torch.autograd.grad(g.sum(), x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(UPFIRDN_VARIANT_CASES))
def test_upfirdn2d_second_derivative_at_walk_shapes(cuda, name, dtype):
    """K2's backward is K2 again: the second derivative launches the
    forward's variant once more, never `generic`."""
    shape, kw, fwd_variant, bwd_variant = UPFIRDN_VARIANT_CASES[name]
    f = up.setup_filter([1, 3, 3, 1], device=cuda, separable=True)
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)

    def fn(x, impl):
        return up.upfirdn2d(x, f, impl=impl, **kw)

    dy1 = torch.randn(fn(x, "ref").shape, generator=g, device=cuda).to(dtype)
    dy2 = torch.randn(shape, generator=g, device=cuda).to(dtype)
    n = dict(up.variant_launches)
    got = _second_order(fn, x, dy1, dy2, "auto")
    n[fwd_variant] += 2
    n[bwd_variant] += 1
    assert up.variant_launches == n
    want = _second_order(fn, x, dy1, dy2, "ref")
    for k, r in zip(got, want):
        assert k.shape == r.shape and _rel_err(k, r) <= TOL_GRAD[dtype]


# filtered_lrelu (K3): the kinds of layer of the StyleGAN3-T 256 walk, at a
# few channels: (x shape, up taps, down taps, up, down, padding, gain, slope).
FLRELU_CASES = {
    "L0 up2 pad(9,8)": ([2, 4, 38, 38], 12, 12, 2, 2, (9, 8, 9, 8), None, 0.2),
    "L10 up4 crop(-6,-9)": ([2, 4, 150, 150], 24, 12, 4, 2, (-6, -9, -6, -9), None, 0.2),
    "L13 critical crop(-11,-12)": ([2, 3, 278, 278], 12, 12, 2, 2, (-11, -12, -11, -12),
                                   None, 0.2),
    "toRGB": ([2, 2, 256, 256], 1, 1, 1, 1, (0, 0, 0, 0), 1.0, 1.0),
    "asymmetric pad, down 1": ([3, 5, 17, 13], 12, 6, 2, 1, (5, 6, 4, 7), 1.0, 0.1),
    # out_w = 48, one whole tile: the last tile owns the record through to mid_w.
    "out_w a multiple of the tile": ([2, 3, 38, 50], 12, 12, 2, 2, (9, 8, 9, 8), None, 0.2),
}
# The variant each case's forward and backward must take.
FLRELU_VARIANTS = {
    "L0 up2 pad(9,8)": ("u2t12_d2t12", "u2t12_d2t12"),
    "L10 up4 crop(-6,-9)": ("u4t24_d2t12", "u2t12_d4t24"),
    "L13 critical crop(-11,-12)": ("u2t12_d2t12", "u2t12_d2t12"),
    "toRGB": ("u1t1_d1t1", "u1t1_d1t1"),
    "asymmetric pad, down 1": ("generic", "generic"),
    "out_w a multiple of the tile": ("u2t12_d2t12", "u2t12_d2t12"),
}
TOL_FL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
RECORD_SLIVER = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _flrelu_inputs(cuda, name, dtype, seed):
    """x, random asymmetric taps scaled so the up-rate values are O(|x|),
    and a bias."""
    shape, tu, td, up_, down, padding, gain, slope = FLRELU_CASES[name]
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    fu = torch.randn([tu], generator=g, device=cuda) / (tu * up_) ** 0.5 if tu > 1 else None
    fd = torch.randn([td], generator=g, device=cuda) / td ** 0.5 if td > 1 else None
    b = torch.randn([shape[1]], generator=g, device=cuda).to(dtype)
    return x, fu, fd, b, dict(up=up_, down=down, padding=padding, gain=gain, slope=slope)


def _check_flrelu(cuda, name, dtype, flip, clamp=None, seed=0):
    x, fu, fd, b, kw = _flrelu_inputs(cuda, name, dtype, seed)
    kw.update(clamp=clamp, flip_filter=flip)

    def fn(x, impl):
        return fl.filtered_lrelu(x, fu, fd, b, impl=impl, **kw)

    y_r = fn(x, "ref")
    g = torch.Generator(device=cuda).manual_seed(seed + 1)
    dy = torch.randn(y_r.shape, generator=g, device=cuda).to(dtype)
    n, nv = dict(fl.launches), dict(fl.variant_launches)
    y_k, dx_k = _fwd_bwd(fn, x, dy, "auto")
    assert fl.launches["filtered_lrelu_fwd"] == n["filtered_lrelu_fwd"] + 1
    assert fl.launches["filtered_lrelu_bwd"] == n["filtered_lrelu_bwd"] + 1
    for variant in FLRELU_VARIANTS[name]:
        nv[variant] += 1
    assert fl.variant_launches == nv
    y_r, dx_r = _fwd_bwd(fn, x, dy, "ref")
    assert y_k.shape == y_r.shape and y_k.dtype == dtype and dx_k.shape == x.shape
    assert _rel_err(y_k, y_r) <= TOL_FL[dtype]
    # The backward kernel at the plain version's record: same branches.
    gain = kw["gain"] if kw["gain"] is not None else 2 ** 0.5
    pad, up_, down, slope = kw["padding"], kw["up"], kw["down"], kw["slope"]
    rec_r = fl._record_ref(x, fu, b, up_, pad, gain, slope, clamp, flip)
    dx_m = fl._backward_kernel(dy, rec_r, tuple(x.shape[2:]), fu, fd, up_, down, pad, gain,
                               slope, flip)
    assert _rel_err(dx_m, dx_r) <= TOL_GRAD[dtype]
    # K3's own record differs from the plain one only on a sliver of pixels,
    # and the public path is the backward kernel at that record.
    _, rec_k = fl._forward_kernel(x, fu, fd, b, up_, down, pad, gain, slope, clamp, flip,
                                  need_record=True)
    assert rec_k.shape == rec_r.shape and rec_k.dtype == torch.uint8
    mid_w = fl._geometry(tuple(x.shape[2:]), 1 if fu is None else fu.shape[0],
                         1 if fd is None else fd.shape[0], up_, down, pad, False)["mid_hw"][1]
    assert rec_k.shape[-1] == -(-mid_w // 4)
    bits_k, bits_r = fl.unpack_record(rec_k, mid_w), fl.unpack_record(rec_r, mid_w)
    assert (bits_k != bits_r).float().mean().item() <= RECORD_SLIVER[dtype]
    dx_own = fl._backward_kernel(dy, rec_k, tuple(x.shape[2:]), fu, fd, up_, down, pad, gain,
                                 slope, flip)
    assert torch.equal(dx_k, dx_own)
    return x, fu, fd, b, kw


@pytest.mark.parametrize("flip", [False, True], ids=["conv", "corr"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(FLRELU_CASES))
def test_filtered_lrelu_kernel_matches_plain(cuda, name, dtype, flip):
    _check_flrelu(cuda, name, dtype, flip)


def test_filtered_lrelu_last_tile_owns_the_record_to_the_edge(cuda):
    """With out_w a whole number of tiles the tiles' cores stop short of
    mid_w by taps - down columns; the last tile writes those too."""
    name = "out_w a multiple of the tile"
    shape, tu, td, up_, down, padding, _, _ = FLRELU_CASES[name]
    sp = fl._geometry(tuple(shape[2:]), tu, td, up_, down, padding, False)
    plan = fl._plan(sp)
    assert sp["out_hw"][1] % plan["tow"] == 0
    assert sp["mid_hw"][1] > sp["out_hw"][1] * down
    x, fu, fd, b, kw = _flrelu_inputs(cuda, name, torch.float32, 5)
    gain = 2 ** 0.5
    _, rec_k = fl._forward_kernel(x, fu, fd, b, up_, down, padding, gain, 0.2, 0.5, False,
                                  need_record=True)
    rec_r = fl._record_ref(x, fu, b, up_, padding, gain, 0.2, 0.5, False)
    mid_w = sp["mid_hw"][1]
    differ = fl.unpack_record(rec_k, mid_w) != fl.unpack_record(rec_r, mid_w)
    assert differ.float().mean().item() <= RECORD_SLIVER[torch.float32]
    # The strip past the cores alone: unwritten bytes would differ on most pixels.
    assert differ[..., sp["out_hw"][1] * down:].float().mean().item() <= 1e-3


@pytest.mark.parametrize("name", ["L0 up2 pad(9,8)", "L10 up4 crop(-6,-9)", "toRGB"])
def test_filtered_lrelu_kernel_clamp_and_bias_grad(cuda, name):
    """float32 with the clamp engaged (the up-rate values are O(1), the
    clamp 0.5); the bias gradient is dx summed over N, H, W."""
    x, fu, fd, b, kw = _check_flrelu(cuda, name, torch.float32, flip=False, clamp=0.5, seed=3)
    rec = fl._record_ref(x, fu, b, kw["up"], kw["padding"], kw["gain"] or 2 ** 0.5,
                         kw["slope"], 0.5, False)
    assert (fl.unpack_record(rec, 4 * rec.shape[-1]) & 2).float().mean().item() > 0.05  # the clamp engages
    outs = []
    for impl in ("auto", "ref"):
        bg = b.detach().requires_grad_(True)
        y = fl.filtered_lrelu(x, fu, fd, bg, impl=impl, **kw)
        outs.append(torch.autograd.grad(y.square().sum(), bg)[0])
    assert _rel_err(outs[0], outs[1]) <= 1e-4


def test_filtered_lrelu_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros([1, 2, 16, 16], device=cuda)
    fu = torch.ones([12], device=cuda) / 12
    n = dict(fl.launches)
    # K3 handed a 2-D filter directly refuses it.
    with pytest.raises(NotImplementedError, match="1-D"):
        fl._FilteredLReluFunction.apply(x, torch.ones([4, 4], device=cuda), fu, None, 2, 2,
                                        (5, 5, 5, 5), 2 ** 0.5, 0.2, None, False)
    with pytest.raises(ValueError, match="constants"):
        fl.filtered_lrelu(x, fu.clone().requires_grad_(True), fu, up=2, down=2, padding=5)
    with pytest.raises(TypeError):
        fl.filtered_lrelu(x.half(), fu, fu, up=2, down=2, padding=5)
    assert fl.launches == n
    # filtered_lrelu takes the 2-D (radial) filters on the card through K1
    # and K2, never K3, and agrees with the plain version.
    fd2 = torch.ones([12, 12], device=cuda) / 144
    x = torch.randn([1, 2, 16, 16], device=cuda)
    nd, nu = dict(fl.decomposed_calls), up.launches["upfirdn2d"]
    y = fl.filtered_lrelu(x, fu, fd2, up=2, down=2, padding=5)
    assert fl.launches == n and up.launches["upfirdn2d"] == nu + 2
    assert fl.decomposed_calls["filtered_lrelu_decomposed"] == \
        nd["filtered_lrelu_decomposed"] + 1
    y_r = fl.filtered_lrelu(x, fu, fd2, up=2, down=2, padding=5, impl="ref")
    assert _rel_err(y, y_r) <= 1e-5
