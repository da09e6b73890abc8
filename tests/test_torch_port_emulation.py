"""The port's CUDA kernel sources, compiled for the host and run on the
CPU against the plain PyTorch versions.

There is no GPU or nvcc where these tests run, but there is a C++
compiler: `tests/cuda_host_stub/` stands in for the CUDA headers (one
std::thread per CUDA thread, a barrier for `__syncthreads()`), so the very
sources under `latentaugment_tpu_torch/csrc/` build into host libraries
and the wrappers' launch paths (plans, tap tables, records, tiles) run on
CPU tensors at small sizes. This holds the kernels' index arithmetic and
the launchers' checks; what only the card can show (that nvcc takes the
sources, alignment faults, times) stays with the `gpu`-marked tests and
chip_smoke.py. Tolerances as there: 1e-5 in float32, 2e-2 in bfloat16,
the backward at the plain version's own record.
"""

import contextlib
import ctypes
import os
import shutil
import subprocess
import types

import pytest
import torch

from latentaugment_tpu_torch.ops import _build
from latentaugment_tpu_torch.ops import bias_act as ba
from latentaugment_tpu_torch.ops import filtered_lrelu as fl
from latentaugment_tpu_torch.ops import upfirdn2d as up
from test_torch_port_common import _one_torch_thread  # noqa: F401 (autouse fixture)

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
RECORD_SLIVER = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture(scope="module")
def host_libraries(tmp_path_factory):
    """csrc/*.cu built by the host compiler against the stand-in headers."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    out = tmp_path_factory.mktemp("host_kernels")
    libs = {}
    for source in ("upfirdn2d.cu", "filtered_lrelu.cu"):
        lib = out / (source[:-3] + ".so")
        cmd = [cxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", "-w",
               "-I", os.path.join(HERE, "cuda_host_stub"), "-x", "c++",
               os.path.join(_build.CSRC_DIR, source), "-o", str(lib)]
        done = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        assert done.returncode == 0, done.stderr
        libs[source] = ctypes.CDLL(str(lib))
    return libs


@pytest.fixture
def ops_on_cpu():
    """The registered custom ops take CPU tensors for the test's duration:
    each op's real implementation (the launch path) is registered for the
    CPU in a scoped library, removed again on exit (the ops themselves
    have no CPU kernel)."""
    from torch.library import _scoped_library

    impls = {"bias_act_fwd": ba._bias_act_fwd_impl, "bias_act_bwd": ba._bias_act_bwd_impl,
             "upfirdn2d": up._upfirdn2d_impl, "filtered_lrelu_fwd": fl._filtered_lrelu_fwd_impl,
             "filtered_lrelu_bwd": fl._filtered_lrelu_bwd_impl}
    with _scoped_library("latentaugment_torch", "IMPL") as lib:
        for name, impl in impls.items():
            lib.impl(name, impl, "CPU")
        yield


@pytest.fixture
def emulated(host_libraries, monkeypatch, ops_on_cpu):
    """The wrappers' launch paths on CPU tensors: the host libraries in
    place of the nvcc-built ones, no device guard, stream 0, the custom
    ops registered for the CPU."""
    for source, lib in host_libraries.items():
        monkeypatch.setitem(_build._LIBS, source, lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1e-30)).item()


# filtered_lrelu: (x shape, up taps, down taps, up, down, padding, gain,
# slope, forward variant, backward variant). One or two planes: every
# block costs 256 host threads.
FLRELU_CASES = {
    "L0 up2 pad(9,8)": ([1, 2, 38, 38], 12, 12, 2, 2, (9, 8, 9, 8), 2 ** 0.5, 0.2,
                        "u2t12_d2t12", "u2t12_d2t12"),
    "L3 up4 crop(-6,-9)": ([1, 2, 38, 38], 24, 12, 4, 2, (-6, -9, -6, -9), 2 ** 0.5, 0.2,
                           "u4t24_d2t12", "u2t12_d4t24"),
    "L13 crop(-11,-12), smaller": ([1, 1, 70, 70], 12, 12, 2, 2, (-11, -12, -11, -12),
                                   2 ** 0.5, 0.2, "u2t12_d2t12", "u2t12_d2t12"),
    "asymmetric pad, up2 down2": ([1, 2, 41, 35], 12, 12, 2, 2, (7, 10, 4, 9), 1.3, 0.1,
                                  "u2t12_d2t12", "u2t12_d2t12"),
    "out_w a multiple of the tile": ([1, 1, 38, 50], 12, 12, 2, 2, (9, 8, 9, 8), 1.3, 0.1,
                                     "u2t12_d2t12", "u2t12_d2t12"),
    "toRGB": ([2, 2, 20, 23], 1, 1, 1, 1, (0, 0, 0, 0), 1.0, 1.0, "u1t1_d1t1", "u1t1_d1t1"),
    "asymmetric pad, down 1": ([2, 3, 17, 13], 12, 6, 2, 1, (5, 6, 4, 7), 1.0, 0.1,
                               "generic", "generic"),
    "up 1, down 2": ([1, 2, 30, 27], 1, 12, 1, 2, (3, 4, 5, 2), 1.0, 0.1,
                     "generic", "generic"),
}
FLRELU_MODES = {"f32-conv": (torch.float32, False, None), "f32-corr-clamp": (torch.float32, True, 0.5),
                "bf16-conv": (torch.bfloat16, False, None)}


@pytest.mark.parametrize("mode", list(FLRELU_MODES))
@pytest.mark.parametrize("name", list(FLRELU_CASES))
def test_filtered_lrelu_sources_match_plain(emulated, name, mode):
    shape, tu, td, up_, down, pad, gain, slope, fwd_variant, bwd_variant = FLRELU_CASES[name]
    dtype, flip, clamp = FLRELU_MODES[mode]
    g = torch.Generator().manual_seed(len(name))
    x = torch.randn(shape, generator=g).to(dtype)
    fu = torch.randn([tu], generator=g) / (tu * up_) ** 0.5 if tu > 1 else None
    fd = torch.randn([td], generator=g) / td ** 0.5 if td > 1 else None
    b = torch.randn([shape[1]], generator=g).to(dtype)

    xr = x.clone().requires_grad_(True)
    y_r = fl._filtered_lrelu_ref(xr, fu, fd, b, up_, down, pad, gain, slope, clamp, flip)
    dy = torch.randn(y_r.shape, generator=g).to(dtype)
    dx_r, = torch.autograd.grad(y_r, xr, dy)
    rec_r = fl._record_ref(x, fu, b, up_, pad, gain, slope, clamp, flip)

    n, nv = dict(fl.launches), dict(fl.variant_launches)
    y_k, rec_k = fl._forward_kernel(x, fu, fd, b, up_, down, pad, gain, slope, clamp, flip,
                                    need_record=True)
    dx_k = fl._backward_kernel(dy, rec_r, tuple(shape[2:]), fu, fd, up_, down, pad, gain,
                               slope, flip)
    assert fl.launches == {"filtered_lrelu_fwd": n["filtered_lrelu_fwd"] + 1,
                           "filtered_lrelu_bwd": n["filtered_lrelu_bwd"] + 1}
    nv[fwd_variant] += 1
    nv[bwd_variant] += 1
    assert fl.variant_launches == nv
    assert y_k.shape == y_r.shape and y_k.dtype == dtype and dx_k.shape == x.shape
    assert _rel_err(y_k, y_r.detach()) <= TOL[dtype]
    assert _rel_err(dx_k, dx_r) <= TOL[dtype]
    mid_w = fl._geometry(tuple(shape[2:]), tu, td, up_, down, pad, False)["mid_hw"][1]
    assert rec_k.shape == rec_r.shape
    differ = fl.unpack_record(rec_k, mid_w) != fl.unpack_record(rec_r, mid_w)
    assert differ.float().mean().item() <= RECORD_SLIVER[dtype]
    if clamp is not None:
        assert (fl.unpack_record(rec_k, mid_w) & 2).float().mean().item() > 0.05
    # Without the record the values are the same (the final synthesis under no_grad).
    y_n, none = fl._forward_kernel(x, fu, fd, b, up_, down, pad, gain, slope, clamp, flip,
                                   need_record=False)
    assert none is None and torch.equal(y_n, y_k)


UPFIRDN_CASES = {
    "G blur": (dict(up=1, down=1, padding=(1, 1, 1, 1), gain=4), "u1d1", "u1d1"),
    "D blur": (dict(up=1, down=1, padding=(2, 2, 2, 2), gain=1), "u1d1", "u1d1"),
    "D skip": (dict(up=1, down=2, padding=(1, 1, 1, 1), gain=1), "u1d2", "u2d1"),
    "upsample2d": (dict(up=2, down=1, padding=(2, 1, 2, 1), gain=4), "u2d1", "u1d2"),
    "up 2, odd pad, corr": (dict(up=2, down=1, padding=(1, 2, 3, 0), gain=4, flip_filter=True),
                            "u2d1", "u1d2"),
    "down 2, crop, corr": (dict(up=1, down=2, padding=(-1, 3, 0, 2), gain=2, flip_filter=True),
                           "u1d2", "u2d1"),
    "up 2 down 2": (dict(up=2, down=2, padding=(-1, 3, 0, 2), gain=2, flip_filter=True),
                    "generic", "generic"),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [[2, 2, 17, 13], [1, 1, 40, 141]], ids=["17x13", "40x141"])
@pytest.mark.parametrize("name", list(UPFIRDN_CASES))
def test_upfirdn2d_sources_match_plain(emulated, name, shape, dtype):
    kw, fwd_variant, bwd_variant = UPFIRDN_CASES[name]
    # Asymmetric taps where the case flips, so that the flip shows.
    f = up.setup_filter([1.0, 2.0, 4.0, 0.5] if kw.get("flip_filter") else [1, 3, 3, 1],
                        separable=True)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(shape, generator=g).to(dtype)
    args = (up._parse_scaling(kw["up"]), up._parse_scaling(kw["down"]),
            up._parse_padding(kw["padding"]), bool(kw.get("flip_filter", False)),
            float(kw["gain"]))
    xr = x.clone().requires_grad_(True)
    y_r = up._upfirdn2d_ref(xr, f, kw["up"], kw["down"], kw["padding"], args[3], kw["gain"])
    dy = torch.randn(y_r.shape, generator=g).to(dtype)
    dx_r, = torch.autograd.grad(y_r, xr, dy)
    n, nv = up.launches["upfirdn2d"], dict(up.variant_launches)
    xk = x.clone().requires_grad_(True)
    y_k = up._Upfirdn2dFunction.apply(xk, f, *args)
    dx_k, = torch.autograd.grad(y_k, xk, dy)
    nv[fwd_variant] += 1
    nv[bwd_variant] += 1
    assert up.launches["upfirdn2d"] == n + 2 and up.variant_launches == nv
    assert y_k.shape == y_r.shape and y_k.dtype == dtype
    assert _rel_err(y_k, y_r.detach()) <= TOL[dtype]
    assert _rel_err(dx_k, dx_r) <= TOL[dtype]


def test_upfirdn2d_2d_filter_takes_the_generic_kernel(emulated):
    f = up.setup_filter([1, 3, 3, 1], separable=False)
    x = torch.randn([2, 2, 17, 13], generator=torch.Generator().manual_seed(2))
    nv = dict(up.variant_launches)
    y_k = up._launch(x, f, (1, 1), (1, 1), (1, 1, 1, 1), False, 4.0)
    nv["generic"] += 1
    assert up.variant_launches == nv
    assert _rel_err(y_k, up._upfirdn2d_ref(x, f, 1, 1, 1, False, 4)) <= 1e-5


# StyleGAN3-R's layers on the decomposed filtered_lrelu, as the 256x256
# plan (generator_config(use_radial_filters=True, conv_kernel=1)) gives
# them, at a few pixels: the 1-D up filter (12 taps at up 2, 24 at up 4)
# and the radial 12x12 down filter at down 2, each forward and backward
# through the run-time generic instantiation.
SG3R_CASES = {
    "radial fd 12x12, down 2": ([1, 2, 30, 27], (12, 12), dict(down=2), "generic"),
    "radial fd 12x12, down 2, corr": ([2, 1, 29, 30], (12, 12),
                                      dict(down=2, flip_filter=True), "generic"),
    "fu 12 taps, up 2, pad (11,10)": ([1, 2, 9, 11], (12,),
                                      dict(up=2, padding=(11, 10, 11, 10), gain=4), "generic"),
    "fu 24 taps, up 4, crop (-2,-5)": ([1, 1, 9, 10], (24,),
                                       dict(up=4, padding=(-2, -5, -2, -5), gain=16), "generic"),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(SG3R_CASES))
def test_upfirdn2d_sg3r_filters_through_the_runtime_taps(emulated, name, dtype):
    """K2 `generic` with its tap count at run time on the R plan's filters
    against the plain version: 1e-5 in float32, 1e-2 in bfloat16."""
    shape, f_shape, kw, variant = SG3R_CASES[name]
    g = torch.Generator().manual_seed(len(name))
    f = torch.randn(f_shape, generator=g) / f_shape[0]
    x = torch.randn(shape, generator=g).to(dtype)
    args = (up._parse_scaling(kw.get("up", 1)), up._parse_scaling(kw.get("down", 1)),
            up._parse_padding(kw.get("padding", 0)), bool(kw.get("flip_filter", False)),
            float(kw.get("gain", 1)))
    plan = up._plan(f_shape, *args[:2], (1, 1))
    assert plan == dict(variant=variant)
    xr = x.clone().requires_grad_(True)
    y_r = up._upfirdn2d_ref(xr, f, *args[:2], kw.get("padding", 0), args[3], args[4])
    dy = torch.randn(y_r.shape, generator=g).to(dtype)
    dx_r, = torch.autograd.grad(y_r, xr, dy)
    n, nv = up.launches["upfirdn2d"], dict(up.variant_launches)
    xk = x.clone().requires_grad_(True)
    y_k = up._Upfirdn2dFunction.apply(xk, f, *args)
    dx_k, = torch.autograd.grad(y_k, xk, dy)
    nv[variant] += 2
    assert up.launches["upfirdn2d"] == n + 2 and up.variant_launches == nv
    assert y_k.shape == y_r.shape and y_k.dtype == dtype and dx_k.shape == x.shape
    tol = {torch.float32: 1e-5, torch.bfloat16: 1e-2}[dtype]
    assert _rel_err(y_k, y_r.detach()) <= tol
    assert _rel_err(dx_k, dx_r) <= tol


def test_sg3r_decomposed_filtered_lrelu_through_the_sources(emulated, monkeypatch):
    """The decomposed form with impl='auto', as filtered_lrelu runs it for a
    CUDA tensor and a 2-D fd (the route itself: test_torch_port_plans.py):
    both FIRs through the host-built K2 `generic` (run-time taps), the two
    bias_act steps through K1's stand-in launchers, never K3; against the
    plain version at the R plan's L0 geometry, 1e-5 in float32."""
    monkeypatch.setattr(ba, "_launch_fwd", _bias_act_fwd_stub)
    monkeypatch.setattr(ba, "_launch_bwd", _bias_act_bwd_stub)
    impls = []
    up_ = up  # the module; `up` is the rate below

    def upfirdn2d_on_card(x, f, up=1, down=1, padding=0, flip_filter=False, gain=1,
                          impl="auto"):
        impls.append(impl)
        return up_._Upfirdn2dFunction.apply(
            x, f, up_._parse_scaling(up), up_._parse_scaling(down),
            up_._parse_padding(padding), bool(flip_filter), float(gain))

    def bias_act_on_card(x, b=None, dim=1, act="linear", alpha=None, gain=None, clamp=None,
                         impl="auto"):
        impls.append(impl)
        spec = ba.activation_funcs[act]
        return ba._BiasActFunction.apply(
            x, b, dim, act, spec.def_alpha if alpha is None else float(alpha),
            spec.def_gain if gain is None else float(gain), -1.0 if clamp is None else clamp)

    monkeypatch.setattr(fl, "upfirdn2d", upfirdn2d_on_card)
    monkeypatch.setattr(fl, "bias_act", bias_act_on_card)
    g = torch.Generator().manual_seed(5)
    x = torch.randn([1, 2, 14, 14], generator=g)
    fu = torch.randn([12], generator=g) / 12
    fd = torch.randn([12, 12], generator=g) / 144
    b = torch.randn([2], generator=g)
    args = (2, 2, (11, 10, 11, 10), 2 ** 0.5, 0.2, 0.5, False)
    n_k3, n_ba = dict(fl.launches), dict(ba.launches)
    n_up = up.variant_launches["generic"]
    xk = x.clone().requires_grad_(True)
    y_k = fl._decomposed(xk, fu, fd, b, *args, impl="auto")
    dy = torch.randn(y_k.shape, generator=g)
    dx_k, = torch.autograd.grad(y_k, xk, dy)
    monkeypatch.undo()
    assert impls == ["auto"] * 4
    assert fl.launches == n_k3
    assert up.variant_launches["generic"] == n_up + 4  # two FIRs, forward and backward
    assert ba.launches["bias_act_fwd"] == n_ba["bias_act_fwd"] + 2
    xr = x.clone().requires_grad_(True)
    y_r = fl._filtered_lrelu_ref(xr, fu, fd, b, *args)
    dx_r, = torch.autograd.grad(y_r, xr, dy)
    assert _rel_err(y_k, y_r) <= 1e-5
    assert _rel_err(dx_k, dx_r) <= 1e-5


def test_launchers_refuse_a_plan_that_does_not_fit(host_libraries):
    """A launcher checks the plan it is handed: shared memory that is not
    its own formula's, a tile it cannot split, a variant it was not
    compiled for. 1 is the stand-in's cudaErrorInvalidValue."""
    k3 = host_libraries["filtered_lrelu.cu"].filtered_lrelu_tiled_launch
    i, f, p, ll = ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_longlong
    k3.argtypes = [p] * 4 + [i, ll, i] + [i] * 6 + [i] * 12 + [p] * 3 + [f, f, f, p]
    sp = fl._geometry((38, 38), 12, 12, 2, 2, (9, 8, 9, 8), False)
    plan = fl._plan(sp)
    x = torch.zeros([1, 1, 38, 38])
    y = torch.zeros([1, 1, *sp["out_hw"]])
    taps = (ctypes.c_float * 28)()

    def launch(up_=2, down=2, backward=0, toh=plan["toh"], tow=plan["tow"], smem=plan["smem"]):
        return k3(x.data_ptr(), None, y.data_ptr(), None, 0, 1, 1, 38, 38, *sp["mid_hw"],
                  *sp["out_hw"], up_, down, backward, 0, 0, 0, 0, toh, tow, plan["mh"],
                  plan["mw"], smem, ctypes.addressof(taps), ctypes.addressof(taps),
                  ctypes.addressof(taps), 0.2, 1.0, -1.0, None)

    assert launch() == 0
    assert launch(smem=plan["smem"] + 16) == 1
    assert launch(toh=plan["toh"] + 1) == 1
    assert launch(tow=plan["tow"] + 4) == 1  # the mid tile no longer covers it
    assert launch(up_=4, down=4) == 1
    assert launch(up_=2, down=4, backward=0) == 1  # compiled for the backward only

    k2 = host_libraries["upfirdn2d.cu"].upfirdn2d_sep4_launch
    k2.argtypes = [p, p, i, ll] + [i] * 11 + [p] * 3
    plan2 = up._plan((4,), (1, 1), (1, 1), (38, 38))
    x2 = torch.zeros([1, 1, 39, 39])

    def launch2(up_=1, down=1, smem=plan2["smem"], tow=plan2["tow"]):
        return k2(x2.data_ptr(), y.data_ptr(), 0, 1, 39, 39, 36, 36, up_, down, 1, 1,
                  plan2["toh"], tow, smem, ctypes.addressof(taps), ctypes.addressof(taps), None)

    assert launch2() == 0
    assert launch2(smem=plan2["smem"] - 4) == 1
    assert launch2(tow=plan2["tow"] + 2) == 1
    assert launch2(up_=2, down=2) == 1

    # The generic kernel: the filter's size picks the unrolled
    # instantiation (at most 4 taps per axis) or the run-time one (at most 64).
    kg = host_libraries["upfirdn2d.cu"].upfirdn2d_launch
    kg.argtypes = [p] * 3 + [i, ll] + [i] * 14 + [f, p]
    f64 = torch.zeros([64, 64])

    def launch_g(taps):
        return kg(x2.data_ptr(), y.data_ptr(), f64.data_ptr(), 0, 1, 39, 39, 14, 14, 1, 1,
                  2, 2, 0, 0, taps, taps, 0, 0, 1.0, None)

    assert launch_g(12) == 0
    assert launch_g(4) == 0
    assert launch_g(64) == 0
    assert launch_g(65) == 1


def _second_order(fn, x, dy1, dy2):
    """g = d<fn(x), dy1>/dx with its graph, then d<g, dy2>/d(x, dy1):
    (y, g, d/dx, d/d dy1), a missing derivative as zeros."""
    x = x.detach().requires_grad_(True)
    dy1 = dy1.detach().requires_grad_(True)
    y = fn(x)
    g, = torch.autograd.grad(y, x, dy1, create_graph=True)
    gx, gdy = torch.autograd.grad(g, (x, dy1), dy2, allow_unused=True)
    gx = torch.zeros_like(x) if gx is None else gx
    return y.detach(), g.detach(), gx, gdy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["G blur", "D blur", "D skip", "upsample2d"])
def test_upfirdn2d_second_derivative_sources_match_plain(emulated, name, dtype):
    """R1 and path length differentiate K2's backward: it is K2 again,
    through the same sources (forward, backward, and the backward's
    backward in the forward's variant), against the plain version."""
    kw, fwd_variant, bwd_variant = UPFIRDN_CASES[name]
    f = up.setup_filter([1, 3, 3, 1], separable=True)
    g = torch.Generator().manual_seed(3)
    x = torch.randn([2, 2, 17, 13], generator=g).to(dtype)
    args = (up._parse_scaling(kw["up"]), up._parse_scaling(kw["down"]),
            up._parse_padding(kw["padding"]), False, float(kw["gain"]))
    y_shape = up._upfirdn2d_ref(x, f, kw["up"], kw["down"], kw["padding"], False,
                                kw["gain"]).shape
    dy1 = torch.randn(y_shape, generator=g).to(dtype)
    dy2 = torch.randn(x.shape, generator=g).to(dtype)
    ref = _second_order(lambda x: up._upfirdn2d_ref(x, f, kw["up"], kw["down"], kw["padding"],
                                                    False, kw["gain"]), x, dy1, dy2)
    n, nv = up.launches["upfirdn2d"], dict(up.variant_launches)
    got = _second_order(lambda x: up._Upfirdn2dFunction.apply(x, f, *args), x, dy1, dy2)
    nv[fwd_variant] += 2
    nv[bwd_variant] += 1
    assert up.launches["upfirdn2d"] == n + 3 and up.variant_launches == nv
    for k, r in zip(got[:2] + got[3:], ref[:2] + ref[3:]):
        assert k.shape == r.shape and k.dtype == dtype
        assert _rel_err(k, r) <= TOL[dtype]
    assert not got[2].any() and not ref[2].any()  # K2 is linear: no d/dx


# K1 is Triton, which has no host build: its two launchers are replaced by
# torch versions of the kernels' formulas, which holds the autograd wiring
# of `_BiasActFunction` / `_BiasActGradFunction` (which kernel each
# derivative launches, and under which counter) on CPU tensors.

def _bias_act_fwd_stub(x, b, y, dim, act, alpha, gain, clamp):
    y.copy_(ba._bias_act_ref(x.float(), None if b is None else b.float(), dim, act, alpha,
                             gain, clamp))
    ba.launches["bias_act_fwd"] += 1


def _bias_act_bwd_stub(dy, x, b, y, dx, dim, act, alpha, gain, clamp, counter):
    g = dy.float() * gain
    yf = y.float()
    if act == "relu":
        g = torch.where(yf * gain > 0, g, 0.0)
    elif act == "lrelu":
        g = torch.where(yf * gain > 0, g, g * alpha)
    elif act != "linear":
        raise NotImplementedError(act)
    if clamp >= 0:
        g = torch.where(yf.abs() < clamp, g, 0.0)
    dx.copy_(g)
    ba.launches[counter] += 1


@pytest.mark.parametrize("clamp", [None, 0.5], ids=["noclamp", "clamp"])
@pytest.mark.parametrize("act", ["linear", "relu", "lrelu"])
def test_bias_act_second_derivative_launches_the_backward_kernel(monkeypatch, ops_on_cpu, act,
                                                                 clamp):
    monkeypatch.setattr(ba, "_launch_fwd", _bias_act_fwd_stub)
    monkeypatch.setattr(ba, "_launch_bwd", _bias_act_bwd_stub)
    g = torch.Generator().manual_seed(4)
    x = torch.randn([3, 5, 4, 6], generator=g)
    b = torch.randn([5], generator=g)
    dy1, dy2 = torch.randn(x.shape, generator=g), torch.randn(x.shape, generator=g)
    spec = ba.activation_funcs[act]
    cfg = (1, act, spec.def_alpha, spec.def_gain, -1.0 if clamp is None else clamp)
    ref = _second_order(lambda x: ba._bias_act_ref(x, b, 1, *cfg[1:]), x, dy1, dy2)
    n = dict(ba.launches)
    got = _second_order(lambda x: ba._BiasActFunction.apply(x, b, *cfg), x, dy1, dy2)
    assert ba.launches == {"bias_act_fwd": n["bias_act_fwd"] + 1,
                           "bias_act_bwd": n["bias_act_bwd"] + 1,
                           "bias_act_bwd2": n["bias_act_bwd2"] + 1}
    for k, r in zip(got, ref):
        torch.testing.assert_close(k, r, rtol=1e-6, atol=1e-6)
    assert not got[2].any()  # d/dx of dx is zero for the rectifiers
    # The bias gradient is a torch reduction of dx: its own derivative
    # with respect to dy reaches the backward kernel again.
    xg, bg, dyg = (t.clone().requires_grad_(True) for t in (x, b, dy1))
    y = ba._BiasActFunction.apply(xg, bg, *cfg)
    _, gb = torch.autograd.grad(y, (xg, bg), dyg, create_graph=True)
    gdy, = torch.autograd.grad(gb.square().sum(), dyg)
    yr = ba._bias_act_ref(xg, bg, 1, *cfg[1:])
    _, gbr = torch.autograd.grad(yr, (xg, bg), dyg, create_graph=True)
    gdyr, = torch.autograd.grad(gbr.square().sum(), dyg)
    torch.testing.assert_close(gdy, gdyr, rtol=1e-6, atol=1e-6)


def test_bias_act_second_derivative_of_a_smooth_activation_raises(monkeypatch, ops_on_cpu):
    monkeypatch.setattr(ba, "_launch_fwd", _bias_act_fwd_stub)
    monkeypatch.setattr(ba, "_launch_bwd", lambda *a, **k: None)
    x = torch.randn([2, 3, 4, 4], requires_grad=True)
    y = ba._BiasActFunction.apply(x, None, 1, "tanh", 0.0, 1.0, -1.0)
    g, = torch.autograd.grad(y.sum(), x, create_graph=True)
    with pytest.raises(NotImplementedError, match="impl='ref'"):
        torch.autograd.grad(g.sum(), x)
