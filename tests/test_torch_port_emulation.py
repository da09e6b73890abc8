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
             "bias_act_grad2": ba._bias_act_grad2_impl,
             "upfirdn2d": up._upfirdn2d_impl, "filtered_lrelu_fwd": fl._filtered_lrelu_fwd_impl,
             "filtered_lrelu_bwd": fl._filtered_lrelu_bwd_impl,
             "filtered_lrelu_lin": fl._filtered_lrelu_lin_impl}
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

    # The linearised forward (the backward's derivative) on a random ddx
    # and bias cotangent, against its plain form at the same record.
    ddx = torch.randn(shape, generator=g).to(dtype)
    ddb = torch.randn([shape[1]], generator=g).to(dtype)
    ddy_r = fl._linearised(ddx, ddb, rec_r, fu, fd, up_, down, pad, gain, slope, flip)

    n, nv = dict(fl.launches), dict(fl.variant_launches)
    y_k, rec_k = fl._forward_kernel(x, fu, fd, b, up_, down, pad, gain, slope, clamp, flip,
                                    need_record=True)
    dx_k = fl._backward_kernel(dy, rec_r, tuple(shape[2:]), fu, fd, up_, down, pad, gain,
                               slope, flip)
    ddy_k = fl._lin_kernel(ddx, ddb, rec_r, fu, fd, up_, down, pad, gain, slope, flip)
    assert fl.launches == {"filtered_lrelu_fwd": n["filtered_lrelu_fwd"] + 1,
                           "filtered_lrelu_bwd": n["filtered_lrelu_bwd"] + 1,
                           "filtered_lrelu_lin": n["filtered_lrelu_lin"] + 1}
    nv[fwd_variant] += 2  # the linearised forward runs the forward's geometry
    nv[bwd_variant] += 1
    assert fl.variant_launches == nv
    assert y_k.shape == y_r.shape and y_k.dtype == dtype and dx_k.shape == x.shape
    assert ddy_k.shape == y_r.shape and ddy_k.dtype == dtype
    assert _rel_err(y_k, y_r.detach()) <= TOL[dtype]
    assert _rel_err(dx_k, dx_r) <= TOL[dtype]
    assert _rel_err(ddy_k, ddy_r) <= TOL[dtype]
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
# through `sepn`, and the radial 12x12 down filter at down 2 through `f2d`,
# each forward and backward.
SG3R_CASES = {
    "radial fd 12x12, down 2": ([1, 2, 30, 27], (12, 12), dict(down=2), "f2d"),
    "radial fd 12x12, down 2, corr": ([2, 1, 29, 30], (12, 12),
                                      dict(down=2, flip_filter=True), "f2d"),
    "fu 12 taps, up 2, pad (11,10)": ([1, 2, 9, 11], (12,),
                                      dict(up=2, padding=(11, 10, 11, 10), gain=4), "sepn"),
    "fu 24 taps, up 4, crop (-2,-5)": ([1, 1, 9, 10], (24,),
                                       dict(up=4, padding=(-2, -5, -2, -5), gain=16), "sepn"),
}


def _fwd_bwd_against_plain(shape, f_shape, kw, variant, dtype, seed):
    """K2 through the autograd Function on a random filter of `f_shape`,
    forward and backward, against the plain version: both launches in
    `variant`, 1e-5 in float32, 1e-2 in bfloat16."""
    g = torch.Generator().manual_seed(seed)
    f = torch.randn(f_shape, generator=g) / f_shape[0]
    x = torch.randn(shape, generator=g).to(dtype)
    args = (up._parse_scaling(kw.get("up", 1)), up._parse_scaling(kw.get("down", 1)),
            up._parse_padding(kw.get("padding", 0)), bool(kw.get("flip_filter", False)),
            float(kw.get("gain", 1)))
    plan = up._plan(f_shape, *args[:2], (1, 1))
    assert plan["variant"] == variant
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(SG3R_CASES))
def test_upfirdn2d_sg3r_filters_through_the_runtime_taps(emulated, name, dtype):
    """K2 on the R plan's filters against the plain version: the radial
    filter (and its backward at up 2) through `f2d`, the 1-D up filters
    (and their backwards at down 2 and 4) through `sepn`; 1e-5 in float32,
    1e-2 in bfloat16."""
    _fwd_bwd_against_plain(*SG3R_CASES[name], dtype, len(name))


# `generic`'s run-time-tap instantiation (more than 4 taps an axis) on
# filters and rates no staged variant takes, forward and backward (the
# backward is `generic` again, up and down swapped).
GENERIC_RUNTIME_CASES = {
    "12x12, down 3": ([1, 2, 30, 27], (12, 12), dict(down=3)),
    "8x8, down 2, crop, corr": ([2, 1, 29, 30], (8, 8),
                                dict(down=2, padding=(-1, 2, 3, -2), flip_filter=True)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(GENERIC_RUNTIME_CASES))
def test_upfirdn2d_generic_runtime_taps_match_plain(emulated, name, dtype):
    """`upfirdn2d_kernel<0, T>` against the plain version: 1e-5 in
    float32, 1e-2 in bfloat16."""
    _fwd_bwd_against_plain(*GENERIC_RUNTIME_CASES[name], "generic", dtype, len(name))


# `sepn` called directly at a few pixels: each of its four (up, down, taps)
# rows, odd and even output widths, padding and crops, both flips, and
# maps of more than one tile each way. The backward is `sepn` again (up
# and down swapped).
SEPN_CASES = {
    "up 2, 12 taps, odd out_w": ([1, 2, 9, 11], 12, dict(up=2, padding=(11, 9, 11, 10), gain=4)),
    "up 2, 12 taps, 2x2 tiles": ([1, 1, 36, 66], 12, dict(up=2, padding=(11, 10, 11, 10), gain=4)),
    "up 4, 24 taps, crop, corr": ([3, 1, 9, 10], 24,
                                  dict(up=4, padding=(-2, -5, -3, -4), gain=16, flip_filter=True)),
    "down 2, 12 taps, crop, corr": ([1, 2, 30, 27], 12,
                                    dict(down=2, padding=(-1, 2, 3, -2), flip_filter=True)),
    "down 4, 24 taps, even out_w": ([2, 1, 41, 50], 24, dict(down=4, padding=(5, 6, 2, 3))),
    "down 4, 24 taps, odd out_w, crop": ([1, 1, 45, 53], 24,
                                         dict(down=4, padding=(-3, 0, 1, -1), gain=2)),
    "down 4, 24 taps, 2x2 tiles": ([1, 1, 80, 150], 24, dict(down=4, padding=(10, 11, 10, 11))),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(SEPN_CASES))
def test_upfirdn2d_sepn_sources_match_plain(emulated, name, dtype):
    """K2's staged polyphase variant against the plain version, forward
    and backward: 1e-5 in float32, 1e-2 in bfloat16."""
    shape, taps, kw = SEPN_CASES[name]
    g = torch.Generator().manual_seed(len(name))
    f = torch.randn([taps], generator=g) / taps
    x = torch.randn(shape, generator=g).to(dtype)
    args = (up._parse_scaling(kw.get("up", 1)), up._parse_scaling(kw.get("down", 1)),
            up._parse_padding(kw["padding"]), bool(kw.get("flip_filter", False)),
            float(kw.get("gain", 1)))
    xr = x.clone().requires_grad_(True)
    y_r = up._upfirdn2d_ref(xr, f, *args[:2], kw["padding"], args[3], args[4])
    dy = torch.randn(y_r.shape, generator=g).to(dtype)
    dx_r, = torch.autograd.grad(y_r, xr, dy)
    n, nv = up.launches["upfirdn2d"], dict(up.variant_launches)
    xk = x.clone().requires_grad_(True)
    y_k = up._Upfirdn2dFunction.apply(xk, f, *args)
    dx_k, = torch.autograd.grad(y_k, xk, dy)
    assert up.launches["upfirdn2d"] == n + 2 and up.variant_launches == dict(nv, sepn=nv["sepn"] + 2)
    assert y_k.shape == y_r.shape and y_k.dtype == dtype and dx_k.shape == x.shape
    if "odd" in name:
        assert y_k.shape[3] % 2 == 1
    if "tiles" in name:
        plan = up._plan((taps,), *args[:2], tuple(y_k.shape[2:]))
        assert y_k.shape[2] > plan["toh"] and y_k.shape[3] > plan["tow"]
    tol = {torch.float32: 1e-5, torch.bfloat16: 1e-2}[dtype]
    assert _rel_err(y_k, y_r.detach()) <= tol
    assert _rel_err(dx_k, dx_r) <= tol


# `f2d` called through the autograd Function at a few pixels: the radial
# 12x12 filter at down 2 and at up 2 (the backward of the other), odd and
# even output widths, padding and crops (both parities: the up-2 phases'
# shifts), both flips, several planes a block, maps smaller than one tile
# and, with the plan's tiles cut (`tiles`), maps of 2x2 tiles and more.
F2D_CASES = {
    "down 2, odd out_w": ([1, 2, 31, 32], dict(down=2), None),
    "down 2, crop, corr": ([2, 1, 30, 29], dict(down=2, padding=(-1, 2, 3, -2),
                                                flip_filter=True), None),
    "down 2, mixed pad parity": ([1, 1, 25, 27], dict(down=2, padding=(2, 1, 1, 4)), None),
    "up 2, odd pad": ([1, 2, 9, 11], dict(up=2, padding=(11, 10, 11, 10), gain=4), None),
    "up 2, even pad, corr": ([1, 1, 10, 9], dict(up=2, padding=(10, 9, 8, 11), gain=4,
                                                 flip_filter=True), None),
    "down 2, 2x2 tiles": ([1, 1, 32, 32], dict(down=2), {(1, 2): (8, 8), (2, 1): (8, 16)}),
    "up 2, 2x2 tiles, 12 planes": ([3, 4, 9, 10], dict(up=2, padding=(11, 10, 11, 10), gain=4),
                                   {(1, 2): (8, 8), (2, 1): (16, 16)}),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(F2D_CASES))
def test_upfirdn2d_f2d_sources_match_plain(emulated, monkeypatch, name, dtype):
    """K2's staged 2-D polyphase variant against the plain version: the
    value, the backward (`f2d` at the other rate) and the backward's
    backward (`f2d` at the first rate again), 1e-5 in float32, 1e-2 in
    bfloat16."""
    shape, kw, tiles = F2D_CASES[name]
    if tiles is not None:
        monkeypatch.setattr(up, "_F2D_TILES", tiles)
    g = torch.Generator().manual_seed(len(name))
    f = torch.randn([12, 12], generator=g) / 12
    x = torch.randn(shape, generator=g).to(dtype)
    args = (up._parse_scaling(kw.get("up", 1)), up._parse_scaling(kw.get("down", 1)),
            up._parse_padding(kw.get("padding", 0)), bool(kw.get("flip_filter", False)),
            float(kw.get("gain", 1)))

    def ref(x):
        return up._upfirdn2d_ref(x, f, *args[:2], kw.get("padding", 0), args[3], args[4])

    y_shape = ref(x).shape
    dy1 = torch.randn(y_shape, generator=g).to(dtype)
    dy2 = torch.randn(x.shape, generator=g).to(dtype)
    want = _second_order(ref, x, dy1, dy2)
    n, nv = up.launches["upfirdn2d"], dict(up.variant_launches)
    got = _second_order(lambda x: up._Upfirdn2dFunction.apply(x, f, *args), x, dy1, dy2)
    assert up.launches["upfirdn2d"] == n + 3 and up.variant_launches == dict(nv, f2d=nv["f2d"] + 3)
    if "odd" in name:
        assert y_shape[3] % 2 == 1 or x.shape[3] % 2 == 1
    if tiles is not None:
        for rates, hw in ((args[:2], y_shape[2:]), (args[1::-1], x.shape[2:])):
            plan = up._plan((12, 12), *rates, tuple(hw))
            assert hw[0] > plan["toh"] and hw[1] > plan["tow"]
    tol = {torch.float32: 1e-5, torch.bfloat16: 1e-2}[dtype]
    for k, r in zip(got[:2] + got[3:], want[:2] + want[3:]):
        assert k.shape == r.shape and k.dtype == dtype
        assert _rel_err(k, r) <= tol
    assert not got[2].any() and not want[2].any()  # K2 is linear: no d/dx


def test_sg3r_decomposed_filtered_lrelu_through_the_sources(emulated, monkeypatch):
    """The decomposed form with impl='auto', as filtered_lrelu runs it for a
    CUDA tensor and a 2-D fd (the route itself: test_torch_port_plans.py):
    both FIRs through the host-built K2 (the 1-D up filter through `sepn`,
    the radial down filter through `f2d`), the two
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
    n_up = dict(up.variant_launches)
    xk = x.clone().requires_grad_(True)
    y_k = fl._decomposed(xk, fu, fd, b, *args, impl="auto")
    dy = torch.randn(y_k.shape, generator=g)
    dx_k, = torch.autograd.grad(y_k, xk, dy)
    monkeypatch.undo()
    assert impls == ["auto"] * 4
    assert fl.launches == n_k3
    # The 1-D up FIR through `sepn`, the 2-D down FIR through `f2d`, each
    # forward and backward.
    assert up.variant_launches == dict(n_up, sepn=n_up["sepn"] + 2, f2d=n_up["f2d"] + 2)
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

    # `sepn`: its four (up, down, taps) rows only, its own shared memory,
    # tiles its items split.
    ks = host_libraries["upfirdn2d.cu"].upfirdn2d_sepn_launch
    ks.argtypes = [p, p, i, ll] + [i] * 12 + [p] * 3
    plan_s = up._plan((24,), (1, 1), (4, 4), (4, 4))
    x3 = torch.zeros([1, 1, 20, 20])
    taps_s = (ctypes.c_float * 28)()

    def launch_s(up_=1, down=4, taps=24, toh=plan_s["toh"], tow=plan_s["tow"],
                 smem=plan_s["smem"]):
        return ks(x3.data_ptr(), y.data_ptr(), 0, 1, 20, 20, 4, 4, up_, down, taps, 0, 0,
                  toh, tow, smem, ctypes.addressof(taps_s), ctypes.addressof(taps_s), None)

    assert launch_s() == 0
    assert launch_s(smem=plan_s["smem"] + 4) == 1
    assert launch_s(tow=plan_s["tow"] + 4) == 1
    assert launch_s(taps=12) == 1
    assert launch_s(up_=2, down=2) == 1
    assert launch_s(up_=2, down=1, taps=12, toh=8,
                    smem=up._sepn_smem_bytes(2, 1, 12, 8, plan_s["tow"])) == 0
    assert launch_s(up_=2, down=1, taps=12, toh=4,  # up: rows a multiple of 8
                    smem=up._sepn_smem_bytes(2, 1, 12, 4, plan_s["tow"])) == 1

    # `f2d`: down 2 or up 2 only, its own shared memory, rows of 4, columns
    # of its item, at most its widest tile, shifts only at up 2.
    kf = host_libraries["upfirdn2d.cu"].upfirdn2d_f2d_launch
    kf.argtypes = [p, p, i, ll] + [i] * 13 + [p] * 2
    x4 = torch.zeros([1, 1, 20, 20])
    taps_f = (ctypes.c_float * 196)()

    def launch_f(up_=1, down=2, toh=8, tow=8, smem=None, sx=0, sy=0):
        smem = up._f2d_smem_bytes(up_, toh) if smem is None else smem
        return kf(x4.data_ptr(), y.data_ptr(), 0, 1, 20, 20, 4, 4, up_, down, 0, 0, sx, sy,
                  toh, tow, smem, ctypes.addressof(taps_f), None)

    assert launch_f() == 0
    assert launch_f(up_=2, down=1, tow=16, sx=1, sy=1) == 0
    assert launch_f(smem=up._f2d_smem_bytes(1, 8) + 4) == 1
    assert launch_f(toh=6) == 1                              # rows of 4
    assert launch_f(up_=2, down=1, tow=12) == 1              # up: columns of 8
    assert launch_f(toh=68, tow=64) == 1                     # at most 64 rows
    assert launch_f(tow=68) == 1                             # down: at most 64 columns
    assert launch_f(up_=2, down=1, tow=136) == 1             # up: at most 128
    assert launch_f(sx=1) == 1                               # no shift at down 2
    assert launch_f(up_=2, down=2, smem=up._f2d_smem_bytes(2, 8)) == 1
    assert launch_f(up_=1, down=1, smem=up._f2d_smem_bytes(1, 8)) == 1


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
        v = x.float() + (0.0 if b is None else b.float().reshape(-1, *[1] * (x.ndim - dim - 1)))
        g = g * ba._act_derivatives(v, act, alpha)[0]
    if clamp >= 0:
        g = torch.where(yf.abs() < clamp, g, 0.0)
    dx.copy_(g)
    ba.launches[counter] += 1


def _bias_act_grad2_stub(ddx, dy, x, b, y, ddy, dv, dim, act, alpha, gain, clamp):
    """The third Triton kernel's launcher with its plain version in place."""
    got = ba._bias_act_grad2_ref(ddx, dy, x, b, y, dim, act, alpha, gain, clamp)
    ddy.copy_(got[0])
    dv.copy_(got[1])
    ba.launches["bias_act_grad2"] += 1


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
                           "bias_act_bwd2": n["bias_act_bwd2"] + 1,
                           "bias_act_grad2": n["bias_act_grad2"]}
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


SMOOTH_ACTS = ["tanh", "sigmoid", "elu", "selu", "softplus", "swish"]


def _stub_bias_act(monkeypatch):
    monkeypatch.setattr(ba, "_launch_fwd", _bias_act_fwd_stub)
    monkeypatch.setattr(ba, "_launch_bwd", _bias_act_bwd_stub)
    monkeypatch.setattr(ba, "_launch_grad2", _bias_act_grad2_stub)


@pytest.mark.parametrize("clamp", [None, 0.5], ids=["noclamp", "clamp"])
@pytest.mark.parametrize("act", SMOOTH_ACTS)
def test_bias_act_second_derivative_of_a_smooth_activation(monkeypatch, ops_on_cpu, act, clamp):
    """A smooth activation's second derivative launches the third kernel
    once (its plain version, `_bias_act_grad2_ref`, in the launcher's
    place): d/dx, d/db and d/d dy against autograd through the plain
    version."""
    _stub_bias_act(monkeypatch)
    g = torch.Generator().manual_seed(len(act) + (clamp is not None))
    x = torch.randn([3, 5, 4, 6], generator=g)
    b = torch.randn([5], generator=g)
    dy1, dy2 = torch.randn(x.shape, generator=g), torch.randn(x.shape, generator=g)
    spec = ba.activation_funcs[act]
    cfg = (1, act, spec.def_alpha, spec.def_gain, -1.0 if clamp is None else clamp)

    def second(fn):
        xg, bg, dyg = (t.clone().requires_grad_(True) for t in (x, b, dy1))
        gx, gb = torch.autograd.grad(fn(xg, bg), (xg, bg), dyg, create_graph=True)
        return (gx, gb) + torch.autograd.grad((gx * dy2).sum() + gb.square().sum(),
                                              (xg, bg, dyg))

    want = second(lambda x, b: ba._bias_act_ref(x, b, 1, *cfg[1:]))
    n = dict(ba.launches)
    got = second(lambda x, b: ba._BiasActFunction.apply(x, b, *cfg))
    assert ba.launches == {"bias_act_fwd": n["bias_act_fwd"] + 1,
                           "bias_act_bwd": n["bias_act_bwd"] + 1,
                           "bias_act_bwd2": n["bias_act_bwd2"],
                           "bias_act_grad2": n["bias_act_grad2"] + 1}
    for k, r in zip(got, want):
        torch.testing.assert_close(k, r, rtol=1e-5, atol=1e-6)
    if clamp is not None:  # the clamp engages
        assert (ba._bias_act_ref(x, b, 1, *cfg[1:]).abs() >= clamp).float().mean() > 0.05


def test_bias_act_third_derivative_of_a_smooth_activation_raises(monkeypatch, ops_on_cpu):
    _stub_bias_act(monkeypatch)
    x = torch.randn([2, 3, 4, 4], requires_grad=True)
    y = ba._BiasActFunction.apply(x, None, 1, "tanh", 0.0, 1.0, -1.0)
    g, = torch.autograd.grad(y.sum(), x, create_graph=True)
    g2, = torch.autograd.grad(g.square().sum(), x, create_graph=True)
    with pytest.raises(NotImplementedError, match="third derivative for act='tanh'"):
        torch.autograd.grad(g2.sum(), x)


# K3 under autograd through the host-built sources: the second derivative
# (the backward's backward) is the linearised forward, the third the
# backward again. (case, forward variant, backward variant) from
# FLRELU_CASES.
FLRELU_AUTOGRAD_CASES = ["L0 up2 pad(9,8)", "L3 up4 crop(-6,-9)", "toRGB", "asymmetric pad, down 1"]


def _flrelu_setup(name, dtype, seed):
    shape, tu, td, up_, down, pad, gain, slope, fwd_variant, bwd_variant = FLRELU_CASES[name]
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g).to(dtype)
    fu = torch.randn([tu], generator=g) / (tu * up_) ** 0.5 if tu > 1 else None
    fd = torch.randn([td], generator=g) / td ** 0.5 if td > 1 else None
    b = torch.randn([shape[1]], generator=g).to(dtype)
    return g, x, fu, fd, b, (up_, down, pad, gain, slope, 0.5, False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", FLRELU_AUTOGRAD_CASES)
def test_filtered_lrelu_second_derivative_through_the_sources(emulated, name, dtype):
    """Path length's pattern through `_FilteredLReluFunction` with the
    clamp engaged: g = (dx, db) of <y, dy1> with its graph, then the
    derivative of <dx, dy2> + <db, db2> w.r.t. dy1. One launch of each
    mode (the linearised forward in the forward's variant), equal to the
    linearised kernel at K3's own record, and that kernel at the plain
    version's record against the plain second derivative."""
    g, x, fu, fd, b, args = _flrelu_setup(name, dtype, len(name))
    up_, down, pad, gain, slope, clamp, flip = args
    fwd_variant, bwd_variant = FLRELU_CASES[name][8:]

    def second(fn):
        xg, bg = x.clone().requires_grad_(True), b.clone().requires_grad_(True)
        y = fn(xg, bg)
        d1 = dy1.clone().requires_grad_(True)
        gx, gb = torch.autograd.grad(y, (xg, bg), d1, create_graph=True)
        gd, = torch.autograd.grad((gx.float() * dy2.float()).sum() + (gb.float() * db2).sum(), d1)
        return y.detach(), gx.detach(), gd

    y_shape = fl._filtered_lrelu_ref(x, fu, fd, b, *args).shape
    dy1 = torch.randn(y_shape, generator=g).to(dtype)
    dy2 = torch.randn(x.shape, generator=g).to(dtype)
    db2 = torch.randn([x.shape[1]], generator=g)
    want = second(lambda x, b: fl._filtered_lrelu_ref(x, fu, fd, b, *args))
    n, nv = dict(fl.launches), dict(fl.variant_launches)
    got = second(lambda x, b: fl._FilteredLReluFunction.apply(x, fu, fd, b, *args))
    assert fl.launches == {k: v + 1 for k, v in n.items()}
    nv[fwd_variant] += 2
    nv[bwd_variant] += 1
    assert fl.variant_launches == nv
    _, rec_k = fl._forward_kernel(x, fu, fd, b, *args, need_record=True)
    rec_r = fl._record_ref(x, fu, b, up_, pad, gain, slope, clamp, flip)
    lin = [fl._lin_kernel(dy2, db2.to(dtype), rec, fu, fd, up_, down, pad, gain, slope, flip)
           for rec in (rec_k, rec_r)]
    assert got[2].dtype == dtype and torch.equal(got[2], lin[0])
    assert _rel_err(lin[1], want[2]) <= TOL[dtype]
    assert _rel_err(got[0], want[0]) <= TOL[dtype]


def test_filtered_lrelu_third_derivative_through_the_sources(emulated):
    """The linearised forward's derivative is the backward again, on the
    same record: a third order launches forward, backward twice and the
    linearised forward once, and holds to the plain third derivative."""
    name = "L3 up4 crop(-6,-9)"
    g, x, fu, fd, b, args = _flrelu_setup(name, torch.float32, 9)
    dy1 = torch.randn(fl._filtered_lrelu_ref(x, fu, fd, b, *args).shape, generator=g)
    dy2, dy3 = torch.randn(x.shape, generator=g), torch.randn(dy1.shape, generator=g)

    def third(fn):
        xg = x.clone().requires_grad_(True)
        d1, d2 = dy1.clone().requires_grad_(True), dy2.clone().requires_grad_(True)
        gx, = torch.autograd.grad(fn(xg), xg, d1, create_graph=True)
        g2, = torch.autograd.grad(gx, d1, d2, create_graph=True)
        return g2.detach(), torch.autograd.grad(g2, d2, dy3)[0]

    want = third(lambda x: fl._filtered_lrelu_ref(x, fu, fd, b, *args))
    n = dict(fl.launches)
    got = third(lambda x: fl._FilteredLReluFunction.apply(x, fu, fd, b, *args))
    assert fl.launches == dict(n, filtered_lrelu_fwd=n["filtered_lrelu_fwd"] + 1,
                               filtered_lrelu_bwd=n["filtered_lrelu_bwd"] + 2,
                               filtered_lrelu_lin=n["filtered_lrelu_lin"] + 1)
    for k, r in zip(got, want):
        assert _rel_err(k, r) <= TOL[torch.float32]


@pytest.mark.parametrize("name", ["L0 up2 pad(9,8)", "toRGB"])
def test_filtered_lrelu_filter_gradients_through_the_sources(emulated, monkeypatch, name):
    """Filters that require grad: dx and db stay K3's backward, dfu and dfd
    come from the decomposed form (here on CPU tensors, so its inner
    calls take the plain versions), and a second derivative w.r.t. the
    filters from the linearised form; all against autograd through the
    plain version, float32."""
    _stub_bias_act(monkeypatch)
    g, x, fu, fd, b, args = _flrelu_setup(name, torch.float32, 11)
    if fu is None:
        fu, fd = torch.ones([1]), torch.ones([1])  # toRGB's identity filters, as tensors
    dy1 = torch.randn(fl._filtered_lrelu_ref(x, fu, fd, b, *args).shape, generator=g)
    dy2 = torch.randn(x.shape, generator=g)

    def grads(fn):
        xg, bg, fug, fdg = (t.clone().requires_grad_(True) for t in (x, b, fu, fd))
        d1 = dy1.clone().requires_grad_(True)
        first = torch.autograd.grad(fn(xg, fug, fdg, bg), (xg, fug, fdg, bg), d1,
                                    create_graph=True)
        second = torch.autograd.grad((first[0] * dy2).sum(), (fug, fdg, d1))
        return [t.detach() for t in first] + list(second)

    want = grads(lambda x, fu, fd, b: fl._filtered_lrelu_ref(x, fu, fd, b, *args))
    n = dict(fl.launches)
    got = grads(lambda x, fu, fd, b: fl._FilteredLReluFunction.apply(x, fu, fd, b, *args))
    assert fl.launches == {k: v + 1 for k, v in n.items()}
    for k, r in zip(got, want):
        assert k.shape == r.shape and _rel_err(k, r) <= 1e-5


@pytest.mark.parametrize("name", ["G blur", "D skip", "upsample2d"])
def test_upfirdn2d_filter_gradient_through_the_sources(emulated, name):
    """A filter that requires grad: dx (and its derivative) stays K2 in
    the case's variants, df is the plain version's; first and second
    order against autograd through the plain version, float32."""
    kw, fwd_variant, bwd_variant = UPFIRDN_CASES[name]
    g = torch.Generator().manual_seed(len(name))
    f = torch.randn([4], generator=g)
    x = torch.randn([2, 2, 17, 13], generator=g)
    args = (up._parse_scaling(kw["up"]), up._parse_scaling(kw["down"]),
            up._parse_padding(kw["padding"]), False, float(kw["gain"]))
    dy1 = torch.randn(up._upfirdn2d_ref(x, f, *args).shape, generator=g)
    dy2 = torch.randn(x.shape, generator=g)

    def grads(fn):
        xg, fg, d1 = (t.clone().requires_grad_(True) for t in (x, f, dy1))
        gx, gf = torch.autograd.grad(fn(xg, fg), (xg, fg), d1, create_graph=True)
        return [gx.detach(), gf.detach()] + list(torch.autograd.grad(
            (gx * dy2).sum() + gf.square().sum(), (xg, fg, d1), allow_unused=True))

    want = grads(lambda x, f: up._upfirdn2d_ref(x, f, *args))
    n, nv = up.launches["upfirdn2d"], dict(up.variant_launches)
    got = grads(lambda x, f: up._Upfirdn2dFunction.apply(x, f, *args))
    nv[fwd_variant] += 2
    nv[bwd_variant] += 1
    assert up.launches["upfirdn2d"] == n + 3 and up.variant_launches == nv
    for k, r in zip(got, want):
        if r is None:  # no path from x: K2 is linear in x
            assert k is None or not k.any()
            continue
        assert _rel_err(k, r) <= 1e-5
