"""The plans, records and bounds of the port's CUDA kernels K2 (upfirdn2d)
and K3 (filtered_lrelu): everything about a launch that is decided in
Python. These run on the CPU with no GPU, nvcc or triton.
"""

import numpy as np
import pytest
import torch

from latentaugment_tpu_torch.models.stylegan3 import networks as net3
from latentaugment_tpu_torch.ops import _taps
from latentaugment_tpu_torch.ops import filtered_lrelu as fl
from latentaugment_tpu_torch.ops import upfirdn2d as up

MAX_SMEM = 232448  # 227 KB, the most a block of the card can take
SG3_LAYERS = net3.generator_config().layers
TILED = {"u2t12_d2t12", "u4t24_d2t12", "u2t12_d4t24"}


# ----------------------------------------------------------------------------
# (a) The packed record.

@pytest.mark.parametrize("width", [1, 3, 4, 5, 82, 562])
def test_record_pack_round_trip(width):
    rng = np.random.default_rng(width)
    bits = torch.as_tensor(rng.integers(0, 4, size=[3, 7, width]).astype(np.uint8))
    packed = fl.pack_record(bits)
    assert packed.dtype == torch.uint8 and tuple(packed.shape) == (3, 7, -(-width // 4))
    assert torch.equal(fl.unpack_record(packed, width), bits)
    # Pixel x sits in bits 2 * (x % 4) of byte x // 4; the padding bits are 0.
    x = width - 1
    assert (packed[0, 0, x // 4].item() >> (2 * (x % 4))) & 3 == bits[0, 0, x].item()
    assert packed[0, 0, -1].item() >> (2 * ((width - 1) % 4 + 1)) == 0


@pytest.mark.parametrize("clamp", [None, 0.5], ids=["noclamp", "clamp"])
@pytest.mark.parametrize("width", [13, 16])
def test_record_ref_is_the_packed_plain_record(width, clamp):
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal([2, 3, 11, width]).astype(np.float32))
    fu = torch.as_tensor(rng.standard_normal([12]).astype(np.float32)) / 24 ** 0.5
    b = torch.as_tensor(rng.standard_normal([3]).astype(np.float32))
    padding, gain, slope = (5, 6, 4, 7), 1.3, 0.1
    rec = fl._record_ref(x, fu, b, 2, padding, gain, slope, clamp, False)
    # The plain record, pixel by pixel, from the plain ops.
    u = up.upfirdn2d(x + b[None, :, None, None], fu, up=2, padding=list(padding), gain=4,
                     impl="ref")
    v = torch.where(u > 0, u, u * slope) * gain
    bits = (~(u > 0)).to(torch.uint8)
    if clamp is not None:
        bits |= (v.abs() > clamp).to(torch.uint8) << 1
        assert (bits & 2).any()
    mid_h, mid_w = u.shape[2:]
    assert tuple(rec.shape) == (6, mid_h, -(-mid_w // 4)) and rec.dtype == torch.uint8
    assert torch.equal(rec, fl.pack_record(bits.reshape(6, mid_h, mid_w)))
    assert torch.equal(fl.unpack_record(rec, mid_w), bits.reshape(6, mid_h, mid_w))


# ----------------------------------------------------------------------------
# (b) The K3 plan.

def _layer_geometry(layer, backward):
    size = layer.in_size + layer.conv_kernel - 1  # the full conv's output
    lo, hi = layer.padding
    return fl._geometry((size, size), layer.up_taps, layer.down_taps, layer.up_factor,
                        layer.down_factor, (lo, hi, lo, hi), backward)


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("index", range(len(SG3_LAYERS)), ids=[l.name for l in SG3_LAYERS])
def test_k3_plan_of_every_sg3_layer_is_specialised(index, backward):
    layer = SG3_LAYERS[index]
    sp = _layer_geometry(layer, backward)
    assert sp["out_hw" if not backward else "in_hw"] == (layer.out_size, layer.out_size)
    plan = fl._plan(sp)
    if layer.is_torgb:
        want = "u1t1_d1t1"
    elif layer.up_factor == 4:
        want = "u2t12_d4t24" if backward else "u4t24_d2t12"
    else:
        want = "u2t12_d2t12"
    assert plan["variant"] == want != "generic"
    assert 0 <= plan["smem"] <= MAX_SMEM
    if want in TILED:
        toh, tow, mh, mw = plan["toh"], plan["tow"], plan["mh"], plan["mw"]
        # What the launcher checks before it launches.
        assert toh % 4 == 0 and tow % 4 == 0 and mh % 8 == 0 and mw % 8 == 0
        assert mh >= (toh - 1) * sp["down"] + sp["t2"] + 3
        assert mw >= (tow - 1) * sp["down"] + sp["t2"] + 3
        assert backward or (sp["pad2"] == (0, 0) and (tow * sp["down"]) % 4 == 0)
        assert plan["smem"] == fl._tiled_smem_bytes(sp["up"], toh, mh, mw)
        assert sp["t1"] == 6 * sp["up"] and sp["t2"] == 6 * sp["down"]


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
def test_k3_plan_of_other_geometries_is_generic(backward):
    # The card test's "asymmetric pad, down 1": 12 and 6 taps, up 2, down 1.
    sp = fl._geometry((17, 13), 12, 6, 2, 1, (5, 6, 4, 7), backward)
    plan = fl._plan(sp)
    assert plan["variant"] == "generic" and plan["smem"] <= MAX_SMEM
    assert plan["smem"] == fl._generic_smem_bytes(sp["up"], sp["t1"], sp["down"], sp["t2"],
                                                  plan["tile"])
    assert backward or (plan["tile"] * sp["down"]) % 4 == 0
    # A padded 1-tap layer is not the pointwise variant.
    assert fl._plan(fl._geometry((8, 8), 1, 1, 1, 1, (1, 0, 0, 0), backward))["variant"] \
        == "generic"


@pytest.mark.parametrize("up_, pad", [(2, 9), (2, 8), (2, -11), (4, -6), (4, 3), (4, 5), (2, 11),
                                      (4, 23)])
def test_polyphase_table_is_the_zero_inserted_fir(up_, pad):
    """Row e of the table, laid over the inputs from g + j0 on, gives
    output up * g + e of the FIR over the zero-inserted signal."""
    rng = np.random.default_rng(up_ * 100 + pad)
    taps = tuple(rng.standard_normal(6 * up_).tolist())
    rows, j0 = _taps.polyphase_table(taps, up_, pad)
    assert len(rows) == up_ and all(len(r) == 7 for r in rows)
    x = rng.standard_normal(40)
    z = np.zeros(40 * up_)
    z[::up_] = x

    def canvas(u):
        return z[u] if 0 <= u < z.size else 0.0

    for m in range(-8, 60):
        want = sum(taps[a] * canvas(m + a - pad) for a in range(len(taps)))
        g, e = divmod(m, up_)
        got = sum(rows[e][k] * (x[g + j0 + k] if 0 <= g + j0 + k < x.size else 0.0)
                  for k in range(7))
        assert abs(got - want) < 1e-12


# ----------------------------------------------------------------------------
# (c) The K2 plan.

K2_CASES = {
    "G blur after the up-conv": ((4,), 1, 1, (257, 257), (1, 1, 1, 1), "u1d1", "u1d1"),
    "D blur before the stride-2 conv": ((4,), 1, 1, (256, 256), (2, 2, 2, 2), "u1d1", "u1d1"),
    "D 1x1 skip": ((4,), 1, 2, (256, 256), (1, 1, 1, 1), "u1d2", "u2d1"),
    "skip-image upsample2d": ((4,), 2, 1, (128, 128), (2, 1, 2, 1), "u2d1", "u1d2"),
    "2-D filter": ((4, 4), 1, 1, (64, 64), (1, 1, 1, 1), "generic", "generic"),
    "up 2 down 2": ((4,), 2, 2, (17, 13), (-1, 3, 0, 2), "generic", "generic"),
    "2 taps": ((2,), 1, 1, (16, 16), (0, 1, 0, 1), "generic", "generic"),
}


@pytest.mark.parametrize("name", list(K2_CASES))
def test_k2_plan(name):
    f_shape, u, d, in_hw, padding, fwd, bwd = K2_CASES[name]
    taps = f_shape[0]
    out_hw = tuple((n * u + padding[2 * i] + padding[2 * i + 1] - taps) // d + 1
                   for i, n in ((1, in_hw[0]), (0, in_hw[1])))
    plan = up._plan(f_shape, (u, u), (d, d), out_hw)
    assert plan["variant"] == fwd
    # The backward swaps up and down; its output is the forward's input.
    assert up._plan(f_shape, (d, d), (u, u), in_hw)["variant"] == bwd
    if fwd != "generic":
        assert plan["toh"] % 2 == 0 and plan["tow"] % 4 == 0
        assert plan["smem"] == up._sep4_smem_bytes(u, d, plan["toh"], plan["tow"]) <= MAX_SMEM


def test_k2_plans_of_at_most_4_taps_keep_the_unrolled_kernel():
    """The SG2 paths' filters (4 taps or fewer) keep their variants, and
    `generic` its plan (its launcher picks the unrolled instantiation from
    the filter's size)."""
    for name, (f_shape, u, d, in_hw, padding, fwd, bwd) in K2_CASES.items():
        plan = up._plan(f_shape, (u, u), (d, d), in_hw)
        if plan["variant"] == "generic":
            assert plan == dict(variant="generic"), name


def _sg3r_plan(res):
    cfg = net3.generator_config(img_resolution=res, use_radial_filters=True, conv_kernel=1,
                                channel_base=65536, channel_max=1024)
    return cfg.layers


@pytest.mark.parametrize("res", [256, 1024])
def test_k2_plan_takes_every_sg3r_filter_at_run_time(res):
    """Every FIR of StyleGAN3-R's decomposed layers and its backward has a
    K2 plan with its taps at run time: the 2-D fd (filter_size *
    down_factor = 12 taps per axis) at down 2 and its backward at up 2
    `f2d`, and the 1-D fu (filter_size * up_factor: 12 at up 2, 24 at up
    4) and its backward at down 2 / 4 `sepn`; 65 taps raise."""
    radial = [layer for layer in _sg3r_plan(res) if layer.down_radial]
    assert radial and all(layer.down_taps == 6 * layer.down_factor == 12 for layer in radial)
    assert {layer.up_factor for layer in radial} == {2, 4}
    for layer in radial:
        fu, fd = net3._layer_filters(layer)
        assert fd.shape == (layer.down_taps, layer.down_taps) and fu.ndim == 1
        u, d = layer.up_factor, layer.down_factor
        assert fu.shape == (6 * u,)
        rates = ((1, 1), (d, d))
        assert up._plan(fd.shape, *rates, (64, 64))["variant"] == "f2d"
        assert up._plan(fd.shape, *rates[::-1], (64, 64))["variant"] == "f2d"  # the backward
        rates = ((u, u), (1, 1))
        assert up._plan(fu.shape, *rates, (64, 64))["variant"] == "sepn"
        assert up._plan(fu.shape, *rates[::-1], (64, 64))["variant"] == "sepn"  # the backward
    with pytest.raises(NotImplementedError, match="65x65"):
        up._plan((65, 65), (1, 1), (2, 2), (8, 8))


# (up, down, taps) of `sepn`, with the R plan's largest map of each at
# 256x256: (rows, columns) of the output and the tile the plan picks.
SEPN_ROWS = {
    "fu up 2, 12 taps (L11)": (2, 1, 12, (562, 562), (64, 128)),
    "fu up 4, 24 taps (L10)": (4, 1, 24, (562, 562), (64, 128)),
    "its backward, down 2": (1, 2, 12, (276, 276), (32, 64)),
    "its backward, down 4": (1, 4, 24, (148, 148), (16, 32)),
}


@pytest.mark.parametrize("name", list(SEPN_ROWS))
def test_k2_sepn_plan_of_the_r_plan_sizes(name):
    """Each (up, down, taps) row plans `sepn` with its tile: rows a
    multiple of the H pass's item (8 up, 2 or 1 down) and of up, columns
    of 8, and at most ~112 KB of shared memory (two blocks an SM); a
    small map takes a tile cut to its size."""
    u, d, taps, out_hw, tile = SEPN_ROWS[name]
    plan = up._plan((taps,), (u, u), (d, d), out_hw)
    assert plan["variant"] == "sepn" and plan["taps"] == taps
    assert (plan["toh"], plan["tow"]) == tile
    assert plan["toh"] % up._sepn_rows_per_item(u, d) == 0 and plan["toh"] % u == 0
    assert plan["tow"] % 8 == 0
    assert plan["smem"] == up._sepn_smem_bytes(u, d, taps, *tile) <= 112 * 1024
    small = up._plan((taps,), (u, u), (d, d), (5, 9))
    assert (small["toh"], small["tow"]) == (up._round_up(5, up._sepn_rows_per_item(u, d)), 16)
    assert small["smem"] == up._sepn_smem_bytes(u, d, taps, small["toh"], small["tow"])


def test_k2_sepn_smem_of_the_down_4_tile():
    """The backward at down 4 with 24 taps is the tight one: 16x32 outputs
    stage 84x148 inputs, and the W pass keeps 84x32; each row pitch is
    padded (2 mod 4 floats staged, 4 more than the tile after W)."""
    assert up._sepn_smem_bytes(1, 4, 24, 16, 32) == 4 * (84 * 150 + 84 * 36)
    assert up._sepn_smem_bytes(4, 1, 24, 64, 128) == 4 * (22 * 38 + 22 * 132)
    assert up._sepn_smem_bytes(2, 1, 12, 64, 128) == 4 * (38 * 70 + 38 * 132)


@pytest.mark.parametrize("f_shape, u, d", [((12,), 4, 1), ((24,), 2, 1), ((12,), 1, 4),
                                            ((12,), 2, 2), ((12, 12), 2, 1), ((8,), 2, 1)])
def test_k2_other_long_filters_stay_generic(f_shape, u, d):
    """Only the four rows of `sepn`: another tap count, a rate pair or a
    2-D filter plans `generic`, as does a rate that differs by axis; the
    2-D 12x12 filter at up 2 is `f2d`'s (the radial filter's backward)."""
    want = "f2d" if (f_shape, u, d) == ((12, 12), 2, 1) else "generic"
    assert up._plan(f_shape, (u, u), (d, d), (64, 64))["variant"] == want
    assert up._plan((12,), (2, 1), (1, 1), (64, 64)) == dict(variant="generic")


@pytest.mark.parametrize("res", [256, 1024])
def test_k2_f2d_plan_of_every_sg3r_radial_geometry(res):
    """Every radial layer of the R plan, forward (down 2 from the up-rate
    canvas) and backward (up 2 back to it), at batch 16 plans `f2d`: rows
    of 4, columns of its item, a tile cut to a smaller map, and at most
    ~112 KB of shared memory (two blocks an SM), the launcher's own
    formula."""
    for layer in (layer for layer in _sg3r_plan(res) if layer.down_radial):
        fu, fd = net3._layer_filters(layer)
        lo, hi = layer.padding
        mid = layer.in_size * layer.up_factor + lo + hi - (fu.shape[0] - 1)
        w = up.work([16, 1024, mid, mid], fd.shape, down=2)
        out = w["out_shape"][2:]
        assert out == (layer.out_size, layer.out_size)
        back = up.transposed_padding((16, 1024, mid, mid), w["out_shape"], (12, 12), (1, 1),
                                     (2, 2), (0, 0, 0, 0))
        assert up.work(w["out_shape"], fd.shape, up=2, padding=back)["out_shape"][2:] == (mid, mid)
        for rates, hw in ((((1, 1), (2, 2)), out), (((2, 2), (1, 1)), (mid, mid))):
            plan = up._plan(fd.shape, *rates, hw)
            u, key = rates[0][0], (rates[0][0], rates[1][0])
            assert plan["variant"] == "f2d", (layer.name, rates)
            assert plan["toh"] % 4 == 0 and plan["tow"] % up._F2D_ITEM_COLS[u] == 0
            assert (plan["toh"], plan["tow"]) == (
                min(up._F2D_TILES[key][0], up._round_up(hw[0], 4)),
                min(up._F2D_TILES[key][1], up._round_up(hw[1], up._F2D_ITEM_COLS[u])))
            assert plan["smem"] == up._f2d_smem_bytes(u, plan["toh"]) <= 112 * 1024


@pytest.mark.parametrize("f_shape, u, d", [((8, 8), 1, 2), ((12, 12), 1, 3), ((12, 12), 2, 2),
                                            ((12, 12), 1, 1), ((12, 12), 4, 1), ((24, 24), 1, 2),
                                            ((12, 8), 1, 2)])
def test_k2_other_2d_filters_stay_generic(f_shape, u, d):
    """`f2d` takes the 12x12 filter at down 2 and at up 2 only: another
    2-D filter, another rate pair, or rates that differ by axis plan
    `generic`."""
    assert up._plan(f_shape, (u, u), (d, d), (64, 64)) == dict(variant="generic")
    assert up._plan((12, 12), (1, 1), (2, 1), (64, 64)) == dict(variant="generic")
    assert up._plan((12, 12), (2, 1), (1, 1), (64, 64)) == dict(variant="generic")


def test_k2_f2d_smem_and_tables():
    """`f2d`'s shared memory: the staged rows (2 toh + 10 down, toh / 2 + 6
    up) at the widest tile's pitch (138 and 70 columns with a gap of 2
    after every 32, made even: 146 and 74 floats); its up-2 tables hold
    each phase's 36 live taps from the phase's start on, the input index
    of entry 0 and the starts as `_taps.polyphase_table_2d` gives them.
    The plan's tiles are within the launcher's largest."""
    assert up._f2d_smem_bytes(1, 64) == 4 * 138 * 146
    assert up._f2d_smem_bytes(2, 64) == 4 * 38 * 74
    assert up._f2d_smem_bytes(1, 36) == 4 * 82 * 146
    for (u, d), (toh, tow) in up._F2D_TILES.items():
        assert toh <= up._F2D_MAX_TILE[u][0] and tow <= up._F2D_MAX_TILE[u][1]
    f = torch.as_tensor(np.random.default_rng(0).standard_normal([12, 12]).astype(np.float32))
    for pad, start in ((11, 0), (10, 1), (-3, 0), (0, 1)):
        values, ox, oy, sx, sy = up._f2d_taps(f, 2, (pad, 0, pad - 1, 0), False, 2.0)
        assert (sx, sy) == (start, 1 - start) and ox == -(pad // 2) and oy == -((pad - 1) // 2)
        table = np.asarray(values[:196]).reshape(2, 2, 7, 7)
        corr = f.flip([0, 1]).numpy().astype(np.float64) * 2.0
        for ey, starts_y in enumerate((0, sy)):
            for ex, starts_x in enumerate((0, sx)):
                live = table[ey, ex, starts_y:starts_y + 6, starts_x:starts_x + 6]
                assert np.count_nonzero(table[ey, ex]) == 36 == np.count_nonzero(live)
                assert np.isclose(live.sum(), corr[(ey + pad - 1) % 2::2, (ex + pad) % 2::2].sum(),
                                  rtol=1e-5)
    values, ox, oy, sx, sy = up._f2d_taps(f, 1, (3, 0, -1, 0), True, 0.5)
    assert (ox, oy, sx, sy) == (3, -1, 0, 0)
    np.testing.assert_allclose(np.asarray(values[:144]), f.numpy().ravel() * 0.5, rtol=1e-6)
    assert not any(values[144:])


def test_2d_filter_picks_the_decomposed_route():
    """filtered_lrelu's route comes from the device, the filters' rank and
    impl alone: a 2-D fd (or fu) on the card is the decomposed form
    through K1 and K2, 1-D filters K3, the CPU or impl='ref' the plain
    version."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    fu, fd1, fd2 = torch.ones(12), torch.ones(12), torch.ones(12, 12)
    assert fl._route(cuda, fu, fd2, "auto") == "decomposed"
    assert fl._route(cuda, fd2, fu, "auto") == "decomposed"
    assert fl._route(cuda, fu, fd1, "auto") == "k3"
    assert fl._route(cuda, None, None, "auto") == "k3"
    assert fl._route(cuda, fu, fd2, "ref") == "ref"
    assert fl._route(cpu, fu, fd2, "auto") == "ref"
    with pytest.raises(NotImplementedError, match="no kernel"):
        fl._route(torch.device("meta"), fu, fd2, "auto")
    # K3 handed a 2-D filter directly refuses it, before any launch.
    with pytest.raises(NotImplementedError, match="1-D"):
        fl._stage_params((38, 38), fu, fd2, 2, 2, (11, 10, 11, 10), False, False)


def test_k2_work_of_2d_filters():
    """A 2-D filter's multiply-adds are its live taps' product per output:
    the R plan's radial 12x12 at down 2 (all 144 live), and the backward
    at up 2 (36 live per output)."""
    w = up.work([16, 512, 562, 562], (12, 12), down=2, itemsize=2)
    assert w["out_shape"] == (16, 512, 276, 276)
    assert w["macs"] == 8192 * 276 * 276 * 144
    assert w["bytes"] == 8192 * (562 * 562 + 276 * 276) * 2
    wb = up.work([16, 512, 276, 276], (12, 12), up=2, padding=(11, 10, 11, 10), itemsize=2)
    assert wb["out_shape"] == (16, 512, 562, 562)
    assert wb["macs"] == 8192 * 562 * 562 * 36
    # A 1-D filter counts the two separable passes, live taps only.
    w1 = up.work([16, 512, 148, 148], (24,), up=4, padding=(-2, -5, -2, -5), itemsize=2)
    assert w1["out_shape"] == (16, 512, 562, 562)
    assert w1["macs"] == 8192 * (148 * 562 * 6 + 562 * 562 * 6)


def test_k2_plan_needs_the_same_rate_on_both_axes():
    assert up._plan((4,), (2, 1), (1, 1), (32, 64))["variant"] == "generic"
    assert up._plan((4,), (1, 1), (1, 2), (32, 64))["variant"] == "generic"
    # A small map takes a tile cut to its size.
    plan = up._plan((4,), (1, 1), (1, 1), (9, 10))
    assert (plan["variant"], plan["toh"], plan["tow"]) == ("u1d1", 10, 12)


# ----------------------------------------------------------------------------
# (d) The bounds' work counts.

def test_k3_work_of_l10_forward():
    layer = SG3_LAYERS[10]
    lo, hi = layer.padding
    w = fl.work([16, 256, 150, 150], layer.up_taps, layer.down_taps, layer.up_factor,
                layer.down_factor, (lo, hi, lo, hi), itemsize=2)
    assert w["macs"] == 4096 * 5176320  # 21.2 G multiply-adds
    assert round(w["macs"] / 1e9, 1) == 21.2
    assert w["bytes"] == 4096 * (150 * 150 + 276 * 276) * 2  # 0.81 GB
    assert round(w["bytes"] / 1e9, 2) == 0.81
    # The 2-bit record of the 562 x 562 canvas: 0.32 GB, and a backward's
    # multiply-adds are the forward's (the transposed passes).
    assert w["record_bytes"] == 4096 * 562 * 141
    wr = fl.work([16, 256, 150, 150], 24, 12, 4, 2, (lo, hi, lo, hi), backward=True,
                 itemsize=2, record=True)
    assert wr["bytes"] == w["bytes"] + w["record_bytes"]
    assert wr["macs"] == 4096 * (276 * 562 * 6 + 562 * 562 * 6 + 562 * 150 * 24 + 150 * 150 * 24)


def test_k2_work_of_the_g_blur():
    w = up.work([32, 128, 257, 257], (4,), padding=1, itemsize=2)
    assert w["out_shape"] == (32, 128, 256, 256)
    assert w["bytes"] == 4096 * (257 * 257 + 256 * 256) * 2  # 1.078 GB
    assert round(w["bytes"] / 1e9, 3) == 1.078
    assert w["macs"] == 4096 * (257 * 256 * 4 + 256 * 256 * 4)
    w2 = up.work([32, 128, 256, 256], (4,), down=2, padding=1, itemsize=2)
    assert w2["out_shape"] == (32, 128, 128, 128)


def test_host_taps_are_copied_once_per_tensor_version():
    f = torch.tensor([1.0, 3.0, 3.0, 1.0])
    assert _taps.host_taps(f) == (1.0, 3.0, 3.0, 1.0)
    assert _taps.host_taps(f) is _taps.host_taps(f)
    f.mul_(2.0)  # an in-place edit is seen
    assert _taps.host_taps(f) == (2.0, 6.0, 6.0, 2.0)
    assert _taps.correlation_taps((1.0, 2.0, 3.0), flip=False, gain=2.0) == (6.0, 4.0, 2.0)
    assert _taps.correlation_taps((1.0, 2.0, 3.0), flip=True) == (1.0, 2.0, 3.0)
