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
