"""The yardstick's counts: model FLOPs against a hand count, the copied
work functions against the port's, K1's element passes against the
bounds PERF.md records, the kernel-kind table against profile_walk's."""

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import tiny
from harness import flops, kernels
from reference import nets


def _small_sg2():
    return dict(tiny.config("sg2-256"), resolution=8, channel_base=64, channel_max=16)


def test_sg2_walk_and_sampling_flops_by_hand():
    cfg = _small_sg2()
    cfg["discriminator"].update(channel_base=64, channel_max=16)
    # G: 4x4 block (16 channels): conv 4*4*16*16*9, its affine 32*16, toRGB 4*4*16*2 and
    # its affine 32*16; 8x8 block (8 channels): the up-conv at its input's 4x4,
    # 4*4*16*8*9, affine 32*16; conv 8*8*8*8*9, affine 32*8; toRGB 8*8*8*2, affine 32*8.
    g = (36864 + 512 + 512 + 512) + (18432 + 512 + 36864 + 256 + 1024 + 256)
    assert flops.g_synthesis_macs(cfg) == g == 95744
    # D: fromRGB 8*8*2*8; conv0 8*8*8*8*9; the down-conv at its output's 4x4, 4*4*8*16*9;
    # skip 4*4*8*16; epilogue conv 4*4*17*16*9, fc 256*16, out 16.
    d = 1024 + 36864 + 18432 + 2048 + 39168 + 4096 + 16
    assert flops.d_macs(cfg) == d
    # VGG16 on 16x16 crops: 16^2 (3*64 + 64*64) 9, 8^2 (64*128 + 128*128) 9,
    # 4^2 (128*256 + 2 * 256*256) 9, 2^2 (256*512 + 2 * 512*512) 9, 1^2 (3 * 512*512) 9.
    v = 9 * (256 * (3 * 64 + 64 * 64) + 64 * (64 * 128 + 128 * 128)
             + 16 * (128 * 256 + 2 * 256 * 256) + 4 * (256 * 512 + 2 * 512 * 512)
             + 3 * 512 * 512)
    assert flops.vgg_macs(16) == v
    walk = dict(tiny.traffic("walk-k10-b16"), crop_size=16, num_epochs=2)
    # K steps of G, D and one VGG pass per modality, forward and input backward, then a G.
    assert flops.flops_per_sample(cfg, walk) == 2 * (2 * 2 * (g + d + 2 * v) + g)
    sample = tiny.traffic("sample-b256")
    assert flops.flops_per_sample(cfg, sample) == 2 * (2 * 32 * 32 + g)


def _no_fir(monkeypatch):
    def resample(x, f, up=1, down=1, padding=0, gain=1.0, flip_filter=False):
        n, c, h, w = x.shape
        px0, px1, py0, py1 = nets.pad_arg(padding)
        fw = 1 if f is None else f.shape[-1]
        oh = (h * up + py0 + py1 - fw) // down + 1
        ow = (w * up + px0 + px1 - fw) // down + 1
        return x.new_zeros([n, c, oh, ow]) + x.mean()
    monkeypatch.setattr(nets, "upfirdn2d", resample)


def test_sg3_synthesis_flops_against_torchs_counter(monkeypatch):
    """The alias-free G has no up-convolution, so torch's counter of the
    reference's convolutions and matrix products, FIR filters taken out,
    reads the count (and the demodulation's small products)."""
    cfg = tiny.config("sg3t-256")
    gen = torch.Generator().manual_seed(0)
    from harness import workspace

    p = workspace.make_params(workspace.g_specs(cfg), gen, torch.device("cpu"))
    _no_fir(monkeypatch)
    ws = torch.randn(1, nets.num_ws(cfg), cfg["w_dim"])
    with FlopCounterMode(display=False) as counter:
        nets.sg3_synthesis(p, cfg, ws)
    counted = counter.get_total_flops()
    ours = 2 * flops.g_synthesis_macs(cfg)
    assert ours <= counted <= ours * 1.02


def test_copied_k2_work_matches_the_port():
    from latentaugment_tpu_torch.ops import upfirdn2d as up

    cases = [([32, 2, 128, 128], [4], 2, 1, [2, 1, 2, 1]),
             ([32, 128, 257, 257], [4], 1, 1, 0),
             ([32, 128, 256, 256], [4], 1, 2, [1, 1, 1, 1]),
             ([32, 128, 256, 256], [4], 1, 1, [2, 2, 2, 2]),
             ([16, 512, 148, 148], [24], 4, 1, [13, 12, 13, 12]),
             ([16, 512, 562, 562], [12, 12], 1, 2, 0)]
    for x, f, u, d, pad in cases:
        for itemsize in (2, 4):
            mine = kernels.k2_work(x, f, u, d, pad, itemsize)
            theirs = up.work(x, f, up=u, down=d, padding=pad, itemsize=itemsize)
            assert mine == theirs


def test_copied_k3_work_matches_the_port_on_every_sg3t_layer():
    from latentaugment_tpu_torch.ops import filtered_lrelu as fl

    cfg = tiny.load("configs", "sg3t-256")
    layers, _ = nets.sg3_layers(cfg)
    for layer in layers:
        tu = 1 if layer["fu"] is None else len(layer["fu"])
        td = 1 if layer["fd"] is None else len(layer["fd"])
        x = [16, layer["in_channels"], layer["in_size"] + layer["conv_kernel"] - 1,
             layer["in_size"] + layer["conv_kernel"] - 1]
        for backward in (False, True):
            for record in (False, True):
                args = (x, tu, td, layer["up"], layer["down"], layer["padding"], backward, 2,
                        record)
                theirs = fl.work(*args)
                mine = kernels.k3_work(*args)
                assert mine == {k: theirs[k] for k in ("macs", "bytes")}


def test_k1_passes_give_the_bounds_perf_md_records():
    # [32,128,256,256] bf16: forward 0.321 ms, backward 0.481 ms (bytes).
    shape = [32, 128, 256, 256]
    fwd = kernels.k1_work("bias_act_fwd", [shape, [128]], 2)
    bwd = kernels.k1_work("bias_act_bwd", [shape, [], [], shape], 2)
    fwd, bwd = (kernels.least_seconds(w["bytes"], w["macs"]) for w in (fwd, bwd))
    assert round(fwd * 1e3, 3) == 0.321 and round(bwd * 1e3, 3) == 0.481


def test_kind_table_is_profile_walks():
    from latentaugment_tpu_torch import profile_walk

    assert kernels.KINDS == profile_walk._KINDS


UPFIRDN2D = [("x", "Tensor"), ("f", "Tensor"), ("up", "List[int]"), ("down", "List[int]"),
             ("padding", "List[int]"), ("flip_filter", "bool"), ("gain", "float")]
BIAS_ACT_FWD = [("x", "Tensor"), ("b", "Optional[Tensor]"), ("dim", "int"), ("act", "str"),
                ("alpha", "float"), ("gain", "float"), ("clamp", "float")]


@pytest.mark.parametrize("op,schema,shapes,args,dtypes,kernel", [
    ("upfirdn2d", UPFIRDN2D, [[8, 4, 16, 16], [4], [], [], [], [], []],
     [None, None, [2, 2], [1, 1], [2, 1, 2, 1], False, 4.0],
     ["c10::BFloat16", "float", "", "", "", "", ""], "k2"),
    ("bias_act_fwd", BIAS_ACT_FWD, [[8, 4, 16, 16], [4], [], [], [], [], []],
     [None, None, 1, "lrelu", 0.2, math.sqrt(2), 256.0], ["float", "float", "", "", "", "", ""],
     "k1"),
])
def test_launch_bound_reads_profiler_arguments_by_name(op, schema, shapes, args, dtypes, kernel):
    k, s = kernels.launch_bound(op, schema, shapes, args, dtypes)
    assert k == kernel and s > 0
    # An argument appended to the op moves nothing.
    more = kernels.launch_bound(op, schema + [("extra", "int")], shapes + [[]], args + [3],
                                dtypes + [""])
    assert more == (k, s)
    with pytest.raises(kernels.UnreadLaunch):  # a dtype the copy does not know
        kernels.launch_bound(op, schema, shapes, args, ["c10::Float8_e4m3fn"] + dtypes[1:])
    renamed = [("in_" + a if a == "x" else a, t) for a, t in schema]
    with pytest.raises(kernels.UnreadLaunch):  # an argument renamed
        kernels.launch_bound(op, renamed, shapes, args, dtypes)
    with pytest.raises(kernels.UnreadLaunch):  # an op of the kernel the copy does not read
        kernels.launch_bound(op + "_fused", schema, shapes, args, dtypes)


def test_the_arguments_read_are_in_the_ports_op_schemas():
    import latentaugment_tpu_torch.ops.bias_act  # noqa: F401
    import latentaugment_tpu_torch.ops.filtered_lrelu  # noqa: F401
    import latentaugment_tpu_torch.ops.upfirdn2d  # noqa: F401
    from harness import trace

    for op, needs in kernels.NEEDS.items():
        schema = dict(trace.op_schema(op))
        assert all(schema.get(a) == t for a, t in needs), (op, schema)


def test_roofline_is_silent_only_where_the_kernel_did_not_run():
    from harness import trace

    tr = {"ops": [("upfirdn2d", UPFIRDN2D, [[8, 4, 16, 16], [4], [], [], [], [], []],
                   [None, None, [1, 1], [1, 1], [0, 0, 0, 0], False, 1.0],
                   ["float", "float", "", "", "", "", ""])],
          "kernels": [(0.0, 10.0, "void upfirdn2d_kernel<1, 1, float>")]}
    tr["ops"] = [(n, s, a, d) for n, _, s, a, d in tr["ops"]]
    tr["schemas"] = {"upfirdn2d": UPFIRDN2D}
    assert 0 < trace.roofline(tr, "k2") <= 100
    assert trace.roofline(dict(tr, ops=[], kernels=[]), "k2") is None
    with pytest.raises(kernels.UnreadLaunch):  # kernels ran, no op was recorded
        trace.roofline(dict(tr, ops=[]), "k2")
