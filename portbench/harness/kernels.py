"""What each launch of the port's kernels must do, whatever the kernel:
bytes moved (each input read once, each output written once) and
multiply-adds, from the launch's arguments as the profiler records them
on the `latentaugment_torch::*` ops; the least time the card could take;
and the table of kernel kinds for the device-time breakdown.

Copied from the port so that later changes to the program cannot move
the yardstick: K2's `work` (latentaugment_tpu_torch/ops/upfirdn2d.py),
K3's `work` and `_geometry` (ops/filtered_lrelu.py), K1's element passes
(chip_smoke.py's bounds), profile_walk.py's `_KINDS`.
"""

PEAK_BYTES_PER_S = 3.35e12  # HBM3, one H100 SXM
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores

KINDS = (
    ("K3 filtered_lrelu", ("filtered_lrelu_kernel",)),
    ("K2 upfirdn2d", ("upfirdn2d_kernel",)),
    ("K1 bias_act", ("bias_act_fwd", "bias_act_bwd")),
    ("plain FIR (depthwise conv)", ("conv_depthwise2d",)),
    ("cuDNN layout transforms", ("nchwToNhwc", "nhwcToNchw")),
    ("cuDNN conv dgrad", ("dgrad",)),
    ("cuDNN conv fprop/other", ("cudnn", "conv", "xmma", "implicit_gemm")),
    ("matmul", ("gemm", "cutlass", "cublas")),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "CatArrayBatchedCopy", "fill", "copy")),
    ("memcpy/memset", ("Memcpy", "Memset")),
)

# The device kernels of each hand-written kernel, by name.
KERNEL_NAMES = {"k1": ("bias_act_fwd", "bias_act_bwd", "bias_act_grad2"),
                "k2": ("upfirdn2d_kernel",), "k3": ("filtered_lrelu_kernel",)}


def kind_of(name):
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "other"


def least_seconds(nbytes, macs=0):
    """The larger of bytes over the memory rate and two operations per
    multiply-add over the float32 rate."""
    return max(nbytes / PEAK_BYTES_PER_S, 2 * macs / PEAK_F32_FLOPS)


def _pair(v):
    return [int(v), int(v)] if isinstance(v, int) else [int(x) for x in v]


def _padding(padding):
    if isinstance(padding, int):
        padding = [padding, padding]
    padding = [int(p) for p in padding]
    if len(padding) == 2:
        padding = [padding[0], padding[0], padding[1], padding[1]]
    return padding


def _numel(shape):
    n = 1
    for s in shape:
        n *= int(s)
    return n


# ----------------------------------------------------------------------------
# K1 (bias_act): element passes over the activation.

def k1_work(op, shapes, itemsize):
    """`shapes`: the op's first tensor and, for the backward, x (empty where
    not given). bias_act_fwd(x, b, ...): x in, y out. bias_act_bwd(dy, x,
    b, y, ...): dy and y in (x too where given), dx out. bias_act_grad2(ddx,
    dy, x, b, y, ...): ddx, dy, x, y in, ddy and the bias term out."""
    full = _numel(shapes[0])
    if op == "bias_act_fwd":
        passes = 2
    elif op == "bias_act_bwd":
        passes = 3 + (1 if shapes[1] else 0)
    else:
        passes = 6
    return dict(bytes=passes * full * itemsize, macs=0)


# ----------------------------------------------------------------------------
# K2 (upfirdn2d).

def k2_work(x_shape, f_shape, up=1, down=1, padding=0, itemsize=2):
    n, c, in_h, in_w = x_shape
    upx, upy = _pair(up)
    downx, downy = _pair(down)
    padx0, padx1, pady0, pady1 = _padding(padding)
    fw, fh = (f_shape[0], f_shape[0]) if len(f_shape) == 1 else (f_shape[1], f_shape[0])
    out_h = (in_h * upy + pady0 + pady1 - fh) // downy + 1
    out_w = (in_w * upx + padx0 + padx1 - fw) // downx + 1
    live_x, live_y = -(-fw // upx), -(-fh // upy)
    if len(f_shape) == 1:
        macs = in_h * out_w * live_x + out_h * out_w * live_y
    else:
        macs = out_h * out_w * live_x * live_y
    return dict(bytes=n * c * (in_h * in_w + out_h * out_w) * itemsize, macs=n * c * macs,
                out_shape=(n, c, out_h, out_w))


# ----------------------------------------------------------------------------
# K3 (filtered_lrelu).

def k3_geometry(in_hw, tu, td, up, down, padding, backward):
    px0, px1, py0, py1 = padding
    mid_w = in_hw[1] * up + px0 + px1 - (tu - 1)
    mid_h = in_hw[0] * up + py0 + py1 - (tu - 1)
    out_w = (mid_w - td + down) // down
    out_h = (mid_h - td + down) // down
    if not backward:
        return dict(in_hw=tuple(in_hw), mid_hw=(mid_h, mid_w), out_hw=(out_h, out_w),
                    up=up, t1=tu, down=down, t2=td)
    return dict(in_hw=(out_h, out_w), mid_hw=(mid_h, mid_w), out_hw=tuple(in_hw),
                up=down, t1=td, down=up, t2=tu)


def k3_work(x_shape, tu, td, up, down, padding, backward=False, itemsize=2, record=False):
    planes = x_shape[0] * x_shape[1]
    sp = k3_geometry(tuple(x_shape[2:]), tu, td, up, down, _padding(padding), backward)
    (in_h, in_w), (mid_h, mid_w), (out_h, out_w) = sp["in_hw"], sp["mid_hw"], sp["out_hw"]
    live1 = -(-sp["t1"] // sp["up"])
    macs = (in_h * mid_w * live1 + mid_h * mid_w * live1
            + mid_h * out_w * sp["t2"] + out_h * out_w * sp["t2"])
    nbytes = (in_h * in_w + out_h * out_w) * itemsize
    record_bytes = mid_h * -(-mid_w // 4)
    return dict(macs=planes * macs, bytes=planes * (nbytes + (record_bytes if record else 0)))


# ----------------------------------------------------------------------------
# One profiler op event -> (kernel, least seconds).

ITEMSIZE = {"float": 4, "c10::BFloat16": 2, "c10::Half": 2, "BFloat16": 2, "Float": 4}

# The arguments each op's bound reads, by name and type, as the ops'
# schemas give them: a launch is read by these names, so an argument
# added to an op moves nothing, and one renamed, retyped or removed, or an
# op of a kernel that is not listed here, stops the traced run.
NEEDS = {
    "bias_act_fwd": (("x", "Tensor"),),
    "bias_act_bwd": (("dy", "Tensor"), ("x", "Optional[Tensor]")),
    "bias_act_grad2": (("ddx", "Tensor"),),
    "upfirdn2d": (("x", "Tensor"), ("f", "Tensor"), ("up", "List[int]"),
                  ("down", "List[int]"), ("padding", "List[int]")),
    "filtered_lrelu_fwd": (("x", "Tensor"), ("fu", "Optional[Tensor]"),
                           ("fd", "Optional[Tensor]"), ("up", "int"), ("down", "int"),
                           ("padding", "List[int]"), ("need_record", "bool")),
    "filtered_lrelu_bwd": (("dy", "Tensor"), ("fu", "Optional[Tensor]"),
                           ("fd", "Optional[Tensor]"), ("in_hw", "List[int]"), ("up", "int"),
                           ("down", "int"), ("padding", "List[int]")),
    "filtered_lrelu_lin": (("ddx", "Tensor"), ("fu", "Optional[Tensor]"),
                           ("fd", "Optional[Tensor]"), ("up", "int"), ("down", "int"),
                           ("padding", "List[int]")),
}


class UnreadLaunch(RuntimeError):
    """A launch of a hand-written kernel that this copy cannot read."""


def launch_bound(name, schema, shapes, args, dtypes):
    """`name`: the op (after 'latentaugment_torch::'); `schema`: its
    arguments as [(name, type)], in order; `shapes`, `args`, `dtypes`: the
    launch's input shapes, concrete inputs (scalars and int lists) and
    dtype names, as the profiler records them in that order. Returns
    (kernel, seconds); raises UnreadLaunch where the op or its arguments
    are not the ones this copy reads."""
    needs = NEEDS.get(name)
    if needs is None:
        raise UnreadLaunch(f"op {name!r} is not one the benchmark reads")
    types = dict(schema)
    wrong = [(a, t, types.get(a)) for a, t in needs if types.get(a) != t]
    if wrong:
        raise UnreadLaunch(f"op {name!r}: argument (name, wanted type, type) {wrong}")
    pos = {a: i for i, (a, _) in enumerate(schema)}
    if len(shapes) != len(schema) or len(args) != len(schema) or len(dtypes) != len(schema):
        raise UnreadLaunch(f"op {name!r}: {len(shapes)} shapes, {len(args)} inputs and "
                           f"{len(dtypes)} dtypes recorded for {len(schema)} arguments")

    def shape(a):
        return shapes[pos[a]]

    def arg(a):
        return args[pos[a]]

    first = needs[0][0]
    itemsize = ITEMSIZE.get(dtypes[pos[first]])
    if itemsize is None:
        raise UnreadLaunch(f"op {name!r}: dtype {dtypes[pos[first]]!r} of {first!r}")

    def taps(a):
        return shape(a)[0] if shape(a) else 1

    if name.startswith("bias_act"):
        w = k1_work(name, [shape(first), shape("x") if name == "bias_act_bwd" else []],
                    itemsize)
        return "k1", least_seconds(w["bytes"], w["macs"])
    if name == "upfirdn2d":
        w = k2_work(shape("x"), shape("f"), arg("up"), arg("down"), arg("padding"), itemsize)
        return "k2", least_seconds(w["bytes"], w["macs"])
    if name == "filtered_lrelu_fwd":
        w = k3_work(shape("x"), taps("fu"), taps("fd"), arg("up"), arg("down"), arg("padding"),
                    False, itemsize, bool(arg("need_record")))
    elif name == "filtered_lrelu_bwd":
        dy = shape("dy")
        w = k3_work([dy[0], dy[1], *arg("in_hw")], taps("fu"), taps("fd"), arg("up"),
                    arg("down"), arg("padding"), True, itemsize, True)
    else:  # filtered_lrelu_lin: the forward's geometry reading the record
        w = k3_work(shape("ddx"), taps("fu"), taps("fd"), arg("up"), arg("down"),
                    arg("padding"), False, itemsize, True)
    return "k3", least_seconds(w["bytes"], w["macs"])
