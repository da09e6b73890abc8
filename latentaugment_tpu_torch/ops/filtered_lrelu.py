"""Filtered leaky ReLU, the StyleGAN3 op
(counterpart: latentaugment_tpu/ops/filtered_lrelu.py).

y = downsample(fd, clamp(lrelu(gain * upsample(fu, pad(x + b))))), with
the bias applied before the up-sampling and `padding` (w.r.t. the
up-sampled image, negative = crop) the only padding, on the up stage.
Two implementations sit side by side:

  * `_filtered_lrelu_ref`: plain PyTorch, the decomposed form of the JAX
    package (filtered_lrelu.py:126-131, :185-192) built from the port's
    own `bias_act` and `upfirdn2d` with impl='ref' on every inner call
    (with 'auto' a CUDA tensor would reach kernel K2, which takes at most
    4 taps); autograd gives its gradient. It runs for CPU tensors and
    for `impl='ref'`, and takes 1-D and 2-D filters.
  * kernel K3, `csrc/filtered_lrelu.cu`, hand-written CUDA for sm_90a,
    built with nvcc at first use and called through ctypes, behind
    `_FilteredLReluFunction`. One launch does the whole op for a tile of
    outputs with the up-rate canvas in shared memory; the backward is
    the same kernel in its second mode, reading the 1-byte sign/clamp
    record the forward writes when autograd needs it. It runs for every
    CUDA tensor unless `impl='ref'`; there is no fallback on the card. It
    takes 1-D (separable) filters and raises for 2-D ones (the radial
    SG3-R filters) and for filters that require grad. The header of the
    .cu file says what bounds it and how.
"""

import ctypes
import math

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import _build
from .bias_act import bias_act
from .upfirdn2d import _get_filter_size, _parse_padding, upfirdn2d

# Launches of kernel K3, counted where launched.
launches = {'filtered_lrelu_fwd': 0, 'filtered_lrelu_bwd': 0}


def filtered_lrelu(x, fu=None, fd=None, b=None, up=1, down=1, padding=0,
                   gain=None, slope=0.2, clamp=None, flip_filter=False,
                   impl='auto'):
    """Filtered leaky ReLU of NCHW `x` (see the module docstring).

    fu / fd: up / down FIR filters (1-D separable or 2-D; None = [1]);
    b: per-channel bias; `gain` defaults to sqrt(2); `slope` is the lrelu
    negative slope; `clamp` the symmetric output clamp (None = none);
    flip_filter False = convolution, True = correlation. The output is
    [N, C, (in*up + p0 + p1 - (fu-1) - (fd-1) + down-1) // down] per axis.
    impl: 'auto' (kernel K3 on CUDA tensors, plain PyTorch on CPU tensors)
    or 'ref' (plain PyTorch everywhere).
    """
    if x.ndim != 4:
        raise ValueError(f"filtered_lrelu expects NCHW, got shape {tuple(x.shape)}")
    if impl not in ('auto', 'ref'):
        raise ValueError(f"impl must be 'auto' or 'ref', got {impl!r}")
    up, down = int(up), int(down)
    if up < 1 or down < 1:
        raise ValueError(f"up and down must be >= 1, got {up}, {down}")
    padding = _parse_padding(padding)
    gain = math.sqrt(2.0) if gain is None else float(gain)
    slope = float(slope)
    clamp = None if clamp is None else float(clamp)
    if b is not None and (b.ndim != 1 or b.shape[0] != x.shape[1]):
        raise ValueError(f"bias shape {tuple(b.shape)} does not match "
                         f"{x.shape[1]} channels")
    if impl == 'ref' or x.device.type == 'cpu':
        return _filtered_lrelu_ref(x, fu, fd, b, up, down, padding, gain, slope,
                                   clamp, flip_filter)
    if x.device.type != 'cuda':
        raise NotImplementedError(f"filtered_lrelu has no kernel for {x.device}")
    for name, f in (('fu', fu), ('fd', fd)):
        if f is None:
            continue
        if f.ndim != 1:
            raise NotImplementedError(
                f"kernel K3 takes 1-D (separable) filters, got a {f.ndim}-D {name}; "
                "use impl='ref' for the radial (2-D) filters")
        if f.requires_grad:
            raise ValueError("kernel K3 treats the filters as constants; "
                             "use impl='ref' to differentiate w.r.t. them")
    need_record = torch.is_grad_enabled() and (
        x.requires_grad or (b is not None and b.requires_grad))
    return _FilteredLReluFunction.apply(x, fu, fd, b, up, down, padding, gain, slope,
                                        clamp, bool(flip_filter), need_record)


def _output_size(in_h, in_w, fu, fd, up, down, padding):
    """(mid_h, mid_w, out_h, out_w): the up-rate canvas and the output."""
    fu_w, fu_h = _get_filter_size(fu)
    fd_w, fd_h = _get_filter_size(fd)
    px0, px1, py0, py1 = padding
    mid_w = in_w * up + px0 + px1 - (fu_w - 1)
    mid_h = in_h * up + py0 + py1 - (fu_h - 1)
    out_w = (mid_w - fd_w + down) // down
    out_h = (mid_h - fd_h + down) // down
    return mid_h, mid_w, out_h, out_w


def _filtered_lrelu_ref(x, fu, fd, b, up, down, padding, gain, slope, clamp,
                        flip_filter):
    """The decomposed form: bias, up-FIR (gain up^2), lrelu*gain + clamp,
    down-FIR, each through the plain versions."""
    batch, channels, in_h, in_w = x.shape
    mid_h, mid_w, out_h, out_w = _output_size(in_h, in_w, fu, fd, up, down, padding)
    if min(mid_h, mid_w, out_h, out_w) <= 0:
        raise ValueError("padded image is smaller than the filters")
    x = bias_act(x, b, impl='ref')
    x = upfirdn2d(x, fu, up=up, padding=list(padding), gain=up ** 2,
                  flip_filter=flip_filter, impl='ref')
    x = bias_act(x, act='lrelu', alpha=slope, gain=gain, clamp=clamp, impl='ref')
    x = upfirdn2d(x, fd, down=down, flip_filter=flip_filter, impl='ref')
    if tuple(x.shape) != (batch, channels, out_h, out_w):
        raise RuntimeError(f"filtered_lrelu shape {tuple(x.shape)} != "
                           f"{(batch, channels, out_h, out_w)}")
    return x


# ----------------------------------------------------------------------------
# Kernel K3 (CUDA C++, csrc/filtered_lrelu.cu).

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_TAPS = 64  # FLRELU_MAX_TAPS in the .cu file


def _library():
    lib = _build.load_cuda_library('filtered_lrelu.cu')
    fn = lib.filtered_lrelu_launch
    if fn.argtypes is None:
        i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
        fn.argtypes = ([p] * 6 + [i, ctypes.c_longlong, i] + [i] * 6
                       + [i] * 5 + [f] + [i] * 5 + [f] + [i, f, f, f, p])
        fn.restype = ctypes.c_int
    return fn


def _stage_params(in_hw, fu, fd, up, down, padding, flip_filter, backward):
    """Launcher arguments of one direction. The forward runs stage 1 = fu
    (up, the user padding's low side, gain up per axis) and stage 2 = fd
    (down, no padding). The backward is the transpose of each stage, as
    K2's backward (upfirdn2d.py): stage 1 = fd flipped with up = down
    and low padding taps - 1, stage 2 = fu flipped with down = up and low
    padding taps - 1 - p0. The mid grid is the up-rate canvas both ways;
    `in_hw` is the forward input's (H, W)."""
    tu, td = _get_filter_size(fu)[0], _get_filter_size(fd)[0]
    px0, _, py0, _ = padding
    mid_h, mid_w, out_h, out_w = _output_size(*in_hw, fu, fd, up, down, padding)
    if not backward:
        return dict(f1=fu, f2=fd, in_hw=in_hw, mid_hw=(mid_h, mid_w), out_hw=(out_h, out_w),
                    up=up, pad1=(px0, py0), t1=tu, flip1=flip_filter, gain1=float(up),
                    down=down, pad2=(0, 0), t2=td, flip2=flip_filter, gain2=1.0)
    return dict(f1=fd, f2=fu, in_hw=(out_h, out_w), mid_hw=(mid_h, mid_w), out_hw=in_hw,
                up=down, pad1=(td - 1, td - 1), t1=td, flip1=not flip_filter, gain1=1.0,
                down=up, pad2=(tu - 1 - px0, tu - 1 - py0), t2=tu, flip2=not flip_filter,
                gain2=float(up))


def _launch(x, bias, record, sp, backward, slope, gain, clamp):
    """One launch of K3; returns the output [N, C, *sp['out_hw']]."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel K3 takes float32 or bfloat16, got {x.dtype}")
    if bias is not None and bias.dtype != x.dtype:
        raise TypeError(f"bias {bias.dtype} does not match the input {x.dtype}")
    taps = []
    for f in (sp['f1'], sp['f2']):
        if f is not None:
            if f.device != x.device:
                raise ValueError(f"filter on {f.device}, input on {x.device}")
            if f.shape[0] > _MAX_TAPS:
                raise NotImplementedError(f"kernel K3 takes at most {_MAX_TAPS} taps")
            f = f.to(torch.float32).contiguous()
        taps.append(f)
    x = x.contiguous()
    bias = bias.contiguous() if bias is not None else None
    n, c = x.shape[:2]
    (in_h, in_w), (mid_h, mid_w), (out_h, out_w) = sp['in_hw'], sp['mid_hw'], sp['out_hw']
    if tuple(x.shape[2:]) != (in_h, in_w):
        raise ValueError(f"input {tuple(x.shape)} does not match the plan {sp['in_hw']}")
    if min(mid_h, mid_w, out_h, out_w) <= 0:
        raise ValueError("padded image is smaller than the filters")
    y = torch.empty([n, c, out_h, out_w], dtype=x.dtype, device=x.device)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    fn = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(ptr(x), ptr(bias), ptr(taps[0]), ptr(taps[1]), y.data_ptr(), ptr(record),
                 _DTYPE_CODE[x.dtype], n * c, c, in_h, in_w, mid_h, mid_w, out_h, out_w,
                 sp['up'], sp['pad1'][0], sp['pad1'][1], sp['t1'], int(sp['flip1']),
                 sp['gain1'], sp['down'], sp['pad2'][0], sp['pad2'][1], sp['t2'],
                 int(sp['flip2']), sp['gain2'], int(backward), slope, gain,
                 -1.0 if clamp is None else clamp, stream)
    if err != 0:
        raise RuntimeError(f"filtered_lrelu kernel launch failed: CUDA error {err}")
    launches['filtered_lrelu_bwd' if backward else 'filtered_lrelu_fwd'] += 1
    return y


def _forward_kernel(x, fu, fd, b, up, down, padding, gain, slope, clamp, flip_filter,
                    need_record):
    """K3 forward: (y, record), record None unless asked for. `padding` is
    (x0, x1, y0, y1)."""
    sp = _stage_params(tuple(x.shape[2:]), fu, fd, up, down, padding, flip_filter,
                       backward=False)
    record = None
    if need_record:
        record = torch.empty([x.shape[0] * x.shape[1], *sp['mid_hw']],
                             dtype=torch.uint8, device=x.device)
    return _launch(x, b, record, sp, False, slope, gain, clamp), record


def _backward_kernel(dy, record, in_hw, fu, fd, up, down, padding, gain, slope, flip_filter):
    """K3 backward: dx for the input of size `in_hw`, from the record."""
    sp = _stage_params(in_hw, fu, fd, up, down, padding, flip_filter, backward=True)
    return _launch(dy, None, record, sp, True, slope, gain, None)


def _record_ref(x, fu, b, up, padding, gain, slope, clamp, flip_filter):
    """The forward's record as the plain version sees it (bit 0: the
    up-rate value is not positive, bit 1: the clamp cut it), from the same
    ops in the same order as `_filtered_lrelu_ref`. Checks hand it to
    `_backward_kernel` to hold the backward kernel against the plain
    backward at one and the same mask: where an up-rate value lies within
    rounding of 0 the two sides may otherwise take different branches of
    lrelu's derivative."""
    u = bias_act(x, b, impl='ref')
    u = upfirdn2d(u, fu, up=up, padding=list(padding), gain=up ** 2,
                  flip_filter=flip_filter, impl='ref')
    v = F.leaky_relu(u, slope)
    if gain != 1.0:
        v = v * gain
    bits = (~(u > 0)).to(torch.uint8)
    if clamp is not None:
        bits |= (v.abs() > clamp).to(torch.uint8) << 1
    return bits.reshape(-1, *u.shape[2:]).contiguous()


class _FilteredLReluFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fu, fd, b, up, down, padding, gain, slope, clamp, flip_filter,
                need_record):
        y, record = _forward_kernel(x, fu, fd, b, up, down, padding, gain, slope, clamp,
                                    flip_filter, need_record)
        ctx.save_for_backward(fu, fd, record)
        ctx.cfg = (tuple(x.shape[2:]), up, down, padding, gain, slope, flip_filter)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        fu, fd, record = ctx.saved_tensors
        if record is None:
            raise RuntimeError("filtered_lrelu backward without the forward's record")
        in_hw, up, down, padding, gain, slope, flip_filter = ctx.cfg
        dx = _backward_kernel(dy, record, in_hw, fu, fd, up, down, padding, gain, slope,
                              flip_filter)
        db = dx.sum(dim=(0, 2, 3)) if ctx.needs_input_grad[3] else None
        return dx, None, None, db, None, None, None, None, None, None, None, None
