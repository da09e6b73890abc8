"""Filtered leaky ReLU, the StyleGAN3 op
(counterpart: latentaugment_tpu/ops/filtered_lrelu.py).

y = downsample(fd, clamp(lrelu(gain * upsample(fu, pad(x + b))))), with
the bias applied before the up-sampling and `padding` (w.r.t. the
up-sampled image, negative = crop) the only padding, on the up stage.
Two implementations sit side by side:

  * `_filtered_lrelu_ref`: plain PyTorch, the decomposed form of the JAX
    package (filtered_lrelu.py:126-131, :185-192) built from the port's
    own `bias_act` and `upfirdn2d` with impl='ref' on every inner call;
    autograd gives its gradient. It runs for CPU tensors and for
    `impl='ref'`, and takes 1-D and 2-D filters.
  * the same decomposed form with impl='auto' on the inner calls, for a
    CUDA tensor and a 2-D `fu` or `fd` (the radial filters of StyleGAN3-R's
    layers that are not critically sampled): kernel K1 for the two
    bias_act steps and kernel K2 for the two FIRs, K2's `generic` variant
    with its tap count at run time. The JAX package makes the same choice
    at the same place, from the filters' rank alone (`_fused_geometry`
    returns None for a non-separable filter, filtered_lrelu.py:143-145).
    `decomposed_calls['filtered_lrelu_decomposed']` counts these calls.
  * kernel K3, `csrc/filtered_lrelu.cu`, hand-written CUDA for sm_90a,
    built with nvcc at first use and called through ctypes inside the
    registered custom ops `latentaugment_torch::filtered_lrelu_fwd` /
    `::filtered_lrelu_bwd`, behind `_FilteredLReluFunction` when a
    gradient is needed. One launch does the whole op for a tile of
    outputs with the up-rate canvas in shared memory; the backward is
    the same kernel in its second mode, reading the sign/clamp record
    the forward writes when autograd needs it. It runs for every CUDA
    tensor with 1-D filters unless `impl='ref'`; there is no fallback on
    the card. It takes 1-D (separable) filters and raises for 2-D ones
    when handed them directly, and for filters that require grad.

The record holds 2 bits per up-rate pixel (bit 0: not positive, bit 1:
clamped), four pixels of a row per byte: [planes, mid_h, ceil(mid_w/4)]
uint8. `pack_record` / `unpack_record` are its plain form.

K3 is bound by fp32 multiply-adds (`work` counts them and the bytes).
`_plan` picks, from the geometry alone, one of the kernel's variants,
its tile and its shared memory: `u2t12_d2t12`, `u4t24_d2t12`,
`u2t12_d4t24` (the alias-free generator's layers and their backwards:
tap loops unrolled, taps as kernel parameters, register-blocked passes),
`u1t1_d1t1` (toRGB: pointwise) or `generic` (everything else: run-time
sizes). The launcher refuses a plan that does not fit its variant, and
nothing retries through another one. `variant_launches` counts launches
by variant. The header of the .cu file says what bounds it and how.
"""

import ctypes
import functools
import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from . import _build, _taps
from .bias_act import bias_act
from .upfirdn2d import _get_filter_size, _parse_padding, upfirdn2d

# Launches of kernel K3, counted where launched, by direction and by the
# plan's variant (both directions together); and the calls on a CUDA
# tensor that took the decomposed form through K1 and K2 (2-D filters).
launches = {'filtered_lrelu_fwd': 0, 'filtered_lrelu_bwd': 0}
decomposed_calls = {'filtered_lrelu_decomposed': 0}
variant_launches = {'u2t12_d2t12': 0, 'u4t24_d2t12': 0, 'u2t12_d4t24': 0,
                    'u1t1_d1t1': 0, 'generic': 0}


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
    route = _route(x.device, fu, fd, impl)
    if route == 'ref':
        return _filtered_lrelu_ref(x, fu, fd, b, up, down, padding, gain, slope,
                                   clamp, flip_filter)
    if route == 'decomposed':
        decomposed_calls['filtered_lrelu_decomposed'] += 1
        return _decomposed(x, fu, fd, b, up, down, padding, gain, slope, clamp, flip_filter,
                           impl='auto')
    for f in (fu, fd):
        if f is not None and f.requires_grad:
            raise ValueError("kernel K3 treats the filters as constants; "
                             "use impl='ref' to differentiate w.r.t. them")
    if torch.is_grad_enabled() and (x.requires_grad or (b is not None and b.requires_grad)):
        return _FilteredLReluFunction.apply(x, fu, fd, b, up, down, padding, gain, slope,
                                            clamp, bool(flip_filter))
    return torch.ops.latentaugment_torch.filtered_lrelu_fwd(
        x, fu, fd, b, up, down, list(padding), gain, slope, clamp, bool(flip_filter), False)[0]


def _route(device, fu, fd, impl):
    """Which form runs, from the device, the filters' rank and `impl`
    alone, before any launch: 'ref' (the plain version: CPU tensors or
    impl='ref'), 'decomposed' (a CUDA tensor and a 2-D filter: K1 and K2)
    or 'k3' (a CUDA tensor and 1-D filters)."""
    if impl == 'ref' or device.type == 'cpu':
        return 'ref'
    if device.type != 'cuda':
        raise NotImplementedError(f"filtered_lrelu has no kernel for {device}")
    return 'decomposed' if any(f is not None and f.ndim == 2 for f in (fu, fd)) else 'k3'


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
    """The decomposed form through the plain versions."""
    return _decomposed(x, fu, fd, b, up, down, padding, gain, slope, clamp, flip_filter,
                       impl='ref')


def _decomposed(x, fu, fd, b, up, down, padding, gain, slope, clamp, flip_filter, impl):
    """bias, up-FIR (gain up^2), lrelu*gain + clamp, down-FIR, each a
    bias_act or upfirdn2d call with `impl` (JAX: filtered_lrelu.py:185-192)."""
    batch, channels, in_h, in_w = x.shape
    mid_h, mid_w, out_h, out_w = _output_size(in_h, in_w, fu, fd, up, down, padding)
    if min(mid_h, mid_w, out_h, out_w) <= 0:
        raise ValueError("padded image is smaller than the filters")
    x = bias_act(x, b, impl=impl)
    x = upfirdn2d(x, fu, up=up, padding=list(padding), gain=up ** 2,
                  flip_filter=flip_filter, impl=impl)
    x = bias_act(x, act='lrelu', alpha=slope, gain=gain, clamp=clamp, impl=impl)
    x = upfirdn2d(x, fd, down=down, flip_filter=flip_filter, impl=impl)
    if tuple(x.shape) != (batch, channels, out_h, out_w):
        raise RuntimeError(f"filtered_lrelu shape {tuple(x.shape)} != "
                           f"{(batch, channels, out_h, out_w)}")
    return x


# ----------------------------------------------------------------------------
# Kernel K3 (CUDA C++, csrc/filtered_lrelu.cu).

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_TAPS = 64  # FLRELU_MAX_TAPS in the .cu file
_MAX_SMEM_BYTES = 232448  # 227 KB, the most a block can take
# The tile search keeps a tiled block under this, so that two fit an SM.
_TILED_SMEM_TARGET = 112 * 1024
_GENERIC_SMEM_TARGET = 64 * 1024
_TILED_VARIANTS = {(2, 12, 2, 12, False): 'u2t12_d2t12', (2, 12, 2, 12, True): 'u2t12_d2t12',
                   (4, 24, 2, 12, False): 'u4t24_d2t12', (2, 12, 4, 24, True): 'u2t12_d4t24'}
_PHASE_TAPS = 7  # FLRELU_PHASE_TAPS in the .cu file


def _library():
    lib = _build.load_cuda_library('filtered_lrelu.cu')
    fn = lib.filtered_lrelu_launch
    if fn.argtypes is None:
        i, f, p, ll = ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = ([p] * 6 + [i, ll, i] + [i] * 6
                       + [i] * 5 + [f] + [i] * 5 + [f] + [i, f, f, f, i, i, p])
        fn.restype = i
        lib.filtered_lrelu_tiled_launch.argtypes = (
            [p] * 4 + [i, ll, i] + [i] * 6 + [i] * 12 + [p] * 3 + [f, f, f, p])
        lib.filtered_lrelu_tiled_launch.restype = i
        lib.filtered_lrelu_pointwise_launch.argtypes = (
            [p] * 4 + [i, ll, i, i, i, i, f, f, f, p])
        lib.filtered_lrelu_pointwise_launch.restype = i
    return lib


def pack_record(bits):
    """[..., H, W] uint8 pairs (0..3) -> [..., H, ceil(W/4)] uint8, pixel x
    in bits 2*(x%4) of byte x//4."""
    w = bits.shape[-1]
    bits = F.pad(bits, [0, -w % 4]).reshape(*bits.shape[:-1], -1, 4)
    return (bits[..., 0] | (bits[..., 1] << 2) | (bits[..., 2] << 4)
            | (bits[..., 3] << 6)).contiguous()


def unpack_record(record, width):
    """The inverse of `pack_record` for rows of `width` pixels."""
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8, device=record.device)
    bits = (record[..., None] >> shifts) & 3
    return bits.reshape(*record.shape[:-1], -1)[..., :width].contiguous()


def _round_up(a, b):
    return -(-a // b) * b


def _geometry(in_hw, tu, td, up, down, padding, backward):
    """Sizes and stage parameters of one direction for filters of `tu` and
    `td` taps. The forward runs stage 1 = fu (up, the user padding's low
    side, gain up per axis) and stage 2 = fd (down, no padding). The
    backward is the transpose of each stage, as K2's backward
    (upfirdn2d.py): stage 1 = fd flipped with up = down and low padding
    taps - 1, stage 2 = fu flipped with down = up and low padding
    taps - 1 - p0. The mid grid is the up-rate canvas both ways; `in_hw`
    is the forward input's (H, W)."""
    px0, px1, py0, py1 = padding
    mid_w = in_hw[1] * up + px0 + px1 - (tu - 1)
    mid_h = in_hw[0] * up + py0 + py1 - (tu - 1)
    out_w = (mid_w - td + down) // down
    out_h = (mid_h - td + down) // down
    if not backward:
        return dict(in_hw=tuple(in_hw), mid_hw=(mid_h, mid_w), out_hw=(out_h, out_w),
                    up=up, pad1=(px0, py0), t1=tu, gain1=float(up),
                    down=down, pad2=(0, 0), t2=td, gain2=1.0, backward=False)
    return dict(in_hw=(out_h, out_w), mid_hw=(mid_h, mid_w), out_hw=tuple(in_hw),
                up=down, pad1=(td - 1, td - 1), t1=td, gain1=1.0,
                down=up, pad2=(tu - 1 - px0, tu - 1 - py0), t2=tu, gain2=float(up),
                backward=True)


def _stage_params(in_hw, fu, fd, up, down, padding, flip_filter, backward):
    """`_geometry` with the filters of each stage and their flips. K3
    takes 1-D filters only: `filtered_lrelu` sends 2-D ones to the
    decomposed form before it gets here."""
    for name, f in (('fu', fu), ('fd', fd)):
        if f is not None and f.ndim != 1:
            raise NotImplementedError(
                f"kernel K3 takes 1-D (separable) filters, got a {f.ndim}-D {name}; "
                "filtered_lrelu takes 2-D filters through kernels K1 and K2")
    tu, td = _get_filter_size(fu)[0], _get_filter_size(fd)[0]
    sp = _geometry(in_hw, tu, td, up, down, padding, backward)
    f1, f2 = (fd, fu) if backward else (fu, fd)
    flip = (not flip_filter) if backward else bool(flip_filter)
    sp.update(f1=f1, f2=f2, flip1=flip, flip2=flip)
    return sp


def _tiled_smem_bytes(up, toh, mh, mw):
    """Shared memory of the tiled kernel (tiled_smem_bytes in the .cu file)."""
    xh, xw = mh // up + 6, mw // up + 6
    px = _round_up(xw, 2)
    px += 2 if (px // 2) % 2 == 0 else 0
    region = _round_up(max(_round_up(xh * px, 4) + xh * (mw + 4), toh * (mw + 1)), 4)
    return 4 * (region + mh * mw)


def _generic_smem_bytes(up, t1, down, t2, to):
    """Shared memory of the generic kernel (generic_smem_bytes in the .cu file)."""
    mt = (to - 1) * down + t2
    xt = (mt + t1 - 2 + up) // up
    return 4 * (2 * _MAX_TAPS + max(xt * xt + xt * mt, mt * to) + mt * mt) + mt * mt


def _tiled_tile(up, down, t2, out_hw):
    """The tiled kernel's output tile for a geometry: of the candidates
    whose shared memory leaves room for two blocks on an SM (any that
    fits the card, failing that), the one with the fewest multiply-adds
    and middle steps over the whole image, halos and ragged edge tiles
    counted. Returns (toh, tow, mh, mw, smem)."""
    out_h, out_w = out_hw
    best = None
    for limit in (_TILED_SMEM_TARGET, _MAX_SMEM_BYTES):
        for toh in (8, 16, 24, 32, 40):
            for tow in (16, 32, 48, 64):
                mh = _round_up((toh - 1) * down + t2 + 3, 8)
                mw = _round_up((tow - 1) * down + t2 + 3, 8)
                smem = _tiled_smem_bytes(up, toh, mh, mw)
                if smem > limit:
                    continue
                xh = mh // up + 6
                cost = (_PHASE_TAPS * (xh + mh) * mw + t2 * toh * (mw + tow) + 8 * mh * mw)
                cost *= -(-out_h // toh) * -(-out_w // tow)
                if best is None or cost < best[0]:
                    best = (cost, toh, tow, mh, mw, smem)
        if best is not None:
            return best[1:]
    raise NotImplementedError("no tile of the tiled filtered_lrelu kernel fits shared memory")


def _plan(sp):
    """The kernel variant, tile and shared memory for the geometry `sp`
    (`_geometry`): a dict with 'variant' and, for the tiled variants,
    'toh', 'tow', 'mh', 'mw', 'smem'; for 'generic', 'tile' and 'smem'.
    The same geometry gives the same dict object: do not edit it."""
    return _plan_of(sp['up'], sp['t1'], sp['down'], sp['t2'], sp['backward'], sp['pad1'],
                    sp['pad2'], sp['in_hw'], sp['mid_hw'], sp['out_hw'])


@functools.lru_cache(maxsize=None)
def _plan_of(up, t1, down, t2, backward, pad1, pad2, in_hw, mid_hw, out_hw):
    variant = _TILED_VARIANTS.get((up, t1, down, t2, backward))
    if variant is not None:
        toh, tow, mh, mw, smem = _tiled_tile(up, down, t2, out_hw)
        return dict(variant=variant, toh=toh, tow=tow, mh=mh, mw=mw, smem=smem)
    if ((up, t1, down, t2) == (1, 1, 1, 1) and pad1 == (0, 0) and pad2 == (0, 0)
            and in_hw == mid_hw == out_hw):
        return dict(variant='u1t1_d1t1', smem=0)
    # A forward tile must own whole record bytes: tile * down % 4 == 0.
    tiles = [to for to in (32, 16, 8, 4) if backward or (to * down) % 4 == 0]
    for limit in (_GENERIC_SMEM_TARGET, _MAX_SMEM_BYTES):
        for to in tiles:
            smem = _generic_smem_bytes(up, t1, down, t2, to)
            if smem <= limit:
                return dict(variant='generic', tile=to, smem=smem)
    raise NotImplementedError("no tile of the generic filtered_lrelu kernel fits shared memory")


def work(x_shape, tu, td, up, down, padding, backward=False, itemsize=2, record=False):
    """What one launch must do whatever the tile: multiply-adds of the
    four 1-D passes (live taps only, each pass over exactly the rows and
    columns the next one needs of the whole image) and bytes moved (the
    input read once, the output written once, plus the record when it is
    written or read)."""
    planes = x_shape[0] * x_shape[1]
    sp = _geometry(tuple(x_shape[2:]), tu, td, up, down, _parse_padding(padding), backward)
    (in_h, in_w), (mid_h, mid_w), (out_h, out_w) = sp['in_hw'], sp['mid_hw'], sp['out_hw']
    live1 = -(-sp['t1'] // sp['up'])
    macs = (in_h * mid_w * live1 + mid_h * mid_w * live1
            + mid_h * out_w * sp['t2'] + out_h * out_w * sp['t2'])
    nbytes = (in_h * in_w + out_h * out_w) * itemsize
    record_bytes = mid_h * -(-mid_w // 4)
    return dict(macs=planes * macs, bytes=planes * (nbytes + (record_bytes if record else 0)),
                record_bytes=planes * record_bytes)


def _tiled_taps(sp):
    """Host arrays (t1x, t1y, t2) and origins (jx, jy) of a tiled launch:
    stage 1's polyphase tables per axis and stage 2's correlation taps,
    flips and per-axis gains folded in."""
    c1 = _taps.correlation_taps(_taps.host_taps(sp['f1']), sp['flip1'], sp['gain1'])
    c2 = _taps.correlation_taps(_taps.host_taps(sp['f2']), sp['flip2'], sp['gain2'])
    rows_x, jx = _taps.polyphase_table(c1, sp['up'], sp['pad1'][0])
    rows_y, jy = _taps.polyphase_table(c1, sp['up'], sp['pad1'][1])
    size = 4 * _PHASE_TAPS
    return (_taps.c_floats(sum(rows_x, ()), size), _taps.c_floats(sum(rows_y, ()), size),
            _taps.c_floats(c2, 24), jx, jy)


def _launch(x, bias, record, sp, slope, gain, clamp):
    """One launch of K3; returns the output [N, C, *sp['out_hw']]."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel K3 takes float32 or bfloat16, got {x.dtype}")
    if bias is not None and bias.dtype != x.dtype:
        raise TypeError(f"bias {bias.dtype} does not match the input {x.dtype}")
    for f in (sp['f1'], sp['f2']):
        if f is not None:
            if f.device != x.device:
                raise ValueError(f"filter on {f.device}, input on {x.device}")
            if f.shape[0] > _MAX_TAPS:
                raise NotImplementedError(f"kernel K3 takes at most {_MAX_TAPS} taps")
    x = x.contiguous()
    bias = bias.contiguous() if bias is not None else None
    n, c = x.shape[:2]
    (in_h, in_w), (mid_h, mid_w), (out_h, out_w) = sp['in_hw'], sp['mid_hw'], sp['out_hw']
    if tuple(x.shape[2:]) != (in_h, in_w):
        raise ValueError(f"input {tuple(x.shape)} does not match the plan {sp['in_hw']}")
    if min(mid_h, mid_w, out_h, out_w) <= 0:
        raise ValueError("padded image is smaller than the filters")
    if record is not None and (record.dtype != torch.uint8 or tuple(record.shape) != (
            n * c, mid_h, -(-mid_w // 4)) or not record.is_contiguous()):
        raise ValueError(f"record {tuple(record.shape)} {record.dtype} does not match the "
                         f"packed up-rate canvas {(n * c, mid_h, -(-mid_w // 4))}")
    backward = sp['backward']
    plan = _plan(sp)
    variant = plan['variant']
    if plan['smem'] > _MAX_SMEM_BYTES:
        raise RuntimeError(f"filtered_lrelu plan {plan} exceeds the card's shared memory")
    y = torch.empty([n, c, out_h, out_w], dtype=x.dtype, device=x.device)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    lib = _library()
    dtype, clamp_arg = _DTYPE_CODE[x.dtype], -1.0 if clamp is None else clamp
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if variant == 'generic':
            taps = [None if f is None else f.to(torch.float32).contiguous()
                    for f in (sp['f1'], sp['f2'])]
            err = lib.filtered_lrelu_launch(
                ptr(x), ptr(bias), ptr(taps[0]), ptr(taps[1]), y.data_ptr(), ptr(record),
                dtype, n * c, c, in_h, in_w, mid_h, mid_w, out_h, out_w,
                sp['up'], sp['pad1'][0], sp['pad1'][1], sp['t1'], int(sp['flip1']),
                sp['gain1'], sp['down'], sp['pad2'][0], sp['pad2'][1], sp['t2'],
                int(sp['flip2']), sp['gain2'], int(backward), slope, gain, clamp_arg,
                plan['tile'], plan['smem'], stream)
        elif variant == 'u1t1_d1t1':
            err = lib.filtered_lrelu_pointwise_launch(
                ptr(x), ptr(bias), y.data_ptr(), ptr(record), dtype, n * c, c, in_h, in_w,
                int(backward), slope, gain, clamp_arg, stream)
        else:
            t1x, t1y, t2, jx, jy = _tiled_taps(sp)
            err = lib.filtered_lrelu_tiled_launch(
                ptr(x), ptr(bias), y.data_ptr(), ptr(record), dtype, n * c, c,
                in_h, in_w, mid_h, mid_w, out_h, out_w, sp['up'], sp['down'], int(backward),
                sp['pad2'][0], sp['pad2'][1], jx, jy, plan['toh'], plan['tow'], plan['mh'],
                plan['mw'], plan['smem'], ctypes.addressof(t1x), ctypes.addressof(t1y),
                ctypes.addressof(t2), slope, gain, clamp_arg, stream)
    if err != 0:
        raise RuntimeError(f"filtered_lrelu kernel launch ({variant}) failed: CUDA error {err}")
    launches['filtered_lrelu_bwd' if backward else 'filtered_lrelu_fwd'] += 1
    variant_launches[variant] += 1
    return y


def _forward_kernel(x, fu, fd, b, up, down, padding, gain, slope, clamp, flip_filter,
                    need_record):
    """K3 forward: (y, record), record None unless asked for. `padding` is
    (x0, x1, y0, y1)."""
    sp = _stage_params(tuple(x.shape[2:]), fu, fd, up, down, padding, flip_filter,
                       backward=False)
    record = None
    if need_record:
        mid_h, mid_w = sp['mid_hw']
        record = torch.empty([x.shape[0] * x.shape[1], mid_h, -(-mid_w // 4)],
                             dtype=torch.uint8, device=x.device)
    return _launch(x, b, record, sp, slope, gain, clamp), record


def _backward_kernel(dy, record, in_hw, fu, fd, up, down, padding, gain, slope, flip_filter):
    """K3 backward: dx for the input of size `in_hw`, from the record."""
    sp = _stage_params(in_hw, fu, fd, up, down, padding, flip_filter, backward=True)
    return _launch(dy, None, record, sp, slope, gain, None)


def _record_ref(x, fu, b, up, padding, gain, slope, clamp, flip_filter):
    """The forward's packed record as the plain version sees it (bit 0:
    the up-rate value is not positive, bit 1: the clamp cut it), from the
    same ops in the same order as `_filtered_lrelu_ref`. Checks hand it to
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
    return pack_record(bits.reshape(-1, *u.shape[2:]))


# Kernel K3 is launched only through the registered custom ops
# `latentaugment_torch::filtered_lrelu_fwd` (the output and the record, an
# empty uint8 tensor when not asked for) and `::filtered_lrelu_bwd`, so
# that `torch.export` records each launch as an op of the program. Their
# fake versions give shapes and dtypes from the shapes alone (no filter
# value: the real ones copy the taps to the host). They have no CPU
# kernel: a CPU tensor raises.

def _filtered_lrelu_fwd_impl(x: torch.Tensor, fu: Optional[torch.Tensor],
                             fd: Optional[torch.Tensor], b: Optional[torch.Tensor], up: int,
                             down: int, padding: List[int], gain: float, slope: float,
                             clamp: Optional[float], flip_filter: bool,
                             need_record: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    y, record = _forward_kernel(x, fu, fd, b, up, down, tuple(padding), gain, slope, clamp,
                                flip_filter, need_record)
    return y, record if record is not None else x.new_empty([0], dtype=torch.uint8)


def _filtered_lrelu_bwd_impl(dy: torch.Tensor, record: torch.Tensor, fu: Optional[torch.Tensor],
                             fd: Optional[torch.Tensor], in_hw: List[int], up: int, down: int,
                             padding: List[int], gain: float, slope: float,
                             flip_filter: bool) -> torch.Tensor:
    return _backward_kernel(dy, record, tuple(in_hw), fu, fd, up, down, tuple(padding), gain,
                            slope, flip_filter)


_filtered_lrelu_fwd_op = torch.library.custom_op(
    "latentaugment_torch::filtered_lrelu_fwd", _filtered_lrelu_fwd_impl, mutates_args=(),
    device_types="cuda")
_filtered_lrelu_bwd_op = torch.library.custom_op(
    "latentaugment_torch::filtered_lrelu_bwd", _filtered_lrelu_bwd_impl, mutates_args=(),
    device_types="cuda")


def _check_dtype(x):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel K3 takes float32 or bfloat16, got {x.dtype}")


@_filtered_lrelu_fwd_op.register_fake
def _(x, fu, fd, b, up, down, padding, gain, slope, clamp, flip_filter, need_record):
    _check_dtype(x)
    sp = _stage_params(tuple(x.shape[2:]), fu, fd, up, down, tuple(padding), flip_filter,
                       backward=False)
    (mid_h, mid_w), n, c = sp['mid_hw'], x.shape[0], x.shape[1]
    record = [n * c, mid_h, -(-mid_w // 4)] if need_record else [0]
    return x.new_empty([n, c, *sp['out_hw']]), x.new_empty(record, dtype=torch.uint8)


@_filtered_lrelu_bwd_op.register_fake
def _(dy, record, fu, fd, in_hw, up, down, padding, gain, slope, flip_filter):
    _check_dtype(dy)
    return dy.new_empty([dy.shape[0], dy.shape[1], *in_hw])


class _FilteredLReluFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fu, fd, b, up, down, padding, gain, slope, clamp, flip_filter):
        y, record = torch.ops.latentaugment_torch.filtered_lrelu_fwd(
            x, fu, fd, b, up, down, list(padding), gain, slope, clamp, flip_filter, True)
        ctx.save_for_backward(fu, fd, record)
        ctx.cfg = (list(x.shape[2:]), up, down, list(padding), gain, slope, flip_filter)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        fu, fd, record = ctx.saved_tensors
        in_hw, up, down, padding, gain, slope, flip_filter = ctx.cfg
        dx = torch.ops.latentaugment_torch.filtered_lrelu_bwd(
            dy, record, fu, fd, in_hw, up, down, padding, gain, slope, flip_filter)
        db = dx.sum(dim=(0, 2, 3)) if ctx.needs_input_grad[3] else None
        return dx, None, None, db, None, None, None, None, None, None, None
