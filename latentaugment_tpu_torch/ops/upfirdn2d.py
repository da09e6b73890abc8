"""Pad -> upsample -> FIR filter -> downsample for batches of 2-D images
(counterpart: latentaugment_tpu/ops/upfirdn2d.py).

Two implementations sit side by side:

  * `_upfirdn2d_ref`: plain PyTorch, the depthwise-conv form of the op
    definition (the JAX package's `_upfirdn2d_ref`); autograd gives its
    gradient. It runs for CPU tensors and for `impl='ref'`.
  * kernel K2, `csrc/upfirdn2d.cu`, hand-written CUDA for sm_90a, built
    with nvcc at first use and called through ctypes inside the registered
    custom op `latentaugment_torch::upfirdn2d` (behind
    `_Upfirdn2dFunction` when a gradient is needed). Forward and
    backward are the same kernels; the backward swaps up and down, flips
    the filter and transforms the padding, as the Pallas kernel's custom
    VJP does (latentaugment_tpu/ops/upfirdn2d.py:598-614), and is itself
    differentiable, so second derivatives launch K2 too. It runs for
    every CUDA tensor unless `impl='ref'`; there is no fallback on the
    card. It takes filters of up to 64 taps per axis, 1-D or 2-D, and
    raises for larger ones.

K2 is bound by bytes (`work` counts them). `_plan` picks, from the
geometry alone, one of the kernel's variants and its tile: `u1d1`, `u1d2`
and `u2d1` (the separable 4-tap filter at the three rate pairs of the
StyleGAN2 walk and its backward: a staged shared-memory tile, two
register-blocked 1-D passes, taps as kernel parameters) or `generic`
(2-D filters, other rates, other tap counts: one thread per output),
which has two instantiations: tap loops unrolled for at most 4 taps per
axis, and a tap count known only at run time for up to 64 (StyleGAN3-R's
12- and 24-tap up filters and radial 12x12 down filter, on the
decomposed filtered_lrelu). The launcher refuses a plan that does not
fit its variant, and nothing retries through another one.
`variant_launches` counts launches by variant. The header of the .cu
file says what bounds it and how.
"""

import ctypes
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from . import _build, _taps

# Launches of kernel K2 (forward and backward), counted where launched,
# in all and by the plan's variant.
launches = {'upfirdn2d': 0}
variant_launches = {'u1d1': 0, 'u1d2': 0, 'u2d1': 0, 'generic': 0}


def _parse_scaling(scaling):
    if isinstance(scaling, int):
        scaling = [scaling, scaling]
    sx, sy = (int(s) for s in scaling)
    if sx < 1 or sy < 1:
        raise ValueError(f"scaling factors must be >= 1, got {scaling}")
    return sx, sy


def _parse_padding(padding):
    if isinstance(padding, int):
        padding = [padding, padding]
    padding = [int(p) for p in padding]
    if len(padding) == 2:
        padx, pady = padding
        padding = [padx, padx, pady, pady]
    padx0, padx1, pady0, pady1 = padding
    return padx0, padx1, pady0, pady1


def _get_filter_size(f):
    if f is None:
        return 1, 1
    if f.ndim not in (1, 2):
        raise ValueError(f"filter must be 1-D or 2-D, got {f.ndim}-D")
    return int(f.shape[-1]), int(f.shape[0])


def setup_filter(f, device=torch.device('cpu'), normalize=True, flip_filter=False,
                 gain=1, separable=None):
    """Prepare a 2-D FIR filter for upfirdn2d (normalize / flip / gain).

    Returns a float32 tensor: [fh, fw] (non-separable) or [taps]
    (separable)."""
    if f is None:
        f = 1
    f = np.asarray(f, dtype=np.float32)
    if f.ndim not in (0, 1, 2) or f.size == 0:
        raise ValueError(f"bad filter shape {f.shape}")
    if f.ndim == 0:
        f = f[np.newaxis]
    if separable is None:
        separable = (f.ndim == 1 and f.size >= 8)
    if f.ndim == 1 and not separable:
        f = np.outer(f, f)
    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = f[::-1] if f.ndim == 1 else f[::-1, ::-1]
    f = f * (gain ** (f.ndim / 2))
    return torch.as_tensor(f.copy(), dtype=torch.float32, device=device)


def separable_factor(f2d):
    """1-D taps `a` with f2d == outer(a, a), or None (numpy, on the host;
    counterpart: latentaugment_tpu/ops/upfirdn2d.py:84-105).

    Checkpoints store the StyleGAN2 resample filter as the 2-D buffer
    outer([1,3,3,1], [1,3,3,1]) / 64; the kernel's separable variants take
    only its 1-D taps, so converters factor it. A filter that is not
    rank 1, or rank 1 but not symmetric, gives None."""
    f = np.asarray(f2d, np.float64)
    if f.ndim == 1:
        return f.astype(np.float32)
    if f.ndim != 2 or f.shape[0] != f.shape[1]:
        return None
    u, s, vt = np.linalg.svd(f)
    if s[0] <= 0 or (len(s) > 1 and s[1:].max() > 1e-6 * s[0]):
        return None
    a = u[:, 0] * np.sqrt(s[0])
    b = vt[0] * np.sqrt(s[0])
    if a.sum() < 0:
        a, b = -a, -b
    if not np.allclose(a, b, atol=1e-9):
        return None
    return a.astype(np.float32)


def upfirdn2d(x, f, up=1, down=1, padding=0, flip_filter=False, gain=1,
              impl='auto'):
    """Apply the upsample/pad/FIR/downsample pipeline to NCHW `x`.

    `padding` is [x0, x1, y0, y1] w.r.t. the upsampled image (negative =
    crop); flip_filter False = convolution, True = correlation; `gain`
    scales the output. impl: 'auto' (kernel K2 on CUDA tensors, plain
    PyTorch on CPU tensors) or 'ref' (plain PyTorch everywhere).
    """
    if x.ndim != 4:
        raise ValueError(f"upfirdn2d expects NCHW, got shape {tuple(x.shape)}")
    if impl not in ('auto', 'ref'):
        raise ValueError(f"impl must be 'auto' or 'ref', got {impl!r}")
    if impl == 'ref' or x.device.type == 'cpu':
        return _upfirdn2d_ref(x, f, up, down, padding, flip_filter, gain)
    if x.device.type != 'cuda':
        raise NotImplementedError(f"upfirdn2d has no kernel for {x.device}")
    if f is None:
        f = torch.ones([1, 1], dtype=torch.float32, device=x.device)
    if f.requires_grad:
        raise ValueError("kernel K2 treats the filter as a constant; "
                         "use impl='ref' to differentiate w.r.t. it")
    args = (x, f, _parse_scaling(up), _parse_scaling(down), _parse_padding(padding),
            bool(flip_filter), float(gain))
    if torch.is_grad_enabled() and x.requires_grad:
        return _Upfirdn2dFunction.apply(*args)
    return torch.ops.latentaugment_torch.upfirdn2d(*args)


def _upfirdn2d_ref(x, f, up, down, padding, flip_filter, gain):
    """Literal translation of the op definition, depthwise-conv form."""
    batch, channels, in_h, in_w = x.shape
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    if in_w * upx + padx0 + padx1 < fw or in_h * upy + pady0 + pady1 < fh:
        raise ValueError("padded image is smaller than the filter")

    # Upsample by zero insertion.
    x = x.reshape(batch, channels, in_h, 1, in_w, 1)
    x = F.pad(x, [0, upx - 1, 0, 0, 0, upy - 1])
    x = x.reshape(batch, channels, in_h * upy, in_w * upx)

    # Pad or crop.
    x = F.pad(x, [max(padx0, 0), max(padx1, 0), max(pady0, 0), max(pady1, 0)])
    x = x[:, :, max(-pady0, 0): x.shape[2] - max(-pady1, 0),
          max(-padx0, 0): x.shape[3] - max(-padx1, 0)]

    # Gain and the flip convention (conv2d correlates; the op convolves).
    if f is None:
        f = torch.ones([1, 1], dtype=torch.float32, device=x.device)
    f = f * (gain ** (f.ndim / 2))
    if not flip_filter:
        f = f.flip(list(range(f.ndim)))
    f = f.to(x.dtype)
    if f.ndim == 1:
        x = F.conv2d(x, f[None, None, None, :].repeat(channels, 1, 1, 1), groups=channels)
        x = F.conv2d(x, f[None, None, :, None].repeat(channels, 1, 1, 1), groups=channels)
    else:
        x = F.conv2d(x, f[None, None].repeat(channels, 1, 1, 1), groups=channels)

    # Downsample by throwing away pixels.
    return x[:, :, ::downy, ::downx]


# ----------------------------------------------------------------------------
# Kernel K2 (CUDA C++, csrc/upfirdn2d.cu).

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_TAPS = 64  # per axis, of `generic`; UPFIRDN2D_MAX_TAPS in the .cu file
_MAX_SMEM_BYTES = 232448  # 227 KB, the most a block can take
# Output tile (rows, columns) of the separable variants on a large map.
_SEP4_TILES = {'u1d1': (32, 128), 'u1d2': (32, 64), 'u2d1': (32, 128)}


def _library():
    lib = _build.load_cuda_library('upfirdn2d.cu')
    fn = lib.upfirdn2d_launch
    if fn.argtypes is None:
        i, p = ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [p] * 3 + [i, ctypes.c_longlong] + [i] * 14 + [ctypes.c_float, p]
        fn.restype = i
        lib.upfirdn2d_sep4_launch.argtypes = [p, p, i, ctypes.c_longlong] + [i] * 11 + [p] * 3
        lib.upfirdn2d_sep4_launch.restype = i
    return lib


def _round_up(a, b):
    return -(-a // b) * b


def _sep4_smem_bytes(up, down, toh, tow):
    """Shared memory of the separable kernel (sep4_smem_bytes in the .cu
    file): the staged tile with its halo and the rows filtered along W."""
    def window(n):
        return (n - 1) * down + 4 if up == 1 else n // 2 + 2
    xh, xw = window(toh), window(tow)
    return 4 * (xh * _round_up(xw, 4) + xh * tow)


def _plan(f_shape, up, down, out_hw):
    """The kernel variant and tile for a filter of shape `f_shape`, rate
    pairs `up` and `down` (x, y) and an output of `out_hw`: a dict with
    'variant' and, for the separable variants, the output tile ('toh',
    'tow') and its shared memory ('smem'). `generic` takes up to
    _MAX_TAPS taps per axis (its launcher picks the unrolled
    instantiation for 4 or fewer); a larger filter raises."""
    sep4 = tuple(f_shape) == (4,) and up[0] == up[1] and down[0] == down[1]
    variant = {(1, 1): 'u1d1', (1, 2): 'u1d2', (2, 1): 'u2d1'}.get((up[0], down[0])) \
        if sep4 else None
    if variant is None:
        fw, fh = (f_shape[0], f_shape[0]) if len(f_shape) == 1 else (f_shape[1], f_shape[0])
        if max(fw, fh) > _MAX_TAPS:
            raise NotImplementedError(f"kernel K2 takes at most {_MAX_TAPS} taps per axis, "
                                      f"got a {fh}x{fw} filter; use impl='ref'")
        return dict(variant='generic')
    toh, tow = _SEP4_TILES[variant]
    toh, tow = min(toh, _round_up(out_hw[0], 2)), min(tow, _round_up(out_hw[1], 4))
    return dict(variant=variant, toh=toh, tow=tow,
                smem=_sep4_smem_bytes(up[0], down[0], toh, tow))


def work(x_shape, f_shape, up=1, down=1, padding=0, itemsize=2):
    """What one call must do whatever the kernel: bytes moved (the input
    read once, the output written once) and multiply-adds (the two 1-D
    passes of a separable filter, or the 2-D product, live taps only)."""
    n, c, in_h, in_w = x_shape
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
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


def _sep4_taps(f, variant, padding, flip_filter, gain):
    """Host arrays (tx, ty) and the origins (ox, oy) of a separable
    launch: the 4 correlation taps and the low padding, or for up = 2 the
    polyphase tables and the input index of their first entry. The gain
    rides on the taps along H."""
    taps = _taps.correlation_taps(_taps.host_taps(f), flip_filter)
    padx0, _, pady0, _ = padding
    if variant == 'u2d1':
        rows_x, ox = _taps.polyphase_table(taps, 2, padx0)
        rows_y, oy = _taps.polyphase_table(taps, 2, pady0)
        tx = rows_x[0] + rows_x[1]
        ty = rows_y[0] + rows_y[1]
    else:
        tx, ty, ox, oy = taps, taps, padx0, pady0
    ty = tuple(t * gain for t in ty)
    return _taps.c_floats(tx, 8), _taps.c_floats(ty, 8), ox, oy


def _output_shape(x, f, up, down, padding):
    """[N, C, out_h, out_w] of a launch, from the shapes alone."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel K2 takes float32 or bfloat16, got {x.dtype}")
    fw, fh = _get_filter_size(f)
    n, c, in_h, in_w = x.shape
    out_h = (in_h * up[1] + padding[2] + padding[3] - fh) // down[1] + 1
    out_w = (in_w * up[0] + padding[0] + padding[1] - fw) // down[0] + 1
    if out_h <= 0 or out_w <= 0:
        raise ValueError("padded image is smaller than the filter")
    return [n, c, out_h, out_w]


# Kernel K2 is launched only through the registered custom op
# `latentaugment_torch::upfirdn2d`, so that `torch.export` records each
# launch as an op of the program. Its fake version gives the output's
# shape and dtype from the shapes alone: it reads no filter value (the
# real one copies the taps to the host, which synchronises). It has no
# CPU kernel: a CPU tensor raises.

def _upfirdn2d_impl(x: torch.Tensor, f: torch.Tensor, up: List[int], down: List[int],
                    padding: List[int], flip_filter: bool, gain: float) -> torch.Tensor:
    return _launch(x, f, tuple(up), tuple(down), tuple(padding), flip_filter, gain)


_upfirdn2d_op = torch.library.custom_op("latentaugment_torch::upfirdn2d", _upfirdn2d_impl,
                                        mutates_args=(), device_types="cuda")


@_upfirdn2d_op.register_fake
def _(x, f, up, down, padding, flip_filter, gain):
    return x.new_empty(_output_shape(x, f, up, down, padding))


def _launch(x, f, up, down, padding, flip_filter, gain):
    """y = upfirdn2d(x) on the card. up/down are (x, y) pairs, padding is
    (x0, x1, y0, y1)."""
    if f.device != x.device:
        raise ValueError(f"filter on {f.device}, input on {x.device}")
    fw, fh = _get_filter_size(f)
    n, c, out_h, out_w = _output_shape(x, f, up, down, padding)
    x = x.contiguous()
    upx, upy = up
    downx, downy = down
    padx0, pady0 = padding[0], padding[2]
    in_h, in_w = x.shape[2:]
    plan = _plan(f.shape, up, down, (out_h, out_w))
    y = torch.empty([n, c, out_h, out_w], dtype=x.dtype, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if plan['variant'] == 'generic':
            f = f.to(torch.float32).contiguous()
            err = lib.upfirdn2d_launch(
                x.data_ptr(), y.data_ptr(), f.data_ptr(), _DTYPE_CODE[x.dtype],
                n * c, in_h, in_w, out_h, out_w, upx, upy, downx, downy,
                padx0, pady0, fw, fh, int(f.ndim == 1), int(flip_filter),
                float(gain), stream)
        else:
            if plan['smem'] > _MAX_SMEM_BYTES:
                raise RuntimeError(f"upfirdn2d plan {plan} exceeds the card's shared memory")
            tx, ty, ox, oy = _sep4_taps(f, plan['variant'], padding, flip_filter, float(gain))
            err = lib.upfirdn2d_sep4_launch(
                x.data_ptr(), y.data_ptr(), _DTYPE_CODE[x.dtype], n * c, in_h, in_w,
                out_h, out_w, upx, downx, ox, oy, plan['toh'], plan['tow'], plan['smem'],
                ctypes.addressof(tx), ctypes.addressof(ty), stream)
    if err != 0:
        raise RuntimeError(f"upfirdn2d kernel launch ({plan['variant']}) failed: "
                           f"CUDA error {err}")
    launches['upfirdn2d'] += 1
    variant_launches[plan['variant']] += 1
    return y


def transposed_padding(x_shape, y_shape, f_size, up, down, padding):
    """The padding (x0, x1, y0, y1) of the backward launch, the forward
    transposed: up and down swapped, the filter flipped. `f_size` is
    (fw, fh), up / down (x, y) pairs, `padding` the forward's."""
    (fw, fh), (upx, upy), (downx, downy) = f_size, up, down
    padx0, _, pady0, _ = padding
    ih, iw = x_shape[2:]
    oh, ow = y_shape[2:]
    return (fw - padx0 - 1, iw * upx - ow * downx + padx0 - upx + 1,
            fh - pady0 - 1, ih * upy - oh * downy + pady0 - upy + 1)


class _Upfirdn2dFunction(torch.autograd.Function):
    """K2 under autograd. The backward is this Function again (up and
    down swapped, the filter flipped, the padding transformed), so it has
    a backward of its own and derivatives of any order launch K2: R1 and
    path-length regularisation differentiate a gradient."""

    @staticmethod
    def forward(ctx, x, f, up, down, padding, flip_filter, gain):
        y = torch.ops.latentaugment_torch.upfirdn2d(x, f, up, down, padding, flip_filter, gain)
        ctx.save_for_backward(f)
        ctx.cfg = (up, down, padding, flip_filter, gain, x.shape)
        return y

    @staticmethod
    def backward(ctx, dy):
        f, = ctx.saved_tensors
        up, down, padding, flip_filter, gain, x_shape = ctx.cfg
        p = transposed_padding(x_shape, dy.shape, _get_filter_size(f), up, down, padding)
        dx = _Upfirdn2dFunction.apply(dy, f, down, up, p, not flip_filter, gain)
        if dx.shape != x_shape:
            raise RuntimeError(f"upfirdn2d backward shape {tuple(dx.shape)} "
                               f"!= input shape {tuple(x_shape)}")
        return dx, None, None, None, None, None, None


# ----------------------------------------------------------------------------
# Convenience wrappers.

def filter2d(x, f, padding=0, flip_filter=False, gain=1, impl='auto'):
    """FIR-filter images; output padded to match input shape by default."""
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [padx0 + fw // 2, padx1 + (fw - 1) // 2,
         pady0 + fh // 2, pady1 + (fh - 1) // 2]
    return upfirdn2d(x, f, padding=p, flip_filter=flip_filter, gain=gain, impl=impl)


def upsample2d(x, f, up=2, padding=0, flip_filter=False, gain=1, impl='auto'):
    """Upsample images by `up` with FIR smoothing (output gain up^2)."""
    upx, upy = _parse_scaling(up)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [padx0 + (fw + upx - 1) // 2, padx1 + (fw - upx) // 2,
         pady0 + (fh + upy - 1) // 2, pady1 + (fh - upy) // 2]
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter,
                     gain=gain * upx * upy, impl=impl)


def downsample2d(x, f, down=2, padding=0, flip_filter=False, gain=1, impl='auto'):
    """Downsample images by `down` with FIR anti-aliasing."""
    downx, downy = _parse_scaling(down)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [padx0 + (fw - downx + 1) // 2, padx1 + (fw - downx) // 2,
         pady0 + (fh - downy + 1) // 2, pady1 + (fh - downy) // 2]
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter,
                     gain=gain, impl=impl)
