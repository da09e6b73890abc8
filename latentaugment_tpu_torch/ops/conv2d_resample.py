"""2-D convolution with optional FIR-filtered up/downsampling
(counterpart: latentaugment_tpu/ops/conv2d_resample.py:156-239).

The same padding algebra and fast-path order as the JAX package; the
convolutions are `F.conv2d` / `F.conv_transpose2d` and every FIR goes
through `upfirdn2d` (kernel K2 on the card). All tensors NCHW, weights
OIHW ([out, in//groups, kh, kw]).
"""

import torch.nn.functional as F

from .upfirdn2d import _get_filter_size, _parse_padding, upfirdn2d


def _conv2d_wrapper(x, w, stride=1, padding=0, groups=1, transpose=False,
                    flip_weight=True):
    """flip_weight=True is cross-correlation (the F.conv2d convention);
    False flips the kernel spatially first (true convolution). With
    transpose=True, w is in conv_transpose layout [in, out//groups, kh, kw]."""
    kh, kw = int(w.shape[-2]), int(w.shape[-1])
    if not flip_weight and (kw > 1 or kh > 1):
        w = w.flip([2, 3])
    op = F.conv_transpose2d if transpose else F.conv2d
    return op(x, w, stride=stride, padding=padding, groups=groups)


def conv2d_resample(x, w, f=None, up=1, down=1, padding=0, groups=1,
                    flip_weight=True, flip_filter=False, impl='auto'):
    """2-D convolution with optional FIR-filtered up/downsampling.

    Args:
      x: [N, C_in, H, W].
      w: [C_out, C_in//groups, kh, kw].
      f: low-pass FIR filter from setup_filter(), or None.
      up/down: integer resampling factors.
      padding: int / [x, y] / [x0, x1, y0, y1], w.r.t. the upsampled image.
      groups: grouped conv count.
      flip_weight: False = convolution, True = correlation.
      flip_filter: same convention for the FIR filter.
      impl: passed to upfirdn2d ('auto' or 'ref').
    """
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError("conv2d_resample expects NCHW x and OIHW w")
    if not (isinstance(up, int) and up >= 1 and isinstance(down, int) and down >= 1):
        raise ValueError(f"up and down must be ints >= 1, got {up}, {down}")
    out_channels, in_channels_per_group, kh, kw = (int(s) for s in w.shape)
    fw, fh = _get_filter_size(f)
    px0, px1, py0, py1 = _parse_padding(padding)

    # Adjust padding to account for up/downsampling.
    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2

    # Fast path: 1x1 conv with downsampling only => downsample first.
    if kw == 1 and kh == 1 and (down > 1 and up == 1):
        x = upfirdn2d(x, f, down=down, padding=[px0, px1, py0, py1],
                      flip_filter=flip_filter, impl=impl)
        return _conv2d_wrapper(x, w, groups=groups, flip_weight=flip_weight)

    # Fast path: 1x1 conv with upsampling only => convolve first.
    if kw == 1 and kh == 1 and (up > 1 and down == 1):
        x = _conv2d_wrapper(x, w, groups=groups, flip_weight=flip_weight)
        return upfirdn2d(x, f, up=up, padding=[px0, px1, py0, py1], gain=up ** 2,
                         flip_filter=flip_filter, impl=impl)

    # Fast path: downsampling only => strided convolution.
    if down > 1 and up == 1:
        x = upfirdn2d(x, f, padding=[px0, px1, py0, py1], flip_filter=flip_filter,
                      impl=impl)
        return _conv2d_wrapper(x, w, stride=down, groups=groups,
                               flip_weight=flip_weight)

    # Fast path: upsampling (optional downsampling) => transpose strided conv.
    if up > 1:
        if groups == 1:
            wt = w.transpose(0, 1)
        else:
            wt = w.reshape(groups, out_channels // groups, in_channels_per_group, kh, kw)
            wt = wt.transpose(1, 2)
            wt = wt.reshape(groups * in_channels_per_group, out_channels // groups, kh, kw)
        px0 -= kw - 1
        px1 -= kw - up
        py0 -= kh - 1
        py1 -= kh - up
        pxt = max(min(-px0, -px1), 0)
        pyt = max(min(-py0, -py1), 0)
        x = _conv2d_wrapper(x, wt, stride=up, padding=[pyt, pxt], groups=groups,
                            transpose=True, flip_weight=(not flip_weight))
        x = upfirdn2d(x, f, padding=[px0 + pxt, px1 + pxt, py0 + pyt, py1 + pyt],
                      gain=up ** 2, flip_filter=flip_filter, impl=impl)
        if down > 1:
            x = upfirdn2d(x, f, down=down, flip_filter=flip_filter, impl=impl)
        return x

    # Fast path: no resampling, symmetric non-negative padding => plain conv.
    if up == 1 and down == 1:
        if px0 == px1 and py0 == py1 and px0 >= 0 and py0 >= 0:
            return _conv2d_wrapper(x, w, padding=[py0, px0], groups=groups,
                                   flip_weight=flip_weight)

    # Fallback: generic path.
    x = upfirdn2d(x, (f if up > 1 else None), up=up, padding=[px0, px1, py0, py1],
                  gain=up ** 2, flip_filter=flip_filter, impl=impl)
    x = _conv2d_wrapper(x, w, groups=groups, flip_weight=flip_weight)
    if down > 1:
        x = upfirdn2d(x, f, down=down, flip_filter=flip_filter, impl=impl)
    return x
