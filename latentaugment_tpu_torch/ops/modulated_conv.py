"""Style-modulated convolution, input-scaling form
(counterpart: latentaugment_tpu/ops/modulated_conv.py:53-68).

Scale the input by the style, run one shared-weight convolution for the
whole batch, then scale the output by the demodulation coefficients in
closed form:

    dcoef[n, o] = rsqrt( (s^2 @ Wsq^T)[n, o] + eps ),  Wsq[o,i] = sum_k w[o,i,k]^2
"""

import torch

from .conv2d_resample import conv2d_resample


def modulated_conv2d(x, weight, styles, noise=None, up=1, down=1, padding=0,
                     resample_filter=None, demodulate=True, flip_weight=True,
                     eps=1e-8, impl='auto'):
    """Args:
      x: [N, I, H, W] input.
      weight: [O, I, kh, kw] shared conv weight.
      styles: [N, I] per-sample modulation.
      noise: optional additive noise broadcastable to the output.
      up/down/padding/resample_filter/flip_weight/impl: as conv2d_resample.
      demodulate: apply weight demodulation (True except toRGB layers).
    Returns [N, O, H', W'].
    """
    batch_size = x.shape[0]
    out_channels, in_channels, kh, kw = (int(s) for s in weight.shape)
    if tuple(styles.shape) != (batch_size, in_channels):
        raise ValueError(f"styles {tuple(styles.shape)} != ({batch_size}, {in_channels})")

    if demodulate:
        # fp32 whatever the activation dtype, then cast.
        w_sq = weight.float().square().sum(dim=(2, 3))  # [O, I]
        dcoefs = torch.rsqrt(styles.float().square() @ w_sq.T + eps)  # [N, O]

    x = x * styles.to(x.dtype)[:, :, None, None]
    x = conv2d_resample(x, weight.to(x.dtype), f=resample_filter, up=up, down=down,
                        padding=padding, flip_weight=flip_weight, impl=impl)
    if demodulate:
        x = x * dcoefs.to(x.dtype)[:, :, None, None]
    if noise is not None:
        x = x + noise.to(x.dtype)
    return x
