"""Alias-free (StyleGAN3) generator as PyTorch modules
(counterpart: latentaugment_tpu/models/stylegan3/networks.py).

Parameter and buffer names are the JAX package's parameter-tree paths
joined with dots (`synthesis.L2_52_512.affine.weight`,
`synthesis.input.freqs`), so a native checkpoint maps onto `state_dict()`
key for key (see ../stylegan2/checkpoint.py). A Fourier-feature input
plane with a per-sample similarity transform, then `num_layers`
modulated full convs, each followed by `filtered_lrelu` (kernel K3 on
the card) at the layer's temporary sampling rate, then a toRGB layer.
The mapping network is the StyleGAN2 one (2 layers by default). There is
no per-pixel noise: `synthesis` accepts and ignores `noise_mode` and
`generator`, so the walk engine calls both families alike. Each layer's
bfloat16 is decided at forward time from the live `cfg.num_fp16_res`;
unlike StyleGAN2, toRGB runs in bfloat16 too when it is chosen, and only
the final image is cast to float32. Unconditional only.
"""

import math

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ...ops.filtered_lrelu import filtered_lrelu
from ...ops.modulated_conv import modulated_conv2d
from ...utils.util_easydict import EasyDict
from ...utils.util_misc import span
from ..stylegan2.networks import (FullyConnectedLayer, MappingNetwork, _randn,
                                  _want_remat, set_impl)
from .filters import design_lowpass_filter


# ----------------------------------------------------------------------------
# Config: the per-layer sampling-rate plan (same fields and defaults as the
# JAX package).

def generator_config(z_dim=512, c_dim=0, w_dim=512, img_resolution=256,
                     img_channels=2, channel_base=32768, channel_max=512,
                     num_mapping_layers=2, mapping_lr_multiplier=0.01,
                     embed_features=None, num_layers=14, num_critical=2,
                     first_cutoff=2.0, first_stopband=2 ** 2.1,
                     last_stopband_rel=2 ** 0.3, margin_size=10,
                     output_scale=0.25, num_fp16_res=4, conv_clamp=256,
                     conv_kernel=3, filter_size=6, lrelu_upsampling=2,
                     use_radial_filters=False):
    """Alias-free generator config; the default is the translation-
    equivariant ('-t') variant. The rotation-equivariant ('-r') variant
    (conv_kernel=1, use_radial_filters=True, channel_base and channel_max
    doubled) has 2-D down filters in its layers that are not critically
    sampled; on the card filtered_lrelu runs those layers through kernels
    K1 and K2 (the decomposed form), the others through K3."""
    if embed_features is None:
        embed_features = w_dim if c_dim > 0 else 0
    cfg = EasyDict(arch='stylegan3', z_dim=z_dim, c_dim=c_dim, w_dim=w_dim,
                   img_resolution=img_resolution, img_channels=img_channels,
                   channel_base=channel_base, channel_max=channel_max,
                   num_mapping_layers=num_mapping_layers,
                   mapping_lr_multiplier=mapping_lr_multiplier,
                   embed_features=embed_features, num_layers=num_layers,
                   num_critical=num_critical, first_cutoff=first_cutoff,
                   first_stopband=first_stopband,
                   last_stopband_rel=last_stopband_rel,
                   margin_size=margin_size, output_scale=output_scale,
                   num_fp16_res=num_fp16_res, conv_clamp=conv_clamp,
                   conv_kernel=conv_kernel, filter_size=filter_size,
                   lrelu_upsampling=lrelu_upsampling,
                   use_radial_filters=use_radial_filters)
    if not num_layers > num_critical >= 0:
        raise ValueError(f"need num_layers > num_critical >= 0, got {num_layers}, {num_critical}")

    # Geometric interpolation of band parameters over the trunk; the last
    # `num_critical` layers run critically sampled at the output rate.
    last_cutoff = img_resolution / 2
    last_stopband = last_cutoff * last_stopband_rel
    exponents = np.minimum(
        np.arange(num_layers + 1) / (num_layers - num_critical), 1.0)
    cutoffs = first_cutoff * (last_cutoff / first_cutoff) ** exponents
    stopbands = first_stopband * (last_stopband / first_stopband) ** exponents
    sampling_rates = np.exp2(np.ceil(np.log2(
        np.minimum(stopbands * 2, img_resolution))))
    half_widths = np.maximum(stopbands, sampling_rates / 2) - cutoffs
    sizes = (sampling_rates + margin_size * 2).astype(np.int64)
    sizes[-2:] = img_resolution  # no margin once critically sampled at full res
    channels = np.rint(np.minimum(
        (channel_base / 2) / cutoffs, channel_max)).astype(np.int64)
    channels[-1] = img_channels

    layers = []
    for idx in range(num_layers + 1):
        prev = max(idx - 1, 0)
        is_torgb = idx == num_layers
        is_critically_sampled = idx >= num_layers - num_critical
        in_sr, out_sr = float(sampling_rates[prev]), float(sampling_rates[idx])
        k = 1 if is_torgb else conv_kernel
        tmp_sr = max(in_sr, out_sr) * (1 if is_torgb else lrelu_upsampling)
        up = int(round(tmp_sr / in_sr))
        down = int(round(tmp_sr / out_sr))
        up_taps = filter_size * up if up > 1 and not is_torgb else 1
        down_taps = filter_size * down if down > 1 and not is_torgb else 1
        in_size, out_size = int(sizes[prev]), int(sizes[idx])
        # Padding on the tmp-rate grid so the down stage lands exactly on
        # out_size, with the symmetric (half-up-step) phase convention.
        pad_total = (out_size - 1) * down + 1
        pad_total -= (in_size + k - 1) * up  # full conv output, upsampled
        pad_total += up_taps + down_taps - 2
        pad_lo = (pad_total + up) // 2
        pad_hi = pad_total - pad_lo
        layers.append(EasyDict(
            name=f'L{idx}_{out_size}_{int(channels[idx])}',
            is_torgb=is_torgb, is_critically_sampled=is_critically_sampled,
            in_channels=int(channels[prev]), out_channels=int(channels[idx]),
            in_size=in_size, out_size=out_size,
            in_sampling_rate=in_sr, out_sampling_rate=out_sr,
            tmp_sampling_rate=tmp_sr,
            in_cutoff=float(cutoffs[prev]), out_cutoff=float(cutoffs[idx]),
            in_half_width=float(half_widths[prev]),
            out_half_width=float(half_widths[idx]),
            conv_kernel=k, up_factor=up, down_factor=down,
            up_taps=up_taps, down_taps=down_taps,
            down_radial=bool(use_radial_filters and not is_critically_sampled),
            padding=(int(pad_lo), int(pad_hi)),
        ))
    cfg.layers = layers
    cfg.input = EasyDict(channels=int(channels[0]), size=int(sizes[0]),
                         sampling_rate=float(sampling_rates[0]),
                         bandwidth=float(cutoffs[0]))
    cfg.num_ws = num_layers + 2  # input transform + each layer incl. toRGB
    return cfg


def _layer_filters(layer):
    """Design a layer's up/down FIR taps (numpy; None = identity)."""
    fu = design_lowpass_filter(
        layer.up_taps, cutoff=layer.in_cutoff, width=layer.in_half_width * 2,
        fs=layer.tmp_sampling_rate)
    fd = design_lowpass_filter(
        layer.down_taps, cutoff=layer.out_cutoff,
        width=layer.out_half_width * 2, fs=layer.tmp_sampling_rate,
        radial=layer.down_radial)
    return fu, fd


def _layer_dtype(cfg, layer):
    """bfloat16 once the layer's sampling rate is within num_fp16_res
    doublings of the output resolution (read from the live cfg)."""
    n16 = int(cfg.num_fp16_res)
    lf16 = n16 > 0 and layer.out_sampling_rate * (2 ** n16) > cfg.img_resolution
    return torch.bfloat16 if lf16 else torch.float32


# ----------------------------------------------------------------------------
# Fourier-feature input plane

class SynthesisInput(nn.Module):
    """w [N, w_dim] -> feature plane [N, C0, size, size].

    freqs: random directions with magnitudes inside the input bandwidth;
    phases uniform in [-0.5, 0.5); the affine predicts a (cos, sin, tx,
    ty) similarity transform from w and starts at the identity (zero
    weight, bias [1, 0, 0, 0]); `transform` is the global 3x3 (row-vector
    convention, applied first)."""

    def __init__(self, gen, cfg):
        super().__init__()
        self.cfg = cfg
        ic = cfg.input
        freqs = _randn(gen, ic.channels, 2)
        radii = freqs.square().sum(dim=1, keepdim=True).sqrt()
        freqs = freqs / (radii * radii.square().exp() ** 0.25) * ic.bandwidth
        phases = torch.rand([ic.channels], generator=gen) - 0.5
        self.weight = nn.Parameter(_randn(gen, ic.channels, ic.channels))
        self.affine = FullyConnectedLayer(gen, cfg.w_dim, 4)
        with torch.no_grad():
            self.affine.weight.zero_()
            self.affine.bias.copy_(torch.tensor([1.0, 0.0, 0.0, 0.0]))
        self.register_buffer('transform', torch.eye(3))
        self.register_buffer('freqs', freqs)
        self.register_buffer('phases', phases)

    def forward(self, w, transform=None):
        ic = self.cfg.input
        n = w.shape[0]
        base = self.transform if transform is None else torch.as_tensor(
            transform, dtype=torch.float32, device=w.device)
        t = self.affine(w.float())  # [N, 4] (c, s, tx, ty)
        t = t / t[:, :2].square().sum(dim=1, keepdim=True).sqrt()
        eye = torch.eye(3, device=w.device).expand(n, 3, 3)
        m_r = eye.clone()
        m_r[:, 0, 0], m_r[:, 0, 1] = t[:, 0], -t[:, 1]
        m_r[:, 1, 0], m_r[:, 1, 1] = t[:, 1], t[:, 0]
        m_t = eye.clone()
        m_t[:, 0, 2], m_t[:, 1, 2] = -t[:, 2], -t[:, 3]
        transforms = m_r @ m_t @ base[None]

        phases = self.phases[None] + torch.einsum('cd,nd->nc', self.freqs, transforms[:, :2, 2])
        freqs = torch.einsum('cd,nde->nce', self.freqs, transforms[:, :2, :2])

        # Dampen features whose transformed frequency leaves the input band.
        amplitudes = (1 - (freqs.norm(dim=2) - ic.bandwidth)
                      / (ic.sampling_rate / 2 - ic.bandwidth)).clamp(0.0, 1.0)

        # Pixel-centre sampling grid of the input canvas (margin included);
        # freqs[..., 0] multiplies the W coordinate.
        coords = (torch.arange(ic.size, dtype=torch.float32, device=w.device)
                  + 0.5 - ic.size / 2) / ic.sampling_rate
        arg = (freqs[:, :, 0][:, None, None, :] * coords[None, None, :, None]
               + freqs[:, :, 1][:, None, None, :] * coords[None, :, None, None]
               + phases[:, None, None, :])
        x = torch.sin(arg * (2 * np.pi)) * amplitudes[:, None, None, :]
        weight = self.weight * float(1.0 / np.sqrt(ic.channels))
        return torch.einsum('nhwc,oc->nohw', x, weight)


# ----------------------------------------------------------------------------
# Synthesis layers

class SynthesisLayer(nn.Module):
    """Modulated full conv at the input rate, then filtered lrelu (up ->
    bias + lrelu (+clamp) -> down) onto the output grid. The input is
    pre-scaled by rsqrt(magnitude_ema), a buffer."""

    def __init__(self, gen, cfg, layer):
        super().__init__()
        self.layer = layer
        self.conv_clamp = cfg.conv_clamp
        self.impl = 'auto'
        self.affine = FullyConnectedLayer(gen, cfg.w_dim, layer.in_channels, bias_init=1.0)
        self.weight = nn.Parameter(_randn(gen, layer.out_channels, layer.in_channels,
                                          layer.conv_kernel, layer.conv_kernel))
        self.bias = nn.Parameter(torch.zeros([layer.out_channels]))
        self.register_buffer('magnitude_ema', torch.ones([]))
        fu, fd = _layer_filters(layer)
        # None buffers stay out of state_dict(), as the JAX tree omits them.
        self.register_buffer('up_filter', torch.as_tensor(fu) if fu is not None else None)
        self.register_buffer('down_filter', torch.as_tensor(fd) if fd is not None else None)

    def forward(self, x, w, dtype=torch.float32):
        layer = self.layer
        styles = self.affine(w.float())
        if layer.is_torgb:
            styles = styles * float(1.0 / np.sqrt(layer.in_channels * layer.conv_kernel ** 2))
        gain_in = torch.rsqrt(self.magnitude_ema.float())
        x = x.to(dtype) * gain_in.to(dtype)
        x = modulated_conv2d(x, self.weight.to(dtype), styles, padding=layer.conv_kernel - 1,
                             demodulate=not layer.is_torgb, flip_weight=True, impl=self.impl)
        # toRGB: identity nonlinearity (slope 1, gain 1); the clamp still applies.
        gain = 1.0 if layer.is_torgb else math.sqrt(2.0)
        slope = 1.0 if layer.is_torgb else 0.2
        pad_lo, pad_hi = layer.padding
        x = filtered_lrelu(x, fu=self.up_filter, fd=self.down_filter, b=self.bias.to(x.dtype),
                           up=layer.up_factor, down=layer.down_factor,
                           padding=[pad_lo, pad_hi, pad_lo, pad_hi], gain=gain, slope=slope,
                           clamp=self.conv_clamp, impl=self.impl)
        if x.shape[2] != layer.out_size or x.shape[3] != layer.out_size:
            raise RuntimeError(f"{layer.name}: output {tuple(x.shape)}, "
                               f"expected {layer.out_size}x{layer.out_size}")
        return x


class SynthesisNetwork(nn.Module):
    def __init__(self, gen, cfg):
        super().__init__()
        self.cfg = cfg
        self.input = SynthesisInput(gen, cfg)
        for layer in cfg.layers:
            setattr(self, layer.name, SynthesisLayer(gen, cfg, layer))

    def forward(self, ws, noise_mode='const', generator=None, remat=False, transform=None,
                rows=None):
        """ws [N, num_ws, w_dim] -> image [N, img_channels, res, res].

        noise_mode/generator/rows are accepted for StyleGAN2 call-site
        compatibility and ignored (this generator draws no noise). remat
        checkpoints layers (bool = all, int = layers whose out_size >=
        remat). `transform` overrides the stored global input transform."""
        with span("G.synthesis"):
            del noise_mode, generator, rows
            cfg = self.cfg
            if ws.shape[1] != cfg.num_ws:
                raise ValueError(f"ws has {ws.shape[1]} layers, the generator takes {cfg.num_ws}")
            x = self.input(ws[:, 0], transform=transform)
            for i, layer in enumerate(cfg.layers):
                mod = getattr(self, layer.name)
                args = (x, ws[:, i + 1], _layer_dtype(cfg, layer))
                if _want_remat(remat, layer.out_size) and torch.is_grad_enabled():
                    x = checkpoint(mod, *args, use_reentrant=False)
                else:
                    x = mod(*args)
            x = x.float()
            if cfg.output_scale != 1.0:
                x = x * float(cfg.output_scale)
            return x


# ----------------------------------------------------------------------------
# Generator (the mapping is the StyleGAN2 one)

class Generator(nn.Module):
    """mapping + synthesis. `seed` draws the random init (a native
    checkpoint loaded with load_state_dict replaces it)."""

    def __init__(self, cfg, seed=0, impl='auto'):
        super().__init__()
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        self.mapping = MappingNetwork(gen, cfg)
        self.synthesis = SynthesisNetwork(gen, cfg)
        set_impl(self, impl)

    def forward(self, z, c=None, truncation_psi=1.0, noise_mode='const', generator=None,
                transform=None, rows=None):
        ws = self.mapping(z, c, truncation_psi=truncation_psi)
        return self.synthesis(ws, noise_mode=noise_mode, generator=generator,
                              transform=transform)
