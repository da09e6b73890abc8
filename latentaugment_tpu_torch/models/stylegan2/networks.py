"""StyleGAN2 generator and discriminator as PyTorch modules
(counterpart: latentaugment_tpu/models/stylegan2/networks.py).

Parameter and buffer names are the JAX package's parameter-tree paths
joined with dots (`synthesis.b4.conv1.weight`), so a native checkpoint
maps onto `state_dict()` key for key (see checkpoint.py). Every conv and
FC ends in `bias_act` (kernel K1 on the card) and every FIR resample runs
through `upfirdn2d` (kernel K2). The top `num_fp16_res` resolutions of G
and D run in bfloat16; torgb runs in float32. A conditional pair
(`c_dim > 0`) embeds the label in G's mapping and projects D's output on
a mapping of the label, as the JAX package's networks do.
"""

import math

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ...ops.bias_act import activation_funcs, bias_act
from ...ops.conv2d_resample import conv2d_resample
from ...ops.modulated_conv import modulated_conv2d
from ...ops.upfirdn2d import setup_filter, upsample2d
from ...utils.util_easydict import EasyDict
from ...utils.util_misc import span


# ----------------------------------------------------------------------------
# Config (same fields and defaults as the JAX package).

def generator_config(z_dim=512, c_dim=0, w_dim=512, img_resolution=256,
                     img_channels=2, channel_base=32768, channel_max=512,
                     num_mapping_layers=8, conv_clamp=256, num_fp16_res=0,
                     mapping_lr_multiplier=0.01, embed_features=None):
    if embed_features is None:
        embed_features = w_dim if c_dim > 0 else 0
    cfg = EasyDict(z_dim=z_dim, c_dim=c_dim, w_dim=w_dim,
                   img_resolution=img_resolution, img_channels=img_channels,
                   channel_base=channel_base, channel_max=channel_max,
                   num_mapping_layers=num_mapping_layers, conv_clamp=conv_clamp,
                   num_fp16_res=num_fp16_res,
                   mapping_lr_multiplier=mapping_lr_multiplier,
                   embed_features=embed_features)
    cfg.block_resolutions = [2 ** i for i in range(2, int(math.log2(img_resolution)) + 1)]
    cfg.channels = {res: min(channel_base // res, channel_max) for res in cfg.block_resolutions}
    # One w per conv, plus one for the final toRGB.
    cfg.num_ws = sum(1 if res == 4 else 2 for res in cfg.block_resolutions) + 1
    return cfg


def discriminator_config(c_dim=0, img_resolution=256, img_channels=2,
                         channel_base=32768, channel_max=512, conv_clamp=256,
                         num_fp16_res=0, mbstd_group_size=4, mbstd_num_channels=1,
                         cmap_dim=None, num_mapping_layers=8,
                         mapping_lr_multiplier=0.01):
    cfg = EasyDict(c_dim=c_dim, img_resolution=img_resolution,
                   img_channels=img_channels, channel_base=channel_base,
                   channel_max=channel_max, conv_clamp=conv_clamp,
                   num_fp16_res=num_fp16_res, mbstd_group_size=mbstd_group_size,
                   mbstd_num_channels=mbstd_num_channels,
                   num_mapping_layers=num_mapping_layers,
                   mapping_lr_multiplier=mapping_lr_multiplier)
    cfg.block_resolutions = [2 ** i for i in range(int(math.log2(img_resolution)), 2, -1)]
    cfg.channels = {res: min(channel_base // res, channel_max)
                    for res in cfg.block_resolutions + [4]}
    if cmap_dim is None:
        cmap_dim = cfg.channels[4] if c_dim > 0 else 0
    cfg.cmap_dim = cmap_dim
    return cfg


def _cmap_mapping_cfg(cfg):
    """Config of D's label-mapping network: a mapping with z_dim 0, an
    embed of width cmap_dim, no w_avg and no broadcast."""
    return EasyDict(z_dim=0, c_dim=cfg.c_dim, w_dim=cfg.cmap_dim,
                    num_mapping_layers=cfg.num_mapping_layers,
                    mapping_lr_multiplier=cfg.mapping_lr_multiplier,
                    embed_features=cfg.cmap_dim, num_ws=0)


def _fp16_resolutions(cfg):
    """The resolutions that run in bfloat16: the top `num_fp16_res`."""
    if cfg.num_fp16_res <= 0:
        return set()
    return set(sorted(cfg.block_resolutions)[-cfg.num_fp16_res:])


def _want_remat(remat, res):
    """remat: bool (all blocks) or int (blocks with res >= remat)."""
    if isinstance(remat, bool):
        return remat
    return res >= int(remat)


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, dtype=torch.float32)


# ----------------------------------------------------------------------------
# Layers. Random init follows the JAX package's distributions, drawn from
# an explicit CPU torch.Generator.

class FullyConnectedLayer(nn.Module):
    """Equalized-lr linear + bias_act. The stored weight is
    randn / lr_multiplier (bias: bias_init / lr_multiplier): forward
    multiplies by lr_multiplier, so the effective init std is 1/sqrt(in)."""

    def __init__(self, gen, in_features, out_features, bias=True, bias_init=0.0,
                 activation='linear', lr_multiplier=1.0):
        super().__init__()
        self.activation = activation
        self.lr_multiplier = lr_multiplier
        self.impl = 'auto'
        self.weight = nn.Parameter(_randn(gen, out_features, in_features) / lr_multiplier)
        self.bias = nn.Parameter(torch.full([out_features], float(bias_init) / lr_multiplier)) \
            if bias else None

    def forward(self, x):
        in_features = self.weight.shape[1]
        w = self.weight.to(x.dtype) * float(self.lr_multiplier / np.sqrt(in_features))
        x = x @ w.T
        b = self.bias.to(x.dtype) * self.lr_multiplier if self.bias is not None else None
        return bias_act(x, b, act=self.activation, impl=self.impl)


class Conv2dLayer(nn.Module):
    """Equalized-lr conv with optional down-sampling + bias_act."""

    def __init__(self, gen, in_channels, out_channels, kernel_size, bias=True,
                 activation='linear', down=1, gain=1.0, conv_clamp=None):
        super().__init__()
        self.activation = activation
        self.down = down
        self.gain = gain
        self.conv_clamp = conv_clamp
        self.impl = 'auto'
        self.weight = nn.Parameter(_randn(gen, out_channels, in_channels,
                                          kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros([out_channels])) if bias else None

    def forward(self, x, f=None):
        out_ch, in_ch, kh, kw = self.weight.shape
        w = self.weight.to(x.dtype) * float(1.0 / np.sqrt(in_ch * kh * kw))
        x = conv2d_resample(x, w, f=f, down=self.down, padding=kh // 2,
                            impl=self.impl)
        act_gain = float(activation_funcs[self.activation].def_gain) * self.gain
        act_clamp = self.conv_clamp * self.gain if self.conv_clamp is not None else None
        b = self.bias.to(x.dtype) if self.bias is not None else None
        return bias_act(x, b, act=self.activation, gain=act_gain, clamp=act_clamp,
                        impl=self.impl)


# ----------------------------------------------------------------------------
# Mapping network

def normalize_2nd_moment(x):
    return x * torch.rsqrt(x.square().mean(dim=1, keepdim=True) + 1e-8)


class MappingNetwork(nn.Module):
    """z (and a label c when c_dim > 0: a plain FC embed, 2nd-moment
    normalized and concatenated with the normalized z) -> w."""

    def __init__(self, gen, cfg, with_w_avg=True):
        super().__init__()
        self.cfg = cfg
        embed_features = int(cfg.get('embed_features', 0) or 0)
        features = [cfg.z_dim + embed_features] + [cfg.w_dim] * cfg.num_mapping_layers
        for i in range(cfg.num_mapping_layers):
            setattr(self, f'fc{i}', FullyConnectedLayer(
                gen, features[i], features[i + 1], activation='lrelu',
                lr_multiplier=cfg.mapping_lr_multiplier))
        if cfg.c_dim > 0:
            self.embed = FullyConnectedLayer(gen, cfg.c_dim, embed_features)
        if with_w_avg:
            self.register_buffer('w_avg', torch.zeros([cfg.w_dim]))

    def forward(self, z, c=None, truncation_psi=1.0, truncation_cutoff=None,
                broadcast=True):
        """z, c -> w (+ truncation toward w_avg, + broadcast to num_ws)."""
        with span("G.mapping"):
            cfg = self.cfg
            x = normalize_2nd_moment(z.float()) if cfg.z_dim > 0 else None
            if cfg.c_dim > 0:
                if c is None:
                    raise ValueError(f"c_dim = {cfg.c_dim} needs labels c [N, {cfg.c_dim}]")
                y = normalize_2nd_moment(self.embed(c.float()))
                x = y if x is None else torch.cat([x, y], dim=1)
            for i in range(cfg.num_mapping_layers):
                x = getattr(self, f'fc{i}')(x)
            if truncation_psi != 1.0 and (truncation_cutoff is None or not broadcast):
                x = self.w_avg + truncation_psi * (x - self.w_avg)
            if broadcast:
                x = x[:, None, :].repeat(1, cfg.num_ws, 1)
                if truncation_psi != 1.0 and truncation_cutoff is not None:
                    x = x.clone()
                    x[:, :truncation_cutoff] = self.w_avg + truncation_psi * (
                        x[:, :truncation_cutoff] - self.w_avg)
            return x


# ----------------------------------------------------------------------------
# Synthesis network

class SynthesisLayer(nn.Module):
    """Modulated conv + noise + lrelu."""

    def __init__(self, gen, in_channels, out_channels, w_dim, resolution, up=1,
                 conv_clamp=None, kernel_size=3):
        super().__init__()
        self.up = up
        self.resolution = resolution
        self.conv_clamp = conv_clamp
        self.impl = 'auto'
        self.affine = FullyConnectedLayer(gen, w_dim, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(_randn(gen, out_channels, in_channels,
                                          kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros([out_channels]))
        self.register_buffer('noise_const', _randn(gen, resolution, resolution))
        self.noise_strength = nn.Parameter(torch.zeros([]))

    def forward(self, x, w, f, noise_mode='const', noise=None, gain=1.0):
        """noise_mode: 'const' | 'random' (`noise`, a draw of
        [N, 1, res, res] standard normals) | 'none'."""
        styles = self.affine(w)
        if noise_mode == 'const':
            noise = self.noise_const.to(x.dtype) * self.noise_strength.to(x.dtype)
        elif noise_mode == 'random':
            noise = noise * self.noise_strength.to(x.dtype)
        elif noise_mode == 'none':
            noise = None
        else:
            raise ValueError(f"unknown noise_mode {noise_mode!r}")
        kh = self.weight.shape[-1]
        x = modulated_conv2d(x, self.weight.to(x.dtype), styles, noise=noise,
                             up=self.up, padding=kh // 2, resample_filter=f,
                             flip_weight=(self.up == 1), impl=self.impl)
        act_gain = float(activation_funcs['lrelu'].def_gain) * gain
        act_clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, self.bias.to(x.dtype), act='lrelu', gain=act_gain,
                        clamp=act_clamp, impl=self.impl)


class ToRGBLayer(nn.Module):
    def __init__(self, gen, in_channels, out_channels, w_dim, conv_clamp=None):
        super().__init__()
        self.conv_clamp = conv_clamp
        self.impl = 'auto'
        self.affine = FullyConnectedLayer(gen, w_dim, in_channels, bias_init=1.0)
        self.weight = nn.Parameter(_randn(gen, out_channels, in_channels, 1, 1))
        self.bias = nn.Parameter(torch.zeros([out_channels]))

    def forward(self, x, w):
        in_ch = self.weight.shape[1]
        styles = self.affine(w) * float(1.0 / np.sqrt(in_ch))
        x = modulated_conv2d(x, self.weight.to(x.dtype), styles, demodulate=False,
                             impl=self.impl)
        return bias_act(x, self.bias.to(x.dtype), clamp=self.conv_clamp,
                        impl=self.impl)


class SynthesisBlock(nn.Module):
    def __init__(self, gen, cfg, res):
        super().__init__()
        self.res = res
        in_ch = cfg.channels[res // 2] if res > 4 else 0
        out_ch = cfg.channels[res]
        if res == 4:
            self.const = nn.Parameter(_randn(gen, out_ch, 4, 4))
        else:
            self.conv0 = SynthesisLayer(gen, in_ch, out_ch, cfg.w_dim, res, up=2,
                                        conv_clamp=cfg.conv_clamp)
        self.conv1 = SynthesisLayer(gen, out_ch, out_ch, cfg.w_dim, res,
                                    conv_clamp=cfg.conv_clamp)
        self.torgb = ToRGBLayer(gen, out_ch, cfg.img_channels, cfg.w_dim,
                                conv_clamp=cfg.conv_clamp)

    def forward(self, x, ws, f, dtype, noise_mode, noises):
        """ws: this block's [N, n_conv + 1, w_dim] slice; noises: one
        random-noise draw per conv ('random' mode) or None. Returns (x, rgb)."""
        noises = noises or (None, None)
        if self.res == 4:
            x = self.const.to(dtype)[None].expand(ws.shape[0], -1, -1, -1)
            w_idx = 0
        else:
            x = self.conv0(x.to(dtype), ws[:, 0], f, noise_mode, noises[0])
            w_idx = 1
        x = self.conv1(x, ws[:, w_idx], f, noise_mode, noises[-1])
        y = self.torgb(x.float(), ws[:, w_idx + 1])
        return x, y


class SynthesisNetwork(nn.Module):
    def __init__(self, gen, cfg):
        super().__init__()
        self.cfg = cfg
        self.impl = 'auto'
        for res in cfg.block_resolutions:
            setattr(self, f'b{res}', SynthesisBlock(gen, cfg, res))
        self.register_buffer('resample_filter', setup_filter([1, 3, 3, 1], separable=True))

    def forward(self, ws, noise_mode='const', generator=None, remat=False, rows=None):
        """ws [N, num_ws, w_dim] -> image [N, img_channels, res, res] (skip
        architecture). remat checkpoints blocks (bool = all, int = blocks
        with res >= remat): the backward recomputes their activations.
        Random noise is drawn from `generator` before each block, so that a
        recomputed block sees the same noise. Under data parallelism `rows`
        (parallel.mesh.Rows) says which rows of a global batch ws holds:
        the noise is drawn for the global batch and its rows taken."""
        with span("G.synthesis"):
            cfg = self.cfg
            f = self.resample_filter
            fp16 = _fp16_resolutions(cfg)
            x = img = None
            w_idx = 0
            for res in cfg.block_resolutions:
                block = getattr(self, f'b{res}')
                dtype = torch.bfloat16 if res in fp16 else torch.float32
                n_conv = 1 if res == 4 else 2
                noises = None
                if noise_mode == 'random':
                    draw = torch.randn if rows is None else rows.randn
                    noises = tuple(draw([ws.shape[0], 1, res, res], generator=generator,
                                        device=ws.device, dtype=dtype)
                                   for _ in range(n_conv))
                args = (x, ws[:, w_idx:w_idx + n_conv + 1], f, dtype, noise_mode, noises)
                if _want_remat(remat, res) and torch.is_grad_enabled():
                    x, y = checkpoint(block, *args, use_reentrant=False)
                else:
                    x, y = block(*args)
                w_idx += n_conv
                img = y if img is None else upsample2d(img, f, up=2, impl=self.impl) + y
            return img


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
                rows=None):
        ws = self.mapping(z, c, truncation_psi=truncation_psi)
        return self.synthesis(ws, noise_mode=noise_mode, generator=generator, rows=rows)


# ----------------------------------------------------------------------------
# Discriminator

class DiscriminatorBlock(nn.Module):
    """Resnet D block: (fromRGB +) conv0 -> down-conv1, + down-skip."""

    def __init__(self, gen, cfg, res, first):
        super().__init__()
        tmp_ch = cfg.channels[res]
        out_ch = cfg.channels[res // 2]
        clamp = cfg.conv_clamp
        self.first = first
        if first:
            self.fromrgb = Conv2dLayer(gen, cfg.img_channels, tmp_ch, 1,
                                       activation='lrelu', conv_clamp=clamp)
        self.conv0 = Conv2dLayer(gen, tmp_ch, tmp_ch, 3, activation='lrelu',
                                 conv_clamp=clamp)
        self.conv1 = Conv2dLayer(gen, tmp_ch, out_ch, 3, activation='lrelu', down=2,
                                 gain=np.sqrt(0.5), conv_clamp=clamp)
        self.skip = Conv2dLayer(gen, tmp_ch, out_ch, 1, bias=False, down=2,
                                gain=np.sqrt(0.5))

    def forward(self, x, img, f):
        if self.first:
            x = self.fromrgb(img)
        y = self.skip(x, f)
        x = self.conv0(x)
        x = self.conv1(x, f)
        return y + x


def minibatch_stddev(x, group_size, num_channels, rows=None):
    """Append per-group feature-stddev channels (D epilogue). Under data
    parallelism `rows` (parallel.mesh.Rows) says which rows of the global
    batch x holds; where they are not whole groups, the global batch is
    gathered (differentiably), grouped, and this rank's rows kept."""
    if rows is not None and not rows.holds_groups(group_size):
        return rows.take(minibatch_stddev(rows.gather_grad(x), group_size, num_channels))
    n, c, h, w = x.shape
    g = min(group_size, n) if group_size is not None else n
    if n % g != 0:
        raise ValueError(f"batch {n} not divisible by mbstd group {g}")
    f_ = num_channels
    y = x.reshape(g, n // g, f_, c // f_, h, w).float()
    y = y - y.mean(dim=0, keepdim=True)
    y = y.square().mean(dim=0)
    y = (y + 1e-8).sqrt()
    y = y.mean(dim=(2, 3, 4))  # [n//g, F]
    y = y.reshape(n // g, f_, 1, 1).to(x.dtype)
    y = y.repeat(g, 1, h, w)
    return torch.cat([x, y], dim=1)


class DiscriminatorEpilogue(nn.Module):
    def __init__(self, gen, cfg):
        super().__init__()
        self.cfg = cfg
        ch4 = cfg.channels[4]
        self.conv = Conv2dLayer(gen, ch4 + cfg.mbstd_num_channels, ch4, 3,
                                activation='lrelu', conv_clamp=cfg.conv_clamp)
        self.fc = FullyConnectedLayer(gen, ch4 * 4 * 4, ch4, activation='lrelu')
        self.out = FullyConnectedLayer(gen, ch4, cfg.cmap_dim or 1)

    def forward(self, x, rows=None):
        x = minibatch_stddev(x, self.cfg.mbstd_group_size, self.cfg.mbstd_num_channels, rows)
        x = self.conv(x)
        x = self.fc(x.reshape(x.shape[0], -1))
        return self.out(x)


class Discriminator(nn.Module):
    """img [N, C, res, res] (and labels c [N, c_dim] when c_dim > 0) ->
    logits [N, 1]. A conditional D is a projection discriminator: the
    logit is <out, mapping(c)> / sqrt(cmap_dim)."""

    def __init__(self, cfg, seed=1, impl='auto'):
        super().__init__()
        self.cfg = cfg
        gen = torch.Generator().manual_seed(seed)
        for i, res in enumerate(cfg.block_resolutions):
            setattr(self, f'b{res}', DiscriminatorBlock(gen, cfg, res, first=(i == 0)))
        self.b4 = DiscriminatorEpilogue(gen, cfg)
        if cfg.c_dim > 0:
            self.mapping = MappingNetwork(gen, _cmap_mapping_cfg(cfg), with_w_avg=False)
        self.register_buffer('resample_filter', setup_filter([1, 3, 3, 1], separable=True))
        set_impl(self, impl)

    def forward(self, img, c=None, remat=False, rows=None):
        """remat as in SynthesisNetwork.forward; `rows` (data parallelism)
        as in minibatch_stddev."""
        with span("D.forward"):
            cfg = self.cfg
            f = self.resample_filter
            fp16 = _fp16_resolutions(cfg)
            x = None
            for res in cfg.block_resolutions:
                block = getattr(self, f'b{res}')
                dtype = torch.bfloat16 if res in fp16 else torch.float32
                if block.first:
                    img = img.to(dtype)
                else:
                    x = x.to(dtype)
                if _want_remat(remat, res) and torch.is_grad_enabled():
                    x = checkpoint(block, x, img, f, use_reentrant=False)
                else:
                    x = block(x, img, f)
            x = self.b4(x.float(), rows)
            if cfg.c_dim > 0:
                cmap = self.mapping(None, c, broadcast=False)
                x = (x * cmap).sum(dim=1, keepdim=True) * float(1.0 / np.sqrt(cfg.cmap_dim))
            return x


def set_impl(module, impl):
    """Route every op of `module` to 'auto' (the kernels on CUDA tensors)
    or 'ref' (plain PyTorch)."""
    if impl not in ('auto', 'ref'):
        raise ValueError(f"impl must be 'auto' or 'ref', got {impl!r}")
    for m in module.modules():
        if hasattr(m, 'impl'):
            m.impl = impl
