"""Plain PyTorch StyleGAN2 and StyleGAN3-T generators, the StyleGAN2
discriminator and the LPIPS VGG16 embedding, written from the published
descriptions (Karras et al. 2020, NVlabs/stylegan2-ada-pytorch; Karras et
al. 2021, NVlabs/stylegan3; Zhang et al. 2018, LPIPS).

Functional over a flat {dotted name: tensor} dict whose names are the
native checkpoint's tree paths, so one file feeds the program and this
reference. Every FIR filter is a depthwise `F.conv2d`, every resampling
conv the unoptimised form (pad and zero-insert, filter, convolve,
subsample). The arithmetic is float32 unless a `Precision` rounds it.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

SQRT2 = math.sqrt(2.0)
LRELU_SLOPE = 0.2


# ----------------------------------------------------------------------------
# Precision: the reference rounds nothing; the control rounds every layer's
# operands one step below what the configuration runs it in.

class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def round_bf16(x):
    return x.to(torch.bfloat16).float()


def round_fp8(x):
    """float8 e4m3 with one scale per tensor (its largest magnitude to 448)."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class Precision:
    """'ref': float32 everywhere (TF32 is switched off by the caller).
    'control': operands of the layers the configuration runs in float32
    rounded to bfloat16, of those it runs in bfloat16 to float8, forward
    and backward."""

    def __init__(self, mode="ref"):
        if mode not in ("ref", "control"):
            raise ValueError(f"precision mode {mode!r}")
        self.mode = mode

    def __call__(self, x, low):
        if self.mode == "ref" or x is None:
            return x
        return _Round.apply(x, round_fp8 if low else round_bf16)


REF = Precision("ref")


# ----------------------------------------------------------------------------
# Primitive ops.

def pad_arg(padding):
    if isinstance(padding, int):
        padding = [padding, padding]
    if len(padding) == 2:
        padding = [padding[0], padding[0], padding[1], padding[1]]
    return [int(p) for p in padding]


def upfirdn2d(x, f, up=1, down=1, padding=0, gain=1.0, flip_filter=False):
    """Zero-insert by `up`, pad ([x0, x1, y0, y1], negative crops), FIR
    with `f` (1-D: separable, applied on both axes; 2-D as given; None:
    identity) as a true convolution, multiply by `gain`, keep every
    `down`-th sample."""
    n, c, h, w = x.shape
    px0, px1, py0, py1 = pad_arg(padding)
    if up > 1:
        x = x.reshape(n, c, h, 1, w, 1)
        x = F.pad(x, [0, up - 1, 0, 0, 0, up - 1])
        x = x.reshape(n, c, h * up, w * up)
    x = F.pad(x, [max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)])
    x = x[:, :, max(-py0, 0):x.shape[2] - max(-py1, 0), max(-px0, 0):x.shape[3] - max(-px1, 0)]
    if f is not None:
        f = f.to(x.dtype) * (gain ** (f.ndim / 2))
        if not flip_filter:
            f = f.flip(list(range(f.ndim)))
        if f.ndim == 1:
            x = F.conv2d(x, f[None, None, None, :].repeat(c, 1, 1, 1), groups=c)
            x = F.conv2d(x, f[None, None, :, None].repeat(c, 1, 1, 1), groups=c)
        else:
            x = F.conv2d(x, f[None, None].repeat(c, 1, 1, 1), groups=c)
    elif gain != 1.0:
        x = x * gain
    if down > 1:
        x = x[:, :, ::down, ::down]
    return x


def bias_act(x, b=None, act="linear", gain=None, clamp=None):
    if b is not None:
        x = x + b.reshape(1, -1, *([1] * (x.ndim - 2)))
    if act == "lrelu":
        x = F.leaky_relu(x, LRELU_SLOPE)
        gain = SQRT2 if gain is None else gain
    elif act != "linear":
        raise ValueError(act)
    gain = 1.0 if gain is None else gain
    if gain != 1.0:
        x = x * gain
    if clamp is not None:
        x = x.clamp(-clamp, clamp)
    return x


def conv2d_resample(x, w, f=None, up=1, down=1, padding=0, flip_weight=True):
    """Convolution with FIR up / down sampling, unoptimised: `up`: zero-
    insert and filter (gain up^2) with the padding widened for the
    filter, then convolve; `down`: convolve, then filter and subsample.
    flip_weight=False is a true convolution."""
    kh, kw = w.shape[-2:]
    fw = 1 if f is None else f.shape[-1]
    px0, px1, py0, py1 = pad_arg(padding)
    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fw + up - 1) // 2
        py1 += (fw - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fw - down + 1) // 2
        py1 += (fw - down) // 2
    if not flip_weight and (kh > 1 or kw > 1):
        w = w.flip([2, 3])
    x = upfirdn2d(x, f if up > 1 else None, up=up, padding=[px0, px1, py0, py1], gain=up ** 2)
    x = F.conv2d(x, w)
    if down > 1:
        x = upfirdn2d(x, f, down=down)
    return x


def fc(p, name, x, prec, low=False, act="linear", lr_multiplier=1.0):
    """Equalised-learning-rate dense layer: stored weight times
    lr_multiplier / sqrt(fan_in), stored bias times lr_multiplier."""
    weight = p[name + ".weight"]
    w = weight * (lr_multiplier / math.sqrt(weight.shape[1]))
    y = prec(x, low) @ prec(w, low).t()
    return prec(bias_act(y, p[name + ".bias"] * lr_multiplier, act), low)


def modulated_conv2d(x, weight, styles, prec, low, noise=None, up=1, padding=0, f=None,
                     demodulate=True, flip_weight=True):
    """Scale the input by the style, convolve, scale the output by the
    demodulation coefficients rsqrt(sum_{i,k} (s_i w_oik)^2 + 1e-8)."""
    if demodulate:
        dcoefs = torch.rsqrt(styles.square() @ weight.square().sum(dim=(2, 3)).t() + 1e-8)
    x = prec(x * styles[:, :, None, None], low)
    x = conv2d_resample(x, prec(weight, low), f=f, up=up, padding=padding,
                        flip_weight=flip_weight)
    if demodulate:
        x = x * dcoefs[:, :, None, None]
    if noise is not None:
        x = x + noise
    return prec(x, low)


def normalize_2nd_moment(x):
    return x * torch.rsqrt(x.square().mean(dim=1, keepdim=True) + 1e-8)


# ----------------------------------------------------------------------------
# Mapping (both generator families).

def mapping(p, cfg, z, prec=REF, truncation_psi=1.0):
    """z [N, z_dim] -> ws [N, num_ws, w_dim]."""
    x = normalize_2nd_moment(z.float())
    for i in range(cfg["num_mapping_layers"]):
        x = fc(p, f"mapping.fc{i}", x, prec, act="lrelu",
               lr_multiplier=cfg["mapping_lr_multiplier"])
    if truncation_psi != 1.0:
        w_avg = p["mapping.w_avg"]
        x = w_avg + truncation_psi * (x - w_avg)
    return x[:, None, :].repeat(1, num_ws(cfg), 1)


def num_ws(cfg):
    if cfg["arch"] == "stylegan3":
        return cfg["num_layers"] + 2
    return 2 * int(math.log2(cfg["resolution"])) - 2


# ----------------------------------------------------------------------------
# StyleGAN2.

def block_resolutions(res):
    return [2 ** i for i in range(2, int(math.log2(res)) + 1)]


def sg2_channels(cfg, res):
    return min(cfg["channel_base"] // res, cfg["channel_max"])


def low_resolutions(res, num_fp16_res):
    """The resolutions run in bfloat16: the top `num_fp16_res` (none under 64x64)."""
    if res < 64 or num_fp16_res <= 0:
        return set()
    return set(block_resolutions(res)[-num_fp16_res:])


def sg2_noise_shapes(cfg, n):
    """(shape, bfloat16?) of each random-noise draw of one synthesis, in draw order."""
    low = low_resolutions(cfg["resolution"], cfg["num_fp16_res"])
    return [([n, 1, r, r], r in low) for r in block_resolutions(cfg["resolution"])
            for _ in range(1 if r == 4 else 2)]


def sg2_synthesis(p, cfg, ws, prec=REF, noises=None):
    """ws [N, num_ws, w_dim] -> image [N, img_channels, res, res]. `noises`:
    one draw per conv layer in `sg2_noise_shapes` order (random noise), or
    None (each layer's constant noise)."""
    res_all = block_resolutions(cfg["resolution"])
    low = low_resolutions(cfg["resolution"], cfg["num_fp16_res"])
    f = p["synthesis.resample_filter"]
    clamp = cfg["conv_clamp"]
    x = img = None
    w_idx = 0
    noise_iter = iter(noises) if noises is not None else None
    for res in res_all:
        pre = f"synthesis.b{res}"
        lo = res in low

        def layer(name, x, w, up):
            styles = fc(p, f"{pre}.{name}.affine", w, prec)
            if noise_iter is None:
                noise = p[f"{pre}.{name}.noise_const"]
            else:
                noise = next(noise_iter).float()
            noise = noise * p[f"{pre}.{name}.noise_strength"]
            y = modulated_conv2d(x, p[f"{pre}.{name}.weight"], styles, prec, lo, noise=noise,
                                 up=up, padding=1, f=f, flip_weight=(up == 1))
            return prec(bias_act(y, p[f"{pre}.{name}.bias"], "lrelu", clamp=clamp), lo)

        if res == 4:
            x = p[f"{pre}.const"][None].expand(ws.shape[0], -1, -1, -1)
            x = layer("conv1", x, ws[:, 0], 1)
            n_conv = 1
        else:
            x = layer("conv0", x, ws[:, w_idx], 2)
            x = layer("conv1", x, ws[:, w_idx + 1], 1)
            n_conv = 2
        w_rgb = ws[:, w_idx + n_conv]
        weight = p[f"{pre}.torgb.weight"]
        styles = fc(p, f"{pre}.torgb.affine", w_rgb, prec) / math.sqrt(weight.shape[1])
        y = modulated_conv2d(x, weight, styles, prec, False, demodulate=False)
        y = prec(bias_act(y, p[f"{pre}.torgb.bias"], clamp=clamp), False)
        w_idx += n_conv
        if img is None:
            img = y
        else:
            img = prec(upfirdn2d(img, f, up=2, padding=[2, 1, 2, 1], gain=4.0), False) + y
    return img


def conv_layer(p, name, x, prec, low, act="linear", down=1, gain=1.0, clamp=None, f=None,
               bias=True):
    weight = p[name + ".weight"]
    o, i, kh, kw = weight.shape
    w = weight / math.sqrt(i * kh * kw)
    y = conv2d_resample(prec(x, low), prec(w, low), f=f, down=down, padding=kh // 2)
    b = p[name + ".bias"] if bias else None
    act_gain = (SQRT2 if act == "lrelu" else 1.0) * gain
    act_clamp = clamp * gain if clamp is not None else None
    return prec(bias_act(y, b, act, gain=act_gain, clamp=act_clamp), low)


def minibatch_stddev(x, group_size, num_channels):
    """Rows n and n + k * (N / G) form a group (k < G)."""
    n, c, h, w = x.shape
    g = min(group_size, n)
    y = x.reshape(g, n // g, num_channels, c // num_channels, h, w)
    y = (y - y.mean(dim=0)).square().mean(dim=0)
    y = (y + 1e-8).sqrt().mean(dim=(2, 3, 4))
    y = y.reshape(n // g, num_channels, 1, 1).repeat(g, 1, h, w)
    return torch.cat([x, y], dim=1)


def discriminator(p, dcfg, img, prec=REF):
    """img [N, C, res, res] -> logits [N, 1] (resnet D, no labels)."""
    res_top = dcfg["resolution"]
    low = low_resolutions(res_top, dcfg["num_fp16_res"])
    f = p["resample_filter"]
    clamp = dcfg["conv_clamp"]
    x = None
    for res in [2 ** i for i in range(int(math.log2(res_top)), 2, -1)]:
        pre = f"b{res}"
        lo = res in low
        if x is None:
            x = conv_layer(p, f"{pre}.fromrgb", img, prec, lo, act="lrelu", clamp=clamp)
        y = conv_layer(p, f"{pre}.skip", x, prec, lo, down=2, gain=math.sqrt(0.5), f=f,
                       bias=False)
        x = conv_layer(p, f"{pre}.conv0", x, prec, lo, act="lrelu", clamp=clamp)
        x = conv_layer(p, f"{pre}.conv1", x, prec, lo, act="lrelu", down=2,
                       gain=math.sqrt(0.5), clamp=clamp, f=f)
        x = y + x
    x = minibatch_stddev(x, dcfg["mbstd_group_size"], dcfg["mbstd_num_channels"])
    x = conv_layer(p, "b4.conv", x, prec, False, act="lrelu", clamp=clamp)
    x = fc(p, "b4.fc", x.reshape(x.shape[0], -1), prec, act="lrelu")
    return fc(p, "b4.out", x, prec)


# ----------------------------------------------------------------------------
# StyleGAN3-T.

def kaiser_filter(numtaps, cutoff, width, fs):
    """Kaiser-windowed sinc of unit DC gain (scipy.signal.firwin's
    design); None for one tap."""
    if numtaps == 1:
        return None
    atten = 2.285 * (numtaps - 1) * np.pi * (width / (fs / 2)) + 7.95
    if atten > 50:
        beta = 0.1102 * (atten - 8.7)
    elif atten >= 21:
        beta = 0.5842 * (atten - 21) ** 0.4 + 0.07886 * (atten - 21)
    else:
        beta = 0.0
    m = np.arange(numtaps) - (numtaps - 1) / 2
    h = np.sinc(2 * cutoff / fs * m) * np.kaiser(numtaps, beta)
    return (h / h.sum()).astype(np.float32)


def sg3_layers(cfg):
    """The per-layer sampling plan of the alias-free generator
    (NVlabs/stylegan3 training/networks_stylegan3.py, SynthesisNetwork)."""
    res, nl, ncrit = cfg["resolution"], cfg["num_layers"], cfg["num_critical"]
    last_cutoff = res / 2
    last_stopband = last_cutoff * cfg["last_stopband_rel"]
    exponents = np.minimum(np.arange(nl + 1) / (nl - ncrit), 1.0)
    cutoffs = cfg["first_cutoff"] * (last_cutoff / cfg["first_cutoff"]) ** exponents
    stopbands = cfg["first_stopband"] * (last_stopband / cfg["first_stopband"]) ** exponents
    rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, res))))
    half_widths = np.maximum(stopbands, rates / 2) - cutoffs
    sizes = rates + cfg["margin_size"] * 2
    sizes[-2:] = res
    channels = np.rint(np.minimum((cfg["channel_base"] / 2) / cutoffs, cfg["channel_max"]))
    channels[-1] = cfg["img_channels"]
    layers = []
    for idx in range(nl + 1):
        prev = max(idx - 1, 0)
        torgb = idx == nl
        in_sr, out_sr = float(rates[prev]), float(rates[idx])
        k = 1 if torgb else cfg["conv_kernel"]
        tmp_sr = max(in_sr, out_sr) * (1 if torgb else cfg["lrelu_upsampling"])
        up, down = int(round(tmp_sr / in_sr)), int(round(tmp_sr / out_sr))
        up_taps = cfg["filter_size"] * up if up > 1 and not torgb else 1
        down_taps = cfg["filter_size"] * down if down > 1 and not torgb else 1
        in_size, out_size = int(sizes[prev]), int(sizes[idx])
        pad_total = (out_size - 1) * down + 1 - (in_size + k - 1) * up + up_taps + down_taps - 2
        pad_lo = (pad_total + up) // 2
        layers.append(dict(
            name=f"L{idx}_{out_size}_{int(channels[idx])}", torgb=torgb,
            in_channels=int(channels[prev]), out_channels=int(channels[idx]),
            in_size=in_size, out_size=out_size, out_sampling_rate=out_sr, conv_kernel=k,
            up=up, down=down, padding=[pad_lo, pad_total - pad_lo, pad_lo, pad_total - pad_lo],
            fu=kaiser_filter(up_taps, float(cutoffs[prev]), float(half_widths[prev]) * 2, tmp_sr),
            fd=kaiser_filter(down_taps, float(cutoffs[idx]), float(half_widths[idx]) * 2,
                             tmp_sr)))
    inp = dict(channels=int(channels[0]), size=int(sizes[0]), sampling_rate=float(rates[0]),
               bandwidth=float(cutoffs[0]))
    return layers, inp


def sg3_low(cfg, layer):
    n16 = cfg["num_fp16_res"]
    return n16 > 0 and layer["out_sampling_rate"] * (2 ** n16) > cfg["resolution"]


def filtered_lrelu(x, fu, fd, b, up, down, padding, gain, slope, clamp):
    """bias, upsample with fu (gain up^2), leaky ReLU times gain, clamp,
    downsample with fd (NVlabs/stylegan3 torch_utils/ops/filtered_lrelu.py,
    its reference path)."""
    x = bias_act(x, b)
    x = upfirdn2d(x, fu, up=up, padding=padding, gain=up ** 2)
    x = F.leaky_relu(x, slope) * gain
    if clamp is not None:
        x = x.clamp(-clamp, clamp)
    return upfirdn2d(x, fd, down=down)


def sg3_input(p, inp, w, prec):
    """Fourier features of the input plane under the similarity transform
    predicted from w [N, w_dim]."""
    n = w.shape[0]
    t = fc(p, "synthesis.input.affine", w, prec)
    t = t / t[:, :2].square().sum(dim=1, keepdim=True).sqrt()
    eye = torch.eye(3, device=w.device)
    m_r = eye.repeat(n, 1, 1)
    m_r[:, 0, 0], m_r[:, 0, 1], m_r[:, 1, 0], m_r[:, 1, 1] = t[:, 0], -t[:, 1], t[:, 1], t[:, 0]
    m_t = eye.repeat(n, 1, 1)
    m_t[:, 0, 2], m_t[:, 1, 2] = -t[:, 2], -t[:, 3]
    transforms = m_r @ m_t @ p["synthesis.input.transform"][None]
    freqs0 = p["synthesis.input.freqs"]
    phases = p["synthesis.input.phases"][None] + (freqs0[None] @ transforms[:, :2, 2:]).squeeze(2)
    freqs = freqs0[None] @ transforms[:, :2, :2]
    amp = (1 - (freqs.norm(dim=2) - inp["bandwidth"])
           / (inp["sampling_rate"] / 2 - inp["bandwidth"])).clamp(0, 1)
    size = inp["size"]
    coords = (torch.arange(size, dtype=torch.float32, device=w.device) + 0.5 - size / 2) \
        / inp["sampling_rate"]
    arg = (freqs[:, None, None, :, 0] * coords[None, None, :, None]
           + freqs[:, None, None, :, 1] * coords[None, :, None, None] + phases[:, None, None, :])
    x = torch.sin(arg * (2 * math.pi)) * amp[:, None, None, :]
    weight = p["synthesis.input.weight"] / math.sqrt(inp["channels"])
    x = prec(x, False) @ prec(weight, False).t()
    return x.permute(0, 3, 1, 2)


def sg3_synthesis(p, cfg, ws, prec=REF, plan=None):
    """ws [N, num_ws, w_dim] -> image [N, img_channels, res, res]."""
    layers, inp = plan if plan is not None else sg3_layers(cfg)
    x = sg3_input(p, inp, ws[:, 0], prec)
    dev = ws.device
    for i, layer in enumerate(layers):
        pre = f"synthesis.{layer['name']}"
        lo = sg3_low(cfg, layer)
        styles = fc(p, f"{pre}.affine", ws[:, i + 1], prec)
        k = layer["conv_kernel"]
        if layer["torgb"]:
            styles = styles / math.sqrt(layer["in_channels"] * k * k)
        x = x * torch.rsqrt(p[f"{pre}.magnitude_ema"])
        x = modulated_conv2d(x, p[f"{pre}.weight"], styles, prec, lo, padding=k - 1,
                             demodulate=not layer["torgb"], flip_weight=True)
        fu = None if layer["fu"] is None else torch.as_tensor(layer["fu"], device=dev)
        fd = None if layer["fd"] is None else torch.as_tensor(layer["fd"], device=dev)
        x = filtered_lrelu(x, fu, fd, p[f"{pre}.bias"], layer["up"], layer["down"],
                           layer["padding"], 1.0 if layer["torgb"] else SQRT2,
                           1.0 if layer["torgb"] else LRELU_SLOPE, cfg["conv_clamp"])
        x = prec(x, lo)
    return x * cfg["output_scale"]


def synthesis(p, cfg, ws, prec=REF, noises=None):
    if cfg["arch"] == "stylegan3":
        return sg3_synthesis(p, cfg, ws, prec)
    return sg2_synthesis(p, cfg, ws, prec, noises)


# ----------------------------------------------------------------------------
# LPIPS VGG16 embedding.

VGG16_PLAN = [("conv1_1", 64), ("conv1_2", 64), "M", ("conv2_1", 128), ("conv2_2", 128), "M",
              ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), "M",
              ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), "M",
              ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512)]
LPIPS_TAPS = ("conv1_2", "conv2_2", "conv3_3", "conv4_3", "conv5_3")
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def lpips_features(v, x, prec=REF):
    """[N, 3, H, W] in [0, 255] -> [N, D]: each tap's activations, unit
    norm over channels at each pixel, times sqrt(lin) / sqrt(H W),
    concatenated; a squared distance of two is their LPIPS distance."""
    x = torch.cat([(x[:, i:i + 1] / 127.5 - 1.0 - _SHIFT[i]) / _SCALE[i] for i in range(3)],
                  dim=1)
    feats = []
    for item in VGG16_PLAN:
        if item == "M":
            x = F.max_pool2d(x, 2)
            continue
        name, _ = item
        x = F.relu(F.conv2d(prec(x, False), prec(v[name + ".weight"], False),
                            v[name + ".bias"], padding=1))
        x = prec(x, False)
        if name in LPIPS_TAPS:
            a = x * torch.rsqrt(x.square().sum(dim=1, keepdim=True) + 1e-10)
            a = a * torch.sqrt(v["lin." + name].clamp(min=0))[None, :, None, None]
            a = a / math.sqrt(a.shape[2] * a.shape[3])
            feats.append(a.reshape(a.shape[0], -1))
    return torch.cat(feats, dim=1)
