"""Model FLOPs of one sample, counted from the configuration's shapes: the
multiply-adds of every convolution and dense layer (FIR filters, bias and
activations are not model FLOPs), two FLOPs each.

A walk sample costs K Adam steps of G synthesis, D and the LPIPS VGG16 on
each modality's crop, forward and backward (the backward differentiates
with respect to the input only, as the weights are frozen: as many
multiply-adds as the forward), then one G synthesis forward. A sampling
sample costs the mapping and one G synthesis forward. A StyleGAN2 up-
convolution is counted at its input's resolution, a down-convolution at
its output's.
"""

import math

from reference import nets

PEAK_BF16_FLOPS = 989e12  # one H100 SXM, dense, NVIDIA's data sheet


def g_synthesis_macs(cfg):
    w_dim, img_ch = cfg["w_dim"], cfg["img_channels"]
    macs = 0
    if cfg["arch"] == "stylegan2":
        for res in nets.block_resolutions(cfg["resolution"]):
            out = nets.sg2_channels(cfg, res)
            if res == 4:
                macs += 16 * out * out * 9 + w_dim * out
            else:
                inp = nets.sg2_channels(cfg, res // 2)
                macs += (res // 2) ** 2 * inp * out * 9 + w_dim * inp
                macs += res * res * out * out * 9 + w_dim * out
            macs += res * res * out * img_ch + w_dim * out
        return macs
    layers, inp = nets.sg3_layers(cfg)
    macs += inp["size"] ** 2 * inp["channels"] ** 2 + w_dim * 4
    for layer in layers:
        k = layer["conv_kernel"]
        conv_px = (layer["in_size"] + k - 1) ** 2
        macs += conv_px * layer["in_channels"] * layer["out_channels"] * k * k
        macs += w_dim * layer["in_channels"]
    return macs


def mapping_macs(cfg):
    return sum((cfg["z_dim"] if i == 0 else cfg["w_dim"]) * cfg["w_dim"]
               for i in range(cfg["num_mapping_layers"]))


def d_macs(cfg):
    d = cfg["discriminator"]
    res_top = cfg["resolution"]

    def ch(r):
        return min(d["channel_base"] // r, d["channel_max"])

    macs = res_top * res_top * cfg["img_channels"] * ch(res_top)
    for res in [2 ** j for j in range(int(math.log2(res_top)), 2, -1)]:
        tmp, out = ch(res), ch(res // 2)
        half = (res // 2) ** 2
        macs += res * res * tmp * tmp * 9 + half * tmp * out * 9 + half * tmp * out
    c4 = ch(4)
    return macs + 16 * (c4 + d["mbstd_num_channels"]) * c4 * 9 + c4 * 16 * c4 + c4


def vgg_macs(crop):
    macs, size, c_in = 0, crop, 3
    for item in nets.VGG16_PLAN:
        if item == "M":
            size //= 2
            continue
        _, c_out = item
        macs += size * size * c_in * c_out * 9
        c_in = c_out
    return macs


def flops_per_sample(cfg, traffic):
    g = g_synthesis_macs(cfg)
    if traffic["kind"] == "sample":
        return 2 * (mapping_macs(cfg) + g)
    step = g + d_macs(cfg) + len(cfg["modalities"]) * vgg_macs(traffic["crop_size"])
    return 2 * (traffic["num_epochs"] * 2 * step + g)
