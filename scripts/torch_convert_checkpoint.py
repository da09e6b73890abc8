#!/usr/bin/env python3
"""Convert the weights LatentAugment consumes into the PyTorch port's
native files (counterpart: scripts/convert_checkpoint.py).

    python scripts/torch_convert_checkpoint.py stylegan --source network-snapshot.pkl \
        --dest native.pkl [--img_resolution 256 --img_channels 2]
    python scripts/torch_convert_checkpoint.py vgg16 --source vgg16.pt --dest vgg16_lpips.pkl
    python scripts/torch_convert_checkpoint.py inception --source inception_v3.pth \
        --dest inception.pkl

  * stylegan: an NVIDIA StyleGAN2 / StyleGAN3 persistence pickle or a
    TF-era StyleGAN2 pickle -> a native checkpoint (nested numpy, what
    the policy, the projector and the trainer read). Nothing the pickle
    embeds is executed.
  * vgg16: NVIDIA's TorchScript LPIPS VGG16 -> the VGG16 param pickle
    (point LATENTAUGMENT_VGG16 at it).
  * inception: a torchvision inception_v3 state dict (read with
    weights_only) -> the FID detector's param pickle.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def convert_stylegan(args):
    from latentaugment_tpu_torch.models import networks_for
    from latentaugment_tpu_torch.models.stylegan2 import checkpoint, networks

    g_params, g_cfg, d_params, d_cfg = checkpoint.load_stylegan(
        args.source, img_resolution=args.img_resolution, img_channels=args.img_channels)
    # Loading the trees into the modules checks every name and shape.
    G = networks_for(g_cfg).Generator(g_cfg)
    G.load_state_dict(checkpoint.params_to_state_dict(g_params))
    D = None
    if d_params is not None:
        D = networks.Discriminator(d_cfg)
        D.load_state_dict(checkpoint.params_to_state_dict(d_params))
    checkpoint.save_checkpoint(args.dest, G, D)
    print(f"wrote {args.dest} (arch={g_cfg.get('arch', 'stylegan2')}, num_ws={g_cfg.num_ws}, "
          f"res={g_cfg.img_resolution}, D={'yes' if D is not None else 'no'})")


def convert_vgg16(args):
    from latentaugment_tpu_torch.models import vgg

    vgg.convert_torchscript(args.source, args.dest)
    print(f"wrote {args.dest}; point LATENTAUGMENT_VGG16 at it")


def convert_inception(args):
    import torch

    from latentaugment_tpu_torch.models import inception

    state = torch.load(args.source, map_location="cpu", weights_only=True)
    state = state.get("state_dict", state)
    inception.convert_torchvision_state(state, args.dest, strict=True)
    print(f"wrote {args.dest}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)
    s = sub.add_parser("stylegan", help="StyleGAN2 / StyleGAN3 network pickle -> native")
    s.add_argument("--source", required=True, help="NVIDIA or TF-era network pickle")
    s.add_argument("--dest", required=True, help="output native checkpoint")
    s.add_argument("--img_resolution", type=int, default=None)
    s.add_argument("--img_channels", type=int, default=None)
    s.set_defaults(fn=convert_stylegan)
    v = sub.add_parser("vgg16", help="NVIDIA TorchScript vgg16.pt -> LPIPS VGG16 params")
    v.add_argument("--source", required=True)
    v.add_argument("--dest", required=True)
    v.set_defaults(fn=convert_vgg16)
    i = sub.add_parser("inception", help="torchvision inception_v3 state dict -> FID params")
    i.add_argument("--source", required=True)
    i.add_argument("--dest", required=True)
    i.set_defaults(fn=convert_inception)
    args = p.parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
