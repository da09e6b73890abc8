"""Export a trained generator or discriminator as a `torch.export`
program for serving (the port's copy of scripts/export_model.py).

The reference deploys its pickles by shipping Python and CUDA sources
with them (persistence.py re-executes embedded source at load time).
Here `torch.export` traces the forward once into an ExportedProgram with
the trained weights in its state (const noise and `w_avg` among its
buffers), and `torch.export.save` writes it as one `.pt2` file. The
hand-written kernels stay in the program: each launch of K1 (bias_act),
K2 (upfirdn2d) and K3 (filtered_lrelu) is a call of a registered custom
op, `latentaugment_torch::*`.

What the serving edge needs: PyTorch and the port's `ops` package,
whose import registers those ops and which builds the kernels at their
first launch (nvcc and Triton, into the checkout's build/). It needs no
model source and no pickle.

    python scripts/torch_export_model.py --checkpoint runs/ckpt.pkl \\
        --out g.pt2 [--which g|d] [--batch 0] [--truncation 1.0] [--device cuda]

--batch 0 (default) exports with a symbolic batch dimension: one program
serves any batch size (the serving layer still pads to a few bucketed
sizes). The discriminator's minibatch-stddev groups need a concrete
batch: --which d requires --batch N. A program exported on the card runs
on the card; one exported with --device cpu holds the plain versions of
the ops and runs on the CPU.

Round trip, no model code:

    import torch, latentaugment_tpu_torch.ops
    g = torch.export.load('g.pt2').module()
    imgs = g(z)                 # [B, z_dim] -> [B, C, H, W] float32
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch
import torch.nn as nn


class GeneratorProgram(nn.Module):
    """z (and one-hot labels c when conditional) -> float32 images, with
    the truncation psi and const noise fixed."""

    def __init__(self, G, truncation):
        super().__init__()
        self.G, self.truncation = G, float(truncation)

    def forward(self, z, c=None):
        return self.G(z, c, truncation_psi=self.truncation, noise_mode='const').float()


class DiscriminatorProgram(nn.Module):
    """images (and labels c when conditional) -> logits [N, 1]."""

    def __init__(self, D):
        super().__init__()
        self.D = D

    def forward(self, img, c=None):
        return self.D(img, c)


def build_export(checkpoint, which='g', batch=0, truncation=1.0, device='cuda'):
    """Load `checkpoint` (native, NVIDIA or TF-era pickle) and export the
    requested network on `device`. Returns the torch.export.ExportedProgram
    (torch.export.save writes the artifact)."""
    from latentaugment_tpu_torch.models import networks_for
    from latentaugment_tpu_torch.models.stylegan2 import checkpoint as ckpt
    from latentaugment_tpu_torch.models.stylegan2 import networks
    from latentaugment_tpu_torch.utils.util_general import resolve_device

    dev = resolve_device(device)
    g_params, g_cfg, d_params, d_cfg = ckpt.load_stylegan(checkpoint)
    gen = torch.Generator().manual_seed(0)
    if which == 'g':
        cfg = g_cfg
        G = networks_for(cfg).Generator(cfg)
        G.load_state_dict(ckpt.params_to_state_dict(g_params))
        module = GeneratorProgram(G, truncation)
        # An example batch of 1 would be specialised: trace at 2.
        lead = int(batch) or 2
        data = torch.randn([lead, cfg.z_dim], generator=gen)
    elif which == 'd':
        if d_params is None:
            raise ValueError(f'{checkpoint} has no discriminator')
        if not batch:
            raise ValueError('--which d needs a concrete --batch '
                             '(minibatch-stddev groups over the batch)')
        cfg = d_cfg
        D = networks.Discriminator(cfg)
        D.load_state_dict(ckpt.params_to_state_dict(d_params))
        module = DiscriminatorProgram(D)
        lead = int(batch)
        data = torch.rand([lead, cfg.img_channels, cfg.img_resolution, cfg.img_resolution],
                          generator=gen) * 2 - 1
    else:
        raise ValueError(f'unknown --which {which!r}')
    module = module.to(dev).eval().requires_grad_(False)

    # Unconditional nets export a one-argument program, conditional ones a
    # two-argument (data, one-hot labels) one, with the same lead dim.
    args = [data.to(dev)]
    if cfg.c_dim:
        args.append(torch.eye(cfg.c_dim)[torch.arange(lead) % cfg.c_dim].to(dev))
    dynamic_shapes = None
    if not batch:
        dim = torch.export.Dim('batch', min=1)
        dynamic_shapes = [{0: dim} for _ in args]
    with torch.no_grad():
        return torch.export.export(module, tuple(args), dynamic_shapes=dynamic_shapes,
                                   strict=False)


def input_shapes(ep):
    """The program's user inputs' shapes (a symbolic dim as its SymInt)."""
    user = set(ep.graph_signature.user_inputs)
    return [tuple(n.meta['val'].shape) for n in ep.graph.nodes
            if n.op == 'placeholder' and n.name in user]


def main(argv=None):
    p = argparse.ArgumentParser(
        description='Export a checkpoint as a torch.export serving artifact')
    p.add_argument('--checkpoint', required=True,
                   help='native or NVIDIA-pickle checkpoint')
    p.add_argument('--out', required=True, help='artifact path (.pt2)')
    p.add_argument('--which', choices=['g', 'd'], default='g')
    p.add_argument('--batch', type=int, default=0,
                   help='0 = symbolic batch dim (G only); N = concrete')
    p.add_argument('--truncation', type=float, default=1.0,
                   help='truncation psi baked into the G export')
    p.add_argument('--device', default='cuda',
                   help='torch device (cuda, cuda:N or cpu); cuda without CUDA raises')
    p.add_argument('--cpu', action='store_true', help='same as --device cpu')
    args = p.parse_args(argv)

    ep = build_export(args.checkpoint, which=args.which, batch=args.batch,
                      truncation=args.truncation, device='cpu' if args.cpu else args.device)
    torch.export.save(ep, args.out)
    shapes = ', '.join(str(s) for s in input_shapes(ep))
    print(f'[export] {args.which.upper()} -> {args.out} '
          f'({os.path.getsize(args.out) / 1e6:.1f} MB, inputs [{shapes}], '
          f'device {"cpu" if args.cpu else args.device})')
    return ep


if __name__ == '__main__':
    main()
