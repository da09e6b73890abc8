"""LatentAug optimization engine: the multi-objective latent walk
(counterpart: latentaugment_tpu/augments/engine.py).

K Adam steps on w [B, 1, w_dim]; each step differentiates one fused loss
(latent-manifold L2, discriminator softplus, centre-crop pixel L2 and the
VGG16 LPIPS embedding L2) with respect to w only — every weight has
requires_grad False. The JAX `lax.scan` is a Python loop that never
synchronises with the device: step losses stay tensors and come back
stacked. The final image is synthesized with random noise drawn from an
explicit torch.Generator.

`--lpips_script` picks the LPIPS embedding: 'lpips_script' is the full
five-tap VGG16 stack on [0,255] input, anything else ('lpips_tr') the
local criterion's three taps on [-1,1] input (criteria/lpips.py). With
`--verbose_log` the first batch runs the un-fused walk, which times each
loss term on the host and, at batch 1, snapshots w and the image per step.

Not ported here: the device mesh and tensor parallelism (a `mesh` that is
not None raises) and the walk's conditional branch (a generator with
c_dim > 0 raises in make_walk_fns).
"""

import json
import os
import pickle
import random
import time

import numpy as np
import torch

from ..models import networks_for, vgg
from ..models.stylegan2 import checkpoint, networks
from ..ops.adam import adam_step as _adam_update
from ..utils import util_general, util_path
from ..utils.util_easydict import EasyDict
from ..utils.util_general import resolve_device  # noqa: F401 (re-exported)
from . import losses, manifold
from .criteria.lpips import default_lin, embedding_from_params


def make_bundle(G, D=None, vgg_params=None, W_summary=None, X_cc_summaries=None,
                fea_summaries=None, lpips_lin=None):
    """All device state the walk functions read, in one dict."""
    return {"G": G, "D": D, "vgg": vgg_params, "lpips_lin": lpips_lin,
            "W_summary": W_summary, "X_cc_summaries": X_cc_summaries,
            "fea_summaries": fea_summaries}


def require_unconditional_walk(g_cfg):
    if g_cfg.c_dim > 0:
        raise NotImplementedError(
            "the walk's conditional branch (c_dim > 0) is not ported yet; it comes "
            "with the mesh slice (the networks and the trainer take labels already)")


def make_walk_fns(g_cfg, *, n_modes, w_pix, w_lpips, w_latent,
                  w_disc, num_epochs=10, opt_lr=0.01, crop_size=64,
                  preprocess="center_random_crop", soft_aug=False, alpha=1.0,
                  truncation_psi=1.0, remat=False, lpips_variant="script",
                  lpips_ref_input=False):
    """Build the walk/ganrand/z_to_w/synthesize functions. Each takes a
    bundle (make_bundle) as its first argument."""
    require_unconditional_walk(g_cfg)
    res = g_cfg.img_resolution
    num_ws = g_cfg.num_ws
    modalities = list(range(n_modes))
    w_pix, w_lpips = float(w_pix), float(w_lpips)
    w_latent, w_disc = float(w_latent), float(w_disc)
    transform = manifold.get_transform(res, crop_size, preprocess)

    def broadcast(w):
        # One w per sample, repeated across layers (flat W space).
        if w.ndim != 3 or w.shape[1] != 1:
            raise ValueError(
                f"walk w must be [B, 1, w_dim] (flat W space), got {tuple(w.shape)}")
        return w.repeat(1, num_ws, 1)

    def synth(bundle, w):
        ws = broadcast(w)
        return ws, bundle["G"].synthesis(ws, noise_mode="const", remat=remat)

    def term_latent(bundle, ws):
        W_mean, W_msq = bundle["W_summary"]
        return w_latent * losses.l2_mean_loss(ws, W_mean, W_msq)

    def term_disc(bundle, x):
        return w_disc * losses.disc_softplus_loss(bundle["D"](x, remat=remat))

    def term_pix(bundle, x):
        x_cc = manifold.center_crop(x, res)
        acc = 0.0
        for m in modalities:
            x_mean, x_msq = bundle["X_cc_summaries"][m]
            acc = acc + w_pix * losses.l2_mean_loss(x_cc[:, m:m + 1], x_mean, x_msq)
        return acc / n_modes

    def term_lpips(bundle, x, crop_pos):
        x_crop = transform(x, crop_pos)
        # One VGG pass for every modality: the modality axis folds into
        # the batch (batch-major).
        b = x_crop.shape[0]
        xm = x_crop.reshape(b * n_modes, 1, *x_crop.shape[2:]).repeat(1, 3, 1, 1)
        if lpips_variant == "script":
            # [0,255] input, the scale the manifold features are extracted at;
            # lpips_ref_input feeds the raw [-1,1] image instead.
            feats = vgg.lpips_features(bundle["vgg"], xm if lpips_ref_input
                                       else (xm + 1.0) * 127.5)
        else:  # the local LPIPS criterion's embedding
            feats = embedding_from_params(bundle["vgg"], bundle["lpips_lin"], xm)
        feats = feats.reshape(b, n_modes, -1)
        acc = 0.0
        for m in modalities:
            f_mean, f_msq = bundle["fea_summaries"][m]
            acc = acc + w_lpips * losses.l2_mean_loss(feats[:, m], f_mean, f_msq,
                                                      normalize=False)
        return acc / n_modes

    terms = {}
    if w_latent > 0.0:
        terms["loss_latent"] = lambda bundle, ws, x, crop_pos: term_latent(bundle, ws)
    if w_disc > 0.0:
        terms["loss_disc"] = lambda bundle, ws, x, crop_pos: term_disc(bundle, x)
    if w_pix > 0.0:
        terms["loss_pix"] = lambda bundle, ws, x, crop_pos: term_pix(bundle, x)
    if w_lpips > 0.0:
        terms["loss_lpips"] = lambda bundle, ws, x, crop_pos: term_lpips(bundle, x, crop_pos)

    def loss_fn(bundle, w, crop_pos):
        """(total, aux): total = -latent - pix - lpips + disc."""
        ws, x = synth(bundle, w)
        aux = {name: fn(bundle, ws, x, crop_pos) for name, fn in terms.items()}
        total = (-aux.get("loss_latent", 0.0) - aux.get("loss_pix", 0.0)
                 - aux.get("loss_lpips", 0.0) + aux.get("loss_disc", 0.0))
        aux["loss"] = total
        return total, aux

    def adam_step(bundle, carry, t, crop_pos):
        """One Adam update on w; `t` is the 0-based step (a Python int)."""
        w, m, v = carry
        with torch.enable_grad():
            w_leaf = w.detach().requires_grad_(True)
            total, aux = loss_fn(bundle, w_leaf, crop_pos)
            if terms:
                g, = torch.autograd.grad(total, w_leaf)
            else:
                g = torch.zeros_like(w)
        w, m, v = _adam_update(w, m, v, g, t, opt_lr)
        return (w, m, v), {k: torch.as_tensor(val).detach() for k, val in aux.items()}

    @torch.no_grad()
    def finish(bundle, w0, w_opt, generator):
        """Soft/hard gate + final synthesis with random noise."""
        w_aug = alpha * w_opt + (1.0 - alpha) * w0 if soft_aug else w_opt
        ws_aug = broadcast(w_aug)
        img = bundle["G"].synthesis(ws_aug, noise_mode="random", generator=generator)
        return img, ws_aug

    def walk(bundle, w0, crop_pos, generator):
        """K Adam steps on w; returns (img_aug, ws_aug, traces) where
        traces maps each loss name to a [K] tensor of the per-step values
        (taken before each step's update)."""
        carry = (w0, torch.zeros_like(w0), torch.zeros_like(w0))
        steps = []
        for t in range(num_epochs):
            carry, aux = adam_step(bundle, carry, t, crop_pos)
            steps.append(aux)
        img, ws_aug = finish(bundle, w0, carry[0], generator)
        traces = {k: torch.stack([s[k] for s in steps]) for k in steps[0]} if steps else {}
        return img, ws_aug, traces

    @torch.no_grad()
    def ganrand(bundle, z, generator):
        ws = bundle["G"].mapping(z, truncation_psi=truncation_psi)
        img = bundle["G"].synthesis(ws, noise_mode="random", generator=generator)
        return img, ws

    @torch.no_grad()
    def z_to_w(bundle, z):
        return bundle["G"].mapping(z, truncation_psi=truncation_psi)[:, :1, :]

    @torch.no_grad()
    def synthesize(bundle, ws, generator):
        return bundle["G"].synthesis(ws, noise_mode="random", generator=generator)

    return EasyDict(walk=walk, ganrand=ganrand, z_to_w=z_to_w, synthesize=synthesize,
                    loss_fn=loss_fn, synth=synth, terms=terms, adam_step=adam_step,
                    finish=finish, num_epochs=num_epochs, remat=remat)


def resolve_stylegan_path(model_dir, dataset, dataset_name, modalities,
                          exp_stylegan, network_pkl):
    """model_dir/<dataset>/training-runs/<dataset_name>/<modalities>/<exp>/
    <network_pkl>; model_dir may also point at a checkpoint file or its
    directory."""
    dir_model = os.path.join(
        model_dir, dataset, "training-runs", dataset_name,
        util_general.parse_separated_list_comma(modalities))
    if os.path.isdir(dir_model):
        exp_name = [x for x in os.listdir(dir_model) if exp_stylegan in x]
        if len(exp_name) != 1:
            raise FileNotFoundError(f"ambiguous experiment under {dir_model}")
        return os.path.join(dir_model, exp_name[0], network_pkl)
    return (model_dir if os.path.isfile(model_dir)
            else os.path.join(model_dir, network_pkl))


def resolve_vgg_path(model_dir):
    """LPIPS VGG16 checkpoint: LATENTAUGMENT_VGG16, else
    model_dir/vgg16_lpips.pkl if present, else None (seeded random init)."""
    path = os.environ.get("LATENTAUGMENT_VGG16")
    if path:
        return path
    default = os.path.join(model_dir, "vgg16_lpips.pkl") if model_dir else None
    return default if default and os.path.isfile(default) else None


class LatentAugEngine:
    """Holds G/D/VGG + manifold summaries + the walk functions."""

    def __init__(self, phase, opt, save_dir, device, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh (data / tensor parallelism) belongs to the DDP slice, "
                "which is not ported yet")
        self.save_dir = save_dir
        self.model_dir = opt.model_dir
        self.interim_dir = opt.interim_dir
        self.phase = phase
        self.device = device
        self.impl = opt.impl

        self.dataset = opt.dataset_aug
        self.dataset_name = opt.dataset_name_aug
        self.modalities = util_general.parse_comma_separated_list(opt.modalities_aug)
        self.res = opt.img_resolution
        self.batch_size = opt.batch_size
        self.exp_stylegan = opt.exp_stylegan
        self.network_pkl_stylegan = opt.network_pkl_stylegan
        self.dataset_w_name = opt.dataset_w_name
        self.exp_inv = opt.exp_inv

        self.num_epochs = opt.opt_num_epochs
        self.opt_lr = opt.opt_lr
        self.truncation_psi = opt.truncation_psi
        self.w_pix = opt.w_pix
        self.w_lpips = opt.w_lpips
        self.w_latent = opt.w_latent
        self.w_disc = opt.w_disc
        self.crop_size = opt.crop_size_aug
        self.preprocess = opt.preprocess_aug
        self.soft_aug = opt.soft_aug
        self.alpha = opt.alpha
        self.lpips_ref_input = bool(opt.lpips_ref_input)
        self.lpips_script = opt.lpips_script
        self.lpips_variant = "script" if self.lpips_script == "lpips_script" else "tr"
        self.verbose_log = opt.verbose_log
        self._verbose_done = False
        # Per-step losses and times of the last recorded walk (verbose_log).
        self.stats_loss = EasyDict()
        self.stats_time = EasyDict()

        # Host crop-position stream, seeded as in the JAX engine so both
        # draw the same crops.
        self._seed = opt.seed
        self._crop_rng = random.Random(self._seed + 1)
        # Device stream for the final synthesis noise.
        self._synth_gen = torch.Generator(device=device).manual_seed(self._seed + 3)
        # Per-step loss traces of the last walk, {name: [K] tensor}.
        self.last_traces = {}

        self.G, self.D = self.load_stylegan(opt)
        self.G_cfg = self.G.cfg
        self.z_dim = self.G_cfg.z_dim
        self.w_dim = self.G_cfg.w_dim
        self.num_ws = self.G_cfg.num_ws

        self.vgg_params = self.lpips_lin = None
        if self.w_lpips > 0.0:
            self.vgg_params = vgg.get_vgg16(path=resolve_vgg_path(self.model_dir),
                                            device=device)
            if self.lpips_variant == "tr":
                self.lpips_lin = default_lin(self.vgg_params, device=device)

        cache_dir = os.path.join(self.interim_dir, self.dataset, "cache_dir")
        self.stats_dataset_w = manifold.LatentCodeDataset(
            path=os.path.join(self.interim_dir, self.dataset,
                              self.dataset_w_name + ".zip"),
            split=self.phase, w_dim=self.w_dim, num_ws=self.num_ws)

        self.W_summary = self.X_cc_summaries = self.fea_summaries = None
        if self.w_latent > 0.0:
            stats = self.compute_stats(
                self.stats_dataset_w, "latent", cache_dir,
                cache_tag=f"{self.dataset_w_name}-{self.phase}", step=opt.step_w)
            self.W_summary = losses.manifold_summary(
                torch.as_tensor(stats.get_all(), device=device))

        img_dataset = None
        if self.w_pix > 0.0 or self.w_lpips > 0.0:
            img_dataset = manifold.ImgDataset(
                path=os.path.join(self.interim_dir, self.dataset,
                                  self.dataset_name + ".zip"),
                modalities=self.modalities, split=self.phase, resolution=self.res)

        if self.w_pix > 0.0:
            stats = self.compute_stats(
                img_dataset, "img", cache_dir,
                cache_tag=f"{self.dataset_name}-{self.phase}", step=opt.step_img)
            x_cc = manifold.center_crop(torch.as_tensor(stats.get_all(), device=device),
                                        self.res)
            self.X_cc_summaries = [losses.manifold_summary(x_cc[:, m:m + 1])
                                   for m in range(len(self.modalities))]

        if self.w_lpips > 0.0:
            self.fea_summaries = []
            for mode_id, mode in enumerate(self.modalities):
                stats = self.compute_stats(
                    img_dataset, "features_jit", cache_dir,
                    cache_tag=(f"{self.dataset_name}-{self.phase}-{mode}"
                               f"-{opt.crop_size_aug}-{self.preprocess}"
                               f"-{self.lpips_variant}"),
                    step=opt.step_img, mode_id=mode_id)
                self.fea_summaries.append(losses.manifold_summary(
                    torch.as_tensor(stats.get_all(), device=device)))

        self._fns = make_walk_fns(
            self.G_cfg, n_modes=len(self.modalities),
            w_pix=self.w_pix, w_lpips=self.w_lpips, w_latent=self.w_latent,
            w_disc=self.w_disc, num_epochs=self.num_epochs, opt_lr=self.opt_lr,
            crop_size=self.crop_size, preprocess=self.preprocess,
            soft_aug=bool(self.soft_aug), alpha=float(self.alpha),
            truncation_psi=self.truncation_psi, lpips_variant=self.lpips_variant,
            lpips_ref_input=self.lpips_ref_input, remat=self._remat_setting(opt))
        self._bundle = make_bundle(
            self.G, self.D, self.vgg_params, W_summary=self.W_summary,
            X_cc_summaries=self.X_cc_summaries, fea_summaries=self.fea_summaries,
            lpips_lin=self.lpips_lin)

    def _remat_setting(self, opt):
        """Per-block remat unless the options set it: on when G runs all in
        float32 (num_fp16_res 0), whose activations are the largest; a
        string 'true'/'false' or an int (blocks with res >= it) as given,
        as the JAX engine reads `opt.remat`."""
        r = getattr(opt, "remat", None)
        if r is None or r == "":
            return self.G_cfg.num_fp16_res == 0
        if isinstance(r, str):
            low = r.lower()
            if low in ("true", "false"):
                return low == "true"
            return int(r)
        return r

    def load_stylegan(self, opt):
        """Native checkpoint -> (G, D) modules on the device, frozen."""
        path = resolve_stylegan_path(
            self.model_dir, self.dataset, self.dataset_name,
            self.modalities, self.exp_stylegan, self.network_pkl_stylegan)
        print(f'Loading stylegan from "{path}"...')
        g_params, g_cfg, d_params, d_cfg = checkpoint.load_stylegan(path)
        require_unconditional_walk(g_cfg)
        # bf16 for the top blocks is a run-time choice, whatever the
        # checkpoint was trained with.
        n16 = (opt.num_fp16_res or 0) if self.res >= 64 else 0
        g_cfg.num_fp16_res = n16
        G = networks_for(g_cfg).Generator(g_cfg, impl=self.impl)
        G.load_state_dict(checkpoint.params_to_state_dict(g_params))
        G = G.to(self.device).eval().requires_grad_(False)
        D = None
        if d_params is not None:
            d_cfg.num_fp16_res = n16
            D = networks.Discriminator(d_cfg, impl=self.impl)
            D.load_state_dict(checkpoint.params_to_state_dict(d_params))
            D = D.to(self.device).eval().requires_grad_(False)
        elif self.w_disc > 0.0:
            raise ValueError(f"{path} has no discriminator but w_disc > 0")
        print("Done.")
        return G, D

    # ------------------------------------------------------------------
    # Public forward API

    def _to_device(self, a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def forward(self, w, fname=None):
        """w [B, 1, w_dim] (or z [B, z_dim]) -> (img_aug, ws_aug [B, num_ws, w_dim]),
        both tensors on the device. With verbose_log the first batch runs
        the un-fused walk (`fname` names its snapshots); later ones run the
        fused walk and record its loss traces and wall time."""
        w = self._to_device(w)
        if w.ndim == 2:
            w = self._fns.z_to_w(self._bundle, w)
        crop_pos = manifold.get_params(self.res, self.crop_size, self.preprocess,
                                       rng=self._crop_rng)["crop_pos"]
        tick = time.time()
        if self.verbose_log and not self._verbose_done:
            self._verbose_done = True
            img, ws_aug = self._walk_debug(w, crop_pos, fname)
            self._sync()
            self.stats_time["last_forward_s"] = time.time() - tick
            return img, ws_aug
        img, ws_aug, self.last_traces = self._fns.walk(self._bundle, w, crop_pos,
                                                       self._synth_gen)
        if self.verbose_log:
            self._sync()
            self._record_traces(self.last_traces, time.time() - tick)
        return img, ws_aug

    def forward_ganrand(self, z):
        return self._fns.ganrand(self._bundle, self._to_device(z), self._synth_gen)

    def synthetize(self, ws, generator=None):
        """ws [B, num_ws, w_dim] -> image with random noise, drawn from
        `generator` (default: a device generator seeded with 0)."""
        ws = self._to_device(ws)
        if tuple(ws.shape[1:]) != (self.num_ws, self.w_dim):
            raise ValueError(f"synthetize expects [B, {self.num_ws}, {self.w_dim}], "
                             f"got {tuple(ws.shape)}")
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return self._fns.synthesize(self._bundle, ws, generator)

    def broadcasting(self, latent):
        """[B, 1, w_dim] -> [B, num_ws, w_dim]."""
        if latent.ndim != 3 or latent.shape[1] != 1:
            raise ValueError(
                f"broadcasting expects [B, 1, w_dim], got {tuple(latent.shape)}")
        if isinstance(latent, torch.Tensor):
            return latent.repeat(1, self.num_ws, 1)
        return np.repeat(latent, self.num_ws, axis=1)

    @staticmethod
    def reverse_broadcasting(latent):
        """[B, num_ws, w_dim] -> [B, 1, w_dim]."""
        return latent[:, :1, :]

    # ------------------------------------------------------------------
    # Verbose walk: per-term timing and per-step snapshots

    def _walk_debug(self, w0, crop_pos, fname=None):
        """Un-fused K-step walk. Each loss term is evaluated on its own and
        timed on the host (time_latent / time_disc / time_pix / time_lpips);
        at batch 1, w and the image are snapshotted per step. The Adam
        trajectory is the fused walk's (same adam_step)."""
        fns, bundle = self._fns, self._bundle
        carry = (w0, torch.zeros_like(w0), torch.zeros_like(w0))
        steps = []
        for epoch in range(self.num_epochs):
            tick_epoch = time.time()
            with torch.no_grad():
                ws, x = fns.synth(bundle, carry[0])
                self._sync()
                loss_d, time_d = EasyDict(), EasyDict()
                for name, term in fns.terms.items():
                    tik = time.time()
                    loss_d[name] = float(term(bundle, ws, x, crop_pos))  # waits for the device
                    time_d[f"time_{name[len('loss_'):]}"] = time.time() - tik
            loss_d["loss"] = (-loss_d.get("loss_latent", 0.0) - loss_d.get("loss_pix", 0.0)
                              - loss_d.get("loss_lpips", 0.0) + loss_d.get("loss_disc", 0.0))
            carry, aux = fns.adam_step(bundle, carry, epoch, crop_pos)
            steps.append(aux)
            self._sync()
            time_d["time_epoch"] = time.time() - tick_epoch
            self.stats_loss[f"epoch_{epoch}"] = loss_d
            self.stats_time[f"epoch_{epoch}"] = time_d
            desc = " ".join(f"{k} {v:<4.2f}" for k, v in loss_d.items())
            desc += " ||| " + " ".join(f"{k} {v:<4.3f}" for k, v in time_d.items())
            print(f"epoch {epoch + 1:>4d}/{self.num_epochs}, {desc}")
            if w0.shape[0] == 1 and fname:
                # snap_w saves the w after this step, snap_img the image
                # synthesized from the w before it: frame e pairs w_{e+1}
                # with img_e, the pairing analysis/create_gif expects.
                self.snap_w(carry[0], epoch, fname[0])
                self.snap_img(x, epoch, fname[0])
        self.snapshot_stats(self.stats_loss, title="losses")
        self.snapshot_stats(self.stats_time, title="times [s]")
        self.last_traces = ({k: torch.stack([s[k] for s in steps]) for k in steps[0]}
                            if steps else {})
        return fns.finish(bundle, w0, carry[0], self._synth_gen)

    def snap_w(self, w, epoch, fname):
        """Pickle the step-`epoch` latent as w_<fname>_<epoch>.pkl."""
        name = util_path.get_filename_without_extension(fname)
        with open(os.path.join(self.save_dir, f"w_{name}_{epoch}.pkl"), "wb") as f:
            pickle.dump(w.detach().float().cpu().numpy().squeeze(), f,
                        pickle.HIGHEST_PROTOCOL)

    def snap_img(self, img, epoch, fname):
        """PNG of [A | B] side by side as <fname>_<epoch>.png."""
        from PIL import Image

        name = util_path.get_filename_without_extension(fname)
        arr = img.detach().float().cpu().numpy()[0]  # [modes, H, W]
        strip = np.clip(np.concatenate(list(arr), axis=1), -1.0, 1.0)
        strip = ((strip + 1.0) / 2.0 * 255.0).astype(np.uint8)
        Image.fromarray(strip, mode="L").save(
            os.path.join(self.save_dir, f"{name}_{epoch}.png"))

    def _record_traces(self, traces, wall):
        """Store the fused walk's per-step losses and its wall time."""
        traces = {k: v.float().cpu().numpy() for k, v in traces.items()}
        for epoch in range(self.num_epochs):
            self.stats_loss[f"epoch_{epoch}"] = EasyDict(
                {name: float(vals[epoch]) for name, vals in traces.items()})
        self.stats_time["last_forward_s"] = wall

    def snapshot_stats(self, stats=None, title="losses"):
        """Dump loss/time curves to <title>.jsonl, and one PNG per curve
        where matplotlib is installed."""
        stats = stats if stats is not None else self.stats_loss
        # Per-step dict entries only (stats_time also holds 'last_forward_s').
        stats = {k: v for k, v in stats.items() if isinstance(v, dict)}
        with open(os.path.join(self.save_dir, f"{title}.jsonl"), "w") as f:
            f.write(json.dumps(stats, indent=2) + "\n")
        try:
            import matplotlib
        except ImportError:
            return
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        ticks = list(stats.values())
        for kk in (ticks[0] if ticks else ()):
            fig = plt.figure()
            plt.plot([t[kk] for t in ticks], label=kk)
            plt.xlabel("epochs")
            plt.ylabel(title)
            plt.legend()
            fig.savefig(os.path.join(self.save_dir, f"{title}_{kk}.png"), dpi=150,
                        format="png")
            plt.close(fig)

    # ------------------------------------------------------------------
    # Manifold statistics

    def compute_stats(self, dataset, manifold_name, cache_dir, cache_tag="",
                      step=10, max_items=100000, mode_id=None):
        num_items = min(len(dataset), max_items) if max_items else len(dataset)
        util_path.create_dir(cache_dir)
        if cache_tag != "":
            cache_tag += "-"
        cache_tag += f"{manifold_name}-step_{step}-maxitems_{num_items}"
        cache_file = os.path.join(cache_dir, cache_tag + ".pkl")
        # Crop stream seeded from (run seed, cache tag), as in the JAX engine.
        rng = random.Random(f"{self._seed}-{cache_tag}")

        if os.path.isfile(cache_file):
            print(f"{manifold_name} dataset already created in {cache_file}.")
            return manifold.DatasetStats.load(cache_file)

        print(f"{manifold_name} dataset initialization.")
        stats = manifold.DatasetStats(manifold=manifold_name, max_items=num_items,
                                      step=step)
        for idx in range(len(dataset)):
            x, fname = dataset[idx]
            if stats.is_full():
                break
            if manifold_name == "img":
                item = x[None] / 127.5 - 1.0  # [-1, 1], as synthetic images
            elif manifold_name == "latent":
                item = x[None]
            else:  # features_jit
                # Draw crop params for every item so the admitted items'
                # crops do not depend on the schedule.
                params = manifold.get_params(self.res, self.crop_size,
                                             self.preprocess, rng=rng)
                if not stats.admits(fname):
                    continue
                item = self._extract_features(x, mode_id, params)
            if stats.append(item, fname) < 0:
                break
        stats.save(cache_file)
        return stats

    @torch.no_grad()
    def _extract_features(self, img, mode_id, params):
        """LPIPS embedding of one [modes, H, W] raw [0,255] image crop."""
        x = self._to_device(np.asarray(img, dtype=np.float32)[mode_id][None, None])
        x = manifold.get_transform(self.res, self.crop_size, self.preprocess, params)(x)
        x = x.repeat(1, 3, 1, 1)
        if self.lpips_variant == "script":
            return vgg.lpips_features(self.vgg_params, x).cpu().numpy()
        return embedding_from_params(self.vgg_params, self.lpips_lin,
                                     x / 127.5 - 1.0).cpu().numpy()


def define_latentaugment(module_name, phase, opt, save_dir, device, mesh=None):
    if module_name == "latent_aug":
        return LatentAugEngine(phase, opt, save_dir, device, mesh=mesh)
    raise NotImplementedError(f"Module name [{module_name}] is not recognized")
