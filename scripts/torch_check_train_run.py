"""Check a training run's dynamics from its log.jsonl: that the trainer
trains, not only that it steps (a wrong loss sign still steps finitely).
The port's copy of scripts/check_train_run.py, with the same checks,
messages and summary; numpy and PIL only (matplotlib where installed).

Assertions (robust to dataset and scale, chosen so that a sign or
plumbing bug fails loudly while honest stochastic noise passes):
  1. every logged value is finite, rt in [-1, 1], aug_p in [0, 1]
  2. the run covered the expected kimg
  3. D learns to score real data: Loss/D/real = softplus(-D(real))
     ends below ln 2 or falls from the first quarter to the last
  4. the ADA controller responds in the right direction: over the
     second half, if rt persistently exceeds the target, p must have
     risen; persistently below, fallen
  5. the R1 penalty stays bounded (an exploding r1 is a D gradient
     blow-up)
  6. Loss/D/gen stays on the softplus operating scale (a fully flipped
     D objective drives every logit to +inf, which mimics separation on
     the real side and is caught only here; see
     artifacts/negative_control_r5/)

Also draws the loss / rt / aug_p trajectories to <run_dir>/dynamics.png:
with matplotlib where it is installed, else the same three panels with
PIL.

    python scripts/torch_check_train_run.py <run_dir> [--kimg 10] [--target 0.6]
"""

import argparse
import json
import os

import numpy as np


def load_log(run_dir):
    rows = []
    with open(os.path.join(run_dir, "log.jsonl")) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def check_rows(rows, *, expect_kimg=None, ada_target=0.6, require_ada=True):
    """Raises AssertionError with a named reason on any dynamics
    violation; returns a dict summary on success."""
    assert len(rows) >= 4, f"only {len(rows)} log rows — run too short"
    keys = ("Loss/G/loss", "Loss/D/gen", "Loss/D/real", "Progress/rt",
            "aug_p", "kimg")
    series = {k: np.array([r[k] for r in rows], dtype=np.float64)
              for k in keys if k in rows[0]}
    for k, v in series.items():
        assert np.isfinite(v).all(), \
            f"{k} has non-finite values at rows {np.where(~np.isfinite(v))[0]}"
    rt = series["Progress/rt"]
    assert (rt >= -1.0 - 1e-6).all() and (rt <= 1.0 + 1e-6).all(), \
        f"rt outside [-1,1]: [{rt.min()}, {rt.max()}]"
    p = series["aug_p"]
    assert (p >= 0).all() and (p <= 1.0).all(), \
        f"aug_p outside [0,1]: [{p.min()}, {p.max()}]"

    if expect_kimg is not None:
        got = series["kimg"][-1]
        assert got >= 0.95 * expect_kimg, \
            f"run covered {got} kimg < expected {expect_kimg}"

    # D separation: softplus(-D(real)) < ln 2 means the median real image
    # scores positive. Pass when the run ends separated or improves
    # towards it; a wrong D-loss sign drives D(real) negative (loss above
    # ln 2 and rising), which fails both arms. The median of each
    # quarter, not the mean: single-step adversarial spikes are normal,
    # and on a small dataset D separates within the first quarter and
    # then rides the ADA equilibrium.
    q = max(3, len(rows) // 4)
    ln2 = float(np.log(2.0))
    d_real_first = float(np.median(series["Loss/D/real"][:q]))
    d_real_last = float(np.median(series["Loss/D/real"][-q:]))
    assert d_real_last < ln2 or d_real_last < d_real_first, (
        f"D never separates real data: first-quarter median "
        f"{d_real_first:.4f} -> last-quarter median {d_real_last:.4f}, "
        f"both arms fail (last >= ln2 {ln2:.3f} and not improving) — "
        "wrong loss sign / optimizer not stepping D?")

    # ADA responsiveness over the second half, judged only when rt is
    # persistently on one side of the target (an rt oscillating around
    # it legitimately leaves p near-flat).
    ada = None
    half = len(rows) // 2
    rt_h, p_h = rt[half:], p[half:]
    dp = float(p_h[-1] - p_h[0])
    if require_ada:
        if (rt_h > ada_target).mean() > 0.8:
            # p saturated at the controller's 1.0 cap leaves dp == 0.
            assert dp > 0 or p_h[0] >= 1.0, (
                f"rt persistently above target {ada_target} "
                f"(mean {rt_h.mean():.3f}) but p fell/flat: dp={dp:.5f}")
            ada = "p rose or pinned at cap (rt > target)"
        elif (rt_h < ada_target).mean() > 0.8:
            assert dp < 0 or p_h[0] == 0.0, (
                f"rt persistently below target {ada_target} "
                f"(mean {rt_h.mean():.3f}) but p rose: dp={dp:.5f}")
            ada = "p fell or pinned at 0 (rt < target)"
        else:
            ada = "rt straddles target — direction not judged"

    # D's fake-side loss must stay on the softplus operating scale: a
    # flipped D objective keeps checks 3-4 passing while Loss/D/gen
    # explodes by orders of magnitude (healthy runs sit at O(1)).
    d_gen_last = float(np.median(series["Loss/D/gen"][-q:]))
    assert d_gen_last < 20.0, (
        f"Loss/D/gen exploded: last-quarter median {d_gen_last:.2f} — "
        "D scores fakes arbitrarily high (wrong objective sign / "
        "runaway logits)")

    r1 = np.array([r.get("Loss/r1_penalty", 0.0) for r in rows])
    assert np.isfinite(r1).all() and (np.abs(r1[-q:]).mean()
                                      < 10 * max(np.abs(r1[:q]).mean(),
                                                 1.0)), \
        "R1 penalty exploding"

    return dict(
        rows=len(rows), kimg=float(series["kimg"][-1]),
        d_real_first=d_real_first, d_real_last=d_real_last,
        rt_mean_last=float(rt[-q:].mean()),
        p_final=float(p[-1]), ada=ada,
        g_loss_last=float(series["Loss/G/loss"][-q:].mean()),
    )


_PANELS = ((("Loss/G/loss", "Loss/D/gen", "Loss/D/real"), "loss"),
           (("Progress/rt",), "ADA rt"), (("aug_p",), "aug p"))


def plot(rows, out_png):
    """The three panels (losses, rt with its 0.6 target, aug p) against
    kimg, written to `out_png`."""
    try:
        import matplotlib
    except ImportError:
        return _plot_pil(rows, out_png)
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    kimg = [r["kimg"] for r in rows]
    fig, axes = plt.subplots(3, 1, figsize=(8, 9), sharex=True)
    for ax, (keys, ylabel) in zip(axes, _PANELS):
        for k in keys:
            ax.plot(kimg, [r[k] for r in rows], label="rt" if k == "Progress/rt" else k)
        if ylabel == "ADA rt":
            ax.axhline(0.6, ls="--", c="gray", lw=0.8, label="target")
        ax.set_ylabel(ylabel)
        ax.legend(fontsize=8)
    axes[2].set_xlabel("kimg")
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)
    return out_png


def _plot_pil(rows, out_png, width=880, panel_h=300, margin=40):
    """`plot` without matplotlib: each panel's series as tab10 polylines
    over kimg, scaled to the panel, with its label and, for rt, the 0.6
    target dashed in gray."""
    from PIL import Image, ImageDraw

    tab10 = [(31, 119, 180), (255, 127, 14), (44, 160, 44)]
    kimg = np.array([r["kimg"] for r in rows], np.float64)
    img = Image.new("RGB", (width, 3 * panel_h), "white")
    draw = ImageDraw.Draw(img)
    k0, k1 = kimg.min(), max(kimg.max(), kimg.min() + 1e-12)
    for i, (keys, ylabel) in enumerate(_PANELS):
        top = i * panel_h
        vals = np.array([[r[k] for r in rows] for k in keys], np.float64)
        lo, hi = np.nanmin(vals), np.nanmax(vals)
        if ylabel == "ADA rt":
            lo, hi = min(lo, 0.6), max(hi, 0.6)
        hi = max(hi, lo + 1e-12)

        def xy(k, v):
            return (margin + (k - k0) / (k1 - k0) * (width - 2 * margin),
                    top + panel_h - margin - (v - lo) / (hi - lo) * (panel_h - 2 * margin))
        draw.rectangle([margin, top + margin, width - margin, top + panel_h - margin],
                       outline=(0, 0, 0))
        draw.text((4, top + 4), f"{ylabel}  [{lo:.4g}, {hi:.4g}]", fill=(0, 0, 0))
        for j, (k, v) in enumerate(zip(keys, vals)):
            draw.line([xy(a, b) for a, b in zip(kimg, v)], fill=tab10[j], width=2)
            draw.text((width - 200, top + 4 + 12 * j), "rt" if k == "Progress/rt" else k,
                      fill=tab10[j])
        if ylabel == "ADA rt":
            y = xy(k0, 0.6)[1]
            for x in range(margin, width - margin, 12):
                draw.line([(x, y), (x + 6, y)], fill=(128, 128, 128))
    draw.text((width // 2 - 16, 3 * panel_h - 16), "kimg", fill=(0, 0, 0))
    img.save(out_png)
    return out_png


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("run_dir")
    ap.add_argument("--kimg", type=float, default=None,
                    help="expected coverage (default: no check)")
    ap.add_argument("--target", type=float, default=0.6)
    ap.add_argument("--no-ada", action="store_true",
                    help="run trained with aug=noaug/fixed")
    args = ap.parse_args(argv)
    rows = load_log(args.run_dir)
    summary = check_rows(rows, expect_kimg=args.kimg,
                         ada_target=args.target,
                         require_ada=not args.no_ada)
    png = plot(rows, os.path.join(args.run_dir, "dynamics.png"))
    summary["plot"] = png
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
