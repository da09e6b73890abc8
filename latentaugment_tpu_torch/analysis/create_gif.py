"""Walk-trajectory GIFs (counterpart:
latentaugment_tpu/analysis/create_gif.py): the per-step PNG snapshots
that the engine's verbose walk writes (`snap_img`) become one animated
GIF per sample, written with PIL. Host-only.

    python -m latentaugment_tpu_torch.analysis.create_gif --snapshot_dir <dir>
"""

import os
import re

from PIL import Image


def create_gif(snapshot_dir, out_path=None, pattern=r"(.+)_(\d+)\.png$",
               duration_ms=200):
    """Group '<fname>_<epoch>.png' snapshots by fname; write one GIF each."""
    groups = {}
    for f in sorted(os.listdir(snapshot_dir)):
        m = re.match(pattern, f)
        if not m:
            continue
        groups.setdefault(m.group(1), []).append((int(m.group(2)), f))

    outputs = []
    for name, frames in groups.items():
        frames.sort()
        imgs = [Image.open(os.path.join(snapshot_dir, f)).convert("P")
                for _, f in frames]
        if not imgs:
            continue
        out = out_path or os.path.join(snapshot_dir, f"{name}.gif")
        imgs[0].save(out, save_all=True, append_images=imgs[1:],
                     duration=duration_ms, loop=0)
        outputs.append(out)
        print(f"wrote {out} ({len(imgs)} frames)")
    return outputs


def add_text_to_image(img, text, font_path=None, font_size=50):
    """Draw white text at the upper-left corner (PIL's default bitmap font
    when no .ttf path is given or it cannot be read)."""
    from PIL import ImageDraw, ImageFont

    draw = ImageDraw.Draw(img)
    font = None
    if font_path:
        try:
            font = ImageFont.truetype(font_path, font_size)
        except OSError:
            font = None
    if font is None:
        font = ImageFont.load_default()
    draw.text((10, 10), text, fill="white", font=font)
    return img


def create_gif_hstack(source_dir, duration_ms=200, output_name="gif.gif",
                      latent_size=(256, 256)):
    """Stack each epoch's image snapshot beside its latent snapshot and
    animate ('latent' in the filename marks the latent-trajectory PNGs)."""
    names = sorted(f for f in os.listdir(source_dir) if f.endswith(".png"))
    names_latent = [x for x in names if "latent" in x]
    names_img = [x for x in names if "latent" not in x]

    frames = []
    for name_img, name_latent in zip(names_img, names_latent):
        img = Image.open(os.path.join(source_dir, name_img)).convert("RGB")
        latent = Image.open(
            os.path.join(source_dir, name_latent)).convert("RGB")
        latent = latent.resize(latent_size, Image.BICUBIC)
        h = max(img.height, latent.height)
        canvas = Image.new("RGB", (img.width + latent.width, h))
        canvas.paste(img, (0, 0))
        canvas.paste(latent, (img.width, 0))
        frames.append(canvas)

    out = os.path.join(source_dir, output_name)
    if frames:
        frames[0].save(out, save_all=True, append_images=frames[1:],
                       duration=duration_ms, loop=0)
    return out


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--snapshot_dir", required=True)
    ap.add_argument("--duration_ms", type=int, default=200)
    args = ap.parse_args()
    create_gif(args.snapshot_dir, duration_ms=args.duration_ms)
