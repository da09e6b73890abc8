"""Report and plot helpers (counterpart:
latentaugment_tpu/utils/util_reports.py): static matplotlib scatters and
image grids, and the interactive Bokeh scatter, which falls back to the
static one where bokeh is not installed (it is imported inside the
function). Where matplotlib is not installed, `scatter_plot` draws its
points with PIL (no axes or legend), so the coverage plot is written on
a host that has PIL only. Host-only, numpy in, files out."""

import os

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def scatter_plot(points, labels=None, title="", save_path=None, cmap="tab10",
                 alpha=0.6, s=8):
    """2-D scatter of [N, 2] points, colored by integer labels."""
    try:
        plt = _plt()
    except ImportError:
        return _scatter_plot_pil(points, labels, save_path, s)
    points = np.asarray(points)
    fig, ax = plt.subplots(figsize=(6, 6))
    if labels is None:
        ax.scatter(points[:, 0], points[:, 1], s=s, alpha=alpha)
    else:
        labels = np.asarray(labels)
        for lab in np.unique(labels):
            m = labels == lab
            ax.scatter(points[m, 0], points[m, 1], s=s, alpha=alpha,
                       label=str(lab))
        ax.legend()
    ax.set_title(title)
    if save_path:
        fig.savefig(save_path, dpi=200, bbox_inches="tight")
    plt.close(fig)
    return save_path


def _scatter_plot_pil(points, labels, save_path, s, size=800, margin=20):
    """scatter_plot without matplotlib: each label's points as dots of its
    tab10 color on a white square, the points scaled to fill it."""
    from PIL import Image, ImageDraw

    if not save_path:
        return save_path
    points = np.asarray(points, np.float64)
    labels = np.zeros(len(points), int) if labels is None else np.asarray(labels)
    lo, hi = points.min(0), points.max(0)
    xy = margin + (points - lo) / np.maximum(hi - lo, 1e-12) * (size - 2 * margin)
    tab10 = [(31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40), (148, 103, 189),
             (140, 86, 75), (227, 119, 194), (127, 127, 127), (188, 189, 34), (23, 190, 207)]
    img = Image.new("RGB", (size, size), "white")
    draw = ImageDraw.Draw(img)
    r = max(1.0, s ** 0.5)
    for i, lab in enumerate(np.unique(labels)):
        for x, y in xy[labels == lab]:
            draw.ellipse([x - r, size - y - r, x + r, size - y + r], fill=tab10[i % 10])
    img.save(save_path)
    return save_path


def scatter_plot_interactive(points, labels, title="", save_path=None,
                             hover_images=None):
    """Interactive Bokeh scatter. Falls back
    to the static plot when bokeh is unavailable."""
    try:
        from bokeh.models import ColumnDataSource, HoverTool
        from bokeh.plotting import figure, output_file, save
    except ImportError:
        print("[reports] bokeh not installed; writing static scatter instead")
        alt = (os.path.splitext(save_path)[0] + ".png") if save_path else None
        return scatter_plot(points, labels, title=title, save_path=alt)

    points = np.asarray(points)
    source = ColumnDataSource(data=dict(
        x=points[:, 0], y=points[:, 1],
        label=[str(l) for l in labels],
        img=hover_images if hover_images is not None else [""] * len(points)))
    p = figure(title=title, tools="pan,wheel_zoom,box_zoom,reset,save")
    p.scatter("x", "y", source=source, legend_field="label", alpha=0.6, size=5)
    p.add_tools(HoverTool(tooltips=[("label", "@label")]))
    if save_path:
        output_file(save_path)
        save(p)
    return save_path


def get_cmap(n, name="hsv"):
    """Index -> distinct RGB color mapper."""
    _plt()  # force the Agg backend before touching matplotlib registries
    import matplotlib

    # plt.cm.get_cmap is deprecated since matplotlib 3.7; the colormap
    # registry replaces it.
    return matplotlib.colormaps[name].resampled(n)


def plot_training(history, plot_training_dir, columns_to_plot=None,
                  **plot_args):
    """Plot training-history curves, one line per column, to
    `<dir>/<title>.png`; `history` is a dict of lists."""
    from . import util_path

    util_path.create_dir(plot_training_dir)
    if not isinstance(history, dict):
        history = dict(history)
    columns = list(history.keys())
    if columns_to_plot is not None:
        columns = [c for c in columns if c in set(columns_to_plot)]

    plt = _plt()
    cmap = get_cmap(len(columns) + 1)
    fig = plt.figure(figsize=(8, 6))
    for idx, key in enumerate(columns):
        plt.plot(np.asarray(history[key]), label=key, c=cmap(idx))
    plt.title(plot_args.get("title", "training"))
    plt.xlabel(plot_args.get("xlab", "epoch"))
    plt.ylabel(plot_args.get("ylab", "loss"))
    plt.legend()
    out = os.path.join(plot_training_dir,
                       f"{plot_args.get('title', 'training')}.png")
    fig.savefig(out, dpi=200, bbox_inches="tight")
    plt.close(fig)
    return out


def embeddable_image(img):
    """[-1,1] grayscale [H, W] -> base64 PNG data URI for Bokeh hover
    tooltips."""
    import base64
    import io

    from PIL import Image

    img = np.asarray(img)
    if img.ndim == 3:
        img = img[0]
    img = np.clip(img, -1.0, 1.0)
    img8 = ((img + 1) * 255 / 2).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img8, mode="L").save(buf, format="png")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def dump_images(output_dir, imgs, fname):
    """Write each [-1,1] image as `<fname>_<i>.png` (PIL)."""
    from PIL import Image

    os.makedirs(output_dir, exist_ok=True)
    paths = []
    for i, x in enumerate(np.asarray(imgs)):
        if x.ndim == 3:
            x = x[0]
        x = np.clip(x, -1.0, 1.0)
        x8 = ((x + 1) / 2 * 255.0).astype(np.uint8)
        p = os.path.join(output_dir, f"{fname}_{i}.png")
        Image.fromarray(x8, mode="L").save(p)
        paths.append(p)
    return paths


def show_activation(x, layer, report_dir):
    """Save a square grid of one batch item's activation channels,
    normalized from (-1,1), through image_grid."""
    x = np.asarray(x)
    assert x.ndim == 4  # [N, C, H, W]
    out_dir = os.path.join(report_dir, "activations")
    os.makedirs(out_dir, exist_ok=True)
    grid = np.transpose(x, (1, 0, 2, 3))[:, 0]  # channels of item 0
    nrow = int(np.sqrt(grid.shape[0]))
    tot = max(nrow * nrow, 1)
    grid = (np.clip(grid[:tot], -1.0, 1.0) + 1.0) / 2.0
    return image_grid(grid, n_cols=max(nrow, 1),
                      save_path=os.path.join(
                          out_dir, f"activation_grid_{layer}.png"))


def image_grid(images, n_cols=8, save_path=None, title=""):
    """Tile a batch of [N, 1, H, W] or [N, H, W] images into one PNG."""
    plt = _plt()
    images = np.asarray(images)
    if images.ndim == 4:
        images = images[:, 0]
    n = images.shape[0]
    n_rows = (n + n_cols - 1) // n_cols
    fig, axes = plt.subplots(n_rows, n_cols,
                             figsize=(1.5 * n_cols, 1.5 * n_rows))
    # reshape, not atleast_2d: subplots(n, 1) returns shape (n,), which
    # atleast_2d would turn into (1, n).
    axes = np.asarray(axes).reshape(n_rows, n_cols)
    for i in range(n_rows * n_cols):
        ax = axes[i // n_cols, i % n_cols]
        ax.axis("off")
        if i < n:
            ax.imshow(images[i], cmap="gray")
    fig.suptitle(title)
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return save_path
