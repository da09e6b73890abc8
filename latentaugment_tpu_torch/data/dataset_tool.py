"""Offline dataset preprocessing tool
(counterpart: latentaugment_tpu/data/dataset_tool.py).

The same steps, in the same order and with the same products on disk:
per-patient volumes resized, normalized to [0, 255] and masked, sliced
into `<patient>/<patient>_<NNNNN>.pickle` modality dicts, split by
patient and packed into a zip of `<split>/<patient>/<split>_<slice>.pickle`
members, which the port's pelvis loader and the trainer's image-folder
dataset read. Sanity PNGs are written where matplotlib is installed and
skipped where it is not.

Volumes are `.npy` [D, H, W] per modality file; `.nii/.nii.gz` need
nibabel and DICOM needs pydicom, each raising a clear ImportError
without it. The command line is the JAX tool's, with the same
subcommands, options and defaults:

    python -m latentaugment_tpu_torch.data.dataset_tool prepare-pelvis \
        --data_dir <vols> --interim_dir <tmp> --dest_zip out.zip --resolution 256
    python -m latentaugment_tpu_torch.data.dataset_tool run \
        --configuration_file cfg.yaml --processing_step <step> ...

`run` reads a yaml configuration and needs the `yaml` module.
"""

import argparse
import glob
import json
import os
import random
import shutil
import sys
import zipfile

import numpy as np

from ..utils import util_io, util_path
from ..utils.util_easydict import EasyDict


class DatasetToolError(Exception):
    """A dataset that breaks the tool's contract (shape, attributes)."""


# ----------------------------------------------------------------------------
# Volume IO

def load_volume(path):
    """[D, H, W] float array from .npy or .nii(.gz)."""
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith((".nii", ".nii.gz", ".gz")):
        try:
            import nibabel as nib
        except ImportError as e:
            raise ImportError(
                "nibabel is required for NIfTI volumes and is not installed; "
                "convert volumes to .npy") from e
        data = nib.load(path).get_fdata()
        # NIfTI is [H, W, D]; reorder to [D, H, W].
        return np.transpose(data, (2, 0, 1))
    raise IOError(f"unsupported volume format: {path}")


# ----------------------------------------------------------------------------
# Normalization (parity: dataset_tool.py:295-374)

def get_normalization_range(data, data_options):
    if data_options.get("upper_percentile") is not None:
        upper = np.percentile(data, data_options["upper_percentile"])
    elif data_options.get("range", {}).get("max") is not None:
        upper = data_options["range"]["max"]
    else:
        upper = data.max()

    if data_options.get("lower_percentile") is not None:
        lower = np.percentile(data, data_options["lower_percentile"])
    elif data_options.get("range", {}).get("min") is not None:
        lower = data_options["range"]["min"]
    else:
        lower = data.min()
    return upper, lower


def normalize_per_dataset(data, dataset, modes_args, low=0.0, hi=255.0):
    if dataset.startswith("Pelvis"):
        upper, lower = get_normalization_range(data, modes_args)
        data = np.clip(data, lower, upper)
        data = (data - lower) / max(upper - lower, 1e-12)
        return data * (hi - low) + low
    if dataset == "claro":
        return data
    raise NotImplementedError(f"Normalization for {dataset} was not implemented.")


# ----------------------------------------------------------------------------
# Slicing -> per-slice pickle dicts (parity: convert_dataset_mi :570-704)

def iterate_patient_slices(source, transpose_img=True):
    """Yield {folder_name, name, depth_index, total_depth, img(dict)} per
    slice from `<source>/<patient>/<modality>.{npy,nii.gz}` volumes."""
    folders = sorted(f for f in glob.glob(os.path.join(source, "*"))
                     if os.path.isdir(f))
    for folder in folders:
        patient = util_path.get_filename_without_extension(folder)
        vols = {}
        for file_mode in sorted(glob.glob(os.path.join(folder, "*"))):
            mode = util_path.get_filename_without_extension(file_mode)
            mode = mode.replace(".nii", "")
            vols[mode] = load_volume(file_mode)
        if not vols:
            continue
        depth = min(v.shape[0] for v in vols.values())
        for d in range(depth):
            img = {}
            for mode, vol in vols.items():
                sl = vol[d]
                if transpose_img:
                    sl = sl.transpose(1, 0)
                img[mode] = sl
            yield dict(folder_name=patient, name=f"{patient}_{d:05d}",
                       depth_index=d, total_depth=depth, img=img)


def snap_pickle(source, dest, source_mask=None, pop_range=10,
                apply_mask=False, is_overwrite=False, sanity_check_prob=0.05):
    """Slice volumes into `<dest>/temp/<patient>/<name>.pickle` dicts.

    Skips `pop_range` slices at both stack ends (CT registration issues),
    honors a CT_registration_problem.json skip list, optionally applies a
    binary mask volume, enforces square power-of-two shapes, and dumps
    sanity PNGs for a random subset.
    """
    reg_problems = {}
    reg_file = os.path.join(dest, "CT_registration_problem.json")
    if os.path.exists(reg_file):
        with open(reg_file) as f:
            reg_problems = json.load(f)

    temp = os.path.join(dest, "temp")
    if os.path.isdir(temp) and is_overwrite:
        shutil.rmtree(temp)
    util_path.create_dir(temp)

    mask_vols = {}

    def get_mask_slice(patient, d):
        """Mask slice by (patient, depth) lookup — zip-iterating the mask
        source would desync whenever a slice is skipped (pop_range /
        registration problems)."""
        if patient not in mask_vols:
            pdir = os.path.join(source_mask, patient)
            files = [f for f in sorted(glob.glob(os.path.join(pdir, "*")))
                     if util_path.get_filename_without_extension(f)
                     .replace(".nii", "") == "mask"]
            mask_vols[patient] = load_volume(files[0]) if files else None
        vol = mask_vols[patient]
        return None if vol is None else vol[d]

    dataset_attrs = None
    n_written = 0
    for image in iterate_patient_slices(source):
        folder_name = image["folder_name"]
        out_path = os.path.join(temp, folder_name, image["name"] + ".pickle")
        util_path.create_dir(os.path.dirname(out_path))

        if not is_overwrite and os.path.exists(out_path):
            continue
        d, total = image["depth_index"], image["total_depth"]
        if d < pop_range or d >= total - pop_range:
            continue
        if folder_name in reg_problems:
            lo, hi_ = reg_problems[folder_name]
            if (lo != -1 and d < lo) or (lo == -1 and d > hi_):
                continue

        img = image["img"]
        if apply_mask and source_mask:
            mask = get_mask_slice(folder_name, d)
            if mask is not None:
                # Mask volumes are stored [D, H, W] like the modality volumes;
                # iterate_patient_slices transposes slices, so match it.
                mask = mask.transpose(1, 0).astype(np.uint8)
                for mode in sorted(img):
                    img[mode] = np.multiply(img[mode], mask).astype(np.float64)

        modalities = sorted(img.keys())
        cur_attrs = dict(width=img[modalities[0]].shape[1],
                         height=img[modalities[0]].shape[0],
                         modalities=modalities)
        if dataset_attrs is None:
            dataset_attrs = cur_attrs
            w, h = cur_attrs["width"], cur_attrs["height"]
            if w != h:
                raise DatasetToolError(
                    f"Images are required to be square. Got {w}x{h}")
            if w != 2 ** int(np.floor(np.log2(w))):
                raise DatasetToolError(
                    "Image width/height are required to be power-of-two")
        elif dataset_attrs != cur_attrs:
            raise DatasetToolError(
                f"Image {out_path} attributes must be equal across the dataset")

        if random.random() < sanity_check_prob:
            _sanity_png(img, dest, folder_name, image["name"])

        util_io.write_pickle(img, out_path)
        n_written += 1
    print(f"snap_pickle: wrote {n_written} slices to {temp}")
    return temp


def _sanity_png(img, dest, patient, name):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    sdir = os.path.join(dest, "sanity_check", patient)
    util_path.create_dir(sdir)
    modes = sorted(img)
    fig, axes = plt.subplots(1, len(modes), figsize=(3 * len(modes), 3))
    axes = np.atleast_1d(axes)
    for ax, mode in zip(axes, modes):
        ax.imshow(img[mode], cmap="gray")
        ax.set_title(mode, fontsize=6)
        ax.axis("off")
    fig.savefig(os.path.join(sdir, f"{name}.png"), dpi=100)
    plt.close(fig)


# ----------------------------------------------------------------------------
# Splits (parity: dataset_tool.py:708-742)

def split_list(input_list, split=0.8, shuffle_list=True, seed=None):
    items = list(input_list)
    if shuffle_list:
        random.Random(seed).shuffle(items)
    n = int(round(len(items) * split))
    return items[:n], items[n:]


def make_splits(patients, train=0.7, val=0.2, test=0.1, seed=42):
    assert abs(train + val + test - 1.0) < 1e-6
    train_p, rest = split_list(patients, split=train, seed=seed)
    val_p, test_p = split_list(rest, split=val / max(val + test, 1e-12),
                               shuffle_list=False)
    return {"train": sorted(train_p), "val": sorted(val_p),
            "test": sorted(test_p)}


def make_cv_splits(patients, n_folds=5, val_frac=0.2, seed=42):
    items = list(patients)
    random.Random(seed).shuffle(items)
    folds = [items[i::n_folds] for i in range(n_folds)]
    splits = []
    for k in range(n_folds):
        test_p = folds[k]
        rest = [p for i, f in enumerate(folds) if i != k for p in f]
        n_val = int(round(len(rest) * val_frac))
        splits.append({"train": sorted(rest[n_val:]),
                       "val": sorted(rest[:n_val]),
                       "test": sorted(test_p)})
    return splits


# ----------------------------------------------------------------------------
# Zip writer (parity: snap_zip / write_to_zip)

def snap_zip(temp_dir, dest_zip, splits):
    """Pack `<temp>/<patient>/<slice>.pickle` into
    `<split>/<patient>/<split>_<slice>.pickle` zip members."""
    patient_to_split = {p: s for s, ps in splits.items() for p in ps}
    n = 0
    with zipfile.ZipFile(dest_zip, "w", zipfile.ZIP_STORED) as zf:
        for patient in sorted(os.listdir(temp_dir)):
            pdir = os.path.join(temp_dir, patient)
            if not os.path.isdir(pdir):
                continue
            split = patient_to_split.get(patient)
            if split is None:
                continue
            for fname in sorted(os.listdir(pdir)):
                arcname = f"{split}/{patient}/{split}_{fname}"
                zf.write(os.path.join(pdir, fname), arcname)
                n += 1
    print(f"snap_zip: wrote {n} members to {dest_zip}")
    return dest_zip


# ----------------------------------------------------------------------------
# Front half: DICOM -> volume, resize, mask (parity: dataset_tool.py:216-520).
# Heavy medical-IO deps (pydicom, nibabel) are gated; all geometry/morphology
# logic is dependency-free and tested on synthetic volumes.

def save_volume(path_base, vol):
    """Save [D, H, W] as .nii.gz when nibabel exists, else .npy."""
    try:
        import nibabel as nib

        img = nib.Nifti1Image(np.transpose(np.asarray(vol), (1, 2, 0)),
                              affine=np.eye(4))
        out = path_base + ".nii.gz"
        nib.save(img, out)
    except ImportError:
        out = path_base + ".npy"
        np.save(out, np.asarray(vol))
    return out


def assemble_dicom_series(slices):
    """Sort a DICOM series into a [D, H, W] float volume.

    `slices` are objects exposing pixel_array and (optionally)
    ImagePositionPatient / InstanceNumber / RescaleSlope / RescaleIntercept
    — real pydicom datasets or synthetic stand-ins. Slices order by the
    z-component of ImagePositionPatient (falling back to InstanceNumber),
    and HU rescale slope/intercept apply per slice (parity:
    dicom_series_to_nifti's assembly; ref dataset_tool.py:216-246,
    mayoclinic_dataset.py:28-48)."""
    def sort_key(s):
        pos = getattr(s, "ImagePositionPatient", None)
        if pos is not None:
            return float(pos[2])
        return float(getattr(s, "InstanceNumber", 0))

    ordered = sorted(slices, key=sort_key)
    planes = []
    for s in ordered:
        arr = np.asarray(s.pixel_array, dtype=np.float64)
        slope = float(getattr(s, "RescaleSlope", 1.0) or 1.0)
        intercept = float(getattr(s, "RescaleIntercept", 0.0) or 0.0)
        planes.append(arr * slope + intercept)
    return np.stack(planes, axis=0)


def convert_dicom_2_nifti(source, dest, modes_to_preprocess):
    """Merge each patient's per-modality DICOM series into one volume file.

    Layout: <source>/<patient>[/<study>]/<modality>/*.dcm ->
    <dest>/<patient>/<modality>.{nii.gz,npy}. Requires pydicom."""
    try:
        import pydicom
    except ImportError as e:
        raise ImportError("pydicom is required for DICOM ingestion; convert "
                          "your series to .npy volumes instead") from e

    for pat in sorted(glob.glob(os.path.join(source, "*"))):
        patient = util_path.get_filename_without_extension(pat)
        output_dir = os.path.join(dest, patient)
        if os.path.exists(output_dir):
            print(f"{output_dir} already exists! Skip this patient.")
            continue
        util_path.create_dir(output_dir)
        for mode in modes_to_preprocess:
            mode_dir = os.path.join(pat, mode)
            if not os.path.isdir(mode_dir):
                sub = sorted(os.listdir(pat))
                mode_dir = os.path.join(pat, sub[0], mode) if sub else mode_dir
            files = sorted(glob.glob(os.path.join(mode_dir, "*")))
            if not files:
                print(f"fail to convert {mode_dir}: no files")
                continue
            try:
                slices = [pydicom.dcmread(f) for f in files]
                vol = assemble_dicom_series(slices)
                save_volume(os.path.join(output_dir, mode), vol)
                print(f"converted {patient}/{mode}: {vol.shape}")
            except Exception as e:  # parity: ref swallows per-series failures
                print(f"fail to convert {mode_dir}: {e}")


def resize_volume(vol, image_shape, interpolation="linear"):
    """In-plane resample of [D, H, W] to [D, *image_shape].

    scipy.ndimage.zoom per volume (order 1 = the reference's 'linear'
    respacing; ref dataset_tool.py:249-292)."""
    from scipy import ndimage

    d, h, w = vol.shape
    order = {"nearest": 0, "linear": 1, "cubic": 3}[interpolation]
    zoom = (1.0, image_shape[0] / h, image_shape[1] / w)
    return ndimage.zoom(np.asarray(vol, np.float64), zoom, order=order)


def _resize_one(args):
    folder, dest, image_shape, interpolation = args
    patient = util_path.get_filename_without_extension(folder)
    outdir = util_path.create_dir(os.path.join(dest, patient))
    for file_mode in sorted(glob.glob(os.path.join(folder, "*"))):
        mode = util_path.get_filename_without_extension(file_mode).replace(
            ".nii", "")
        vol = resize_volume(load_volume(file_mode), image_shape, interpolation)
        save_volume(os.path.join(outdir, mode), vol)
    return patient


def resize_nifti_folder(source, dest, image_shape=(256, 256),
                        interpolation="linear", processes=None):
    """Resize every patient's volumes in a pool of worker processes (one
    per patient up to the CPU count; started with `spawn`, safe beside
    torch's threads), serially where the sandbox cannot start one."""
    import multiprocessing

    folders = sorted(f for f in glob.glob(os.path.join(source, "*"))
                     if os.path.isdir(f))
    args = [(f, dest, tuple(image_shape), interpolation) for f in folders]
    if processes is None:
        processes = max(1, min(len(args), os.cpu_count() or 1))
    try:
        with multiprocessing.get_context("spawn").Pool(processes=processes) as pool:
            done = pool.map(_resize_one, args)
        print(f"resized {len(done)} patients -> {dest}")
        return done
    except (OSError, PermissionError) as e:
        # Only a pool that cannot start falls back to serial: a worker's
        # exception propagates rather than rerunning the dataset serially.
        print(f"[dataset_tool] Pool unavailable ({e}); resizing serially")
    done = [_resize_one(a) for a in args]
    print(f"resized {len(done)} patients -> {dest}")
    return done


# ----- masking (parity: find_mask_* dataset_tool.py:376-520; nilearn's
# compute_epi_mask replaced by a dependency-free histogram-threshold mask)

def get_largest_connected_region(data):
    from scipy import ndimage

    if np.sum(data) > 0:
        label, _ = ndimage.label(data == 1)
        size = np.bincount(label.ravel())
        biggest = size[1:].argmax() + 1
        return (label == biggest).astype(np.uint8)
    return data


def remove_small_regions(data, min_size):
    from scipy import ndimage

    binary = (np.asarray(data) != 0).astype(np.uint8)
    labelled, num = ndimage.label(binary)
    refined = np.asarray(data).copy()
    for lab in range(1, num + 1):
        if np.sum(refined[labelled == lab]) < min_size:
            refined[labelled == lab] = 0
    return refined


def compute_intensity_mask(vol):
    """EPI-style foreground mask: threshold at the largest gap in the
    robust intensity histogram (nilearn.compute_epi_mask analogue — finds
    the valley between background and tissue modes between the 10th and
    90th percentile of nonzero intensities)."""
    v = np.asarray(vol, np.float64)
    lo, hi = np.percentile(v, [10, 90])
    if hi <= lo:
        return (v > lo).astype(np.uint8)
    hist, edges = np.histogram(v, bins=64, range=(lo, hi))
    # Valley: minimum of the smoothed histogram interior.
    kernel = np.ones(5) / 5.0
    smooth = np.convolve(hist, kernel, mode="same")
    valley = int(np.argmin(smooth[4:-4])) + 4
    thr = edges[valley]
    return (v > thr).astype(np.uint8)


def build_mask_volume(vol, dataset):
    """Per-dataset mask recipe on a [D, H, W] volume (ref :421-506; note
    the reference operates [H, W, D] — recipes are per-slice either way)."""
    from scipy import ndimage

    if dataset == "spleen":
        m = (np.asarray(vol) >= 30).astype(np.uint8)
        m = get_largest_connected_region(m)
        m = ndimage.binary_fill_holes(m).astype(np.uint8)
        before = m.copy()
        m = ndimage.binary_closing(m, structure=np.ones((3, 3, 3))).astype(np.uint8)
        m = ((m + before) > 0).astype(np.uint8)
        return ndimage.median_filter(m, size=3)
    if dataset == "heart":
        m = (np.asarray(vol) >= 5).astype(np.uint8)
        for j in range(m.shape[0]):
            m[j] = ndimage.binary_closing(m[j], structure=np.ones((5, 5))).astype(np.uint8)
            m[j] = get_largest_connected_region(m[j])
            m[j] = ndimage.binary_fill_holes(m[j]).astype(np.uint8)
            m[j] = ndimage.median_filter(m[j], size=11)
        return m
    if dataset == "kits19":
        m = (np.asarray(vol) >= 5).astype(np.uint8)
        for j in range(m.shape[0]):
            m[j] = ndimage.binary_fill_holes(m[j]).astype(np.uint8)
            m[j] = ndimage.median_filter(m[j], size=9)
        return remove_small_regions(m, min_size=125)
    # Pelvis_2.1 and default: intensity mask + per-slice hole filling.
    m = compute_intensity_mask(vol)
    for j in range(m.shape[0]):
        m[j] = ndimage.binary_fill_holes(m[j]).astype(np.uint8)
    return m


def mask_reference_modality(dataset):
    """Which modality volume drives the mask (ref :377-389)."""
    return {"brats20": "t2", "spleen": "img", "heart": "img",
            "kits19": "imaging", "Pelvis_2.1": "MR_nonrigid_CT"}.get(
                dataset, None)


def find_mask_folder(source, dest, dataset):
    """Build <dest>/<patient>/mask.{nii.gz,npy} from the reference
    modality of each patient."""
    ref = mask_reference_modality(dataset)
    done = []
    for folder in sorted(glob.glob(os.path.join(source, "*"))):
        if not os.path.isdir(folder):
            continue
        patient = util_path.get_filename_without_extension(folder)
        files = sorted(glob.glob(os.path.join(folder, "*")))
        if ref is not None:
            files = [f for f in files
                     if util_path.get_filename_without_extension(f)
                     .replace(".nii", "") == ref] or files
        if not files:
            continue
        vol = load_volume(files[0])
        mask = build_mask_volume(vol, dataset)
        outdir = util_path.create_dir(os.path.join(dest, patient))
        save_volume(os.path.join(outdir, "mask"), mask.astype(np.uint8))
        done.append(patient)
    print(f"masked {len(done)} patients -> {dest}")
    return done


# ----------------------------------------------------------------------------
# Recipe (parity: prepare_Pelvis_2_1 dataset_tool.py:1119)

def prepare_pelvis_2_1(data_dir, interim_dir, dest_zip, dataset="Pelvis_2.1",
                       image_shape=(256, 256), modes_args=None, pop_range=10,
                       apply_mask=False, splits=(0.7, 0.2, 0.1), seed=42,
                       from_dicom=False, modes=("MR_nonrigid_CT", "MR_MR_T2")):
    """Full preprocessing chain: [DICOM ->] resize -> normalize -> mask ->
    snap_pickle -> splits -> zip. `data_dir` holds per-patient volume
    folders (or DICOM series when from_dicom)."""
    if not [f for f in glob.glob(os.path.join(data_dir, "*"))
            if os.path.isdir(f)]:
        raise DatasetToolError(
            f"no patient folders found under {data_dir!r}")
    stage = data_dir
    if from_dicom:
        nifti_dir = os.path.join(interim_dir, "nifti_volumes")
        convert_dicom_2_nifti(stage, nifti_dir, list(modes))
        stage = nifti_dir

    resized = os.path.join(interim_dir, "nifti_resized")
    resize_nifti_folder(stage, resized, image_shape)

    normalized = os.path.join(interim_dir, "nifti_normalized")
    for folder in sorted(glob.glob(os.path.join(resized, "*"))):
        patient = util_path.get_filename_without_extension(folder)
        outdir = util_path.create_dir(os.path.join(normalized, patient))
        for file_mode in sorted(glob.glob(os.path.join(folder, "*"))):
            mode = util_path.get_filename_without_extension(file_mode).replace(".nii", "")
            vol = normalize_per_dataset(load_volume(file_mode), dataset,
                                        (modes_args or {}).get(mode, {}))
            save_volume(os.path.join(outdir, mode), vol)

    mask_dir = None
    if apply_mask:
        mask_dir = os.path.join(interim_dir, "nifti_mask")
        find_mask_folder(normalized, mask_dir, dataset)

    pickle_dir = os.path.join(interim_dir, "pickles")
    temp = snap_pickle(normalized, pickle_dir, source_mask=mask_dir,
                       pop_range=pop_range, apply_mask=apply_mask,
                       is_overwrite=True)
    patients = [p for p in sorted(os.listdir(temp))
                if os.path.isdir(os.path.join(temp, p))]
    split_map = make_splits(patients, *splits, seed=seed)
    snap_zip(temp, dest_zip, split_map)
    return dest_zip, split_map


# ----------------------------------------------------------------------------
# TIFF slice pipeline (parity: process_tiff dataset_tool.py:874-982; the
# reference's ImgDatasetPreparation lives in an external
# `src.models.stylegan3.genlib.utils.util_medical_data` module that is NOT
# part of the reference repo — the per-slice transform below re-specifies
# the behavior its call signature implies: box -> clip -> scale -> resize).

def load_slice_2d(path):
    """[H, W] float64 from a single-slice .tif/.tiff/.png (PIL) or .npy."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float64)
    from PIL import Image

    return np.asarray(Image.open(path), dtype=np.float64)


def _find_slice_file(data_dir, rel):
    """Resolve `<patient>/<slice>` (extension optional) to a real file."""
    base = os.path.join(data_dir, rel)
    if os.path.exists(base):
        return base
    for ext in (".tif", ".tiff", ".png", ".npy"):
        if os.path.exists(base + ext):
            return base + ext
    raise FileNotFoundError(f"no slice file for {rel!r} under {data_dir!r}")


def load_patient_boxes(data_dir_box):
    """{patient: [y0, x0, y1, x1]} from `<data_dir_box>/boxes.json` or
    per-patient `<patient>.json` files. Returns {} when unset/absent."""
    if not data_dir_box:
        return {}
    global_file = os.path.join(data_dir_box, "boxes.json")
    if os.path.exists(global_file):
        with open(global_file) as f:
            return {k: [int(v) for v in box] for k, box in json.load(f).items()}
    boxes = {}
    for f in glob.glob(os.path.join(data_dir_box, "*.json")):
        patient = util_path.get_filename_without_extension(f)
        with open(f) as fh:
            boxes[patient] = [int(v) for v in json.load(fh)]
    return boxes


def apply_box_to_slice(img, box, box_value="min"):
    """Zero out (to `box_value`: 'min' or a number) everything outside the
    patient's lung bounding box [y0, x0, y1, x1]."""
    if box is None:
        return img
    fill = float(img.min()) if box_value == "min" else float(box_value)
    y0, x0, y1, x1 = box
    out = np.full_like(img, fill)
    out[y0:y1, x0:x1] = img[y0:y1, x0:x1]
    return out


def transform_tiff_slice(img, resolution, box=None, box_value="min",
                         clip=None, scale=None, convert_to_uint8=False,
                         scale_by_255=True):
    """Per-slice claro CT transform: box mask -> HU clip -> scale to [0, 1]
    -> resize to `resolution`² -> optional x255 / uint8 cast."""
    img = apply_box_to_slice(np.asarray(img, np.float64), box, box_value)
    if clip:
        img = np.clip(img, clip["min"], clip["max"])
    if scale:
        lo, hi = float(scale["min"]), float(scale["max"])
        img = (img - lo) / max(hi - lo, 1e-12)
    if img.shape != (resolution, resolution):
        from PIL import Image

        img = np.asarray(
            Image.fromarray(img.astype(np.float32)).resize(
                (resolution, resolution), Image.BILINEAR),
            dtype=np.float64)
    if scale_by_255:
        img = img * 255.0
    if convert_to_uint8:
        img = np.rint(np.clip(img, 0, 255)).astype(np.uint8)
    return img


def read_fold_slices(source_interim):
    """Slice relpaths from `<source_interim>/bootstrap/folds/all.txt`
    (space-separated table with an `img` column, as the reference's
    pd.read_csv(..., sep=" ") at dataset_tool.py:903)."""
    path = os.path.join(source_interim, "bootstrap", "folds", "all.txt")
    with open(path) as f:
        header = f.readline().split()
        img_col = header.index("img")
        return [line.split()[img_col] for line in f if line.strip()]


def process_tiff(source, source_interim, source_box, dest, dataset,
                 resolution, box_value, clip, scale, convert_to_uint8,
                 scale_by_255, mode=None, is_overwrite=True,
                 is_sanity_check=True, sanity_check_prob=0.05):
    """claro tiff slices -> `<dest>/temp/<patient>/<patient>_<NNNNN>.pickle`
    single-modality dicts (parity: dataset_tool.py:874-982)."""
    if mode is None:
        mode = ["CT"]
    assert len(mode) == 1

    temp = os.path.join(dest, "temp")
    if os.path.isdir(temp) and is_overwrite:
        print(f"Removing {temp}")
        shutil.rmtree(temp)
    util_path.create_dir(temp)

    rels = read_fold_slices(source_interim)
    patients = sorted({r.replace("\\", "/").split("/")[0] for r in rels})
    print(f"Number of images: {len(rels)}")
    print(f"Number of patients: {len(patients)}")
    boxes = load_patient_boxes(source_box)

    dataset_attrs = None
    n_written = 0
    next_slice_id = {}  # per-patient fallback counter for unnumbered stems
    for rel in rels:
        rel = rel.replace("\\", "/")
        id_patient = rel.split("/")[0]
        stem = util_path.get_filename_without_extension(rel)
        # Trailing integer in the stem is the slice id (ref formats
        # `<id_patient>_<int(id_slice):05d>`). Stems without one get a
        # per-patient running index — a constant 0 made every such slice
        # of a patient overwrite the same pickle.
        if stem.split("_")[-1].isdigit():
            id_slice = int(stem.split("_")[-1])
        else:
            id_slice = next_slice_id.get(id_patient, 0)
        next_slice_id[id_patient] = max(next_slice_id.get(id_patient, 0),
                                        id_slice + 1)

        out_path = os.path.join(temp, id_patient,
                                f"{id_patient}_{id_slice:05d}.pickle")
        util_path.create_dir(os.path.dirname(out_path))
        # Resume check BEFORE the load+transform so a rerun over a
        # mostly-complete dataset skips the expensive work, not just the
        # final write.
        if not is_overwrite and os.path.exists(out_path):
            continue

        raw = load_slice_2d(_find_slice_file(source, rel))
        img_arr = transform_tiff_slice(
            raw, resolution, box=boxes.get(id_patient), box_value=box_value,
            clip=clip, scale=scale, convert_to_uint8=convert_to_uint8,
            scale_by_255=scale_by_255)
        img = {mode[0]: img_arr}

        if is_sanity_check and random.random() < sanity_check_prob:
            _sanity_tiff(img_arr, dest, id_patient,
                         f"{id_patient}_{id_slice:05d}")

        modalities = sorted(img.keys())
        cur_attrs = dict(width=img_arr.shape[1], height=img_arr.shape[0],
                         modalities=modalities, dtype=str(img_arr.dtype))
        if dataset_attrs is None:
            dataset_attrs = cur_attrs
            w, h = cur_attrs["width"], cur_attrs["height"]
            if w != h:
                raise DatasetToolError(
                    f"Image dimensions after scale and crop are required to "
                    f"be square. Got {w}x{h}")
            if w != 2 ** int(np.floor(np.log2(w))):
                raise DatasetToolError(
                    "Image width/height after scale and crop are required "
                    "to be power-of-two")
            if not convert_to_uint8 and cur_attrs["dtype"] != "float64":
                raise DatasetToolError(
                    f"SG2 medical preprocessing requires float data, got "
                    f"{cur_attrs['dtype']}")
        elif dataset_attrs != cur_attrs:
            raise DatasetToolError(
                f"Image {out_path} attributes must be equal across the dataset")

        util_io.write_pickle(img, out_path)
        n_written += 1
    print(f"process_tiff: wrote {n_written} slices to {temp}")
    return temp


def _sanity_tiff(img_arr, dest, patient, name):
    try:
        from PIL import Image
    except ImportError:
        return
    sdir = os.path.join(dest, "sanity_check", patient)
    util_path.create_dir(sdir)
    # PIL has no float64 mode; 'F' (float32) carries the /255 sanity view.
    Image.fromarray((np.asarray(img_arr, np.float64) / 255.0).astype(
        np.float32)).save(os.path.join(sdir, f"{name}.tif"), "tiff")


# ----------------------------------------------------------------------------
# claro recipe (parity: prepare_claro dataset_tool.py:1055-1117)

def _snap_zip_step(data_dir, interim_dir, validation, opts):
    """Shared snap_zip step body (claro + Pelvis recipes): zip the temp
    pickle tree with train/val/test splits; returns the zip path."""
    temp = os.path.join(data_dir, "temp")
    temp = temp if os.path.isdir(temp) else data_dir
    patients = [p for p in sorted(os.listdir(temp))
                if os.path.isdir(os.path.join(temp, p))]
    patients = patients[:opts.max_patients]
    dest_zip = os.path.join(
        interim_dir, f"{opts.dataset}-num-{len(patients):06d}.zip")
    splits = make_splits(patients, *validation["split"], seed=opts.seed)
    snap_zip(temp, dest_zip, splits)
    return dest_zip


def prepare_claro(data_dir, interim_dir, reports_dir, data_dir_box, cfg, opts):
    """Dispatch one claro processing step from a parsed config dict."""
    data_cfg = cfg["data"]
    resolution = data_cfg["resolution"]
    modes_args = data_cfg["modes"]
    options = data_cfg["options"]
    validation = data_cfg["validation"]

    util_path.create_dir(reports_dir)
    print("Training options:")
    print(f"Data directory:      {data_dir}")
    print(f"Output directory:    {interim_dir}")
    print(f"Dataset resolution:  {resolution}")
    print(f"Processing step:     {opts.processing_step}")

    if opts.processing_step == "process_tiff":
        return process_tiff(
            source=data_dir, source_interim=interim_dir,
            source_box=data_dir_box, dest=interim_dir, dataset=opts.dataset,
            resolution=resolution, box_value=options["box_value"],
            clip=modes_args["CT"]["clip"], scale=modes_args["CT"]["scale"],
            convert_to_uint8=options["convert_to_uint8"],
            scale_by_255=options["scale_by_255"])
    if opts.processing_step == "snap_zip":
        return _snap_zip_step(data_dir, interim_dir, validation, opts)
    raise NotImplementedError(
        f"claro has no step {opts.processing_step!r} (reference supports "
        "process_tiff and snap_zip — dataset_tool.py:1101-1117)")


# ----------------------------------------------------------------------------
# Command line

REFERENCE_STEPS = ["process_dicom_2_nifti", "process_nifti_resized",
                   "process_nifti_normalized", "mask_nifti", "snap_pickle",
                   "snap_zip", "process_tiff"]


def process_normalized(source, dest, dataset, modes_config=None):
    """Normalize each modality volume to [0, 255] per dataset rules into
    `<dest>/<patient>/<mode>.npy`."""
    modes_args = {}
    if modes_config:
        with open(modes_config) as f:
            modes_args = json.load(f)
    for folder in sorted(glob.glob(os.path.join(source, "*"))):
        patient = util_path.get_filename_without_extension(folder)
        outdir = util_path.create_dir(os.path.join(dest, patient))
        for file_mode in sorted(glob.glob(os.path.join(folder, "*"))):
            mode = util_path.get_filename_without_extension(file_mode).replace(".nii", "")
            vol = normalize_per_dataset(load_volume(file_mode), dataset, modes_args.get(mode, {}))
            np.save(os.path.join(outdir, f"{mode}.npy"), vol)
            print(f"normalized {patient}/{mode}")


def snap_zip_cmd(temp_dir, dest_zip, train, val, test, seed):
    """Partition patients into splits, write them beside the zip, pack it."""
    patients = [p for p in sorted(os.listdir(temp_dir))
                if os.path.isdir(os.path.join(temp_dir, p))]
    splits = make_splits(patients, train, val, test, seed)
    with open(os.path.splitext(dest_zip)[0] + "_splits.json", "w") as f:
        json.dump(splits, f, indent=2)
    return snap_zip(temp_dir, dest_zip, splits)


def run_cmd(seed, configuration_file, data_dir, data_dir_mask, data_dir_box, interim_dir,
            reports_dir, dataset, max_patients, processing_step):
    """One processing step from a yaml configuration: 'claro' datasets
    (by substring) and Pelvis_2.1, with the JAX tool's per-step output
    folders."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError("the `run` step reads a yaml configuration and needs the `yaml` "
                          "module (PyYAML), which is not installed; run the steps' own "
                          "subcommands instead") from e

    opts = EasyDict(seed=seed, configuration_file=configuration_file, data_dir=data_dir,
                    data_dir_mask=data_dir_mask, data_dir_box=data_dir_box,
                    interim_dir=interim_dir, reports_dir=reports_dir, dataset=dataset,
                    max_patients=max_patients, processing_step=processing_step)
    with open(opts.configuration_file) as f:
        cfg = yaml.safe_load(f)

    random.seed(opts.seed)
    np.random.seed(opts.seed)

    interim_dir = os.path.join(opts.interim_dir, opts.dataset)
    reports_dir = os.path.join(opts.reports_dir, opts.dataset)
    util_path.create_dir(reports_dir)
    util_path.create_dir(interim_dir)

    if "claro" in opts.dataset:
        return prepare_claro(opts.data_dir, interim_dir, reports_dir, opts.data_dir_box,
                             cfg=cfg, opts=opts)
    if opts.dataset == "Pelvis_2.1":
        return _prepare_pelvis_step(opts.data_dir, interim_dir, reports_dir,
                                    opts.data_dir_mask, cfg=cfg, opts=opts)
    raise NotImplementedError(f"{opts.dataset:s} is not implemented")


def _prepare_pelvis_step(data_dir, interim_dir, reports_dir, data_dir_mask,
                         cfg, opts):
    """One Pelvis_2.1 processing step (parity: prepare_Pelvis_2_1
    dataset_tool.py:1119-1226 — per-step dest naming preserved)."""
    data_cfg = cfg["data"]
    resolution = data_cfg["resolution"]
    modes_args = data_cfg["modes"]
    options = data_cfg["options"]
    validation = data_cfg["validation"]
    step = opts.processing_step

    if step == "process_dicom_2_nifti":
        dest = os.path.join(interim_dir, "nifti_volumes")
        return convert_dicom_2_nifti(data_dir, dest, list(modes_args.keys()))
    if step == "process_nifti_resized":
        dest = os.path.join(interim_dir, f"nifti_volumes_{resolution}x{resolution}")
        return resize_nifti_folder(data_dir, dest, (resolution, resolution))
    if step == "process_nifti_normalized":
        dest = os.path.join(
            interim_dir, f"nifti_volumes_{resolution}x{resolution}_normalized")
        for folder in sorted(glob.glob(os.path.join(data_dir, "*"))):
            patient = util_path.get_filename_without_extension(folder)
            outdir = util_path.create_dir(os.path.join(dest, patient))
            for file_mode in sorted(glob.glob(os.path.join(folder, "*"))):
                mode = util_path.get_filename_without_extension(
                    file_mode).replace(".nii", "")
                vol = normalize_per_dataset(load_volume(file_mode),
                                            opts.dataset,
                                            modes_args.get(mode, {}))
                save_volume(os.path.join(outdir, mode), vol)
        return dest
    if step == "mask_nifti":
        dest = os.path.join(
            interim_dir, f"nifti_volumes_{resolution}x{resolution}_mask")
        return find_mask_folder(data_dir, dest, opts.dataset)
    if step == "snap_pickle":
        return snap_pickle(data_dir, interim_dir, source_mask=data_dir_mask,
                           pop_range=options.get("pop_range", 10),
                           apply_mask=options.get("apply_mask", False),
                           is_overwrite=True)
    if step == "snap_zip":
        return _snap_zip_step(data_dir, interim_dir, validation, opts)
    raise NotImplementedError(
        f"Pelvis_2.1 has no step {step!r} (process_tiff is claro-only — "
        "ref dataset_tool.py:1101)")



def _parser():
    p = argparse.ArgumentParser(prog="python -m latentaugment_tpu_torch.data.dataset_tool",
                                description="LatentAugment offline dataset tool.")
    sub = p.add_subparsers(dest="command", required=True)

    def cmd(name, fn, help):
        s = sub.add_parser(name, help=help, description=help)
        s.set_defaults(fn=fn)
        return s

    s = cmd("process-dicom-2-nifti",
            lambda a: convert_dicom_2_nifti(a.source, a.dest, a.modes.split(",")),
            "Merge DICOM series into per-modality volumes (needs pydicom).")
    s.add_argument("--source", required=True, help="dir of <patient>/<modality>/*.dcm")
    s.add_argument("--dest", required=True)
    s.add_argument("--modes", default="MR_nonrigid_CT,MR_MR_T2")

    s = cmd("process-nifti-resized",
            lambda a: resize_nifti_folder(a.source, a.dest, (a.height, a.width), a.interpolation),
            "In-plane resize of every patient volume.")
    s.add_argument("--source", required=True)
    s.add_argument("--dest", required=True)
    s.add_argument("--width", type=int, default=256)
    s.add_argument("--height", type=int, default=256)
    s.add_argument("--interpolation", default="linear")

    s = cmd("mask-nifti", lambda a: find_mask_folder(a.source, a.dest, a.dataset),
            "Build per-patient foreground masks from the reference modality.")
    s.add_argument("--source", required=True)
    s.add_argument("--dest", required=True)
    s.add_argument("--dataset", default="Pelvis_2.1")

    s = cmd("process-normalized",
            lambda a: process_normalized(a.source, a.dest, a.dataset, a.modes_config),
            "Normalize each modality volume to [0, 255] per dataset rules.")
    s.add_argument("--source", required=True, help="dir of <patient>/<modality> volumes")
    s.add_argument("--dest", required=True)
    s.add_argument("--dataset", default="Pelvis_2.1")
    s.add_argument("--modes_config", default=None,
                   help="json file: {modality: {upper_percentile, lower_percentile, range}}")

    s = cmd("snap-pickle",
            lambda a: snap_pickle(a.source, a.dest, source_mask=a.source_mask,
                                  pop_range=a.pop_range, apply_mask=a.apply_mask,
                                  is_overwrite=a.overwrite),
            "Slice volumes into per-slice pickle dicts.")
    s.add_argument("--source", required=True)
    s.add_argument("--dest", required=True)
    s.add_argument("--source_mask", default=None)
    s.add_argument("--pop_range", type=int, default=10)
    s.add_argument("--apply_mask", action="store_true")
    s.add_argument("--overwrite", action="store_true")

    s = cmd("snap-zip",
            lambda a: snap_zip_cmd(a.temp_dir, a.dest_zip, a.train, a.val, a.test, a.seed),
            "Partition patients into splits and pack the zip.")
    s.add_argument("--temp_dir", required=True)
    s.add_argument("--dest_zip", required=True)
    s.add_argument("--train", type=float, default=0.7)
    s.add_argument("--val", type=float, default=0.2)
    s.add_argument("--test", type=float, default=0.1)
    s.add_argument("--seed", type=int, default=42)

    s = cmd("prepare-pelvis",
            lambda a: prepare_pelvis_2_1(a.data_dir, a.interim_dir, a.dest_zip,
                                         dataset=a.dataset,
                                         image_shape=(a.resolution, a.resolution),
                                         pop_range=a.pop_range, apply_mask=a.apply_mask,
                                         from_dicom=a.from_dicom, seed=a.seed),
            "Full Pelvis_2.1 recipe: [DICOM ->] resize -> normalize -> mask -> "
            "slice pickles -> split -> zip.")
    s.add_argument("--data_dir", required=True, help="per-patient volume folders")
    s.add_argument("--interim_dir", required=True)
    s.add_argument("--dest_zip", required=True)
    s.add_argument("--dataset", default="Pelvis_2.1")
    s.add_argument("--resolution", type=int, default=256)
    s.add_argument("--pop_range", type=int, default=10)
    s.add_argument("--apply_mask", action="store_true")
    s.add_argument("--from_dicom", action="store_true")
    s.add_argument("--seed", type=int, default=42)

    s = cmd("process_tiff",
            lambda a: process_tiff(source=a.source, source_interim=a.source_interim,
                                   source_box=a.source_box, dest=a.dest, dataset=a.dataset,
                                   resolution=a.resolution, box_value=a.box_value,
                                   clip={"min": a.clip_min, "max": a.clip_max},
                                   scale={"min": a.clip_min, "max": a.clip_max},
                                   convert_to_uint8=a.convert_to_uint8,
                                   scale_by_255=not a.no_scale_by_255),
            "claro tiff slices -> per-slice pickle dicts.")
    s.add_argument("--source", required=True, help="dir of <patient>/<slice>.tif")
    s.add_argument("--source_interim", required=True, help="dir holding bootstrap/folds/all.txt")
    s.add_argument("--source_box", default=None,
                   help="dir of boxes.json / <patient>.json bounding boxes")
    s.add_argument("--dest", required=True)
    s.add_argument("--dataset", default="claro")
    s.add_argument("--resolution", type=int, default=512)
    s.add_argument("--box_value", default="min")
    s.add_argument("--clip_min", type=float, default=-1000.0)
    s.add_argument("--clip_max", type=float, default=1000.0)
    s.add_argument("--convert_to_uint8", action="store_true")
    s.add_argument("--no_scale_by_255", action="store_true")

    s = cmd("run",
            lambda a: run_cmd(a.seed, a.configuration_file, a.data_dir, a.data_dir_mask,
                              a.data_dir_box, a.interim_dir, a.reports_dir, a.dataset,
                              a.max_patients, a.processing_step),
            "One processing step from a yaml configuration (data.resolution / modes / "
            "options / validation).")
    s.add_argument("--seed", type=int, default=42)
    s.add_argument("--configuration_file", required=True, metavar="PATH")
    s.add_argument("--data_dir", required=True, metavar="PATH")
    s.add_argument("--data_dir_mask", default=None, metavar="PATH")
    s.add_argument("--data_dir_box", default=None, metavar="PATH")
    s.add_argument("--interim_dir", required=True, metavar="PATH")
    s.add_argument("--reports_dir", required=True, metavar="PATH")
    s.add_argument("--dataset", required=True, default="Pelvis_2.1")
    s.add_argument("--max_patients", type=int, default=100000)
    s.add_argument("--processing_step", required=True, choices=REFERENCE_STEPS)
    return p


def main(argv=None):
    """Run one subcommand; a dataset that breaks the contract exits 1
    with its message."""
    args = _parser().parse_args(argv)
    try:
        args.fn(args)
    except DatasetToolError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
