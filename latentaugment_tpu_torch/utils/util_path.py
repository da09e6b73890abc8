"""Path helpers (counterpart: latentaugment_tpu/utils/util_path.py)."""

import ntpath
import os


def create_dir(path):
    os.makedirs(path, exist_ok=True)
    return path


def mkdirs(paths):
    for p in paths if isinstance(paths, (list, tuple)) else [paths]:
        os.makedirs(p, exist_ok=True)


def split_dos_path_into_components(path):
    """Split a path (either / or \\ separated) into its components: the
    zip archives store DOS-style paths."""
    normalized = path.replace("\\", "/")
    return [p for p in normalized.split("/") if p not in ("", ".")]


def get_filename_without_extension(path):
    base = ntpath.basename(path.replace("\\", "/"))
    return os.path.splitext(base)[0]


def get_filename(path):
    return ntpath.basename(path.replace("\\", "/"))
