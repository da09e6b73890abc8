"""Pickle, json and list-file helpers of the drivers and the analysis
tools (counterpart: latentaugment_tpu/utils/util_io.py). Host-only; the
drivers dump what the policy returns, numpy arrays in dicts."""

import datetime
import glob
import json
import os
import pickle
import uuid

from . import util_path


def read_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def write_pickle(obj, path):
    with open(path, "wb") as f:
        pickle.dump(obj, f, pickle.HIGHEST_PROTOCOL)


def write_pickle_atomic(obj, path):
    """Write through a uniquely named temporary file and os.replace, so a
    reader never sees half a file."""
    tmp = f"{path}.tmp.{uuid.uuid4().hex}"
    with open(tmp, "wb") as f:
        pickle.dump(obj, f, pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def read_json(path):
    with open(path, "r") as f:
        return json.load(f)


def write_json(obj, path, indent=2):
    with open(path, "w") as f:
        json.dump(obj, f, indent=indent)


def append_jsonl(obj, path):
    with open(path, "at") as f:
        f.write(json.dumps(obj) + "\n")


def get_string_datetime():
    """Today as 'YYYYMMDD'."""
    return datetime.datetime.now().strftime("%Y%m%d")


def write_list_to_file(my_list, path):
    """One item per line."""
    with open(path, "w+") as f:
        for item in my_list:
            f.write(f"{item}\n")


def read_file_to_list(path):
    """Lines with their newlines, as readlines() gives them."""
    with open(path, "r") as f:
        return f.readlines()


def add_to_zip(zip_obj, patient, split):
    """Add a patient directory's .pickle (else .png) files to an open
    ZipFile as `<split>/<patient>/<file>`."""
    files = glob.glob(os.path.join(patient, "*.pickle"))
    if not files:
        files = glob.glob(os.path.join(patient, "*.png"))
    for file in files:
        arcname = os.path.join(split, util_path.get_filename_without_extension(patient),
                               util_path.get_filename(file))
        zip_obj.write(file, arcname)


def write_excel(*keys, dictionary, sheet_idx, col_position=1, wb=None, ws=None,
                default="not found"):
    """Write per-fold id / label arrays to an openpyxl sheet (openpyxl is
    imported here, so only a caller of this function needs it)."""
    import numpy as np
    import openpyxl

    if wb is None:
        wb = openpyxl.Workbook()
        ws = wb.active
        ws.title = "_fold" + str(sheet_idx)
    if ws is None:
        ws = wb.create_sheet(title="_fold" + str(sheet_idx))

    ws.cell(row=1, column=col_position, value=keys[0].split("_")[1] + "_id")
    ws.cell(row=1, column=col_position + 1, value=keys[0].split("_")[1] + "_label")
    for idx in range(dictionary.get(keys[0], default).shape[0]):
        for key, column in zip(keys, np.arange(len(keys))):
            ws.cell(row=idx + 2, column=col_position + int(column),
                    value=dictionary.get(key, default)[idx, 0])
    return wb, ws
