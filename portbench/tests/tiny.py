"""Tiny configurations and traffic of the benchmark's cells for the CPU
tests: the cells' own files with the widths, depth, batch and steps cut
so that a run of the port's plain path and the reference takes seconds."""

import json
import os
import sys

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PB)
for p in (PB, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def load(kind, name):
    with open(os.path.join(PB, kind, name + ".json")) as f:
        return json.load(f)


def config(name, res=32, num_fp16_res=0):
    """The configuration at `res` with narrow widths; bfloat16 in the top
    `num_fp16_res` resolutions (none under 64x64), as the cells' own."""
    cfg = load("configs", name)
    base = (512 if cfg["arch"] == "stylegan3" else 256) * res // 32
    cfg.update(resolution=res, z_dim=32, w_dim=32, num_mapping_layers=2,
               channel_base=base, channel_max=16, num_fp16_res=num_fp16_res,
               workspace=dict(n_patients=2, slices_per_patient=4),
               discriminator=dict(cfg["discriminator"], channel_base=256 * res // 32,
                                  channel_max=16, num_fp16_res=num_fp16_res))
    return cfg


def traffic(name):
    tr = load("traffic", name)
    tr.update(batch=8, staged_batches=1, warmup_batches=1)
    if tr["kind"] == "walk":
        tr.update(num_epochs=2, crop_size=16, check=dict(batches=1, within=2))
    else:
        tr.update(check=dict(batches=2, within=3, block=4))
    return tr


CELLS = {"sg3t-walk-b16": ("sg3t-256", "walk-k10-b16"),
         "sg2-sample-b256": ("sg2-256", "sample-b256"),
         "sg3t-sample-b64": ("sg3t-256", "sample-b64")}

BENCH = {"end_to_end": [{"name": n, "unit": u} for n, u in (
    ("aug_samples_per_s", "samples/s"), ("gen_samples_per_s", "samples/s"),
    ("peak_mem_gib", "GiB"), ("setup_s", "s"))],
    "per_layer": []}
