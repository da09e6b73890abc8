"""Build the Mayo Clinic annotation CSVs
(counterpart: latentaugment_tpu/data/create_csv_mayoclinic.py).

Walks `<root>/<patient>/<dose-domain>/<slice files>` (DICOM or .npy) and
writes `mayoclinic_{train,val,test}.csv` with the columns [patient,
domain, path_slice], domain LD (low dose) / HD (high dose), patients
split by a seeded shuffle: one seed gives the JAX tool's split and files.

    python -m latentaugment_tpu_torch.data.create_csv_mayoclinic \\
        --root <slices> --dest_dir <csv dir> [--seed 42]
"""

import argparse
import os
import random

from .table import write_table

COLUMNS = ("patient", "domain", "path_slice")


def collect_slices(root, domains=("LD", "HD"), exts=(".dcm", ".ima", ".npy")):
    rows = []
    for patient in sorted(os.listdir(root)):
        pdir = os.path.join(root, patient)
        if not os.path.isdir(pdir):
            continue
        for domain_dir in sorted(os.listdir(pdir)):
            domain = None
            for d in domains:
                if d.lower() in domain_dir.lower():
                    domain = d
            if domain is None:
                continue
            ddir = os.path.join(pdir, domain_dir)
            for fname in sorted(os.listdir(ddir)):
                if os.path.splitext(fname)[1].lower() in exts:
                    rows.append(dict(patient=patient, domain=domain,
                                     path_slice=os.path.join(ddir, fname)))
    return rows


def create_annotation_file(root, dest_dir, train=0.7, val=0.2, test=0.1, seed=42):
    """Write the three CSVs; returns {split: path}."""
    rows = collect_slices(root)
    patients = sorted({r["patient"] for r in rows})
    random.Random(seed).shuffle(patients)
    n_train = int(round(len(patients) * train))
    n_val = int(round(len(patients) * val))
    split_of = {p: ("train" if i < n_train else "val" if i < n_train + n_val else "test")
                for i, p in enumerate(patients)}

    os.makedirs(dest_dir, exist_ok=True)
    outs = {}
    for split in ("train", "val", "test"):
        sub = [r for r in rows if split_of[r["patient"]] == split]
        out = os.path.join(dest_dir, f"mayoclinic_{split}.csv")
        write_table(sub, COLUMNS, out)
        outs[split] = out
        print(f"{split}: {len(sub)} slices -> {out}")
    return outs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", required=True)
    parser.add_argument("--dest_dir", required=True)
    parser.add_argument("--seed", type=int, default=42)
    args = parser.parse_args(argv)
    create_annotation_file(args.root, args.dest_dir, seed=args.seed)


if __name__ == "__main__":
    main()
