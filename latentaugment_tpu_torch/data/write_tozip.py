"""Zip inverted-latent pickle folders into the dataset layout
(counterpart: latentaugment_tpu/data/write_tozip.py): per-patient folders
of inverted-code pickles become `<split>/<patient>/<slice>` zip members,
the image zip's member names, so the policy looks a latent up by its
image's file name.

    python -m latentaugment_tpu_torch.data.write_tozip \
        --source_dir temp-projector --dest_zip inv.zip [--splits_json splits.json]
"""

import argparse
import json
import os
import zipfile


def write_to_zip(source_dir, dest_zip, splits_map=None, default_split="train"):
    """source_dir: <patient>/<slice>.pickle folders. splits_map: patient ->
    split name (default: everything into `default_split`)."""
    n = 0
    with zipfile.ZipFile(dest_zip, "w", zipfile.ZIP_STORED) as zf:
        for patient in sorted(os.listdir(source_dir)):
            pdir = os.path.join(source_dir, patient)
            if not os.path.isdir(pdir):
                continue
            split = (splits_map or {}).get(patient, default_split)
            for fname in sorted(os.listdir(pdir)):
                if not fname.endswith(".pickle"):
                    continue
                zf.write(os.path.join(pdir, fname), f"{split}/{patient}/{fname}")
                n += 1
    print(f"write_to_zip: {n} members -> {dest_zip}")
    return dest_zip


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--source_dir", required=True)
    p.add_argument("--dest_zip", required=True)
    p.add_argument("--splits_json", default=None,
                   help="json of {split: [patients]}")
    args = p.parse_args(argv)
    splits_map = None
    if args.splits_json:
        with open(args.splits_json) as f:
            splits = json.load(f)
        splits_map = {patient: s for s, ps in splits.items() for patient in ps}
    write_to_zip(args.source_dir, args.dest_zip, splits_map)


if __name__ == "__main__":
    main()
