"""The annotation tables of the Mayo Clinic and VCE loaders, read and
written with the `csv` module in the layout pandas gives them (the JAX
package reads them with pandas, which the card's host may not have).

Cells that parse as integers or floats become numpy int64 / float64
scalars, as pandas' columns would hold them, so that arithmetic on them
keeps pandas' dtypes.
"""

import csv

import numpy as np


def _cell(s):
    for kind in (np.int64, np.float64):
        try:
            return kind(s)
        except ValueError:
            pass
    return s


def read_table(path, index_col=False):
    """Rows of a CSV as dicts keyed by its header. `index_col=True` drops
    the first column (the index a pandas `to_csv` writes first)."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = [row for row in reader if row]
    start = 1 if index_col else 0
    return [{k: _cell(v) for k, v in zip(header[start:], row[start:])} for row in rows]


def write_table(rows, columns, path):
    """`rows` (dicts) as a CSV with a leading integer index column, as
    pandas' `DataFrame(rows).to_csv(path)` writes it."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow([""] + list(columns))
        for i, row in enumerate(rows):
            writer.writerow([i] + [row[c] for c in columns])
