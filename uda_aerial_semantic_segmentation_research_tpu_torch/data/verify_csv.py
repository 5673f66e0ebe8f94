"""Read and sanity-check the class_dict_seg.csv schema.

Counterpart of the JAX package's ``data/verify_csv.py``, with the ``csv``
module in place of pandas: ``read_csv`` types each column as
``pandas.read_csv(..., skipinitialspace=True)`` would (all ints, else all
floats, else strings); ``verify_csv`` prints the columns, their types and
the first rows, and returns the columns and the rows.

    python -m uda_aerial_semantic_segmentation_research_tpu_torch.data.verify_csv [CSV]
"""

from __future__ import annotations

import csv
import os
import sys
from typing import List, Optional, Tuple

from uda_aerial_semantic_segmentation_research_tpu_torch.config import Config


def _column(values: List[str]):
    """A CSV column typed as pandas would read it: all ints, all floats, or strings."""
    for kind in (int, float):
        try:
            return [kind(v) for v in values]
        except ValueError:
            continue
    return values


def read_csv(csv_path: str) -> Tuple[List[str], List[list]]:
    """(columns, rows) of a CSV file with a header line; blank lines are
    skipped, spaces after a delimiter dropped, each column typed alike.
    Raises OSError, csv.Error or IndexError (no header) as ``open`` and the
    reader do."""
    with open(csv_path, newline="") as f:
        lines = [r for r in csv.reader(f, skipinitialspace=True) if r]
    header, body = lines[0], lines[1:]
    columns = [_column([r[j] for r in body]) for j in range(len(header))]
    return header, [list(row) for row in zip(*columns)] if body else []


def verify_csv(csv_path: Optional[str] = None) -> Tuple[List[str], List[list]]:
    """Print the columns, their types and the first five rows of the class
    dictionary CSV (``<DATA_DIR>/class_dict_seg.csv`` by default); returns
    ``(columns, rows)``."""
    csv_path = csv_path or os.path.join(Config.DATA_DIR, "class_dict_seg.csv")
    columns, rows = read_csv(csv_path)
    types = [type(rows[0][j]).__name__ if rows else "object" for j in range(len(columns))]
    print(f"Columns: {columns}")
    print("Dtypes:\n" + "\n".join(f"{c}    {t}" for c, t in zip(columns, types)))
    print("Head:\n" + "\n".join(", ".join(str(v) for v in r) for r in rows[:5]))
    return columns, rows


if __name__ == "__main__":
    verify_csv(sys.argv[1] if len(sys.argv) > 1 else None)
