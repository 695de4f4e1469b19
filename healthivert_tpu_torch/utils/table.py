"""A small table in place of pandas for the offline evaluation: rows are a
list of dicts, the first row's keys giving the column order.

`write_rows` writes CSV as ``DataFrame.to_csv(index=False)`` does (floats
through `repr`, NaN as an empty field, ints as ints, minimal quoting),
`read_rows` reads it back with a column's type inferred as pandas'
`read_csv` infers it (int, else float, else str), and `merge_on` is the
inner join of ``DataFrame.merge(on=key, suffixes=...)``. A ``.xlsx`` path
stands for the ``.csv`` beside it, as in healthivert_tpu/evaluation/
rhlv.py:150-174 on a machine without openpyxl; the port never writes or
reads Excel files.
"""

from __future__ import annotations

import csv
import math
import os
import re
from typing import Dict, List, Sequence, Tuple

_INT = re.compile(r"[+-]?\d+\Z")


def csv_path(path: str) -> str:
    """The CSV file that stands for `path` (``x.xlsx`` -> ``x.csv``)."""
    return path[:-5] + ".csv" if path.endswith(".xlsx") else path


def columns(rows: Sequence[dict]) -> List[str]:
    """Column order: the first row's keys, then keys first seen later."""
    cols: Dict[str, None] = {}
    for r in rows:
        cols.update(dict.fromkeys(r))
    return list(cols)


def _field(v) -> str:
    if v is None:
        return ""
    if isinstance(v, bool):
        return str(v)
    if isinstance(v, float) or type(v).__name__ in ("float64", "float32"):
        v = float(v)
        return "" if math.isnan(v) else repr(v)
    return str(v)


def write_rows(rows: Sequence[dict], path: str) -> str:
    """Write `rows` as CSV; returns the path written."""
    path = csv_path(path)
    cols = columns(rows)
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(cols)
        for r in rows:
            w.writerow([_field(r.get(c)) for c in cols])
    return path


def _parse_column(values: List[str]) -> list:
    present = [v for v in values if v != ""]
    if present and len(present) == len(values) and all(_INT.match(v) for v in values):
        return [int(v) for v in values]
    try:
        return [float(v) if v != "" else math.nan for v in values]
    except ValueError:
        return values


def read_rows(path: str) -> List[dict]:
    """Rows of a CSV table; a ``.xlsx`` path reads the ``.csv`` beside it."""
    if path.endswith(".xlsx"):
        alt = csv_path(path)
        if not os.path.exists(alt):
            raise FileNotFoundError(f"{path}: Excel files are not read; no {alt} beside it")
        path = alt
    with open(path, newline="") as f:
        lines = list(csv.reader(f))
    if not lines:
        return []
    head, body = lines[0], lines[1:]
    cols = [_parse_column([r[i] for r in body]) for i in range(len(head))]
    return [dict(zip(head, vals)) for vals in zip(*cols)] if body else []


def merge_on(left: Sequence[dict], right: Sequence[dict], key: str, cols: Sequence[str],
             suffixes: Tuple[str, str] = ("_x", "_y")) -> List[dict]:
    """Inner join of `left` with the `cols` of `right` on `key`, in the left
    table's row order (each left row once per matching right row, in the
    right table's order). A column on both sides other than `key` takes the
    suffixes, as pandas names it."""
    right_cols = [c for c in cols if c != key]
    lcols = columns(left)
    clash = set(lcols) & set(right_cols)
    by_key: Dict[object, List[dict]] = {}
    for r in right:
        by_key.setdefault(r[key], []).append(r)
    out = []
    for row in left:
        for match in by_key.get(row[key], ()):
            merged = {(c + suffixes[0] if c in clash else c): row[c] for c in lcols}
            merged.update({(c + suffixes[1] if c in clash else c): match[c] for c in right_cols})
            out.append(merged)
    return out
