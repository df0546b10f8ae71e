"""A column table: the port's stand-in for the pandas frames of the JAX
package's data layer.

A frame is an ordered ``dict[str, np.ndarray]`` of equal-length 1-D columns.
Numeric columns are int64 or float64, text columns are numpy unicode arrays.
The helpers below are exactly what the copied formatters, windowing and
harness need, with pandas' semantics where the result depends on them:

- ``sort_by``: a stable sort on several keys (``DataFrame.sort_values`` with
  a list of columns);
- ``groups``: row indices per distinct key in sorted-key order, each in
  frame order (``DataFrame.groupby``);
- ``matrix``: columns stacked column-major, as ``DataFrame.values`` lays
  them out -- the scalers' float64 sums run down contiguous columns in
  pandas, and must here too to give the same bits;
- ``as_str``: ``Series.apply(str)``;
- ``read_csv``: ``pandas.read_csv`` type inference (int64, float64 with the
  usual missing-value spellings, else text), with named columns kept text;
  numbers are parsed correctly rounded (pandas' ``float_precision=
  "round_trip"``; its default parser can land one ulp away);
- ``append_errors_csv``: ``reported_errors_{exp}.csv`` as pandas writes it
  (an index column, then ``MSE`` and ``MAE``), appended to.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

Frame = Dict[str, np.ndarray]

# pandas.read_csv's default missing-value spellings
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})


def n_rows(frame: Frame) -> int:
    return len(next(iter(frame.values()))) if frame else 0


def from_columns(columns: Dict[str, object], n: int) -> Frame:
    """A frame of ``n`` rows from arrays or scalars (a scalar fills its
    column, as in ``pandas.DataFrame``)."""
    out = {}
    for name, value in columns.items():
        arr = np.asarray(value)
        if arr.ndim == 0:
            arr = np.full(n, arr.item(), dtype=arr.dtype)
        if len(arr) != n:
            raise ValueError(f"column {name!r} has {len(arr)} rows, not {n}")
        out[name] = arr
    return out


def take(frame: Frame, rows) -> Frame:
    """The rows ``rows`` (indices, a slice or a mask) of every column."""
    return {name: col[rows] for name, col in frame.items()}


def concat(frames: Sequence[Frame]) -> Frame:
    """Frames stacked by rows; all have the first frame's columns."""
    names = list(frames[0])
    return {name: np.concatenate([f[name] for f in frames]) for name in names}


def sort_by(frame: Frame, keys: Sequence[str]) -> Frame:
    """Rows sorted by ``keys`` (the first most significant), stably."""
    order = np.lexsort([frame[k] for k in reversed(keys)])
    return take(frame, order)


def groups(frame: Frame, key: str) -> List[Tuple[object, np.ndarray]]:
    """``[(key value, row indices)]`` in sorted-key order, each group's rows
    in frame order; rows whose key is NaN belong to no group."""
    col = frame[key]
    rows = np.arange(len(col))
    if col.dtype.kind == "f":
        keep = ~np.isnan(col)
        col, rows = col[keep], rows[keep]
    uniq, inverse = np.unique(col, return_inverse=True)
    order = np.argsort(inverse, kind="stable")
    bounds = np.cumsum(np.bincount(inverse, minlength=len(uniq)))[:-1]
    return [(u.item(), rows[idx])
            for u, idx in zip(uniq, np.split(order, bounds))]


def matrix(frame: Frame, columns: Sequence[str], dtype=None) -> np.ndarray:
    """Columns (repeats allowed) as an (n, k) column-major array."""
    cols = [frame[c] for c in columns]
    dtype = dtype or np.result_type(*cols)
    out = np.empty((len(cols), n_rows(frame)), dtype=dtype).T
    for j, col in enumerate(cols):
        out[:, j] = col
    return out


def as_str(col: np.ndarray) -> np.ndarray:
    """Each value through Python's ``str``, as ``Series.apply(str)``."""
    return np.array([str(v) for v in col.tolist()], dtype=str)


def factorize(col: np.ndarray) -> np.ndarray:
    """Codes in order of first appearance (``pandas.factorize``)."""
    if len(col) == 0:
        return np.zeros(0, np.int64)
    _, first, inverse = np.unique(col, return_index=True, return_inverse=True)
    rank = np.empty(len(first), np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(first))
    return rank[inverse]


def _parse_column(values: List[str]):
    present = [v for v in values if v not in NA_VALUES]
    if len(present) == len(values):
        try:
            return np.array([int(v) for v in values], dtype=np.int64)
        except (ValueError, OverflowError):
            pass
    try:
        return np.array([float(v) if v not in NA_VALUES else np.nan
                         for v in values], dtype=np.float64)
    except ValueError:
        return np.array(values, dtype=str)


def read_csv(path: str, str_columns: Iterable[str] = ()) -> Frame:
    """A CSV file with a header row as a frame.  Columns whose every value
    is an integer are int64, those that are numbers or missing float64 (NaN
    where missing), the rest text; ``str_columns`` stay text."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = [r for r in reader if r]
    keep_str = set(str_columns)
    out = {}
    for j, name in enumerate(header):
        values = [r[j] if j < len(r) else "" for r in rows]
        out[name] = (np.array(values, dtype=str) if name in keep_str
                     else _parse_column(values))
    return out


def append_errors_csv(path: str, name: str, errors: Dict[str, str]) -> None:
    """Append the row ``name`` (``errors``: column -> text) to the CSV at
    ``path``, writing the header first if the file is new: pandas'
    ``DataFrame.from_dict(..., orient="index")`` read back and written again
    with ``to_csv``."""
    header, rows = [""] + list(errors), []
    if os.path.exists(path):
        with open(path, newline="") as f:
            old = list(csv.reader(f))
        if old:
            header, rows = old[0], old[1:]
            for col in errors:
                if col not in header:
                    header.append(col)
    row = [name] + [""] * (len(header) - 1)
    for col, value in errors.items():
        row[header.index(col)] = value
    rows.append(row)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(header)
        writer.writerows(r + [""] * (len(header) - len(r)) for r in rows)
