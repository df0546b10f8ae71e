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
  "round_trip"``; its default parser can land one ulp away), or, for the
  ETL, as that default parser reads them (``float_precision="high"``);
- ``append_errors_csv``: ``reported_errors_{exp}.csv`` (and the baselines'
  ``Previous_set_up_Final_errors_{exp}.csv``) as pandas writes it (an index
  column, then ``MSE`` and ``MAE``), appended to: the rows already there
  are read back and written again as pandas does, numbers reformatted;
- ``write_csv``: ``DataFrame.to_csv`` (an index column first, its header
  empty when unnamed; floats as ``repr``, NaN empty; a datetime column
  date-only when every stamp is midnight);
- the dates of the ETL (``data/download.py``), as numpy ``datetime64[s]``:
  ``to_datetime``, ``date_range``, ``dayofweek``/``hour``/``day``/
  ``month``, ``since`` (``(date - earliest).days`` and ``.seconds``),
  ``sort_index_order`` (``sort_index``: no reorder when already
  ascending, else numpy's quicksort, ties in its order) and ``resample``
  (``resample(freq).mean()``, pandas' compensated sums, and ``.last()``).
"""

from __future__ import annotations

import csv
import gzip
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

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


# the powers of ten of pandas' default converter, each correctly rounded
_POW10 = [float(f"1e{i}") for i in range(309)]


def _pandas_float(text: str) -> float:
    """``text`` as pandas' default C converter reads it (``read_csv``'s
    ``float_precision="high"``, ``precise_xstrtod``): at most 17 digits,
    leading zeros among them, summed as ``number * 10 + digit`` in double,
    then scaled by one power of ten.  It can land an ulp away from the
    correctly rounded value where a number has 16 or more digits; with
    fewer (and a small exponent) every step is exact but the last, and it
    equals ``float(text)``."""
    p = text.strip()
    if len(p) <= 16 and "e" not in p and "E" not in p:
        return float(p)
    i, n = 0, len(p)
    negative = p[:1] == "-"
    if p[:1] in "+-":
        i = 1
    number, exponent, digits, decimals = 0.0, 0, 0, 0
    while i < n and "0" <= p[i] <= "9":
        if digits < 17:
            number = number * 10.0 + (ord(p[i]) - 48)
            digits += 1
        else:
            exponent += 1
        i += 1
    if i < n and p[i] == ".":
        i += 1
        while digits < 17 and i < n and "0" <= p[i] <= "9":
            number = number * 10.0 + (ord(p[i]) - 48)
            i += 1
            digits += 1
            decimals += 1
        while i < n and "0" <= p[i] <= "9":
            i += 1
        exponent -= decimals
    if digits == 0:
        return float(p)  # inf, nan, or not a number (ValueError)
    if negative:
        number = -number
    if i < n and p[i] in "eE":
        i += 1
        sign = -1 if p[i:i + 1] == "-" else 1
        if p[i:i + 1] in "+-":
            i += 1
        start, e = i, 0
        while i < n and "0" <= p[i] <= "9":
            e = e * 10 + ord(p[i]) - 48
            i += 1
        if i == start:
            raise ValueError(f"could not convert string to float: {text!r}")
        exponent += sign * e
    if i != n:
        raise ValueError(f"could not convert string to float: {text!r}")
    if exponent > 308:
        return float("inf") if number > 0 else float("-inf")
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        if exponent < -616:
            return 0.0
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _parse_column(values: List[str], decimal: str = ".",
                  float_precision: str = "round_trip"):
    numbers = ([v.replace(decimal, ".") for v in values] if decimal != "."
               else values)
    present = [v for v in numbers if v not in NA_VALUES]
    if len(present) == len(numbers):
        try:
            return np.array([int(v) for v in numbers], dtype=np.int64)
        except (ValueError, OverflowError):
            pass
    parse = _pandas_float if float_precision == "high" else float
    try:
        return np.array([parse(v) if v not in NA_VALUES else np.nan
                         for v in numbers], dtype=np.float64)
    except ValueError:
        return np.array(values, dtype=str)


def read_csv(path: str, str_columns: Iterable[str] = (), *, sep: str = ",",
             decimal: str = ".", header: bool = True,
             encoding: Optional[str] = None,
             float_precision: str = "round_trip") -> Frame:
    """A CSV file (gzip-compressed where its name ends in ``.gz``) as a
    frame.  Columns whose every value is an integer are int64, those that
    are numbers or missing float64 (NaN where missing), the rest text;
    ``str_columns`` stay text.  ``decimal`` is the numbers' decimal mark;
    without a ``header`` row the columns are named "0", "1", ...
    (``pandas.read_csv(..., header=None)`` numbers them).  Numbers are
    read correctly rounded, or with ``float_precision="high"`` as pandas'
    default converter reads them (``_pandas_float``)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", newline="", encoding=encoding) as f:
        rows = [r for r in csv.reader(f, delimiter=sep) if r]
    names = rows.pop(0) if header else [str(j) for j in range(len(rows[0]))]
    keep_str = set(str_columns)
    out = {}
    for j, name in enumerate(names):
        values = [r[j] if j < len(r) else "" for r in rows]
        out[name] = (np.array(values, dtype=str) if name in keep_str
                     else _parse_column(values, decimal, float_precision))
    return out


def _is_missing(v) -> bool:
    return v is None or (isinstance(v, float) and v != v)


def missing(col: np.ndarray) -> np.ndarray:
    """Where ``col`` is missing: NaN, NaT, or None (or NaN) in an object
    column; int, bool and text columns miss nothing."""
    kind = col.dtype.kind
    if kind == "f":
        return np.isnan(col)
    if kind == "M":
        return np.isnat(col)
    if kind == "O":
        return np.array([_is_missing(v) for v in col.tolist()], bool)
    return np.zeros(len(col), bool)


def _format_stamps(col: np.ndarray) -> List[str]:
    """datetime64 values as pandas writes them: ``YYYY-MM-DD`` when every
    stamp is midnight, else ``YYYY-MM-DD HH:MM:SS``; NaT empty."""
    secs = col.astype("datetime64[s]")
    ok = ~np.isnat(secs)
    midnight = bool(np.all(secs[ok] == secs[ok].astype("datetime64[D]")))
    unit = "D" if midnight else "s"
    text = np.datetime_as_string(secs.astype(f"datetime64[{unit}]"))
    return [t.replace("T", " ") if good else ""
            for t, good in zip(text.tolist(), ok.tolist())]


def format_column(col: np.ndarray) -> List[str]:
    """One column's cells as ``DataFrame.to_csv`` writes them: floats as
    ``repr``, NaN and None empty, ints as ints, bools as True/False,
    datetimes by ``_format_stamps``, text as it is."""
    kind = col.dtype.kind
    if kind == "f":
        return ["" if v != v else repr(v) for v in col.tolist()]
    if kind == "M":
        return _format_stamps(col)
    if kind == "O":
        return ["" if _is_missing(v) else repr(v) if isinstance(v, float)
                else str(v) for v in col.tolist()]
    return [str(v) for v in col.tolist()]


def write_csv(path: str, frame: Frame, index: Optional[np.ndarray] = None,
              index_label: str = "") -> None:
    """``DataFrame.to_csv(path)``: with ``index`` (an array, one value a
    row) its column first under ``index_label`` (empty: an unnamed index),
    without it ``to_csv(path, index=False)``."""
    names, cols = list(frame), [format_column(c) for c in frame.values()]
    if index is not None:
        names, cols = [index_label] + names, [format_column(index)] + cols
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(names)
        writer.writerows(zip(*cols))


# -- dates, as datetime64[s] ------------------------------------------------

_DAYFIRST = re.compile(r"^\s*(\d{1,2})[./-](\d{1,2})[./-](\d{4})"
                       r"(?:[ T](\d{1,2}):(\d{2})(?::(\d{2}))?)?\s*$")


def to_datetime(values, fmt: Optional[str] = None,
                dayfirst: bool = False) -> np.ndarray:
    """Text stamps as datetime64[s] (``pandas.to_datetime``): ISO dates and
    date-times (``YYYY-MM-DD[ HH:MM[:SS]]``), or day first
    (``DD.MM.YYYY HH:MM:SS``, ``fmt="%d.%m.%Y %H:%M:%S"`` or
    ``dayfirst=True``).  Raises ValueError on a stamp it cannot read."""
    values = [str(v) for v in np.asarray(values).tolist()]
    if fmt == "%d.%m.%Y %H:%M:%S" or dayfirst:
        iso = []
        for v in values:
            m = _DAYFIRST.match(v)
            if m is None:
                raise ValueError(f"time data {v!r} does not match day-first "
                                 "format")
            d, mo, y, hh, mm, ss = m.groups()
            iso.append(f"{y}-{int(mo):02d}-{int(d):02d}T{int(hh or 0):02d}:"
                       f"{int(mm or 0):02d}:{int(ss or 0):02d}")
        values = iso
    elif fmt is not None:
        raise ValueError(f"unsupported date format {fmt!r}")
    return np.array([v.strip().replace(" ", "T", 1) for v in values],
                    dtype="datetime64[s]")


def date_range(start: str, periods: int, freq_seconds: int = 86400
               ) -> np.ndarray:
    """``pandas.date_range(start, periods=periods)`` at a step of
    ``freq_seconds`` (a day by default)."""
    first = np.datetime64(start, "s")
    return first + np.arange(periods, dtype=np.int64) * np.timedelta64(
        freq_seconds, "s")


def _secs(stamps: np.ndarray) -> np.ndarray:
    return stamps.astype("datetime64[s]").astype(np.int64)


def dayofweek(stamps: np.ndarray) -> np.ndarray:
    """Monday 0 .. Sunday 6 (``DatetimeIndex.dayofweek``)."""
    return (_secs(stamps) // 86400 + 3) % 7  # 1970-01-01 was a Thursday


def hour(stamps: np.ndarray) -> np.ndarray:
    return _secs(stamps) % 86400 // 3600


def month(stamps: np.ndarray) -> np.ndarray:
    return stamps.astype("datetime64[M]").astype(np.int64) % 12 + 1


def day(stamps: np.ndarray) -> np.ndarray:
    days = stamps.astype("datetime64[D]")
    return (days - days.astype("datetime64[M]").astype("datetime64[D]")
            ).astype(np.int64) + 1


def since(stamps: np.ndarray, earliest) -> Tuple[np.ndarray, np.ndarray]:
    """``(date - earliest).days`` and ``.seconds``: whole days, floored,
    and the seconds of the day left over (0 .. 86399)."""
    delta = _secs(stamps) - _secs(np.asarray(earliest))
    return delta // 86400, delta % 86400


def sort_index_order(stamps: np.ndarray) -> Optional[np.ndarray]:
    """The row order of ``DataFrame.sort_index()`` on a datetime index:
    None where the stamps already ascend (pandas then keeps the rows as
    they are), else numpy's quicksort of the stamps, which orders equal
    stamps its own way, as pandas does."""
    if np.all(stamps[1:] >= stamps[:-1]):
        return None
    return np.argsort(stamps, kind="quicksort")


def _bins(stamps: np.ndarray, freq_seconds: int):
    """Each row's bin of ``freq_seconds`` (which divides a day) from the
    first row's midnight, the bins' count and their left edges."""
    t = _secs(stamps)
    origin = t.min() // 86400 * 86400
    b = (t - origin) // freq_seconds
    first = b.min()
    n = int(b.max() - first + 1)
    edges = (origin + (first + np.arange(n)) * freq_seconds).astype(
        "datetime64[s]")
    return (b - first).astype(np.int64), n, edges


def _by_position(labels: np.ndarray, n_groups: int):
    """Per rank r within its group (frame order): the rows of rank r, one a
    group at most."""
    order = np.argsort(labels, kind="stable")
    sizes = np.bincount(labels, minlength=n_groups)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    rank = np.empty(len(labels), np.int64)
    rank[order] = np.arange(len(labels)) - starts[labels[order]]
    return [np.flatnonzero(rank == r) for r in range(int(sizes.max(
        initial=0)))]


def group_mean(values: np.ndarray, labels: np.ndarray, n_groups: int
               ) -> np.ndarray:
    """Each group's mean of each column of ``values`` (n, k), NaN skipped,
    NaN where a group has none: pandas' ``groupby(...).mean()``, whose
    sums add in frame order with Kahan's compensation."""
    k = values.shape[1]
    sums = np.zeros((n_groups, k))
    comp = np.zeros((n_groups, k))
    nobs = np.zeros((n_groups, k), np.int64)
    for rows in _by_position(labels, n_groups):
        g, val = labels[rows], values[rows]
        ok = ~np.isnan(val)
        y = val - comp[g]
        t = sums[g] + y
        c = t - sums[g] - y
        c[np.isnan(c)] = 0.0  # an infinite value: keep the sum infinite
        comp[g] = np.where(ok, c, comp[g])
        sums[g] = np.where(ok, t, sums[g])
        nobs[g] += ok
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(nobs > 0, sums / np.maximum(nobs, 1), np.nan)


def resample(stamps: np.ndarray, frame: Frame, freq_seconds: int,
             how: str = "mean") -> Tuple[np.ndarray, Frame]:
    """``frame`` (rows in ascending ``stamps``) resampled to bins of
    ``freq_seconds`` from the first row's midnight, every bin from the
    first to the last: ``resample(freq).mean()`` (numeric columns, float64
    out) or ``.last()`` (each column's last value that is not missing;
    where a bin has none, NaN, and int and bool columns turn float and
    object as pandas turns them)."""
    labels, n, edges = _bins(stamps, freq_seconds)
    if how == "mean":
        names = list(frame)
        means = group_mean(matrix(frame, names, np.float64), labels, n)
        return edges, {c: means[:, j].copy() for j, c in enumerate(names)}
    if how != "last":
        raise ValueError(f"unsupported resample {how!r}")
    out = {}
    for name, col in frame.items():
        rows = np.flatnonzero(~missing(col))
        last = np.full(n, -1, np.int64)
        np.maximum.at(last, labels[rows], rows)
        have = last >= 0
        if have.all():
            out[name] = col[last]
        elif col.dtype.kind in "iuf":
            res = np.full(n, np.nan)
            res[have] = col[last[have]]
            out[name] = res
        else:
            res = np.full(n, None, dtype=object)
            res[have] = col[last[have]].astype(object)
            out[name] = res
    return edges, out


def _rewritten(values: List[str]) -> List[str]:
    """A CSV column as ``pandas.read_csv`` reads it and ``to_csv`` writes
    it again: numbers in a column of numbers reformatted (``"0.250"`` and
    ``" 0.25"`` become ``"0.25"``, a missing one ``""``), text kept."""
    col = _parse_column(values)
    if col.dtype.kind == "i":
        return [str(v) for v in col.tolist()]
    if col.dtype.kind == "f":
        return ["" if v != v else repr(v) for v in col.tolist()]
    return values


def append_errors_csv(path: str, name: str, errors: Dict[str, str]) -> None:
    """Append the row ``name`` (``errors``: column -> text) to the CSV at
    ``path``, writing the header first if the file is new: pandas'
    ``DataFrame.from_dict(..., orient="index")`` concatenated to the file
    read back with ``read_csv(path, index_col=0)`` and written again with
    ``to_csv``."""
    header, rows = [""] + list(errors), []
    if os.path.exists(path):
        with open(path, newline="") as f:
            old = list(csv.reader(f))
        if old:
            header, rows = old[0], old[1:]
            rows = [r + [""] * (len(header) - len(r)) for r in rows]
            columns = [_rewritten([r[j] for r in rows])
                       for j in range(len(header))]
            rows = [list(r) for r in zip(*columns)] if rows else []
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
