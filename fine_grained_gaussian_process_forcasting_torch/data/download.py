"""Dataset acquisition / ETL to csv: the port's own copy of the JAX
package's ``data/download.py``, on column tables (``data/table.py``) and
numpy instead of pandas.

Per dataset: download (``urllib``; ``file://`` URLs serve local copies),
unpack, resample, add the calendar features, and write the CSV the
experiment's formatter reads, with the same columns, rows, row order and
number formatting as the JAX package's pandas ETL writes:

- ``sort_index`` keeps rows that already ascend and otherwise takes numpy's
  quicksort of the stamps, which orders equal stamps as pandas does;
- ``resample(freq).mean()`` sums in frame order with Kahan's compensation
  (``table.group_mean``), as pandas' group means do;
- directories are listed in ``os.listdir`` order, as in the JAX package;
- text read from a CSV is missing where pandas reads it as NaN, and
  ``fillna`` writes its fill value there.

CLI:  python -m fine_grained_gaussian_process_forcasting_torch.data.download \\
          --expt_name solar [--output_folder .] [--synthetic]
          [--from_local_csv f.csv] [--force_download yes|no]
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import subprocess
import urllib.error
import urllib.request
import zipfile
from typing import List, Optional, Sequence, Tuple

import numpy as np

from fine_grained_gaussian_process_forcasting_torch.data import table
from fine_grained_gaussian_process_forcasting_torch.data.experiment import (
    ExperimentConfig,
)

_URLS = {
    "solar": "https://www.nrel.gov/grid/assets/downloads/al-pv-2006.zip",
    "electricity": (
        "https://archive.ics.uci.edu/ml/machine-learning-databases/00321/"
        "LD2011_2014.txt.zip"
    ),
    "traffic": (
        "https://archive.ics.uci.edu/ml/machine-learning-databases/00204/"
        "PEMS-SF.zip"
    ),
    "air_quality": (
        "https://archive.ics.uci.edu/ml/machine-learning-databases/00501/"
        "PRSA2017_Data_20130301-20170228.zip"
    ),
    "ETTm2": (
        "https://github.com/zhouhaoyi/ETDataset/raw/main/ETT-small/ETTm2.csv"
    ),
    "camel": (
        "https://ral.ucar.edu/sites/default/files/public/product-tool/"
        "camels-catchment-attributes-and-meteorology-for-large-sample-"
        "studies-dataset-downloads/basin_timeseries_v1p2_metForcing_obsFlow.zip"
    ),
    # canonical public mirror of the LSTNet exchange-rate data (the
    # reference expects a manually downloaded ~/Downloads/exchange_rate.csv)
    "exchange": (
        "https://raw.githubusercontent.com/laiguokun/"
        "multivariate-time-series-data/master/exchange_rate/"
        "exchange_rate.txt.gz"
    ),
}

# the bgc-jena weather archive is split into half-year zips
_WEATHER_STEMS = [
    f"mpi_roof_{year}{half}" for year in range(2008, 2022) for half in "ab"
] + ["mpi_roof"]
_WEATHER_URL = "https://www.bgc-jena.mpg.de/wetter/{stem}.zip"

_HOUR, _DAY = 3600, 86400


def download_and_unzip(url: str, zip_path: str, unzip_dir: str) -> None:
    if not os.path.exists(zip_path):
        print(f"Pulling data from {url} to {zip_path}")
        urllib.request.urlretrieve(url, zip_path)
    os.makedirs(unzip_dir, exist_ok=True)
    with zipfile.ZipFile(zip_path) as zf:
        zf.extractall(unzip_dir)


# -- frames with an index ----------------------------------------------------


def _read(path: str, index_col: bool = False, **kw):
    """``pandas.read_csv``: ``table.read_csv`` with pandas' default number
    converter, and text that pandas reads as NaN (its missing-value
    spellings) missing (None in an object column).  With ``index_col``:
    (frame, the first column, its name)."""
    frame = table.read_csv(path, float_precision="high", **kw)
    for name, col in frame.items():
        if col.dtype.kind == "U":
            na = np.isin(col, list(table.NA_VALUES))
            if na.any():
                col = col.astype(object)
                col[na] = None
                frame[name] = col
    if not index_col:
        return frame
    name = next(iter(frame))
    return frame, frame.pop(name), name


def _concat(frames: Sequence[table.Frame]) -> table.Frame:
    """``pandas.concat(frames, axis=0)`` (``join="outer"``): the columns in
    order of first appearance, missing where a frame lacks one."""
    names: List[str] = []
    for f in frames:
        names += [c for c in f if c not in names]
    out = {}
    for name in names:
        parts = []
        for f in frames:
            if name in f:
                parts.append(f[name])
            else:
                parts.append(np.full(table.n_rows(f), np.nan))
        kinds = {p.dtype.kind for p in parts}
        if len(kinds) > 1 and not kinds <= set("iuf"):
            parts = [p.astype(object) for p in parts]
            for p in parts:
                p[table.missing(p)] = None
        out[name] = np.concatenate(parts)
    return out


def _same_name(names: Sequence[str]) -> str:
    """The concatenated index's name: the frames' own where all agree."""
    return names[0] if len(set(names)) == 1 else ""


def _sorted(frame: table.Frame, stamps: np.ndarray
            ) -> Tuple[table.Frame, np.ndarray]:
    """``sort_index()`` on a datetime index."""
    order = table.sort_index_order(stamps)
    if order is None:
        return frame, stamps
    return table.take(frame, order), stamps[order]


def _complete(frame: table.Frame) -> np.ndarray:
    """The rows that ``dropna()`` keeps: nothing missing."""
    return ~np.any([table.missing(c) for c in frame.values()], axis=0)


def _fillna(col: np.ndarray, value) -> np.ndarray:
    """``Series.fillna(value)``: a float column stays float where the fill
    is a number; otherwise missing cells take ``value`` as it is."""
    miss = table.missing(col)
    if not miss.any():
        return col
    if col.dtype.kind == "f" and isinstance(value, (int, float)):
        return np.where(miss, float(value), col)
    out = col.astype(object)
    out[miss] = value
    return out


def _fill(col: np.ndarray, backward: bool = False) -> np.ndarray:
    """``ffill()`` (``bfill()`` with ``backward``): each missing cell takes
    the last (next) present value; leading (trailing) gaps stay."""
    miss = table.missing(col)
    if not miss.any():
        return col
    n = len(col)
    if backward:
        return _fill(col[::-1])[::-1]
    pos = np.where(~miss, np.arange(n), -1)
    np.maximum.accumulate(pos, out=pos)
    out = col.copy()
    have = pos >= 0
    out[have] = col[pos[have]]
    return out


def _replace_zero(frame: table.Frame) -> table.Frame:
    """``replace(0.0, np.nan)`` on float columns."""
    return {k: np.where(v == 0.0, np.nan, v) if v.dtype.kind == "f" else v
            for k, v in frame.items()}


def _add_calendar(frame: table.Frame, stamps: np.ndarray,
                  earliest) -> table.Frame:
    """Day of week, hour, hours and days from ``earliest``, each the
    arithmetic of JAX ``_add_calendar`` (``(date - earliest).seconds / 60
    / 60 + (date - earliest).days * 24`` in float64)."""
    days, seconds = table.since(stamps, earliest)
    frame["day_of_week"] = table.dayofweek(stamps)
    frame["hour"] = table.hour(stamps)
    frame["hours_from_start"] = seconds / 60 / 60 + days * 24
    frame["days_from_start"] = days
    return frame


def _activity_window(frame: table.Frame, stamps: np.ndarray
                     ) -> Tuple[table.Frame, np.ndarray]:
    """Trim to the [first-ffill-valid, last-bfill-valid] index range and
    zero-fill, the reference's active-range recipe
    (``data_loader.py:247-253``)."""
    miss = np.stack([table.missing(c) for c in frame.values()])
    present = ~miss
    if not present.any(axis=1).all():
        raise ValueError("min() arg is an empty sequence")
    first = max(int(np.argmax(row)) for row in present)
    last = min(len(stamps) - 1 - int(np.argmax(row[::-1]))
               for row in present)
    if first > last:
        raise ValueError("min() arg is an empty sequence")
    active = (stamps >= stamps[first]) & (stamps <= stamps[last])
    frame = {k: _fillna(v[active], 0.0) for k, v in frame.items()}
    return frame, stamps[active]


# -- the handlers ------------------------------------------------------------


def download_solar(config: ExperimentConfig) -> None:
    """NREL AL 2006 PV plants, hourly subsampled (``data_loader.py:463-501``)."""
    csv_dir = os.path.join(config.data_folder, "al-pv-2006")
    download_and_unzip(_URLS["solar"], csv_dir + ".zip", csv_dir)

    frames, index, names = [], [], []
    for file in os.listdir(csv_dir):
        parts = file.split("_")
        df, idx, name = _read(os.path.join(csv_dir, file), index_col=True)
        # 5-min -> hourly
        df, idx = table.take(df, slice(0, None, 12)), idx[0::12]
        n = len(idx)
        df["latitude"] = np.full(n, parts[1])
        df["longtitude"] = np.full(n, parts[2])
        df["id"] = np.full(n, parts[1] + "_" + parts[2])
        df["capacity"] = np.full(n, parts[5])
        frames.append(df)
        index.append(idx)
        names.append(name)

    output = _concat(frames)
    stamps = table.to_datetime(np.concatenate(index))
    output, stamps = _sorted(output, stamps)
    output = _add_calendar(output, stamps, stamps.min())
    output["categorical_id"] = output["id"]
    table.write_csv(config.data_csv_path, output, stamps, _same_name(names))


def download_electricity(config: ExperimentConfig) -> None:
    """UCI LD2011-2014, hourly aggregation + per-meter active ranges
    (``data_loader.py:504-566``)."""
    csv_path = os.path.join(config.data_folder, "LD2011_2014.txt")
    download_and_unzip(_URLS["electricity"], csv_path + ".zip",
                       config.data_folder)

    df, idx, _ = _read(csv_path, index_col=True, sep=";", decimal=",")
    df, stamps = _sorted(df, table.to_datetime(idx))
    hours, output = table.resample(stamps, df, _HOUR)
    output = _replace_zero(output)
    earliest_time = hours.min()

    df_list = []
    for label, srs in output.items():
        present = np.flatnonzero(~np.isnan(srs))
        if not len(present):
            raise ValueError("min() arg is an empty sequence")
        active = ((hours >= hours[present[0]])
                  & (hours <= hours[present[-1]]))
        tmp = {"power_usage": _fillna(srs[active], 0.0)}
        tmp = _add_calendar(tmp, hours[active], earliest_time)
        n = int(active.sum())
        tmp["categorical_id"] = np.full(n, label)
        tmp["id"] = np.full(n, label)
        df_list.append(tmp)

    output = _concat(df_list)
    keep = ((output["days_from_start"] >= 1096)
            & (output["days_from_start"] < 1346))
    table.write_csv(config.data_csv_path, table.take(output, keep),
                    np.flatnonzero(keep))


def download_traffic(config: ExperimentConfig) -> None:
    """PEMS-SF: parse the custom matrix format, unshuffle, hourly-average,
    flatten per sensor (``data_loader.py:568-720``)."""
    unzip_dir = os.path.join(config.data_folder, "pems")
    download_and_unzip(_URLS["traffic"], unzip_dir + ".zip", unzip_dir)

    def parse_list(line, typ=int, delim=None):
        return [typ(i) for i in
                line.replace("[", "").replace("]", "").split(delim)]

    def read_list(name):
        with open(os.path.join(unzip_dir, name)) as f:
            return parse_list(f.readlines()[0])

    def read_matrix(name):
        out = []
        with open(os.path.join(unzip_dir, name)) as f:
            for line in f.readlines():
                out.append([
                    parse_list(row, float)
                    for row in parse_list(line, str, ";")
                ])
        return out

    shuffle_order = np.array(read_list("randperm")) - 1
    day_of_week = np.array(
        read_list("PEMS_trainlabels") + read_list("PEMS_testlabels"))
    tensor = np.array(read_matrix("PEMS_train") + read_matrix("PEMS_test"))
    inverse = np.argsort(shuffle_order)
    day_of_week = day_of_week[inverse]
    tensor = tensor[inverse]

    labels = [f"traj_{i}" for i in read_list("stations_list")]
    hourly_list = []
    for day, day_matrix in enumerate(tensor):
        hour_on_day = np.arange(day_matrix.shape[1]) // 6  # 10-min samples
        n_hours = int(hour_on_day.max()) + 1
        means = table.group_mean(day_matrix.T, hour_on_day, n_hours)
        hourly = {c: means[:, j].copy() for j, c in enumerate(labels)}
        hourly["sensor_day"] = np.full(n_hours, day, np.int64)
        hourly["time_on_day"] = np.arange(n_hours, dtype=np.int64)
        hourly["day_of_week"] = np.full(n_hours, day_of_week[day])
        hourly_list.append(hourly)
    hourly_frame = _concat(hourly_list)

    store_columns = [c for c in hourly_frame if "traj" in c]
    other_columns = [c for c in hourly_frame if "traj" not in c]
    slices = []
    for store in store_columns:
        sliced = {"values": hourly_frame[store]}
        sliced.update({c: hourly_frame[c] for c in other_columns})
        n = table.n_rows(sliced)
        sliced["id"] = np.full(n, int(store.replace("traj_", "")), np.int64)
        sliced = table.sort_by(sliced, ["id", "sensor_day", "time_on_day"])
        sliced["values"] = _fill(sliced["values"])
        slices.append(table.take(sliced, _complete(sliced)))
    flat_df = _concat(slices)
    keep = flat_df["sensor_day"] < 173
    flat_df = table.take(flat_df, keep)
    flat_df["categorical_id"] = flat_df["id"]
    flat_df["hours_from_start"] = (
        flat_df["time_on_day"] + flat_df["sensor_day"] * 24.0)
    table.write_csv(config.data_csv_path, flat_df, np.flatnonzero(keep))


def download_air_quality(config: ExperimentConfig) -> None:
    """Beijing PRSA multi-site air quality (``data_loader.py:345-385``)."""
    unzip_dir = os.path.join(config.data_folder, "prsa")
    download_and_unzip(_URLS["air_quality"], unzip_dir + ".zip", unzip_dir)
    folder = os.path.join(unzip_dir, "PRSA_Data_20130301-20170228")
    output = _concat([_read(os.path.join(folder, f), index_col=True)[0]
                      for f in os.listdir(folder)])
    stamps = table.to_datetime([
        f"{y:04d}-{m:02d}-{d:02d}" for y, m, d in zip(
            output["year"].tolist(), output["month"].tolist(),
            output["day"].tolist())])
    output, stamps = _sorted(output, stamps)
    output = {k: _fillna(v, 0.0) for k, v in output.items()}
    output = _add_calendar(output, stamps, stamps.min())
    output["id"] = output["station"]
    output["categorical_id"] = output["station"]
    table.write_csv(config.data_csv_path, output, stamps)


def process_exchange(config: ExperimentConfig,
                     source_csv: str = "~/Downloads/exchange_rate.csv") -> None:
    """Exchange-rate csv to daily frame (``data_loader.py:443-460``).

    The reference expects a manually downloaded csv; when it is absent
    this pulls the canonical LSTNet ``exchange_rate.txt.gz`` mirror and
    names the 8 series the standard way (columns 0-6 + OT)."""
    expanded = os.path.expanduser(source_csv)
    if os.path.exists(expanded):
        exchange = _read(expanded)
    else:
        gz_path = os.path.join(config.data_folder, "exchange_rate.txt.gz")
        print(f"{expanded} not found; pulling {_URLS['exchange']}")
        urllib.request.urlretrieve(_URLS["exchange"], gz_path)
        exchange = _read(gz_path, header=False)
        names = [str(i) for i in range(7)] + ["OT"]
        if len(exchange) != len(names):
            raise ValueError(f"Length mismatch: Expected axis has "
                             f"{len(exchange)} elements, new values have "
                             f"{len(names)} elements")
        exchange = dict(zip(names, exchange.values()))
    stamps = table.date_range("1990-01-01", table.n_rows(exchange))
    exchange = _add_calendar(exchange, stamps, stamps.min())
    n = len(stamps)
    exchange["categorical_id"] = np.ones(n, np.int64)
    exchange["id"] = np.ones(n, np.int64)
    table.write_csv(config.data_csv_path, exchange, stamps)


def process_watershed(config: ExperimentConfig) -> None:
    """Water-quality per-site csvs (``data_loader.py:137-176``)."""
    sites = ["BDC", "BEF", "DCF", "GOF", "HBF", "LMP", "MCQ", "SBM", "TPB",
             "WHB"]
    df_list = []
    for site in sites:
        df, _, _ = _read(
            os.path.join(config.data_folder, f"{site}_WQual_Level4.csv"),
            index_col=True)
        df_list.append(table.take(df, slice(0, None, 4)))
    output = _concat(df_list)
    output, stamps = _sorted(output, table.to_datetime(output["Date"]))
    output = {k: _fill(_fill(v), backward=True) for k, v in output.items()
              if not table.missing(v).all()}
    start_date = np.datetime64("2013-03-28", "s")
    keep = stamps >= start_date
    output, stamps = table.take(output, keep), stamps[keep]
    output = _add_calendar(output, stamps, start_date)
    output["id"] = output["Site"]
    output["categorical_id"] = output["Site"]
    site = output["Site"]
    if site.dtype.kind in "iuf":
        keep = site != 0.0
        output, stamps = table.take(output, keep), stamps[keep]
    output = {k: _fillna(v, "na") for k, v in output.items()}
    table.write_csv(config.data_csv_path, output, stamps, "Date")


def process_covid(config: ExperimentConfig,
                  cases_csv: str = "~/Downloads/covid-data.csv",
                  trips_csv: str = "~/Downloads/Trips_by_Distance.csv") -> None:
    """Covid cases joined with travel data (``data_loader.py:388-439``).

    Both sources require interactive portals (Oracle county case data and
    the BTS "Trips by Distance" download), so — like the reference — they
    must be pre-downloaded; a clear error names them."""
    for path, what in ((cases_csv, "county covid case data (Oracle/HHS "
                        "county dataset, REPORT_DATE/COUNTY_FIPS_NUMBER "
                        "schema)"),
                       (trips_csv, "BTS 'Trips by Distance' export "
                        "(https://data.bts.gov/Research-and-Statistics/"
                        "Trips-by-Distance/w96p-f2qv)")):
        if not os.path.exists(os.path.expanduser(path)):
            raise FileNotFoundError(
                f"{path} not found — place the {what} there; these portals "
                "need interactive downloads, matching the reference's "
                "manual-download workflow (data_loader.py:390-395)."
            )
    df = _read(cases_csv, str_columns=("COUNTY_NAME",))
    df_travel = _read(trips_csv)
    df, stamps = _sorted(df, table.to_datetime(df["REPORT_DATE"]))
    df_travel, travel_stamps = _sorted(df_travel,
                                       table.to_datetime(df_travel["Date"]))
    keep = _complete(df)
    df, stamps = table.take(df, keep), stamps[keep]
    keep = _complete(df_travel)
    df_travel, travel_stamps = table.take(df_travel, keep), travel_stamps[keep]
    earliest, latest = stamps.min(), travel_stamps.max()
    keep = (stamps >= earliest) & (stamps <= latest)
    df, stamps = table.take(df, keep), stamps[keep]
    keep = (travel_stamps >= earliest) & (travel_stamps <= latest)
    df_travel = table.take(df_travel, keep)
    df["day_of_week"] = table.dayofweek(stamps)
    df["id"] = df["COUNTY_FIPS_NUMBER"].astype(np.int64)
    df["categorical_id"] = df["id"]
    df["days_from_start"] = table.since(stamps, earliest)[0]
    frames, index = [], []
    travel_fips = df_travel["County FIPS"].astype(np.int64)
    for fip, rows in table.groups(df, "COUNTY_FIPS_NUMBER"):
        tmp = table.take(df_travel, travel_fips == int(fip))
        dff = table.take(df, rows)
        n = min(table.n_rows(tmp), len(rows))
        for col in ("Number of Trips", "Population Staying at Home",
                    "Population Not Staying at Home"):
            vals = np.zeros(len(rows))
            vals[:n] = tmp[col][:n]
            dff[col] = vals
        frames.append(dff)
        index.append(stamps[rows])
    output = {k: _fillna(v, 0) for k, v in _concat(frames).items()}
    table.write_csv(config.data_csv_path, output, np.concatenate(index),
                    "REPORT_DATE")


def download_weather(config: ExperimentConfig) -> None:
    """BGC-Jena roof weather 2008-2021, hourly means
    (``data_loader.py:179-262``)."""
    df_list, index, names = [], [], []
    for stem in _WEATHER_STEMS:
        csv_path = os.path.join(config.data_folder, f"{stem}.csv")
        download_and_unzip(_WEATHER_URL.format(stem=stem),
                           os.path.join(config.data_folder, f"{stem}.zip"),
                           config.data_folder)
        df, idx, name = _read(csv_path, index_col=True,
                              encoding="unicode_escape")
        df_list.append(df)
        index.append(idx)
        names.append(name)

    output = _concat(df_list)
    # the archive's "Date Time" column is DD.MM.YYYY HH:MM:SS
    stamps = table.to_datetime(np.concatenate(index),
                               fmt="%d.%m.%Y %H:%M:%S")
    output, stamps = _sorted(output, stamps)
    hours, output = table.resample(stamps, output, _HOUR)
    output = _replace_zero(output)
    earliest_time = hours.min()
    output, hours = _activity_window(output, hours)
    output = _add_calendar(output, hours, earliest_time)
    n = len(hours)
    output["id"] = np.ones(n, np.int64)
    output["categorical_id"] = output["id"]
    output["days_from_start"] = table.since(hours, earliest_time)[0]
    table.write_csv(config.data_csv_path, output, hours, _same_name(names))


def download_ett(config: ExperimentConfig) -> None:
    """ETTm2 (electricity transformer temperature, 15-min) from the
    ETDataset repo (``data_loader.py:265-296``; the reference then reads
    ``os.path.join(<file>, "ETTm2.csv")`` — a path bug; the intended read
    of the downloaded csv is implemented)."""
    data_path = os.path.join(config.data_folder, "ETT_raw.csv")
    if not os.path.exists(data_path):
        print(f"Pulling data from {_URLS['ETTm2']} to {data_path}")
        urllib.request.urlretrieve(_URLS["ETTm2"], data_path)

    df, idx, name = _read(data_path, index_col=True)
    df, stamps = _sorted(df, table.to_datetime(idx))
    steps, output = table.resample(stamps, df, 15 * 60)
    output = _replace_zero(output)
    earliest_time = steps.min()
    output, steps = _activity_window(output, steps)
    output = _add_calendar(output, steps, earliest_time)
    n = len(steps)
    output["id"] = np.ones(n, np.int64)
    output["categorical_id"] = output["id"]
    output["days_from_start"] = table.since(steps, earliest_time)[0]
    table.write_csv(config.data_csv_path, output, steps, name)


def download_camel(config: ExperimentConfig) -> None:
    """CAMELS USGS streamflow: parse the per-basin whitespace text files
    (``data_loader.py:299-342``)."""
    zip_path = os.path.join(
        config.data_folder, "basin_timeseries_v1p2_metForcing_obsFlow.zip")
    download_and_unzip(_URLS["camel"], zip_path, config.data_folder)
    flow_dir = os.path.join(config.data_folder, "basin_dataset_public_v1p2",
                            "usgs_streamflow")

    df_list, index = [], []
    for region in sorted(os.listdir(flow_dir)):
        region_dir = os.path.join(flow_dir, region)
        for fname in sorted(os.listdir(region_dir)):
            rows = []
            with open(os.path.join(region_dir, fname)) as f:
                for line in f:
                    vals = [v for v in line.rstrip("\n").split(" ") if v]
                    rows.append(vals)
            arr = np.asarray(rows)[:, :-1]
            df = {
                "date": np.array([f"{a[1]}-{a[2]}-{a[3]}" for a in arr]),
                "id": arr[:, 0],
                "streamflow": arr[:, -1].astype(object),
            }
            df, stamps = _sorted(df, table.to_datetime(df["date"]))
            df["streamflow"][df["streamflow"] == "-999.00"] = None
            df, stamps = _activity_window(df, stamps)
            earliest_time = stamps.min()
            df = _add_calendar(df, stamps, earliest_time)
            df["categorical_id"] = df["id"]
            df["days_from_start"] = table.since(stamps, earliest_time)[0]
            df_list.append(df)
            index.append(stamps)

    output, stamps = _sorted(_concat(df_list), np.concatenate(index))
    table.write_csv(config.data_csv_path, output, stamps, "date")


def _un7z(path: str, data_folder: str) -> None:
    try:
        import py7zr  # optional

        with py7zr.SevenZipFile(path) as zf7:
            zf7.extractall(data_folder)
        return
    except ImportError:
        pass
    for tool in ("7z", "7za"):
        if shutil.which(tool):
            subprocess.run([tool, "x", "-y", f"-o{data_folder}", path],
                           check=True, capture_output=True)
            return
    raise RuntimeError(
        f"cannot extract {path}: install py7zr or a system 7z binary")


def _lookup(keys: Sequence[np.ndarray], table_keys: Sequence[np.ndarray]
            ) -> List[List[int]]:
    """For each left row, the right rows whose keys equal its keys, in
    right order (Python equality: 1.0 matches 1)."""
    where = {}
    for j, key in enumerate(zip(*(k.tolist() for k in table_keys))):
        where.setdefault(key, []).append(j)
    return [where.get(key, []) for key in zip(*(k.tolist() for k in keys))]


def _gather(col: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """``col[rows]`` with -1 missing (a left join's unmatched rows): ints
    turn float, text and bools object, as pandas turns them."""
    hit = rows >= 0
    if hit.all():
        return col[rows]
    if col.dtype.kind in "iuf":
        out = np.full(len(rows), np.nan)
    elif col.dtype.kind == "M":
        out = np.full(len(rows), np.datetime64("NaT"), col.dtype)
    else:
        out = np.full(len(rows), None, dtype=object)
    out[hit] = col[rows[hit]]
    return out


def _merge_left(left: table.Frame, right: table.Frame, left_on: List[str],
                right_on: List[str]) -> Tuple[table.Frame, np.ndarray]:
    """``left.merge(right, left_on=, right_on=, how="left")``: each left
    row once for each match (right order), once if none; the right's
    columns that are not join keys appended.  Also returns each output
    row's left row."""
    matches = _lookup([left[k] for k in left_on], [right[k] for k in right_on])
    left_rows = np.array([i for i, m in enumerate(matches)
                          for _ in (m or [None])], np.int64)
    right_rows = np.array([j for m in matches for j in (m or [-1])],
                          np.int64)
    out = table.take(left, left_rows)
    for name, col in right.items():
        if name in right_on and name in left_on:
            continue
        out[name] = _gather(col, right_rows)
    return out, left_rows


def process_favorita(config: ExperimentConfig) -> None:
    """Favorita grocery sales (Kaggle competition data; manual download —
    ``data_loader.py:723-878``).  The raw archive holds 7z-compressed csvs;
    extraction uses py7zr or a system 7z when available."""
    kaggle_url = (
        "https://www.kaggle.com/c/favorita-grocery-sales-forecasting/data")
    data_folder = config.data_folder
    zip_file = os.path.join(data_folder,
                            "favorita-grocery-sales-forecasting.zip")
    if not os.path.exists(zip_file):
        raise FileNotFoundError(
            f"Favorita zip file not found at {zip_file}! Kaggle requires "
            f"authentication — download it manually from {kaggle_url} and "
            "place it there."
        )
    with zipfile.ZipFile(zip_file) as zf:
        zf.extractall(data_folder)
    for f in glob.glob(os.path.join(data_folder, "*.7z")):
        _un7z(f, data_folder)

    def path(name):
        return os.path.join(data_folder, name)

    start_date = np.datetime64("2015-01-01", "s")
    end_date = np.datetime64("2016-06-01", "s")
    temporal, _, _ = _read(path("train.csv"), index_col=True)
    store_info, store_nbr, _ = _read(path("stores.csv"), index_col=True)
    oil, oil_dates, _ = _read(path("oil.csv"), index_col=True)
    oil = next(iter(oil.values()))
    holidays = _read(path("holidays_events.csv"))
    items, item_nbr, _ = _read(path("items.csv"), index_col=True)
    transactions = _read(path("transactions.csv"))

    temporal["date"] = table.to_datetime(temporal["date"])
    temporal = table.take(temporal, (temporal["date"] >= start_date)
                          & (temporal["date"] < end_date))
    _, first = np.unique(temporal["date"], return_index=True)
    dates = temporal["date"][np.sort(first)]

    temporal["traj_id"] = np.char.add(np.char.add(
        table.as_str(temporal["store_nbr"]), "_"),
        table.as_str(temporal["item_nbr"]))
    stamp_text = np.char.replace(np.datetime_as_string(
        temporal["date"], unit="s"), "T", " ")
    temporal["unique_id"] = np.char.add(np.char.add(
        temporal["traj_id"], "_"), stamp_text)

    # drop trajectories with negative returns
    sales = temporal["unit_sales"].astype(np.float64)
    valid = set()
    for traj, rows in table.groups(temporal, "traj_id"):
        vals = sales[rows][~np.isnan(sales[rows])]
        if len(vals) and vals.min() >= 0:
            valid.add(traj)
    temporal = table.take(temporal, np.isin(temporal["traj_id"],
                                            list(valid)))
    temporal["open"] = np.ones(table.n_rows(temporal), np.int64)

    resampled, index = [], []
    for _, rows in table.groups(temporal, "traj_id"):
        sub_df = table.take(temporal, rows)
        stamps = sub_df.pop("date")
        days, sub_df = table.resample(stamps, sub_df, _DAY, how="last")
        sub_df["date"] = days
        for col in ("store_nbr", "item_nbr", "onpromotion"):
            sub_df[col] = _fill(sub_df[col])
        sub_df["open"] = _fillna(sub_df["open"], 0)
        sub_df["log_sales"] = np.log(sub_df["unit_sales"])
        resampled.append(sub_df)
    temporal = _concat(resampled)

    oil_dates = table.to_datetime(oil_dates)
    if len(np.unique(oil_dates)) != len(oil_dates):
        raise ValueError("cannot reindex on an axis with duplicate labels")
    oil_at = dict(zip(oil_dates.tolist(), oil.tolist()))
    on_dates = _fill(np.array([oil_at.get(d, np.nan)
                               for d in dates.tolist()], np.float64))
    oil_on = dict(zip(dates.tolist(), on_dates.tolist()))
    temporal["oil"] = _fillna(np.array(
        [oil_on.get(d, np.nan) for d in temporal["date"].tolist()],
        np.float64), -1)
    for key_col, keys, info in (("store_nbr", store_nbr, store_info),
                                ("item_nbr", item_nbr, items)):
        rows = np.array([m[0] if m else -1 for m in _lookup(
            [temporal[key_col]], [keys])], np.int64)
        for name, col in info.items():
            temporal[name] = _gather(col, rows)
    transactions["date"] = table.to_datetime(transactions["date"])
    temporal, _ = _merge_left(temporal, transactions, ["date", "store_nbr"],
                              ["date", "store_nbr"])
    temporal["transactions"] = _fillna(temporal["transactions"], -1)
    temporal["day_of_week"] = table.dayofweek(temporal["date"])
    temporal["day_of_month"] = table.day(temporal["date"])
    temporal["month"] = table.month(temporal["date"])

    transferred = np.isin(holidays["transferred"].astype(str),
                          ["True", "TRUE", "true"])
    hol = table.take(holidays, ~transferred)
    hol = {("holiday_type" if c == "type" else c): v for c, v in hol.items()}
    hol["date"] = table.to_datetime(hol["date"])
    n = table.n_rows(temporal)
    for locale, left_on, right_on, out in (
        ("National", ["date"], ["date"], "national_hol"),
        ("Regional", ["state", "date"], ["locale_name", "date"],
         "regional_hol"),
        ("Local", ["city", "date"], ["locale_name", "date"], "local_hol"),
    ):
        subset = table.take(hol, hol["locale"] == locale)
        merged, _ = _merge_left(temporal, subset, left_on, right_on)
        description = _fillna(merged["description"], "")
        temporal[out] = description[:n]  # aligned on the index 0..n-1

    uid = temporal["unique_id"]
    miss = table.missing(uid)
    present = np.flatnonzero(~miss)
    order = np.concatenate([
        present[np.argsort(uid[present].astype(str), kind="stable")],
        np.flatnonzero(miss)])
    table.write_csv(config.data_csv_path, table.take(temporal, order), order)


DOWNLOAD_FUNCTIONS = {
    "electricity": download_electricity,
    "traffic": download_traffic,
    "air_quality": download_air_quality,
    "watershed": process_watershed,
    "solar": download_solar,
    "covid": process_covid,
    "exchange": process_exchange,
    "weather": download_weather,
    "ETTm2": download_ett,
    "camel": download_camel,
    "favorita": process_favorita,
}


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description="dataset download/ETL")
    parser.add_argument("--expt_name", type=str, required=True,
                        choices=sorted(DOWNLOAD_FUNCTIONS) + ["all"])
    parser.add_argument("--output_folder", type=str, default=".")
    parser.add_argument("--force_download", type=str, default="yes",
                        choices=["yes", "no"])
    parser.add_argument("--synthetic", action="store_true",
                        help="write a schema-matching synthetic csv instead "
                             "of downloading (offline environments)")
    parser.add_argument("--synthetic_noise", type=str, default="iid",
                        choices=["iid", "ar1", "gp"])
    parser.add_argument("--from_local_csv", type=str, default=None,
                        help="install a user-supplied processed csv "
                             "(schema+checksum verified via data.manifest) "
                             "instead of downloading — the offline bypass")
    args = parser.parse_args(argv)

    config = ExperimentConfig(experiment=args.expt_name,
                              root_folder=args.output_folder)
    if args.from_local_csv is not None:
        from fine_grained_gaussian_process_forcasting_torch.data.manifest import (  # noqa: E501
            install_local_csv,
        )

        path = install_local_csv(args.expt_name, args.from_local_csv,
                                 root_folder=args.output_folder)
        print(f"Installed verified local csv at {path}")
        return path
    if os.path.exists(config.data_csv_path) and args.force_download == "no":
        print(f"Data already processed for {args.expt_name}; skipping.")
        return config.data_csv_path

    if args.synthetic:
        from fine_grained_gaussian_process_forcasting_torch.data.synthetic import (  # noqa: E501
            make_synthetic_frame,
        )

        frame = make_synthetic_frame(args.expt_name, num_entities=8,
                                     steps_per_entity=2000,
                                     noise=args.synthetic_noise)
        table.write_csv(config.data_csv_path, frame)
        print(f"Wrote synthetic {config.data_csv_path}")
        return config.data_csv_path

    try:
        DOWNLOAD_FUNCTIONS[args.expt_name](config)
    except urllib.error.URLError as e:
        raise SystemExit(
            f"download failed for {args.expt_name!r}: {e}. This environment "
            "appears to be offline — re-run with --synthetic for a "
            "schema-matching generated csv, or place the raw files manually."
        )
    print("Done.")
    return config.data_csv_path


if __name__ == "__main__":
    main()
