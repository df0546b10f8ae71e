"""Local replicas of the public raw files each ETL handler reads.

The replica writers of ``tests/test_etl_handlers.py``, copied: the same file
layouts, separators, index formats and quirks, the same values from the
same seeds.  ``build(name, src)`` writes one handler's sources under
``src`` and returns a ``Replica``: the URLs (``file://``) and module
attributes to set on a download module, the files to place in an
experiment's data folder, and the handler's keyword arguments.  A replica
is served to the JAX package's handler and to the port's alike.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import zipfile
from typing import Callable, Dict

import numpy as np
import pandas as pd

HANDLERS = {
    "exchange": "process_exchange",
    "ETTm2": "download_ett",
    "solar": "download_solar",
    "electricity": "download_electricity",
    "air_quality": "download_air_quality",
    "watershed": "process_watershed",
    "weather": "download_weather",
    "camel": "download_camel",
    "traffic": "download_traffic",
    "covid": "process_covid",
    "favorita": "process_favorita",
}


@dataclasses.dataclass
class Replica:
    urls: Dict[str, str] = dataclasses.field(default_factory=dict)
    attrs: Dict[str, object] = dataclasses.field(default_factory=dict)
    place: Callable[[str], None] = lambda data_folder: None
    kwargs: Dict[str, str] = dataclasses.field(default_factory=dict)


def _file_url(path) -> str:
    return "file://" + str(path)


def _zip_of(zip_path, files: dict) -> str:
    """files: archive-relative name -> text content."""
    with zipfile.ZipFile(zip_path, "w") as zf:
        for name, content in files.items():
            zf.writestr(name, content)
    return str(zip_path)


def _solar(src):
    idx = pd.date_range("2006-01-01", periods=24 * 12, freq="5min")
    body = pd.DataFrame(
        {"Power(MW)": np.abs(np.sin(np.arange(len(idx)) / 40.0))}, index=idx
    ).to_csv(index_label="LocalTime")
    zipped = _zip_of(src / "src.zip", {
        "Actual_30.55_-88.15_2006_DPV_38MW_5_Min.csv": body,
        "Actual_31.95_-87.25_2006_UPV_70MW_5_Min.csv": body,
    })
    return Replica(urls={"solar": _file_url(zipped)})


def _electricity(src):
    early = pd.date_range("2011-01-01", periods=8, freq="15min")
    late = pd.date_range("2014-01-02", periods=24 * 4 * 3, freq="15min")
    idx = early.append(late)
    vals = np.round(np.random.default_rng(0).uniform(1, 5, (len(idx), 2)), 2)
    frame = pd.DataFrame(vals, index=idx, columns=["MT_001", "MT_002"])
    body = frame.to_csv(sep=";", decimal=",", index_label="")
    zipped = _zip_of(src / "src.zip", {"LD2011_2014.txt": body})
    return Replica(urls={"electricity": _file_url(zipped)})


def _traffic(src):
    def day(v):
        # 2 stations x 12 10-min samples (2 hours)
        rows = ";".join(
            "[" + " ".join(f"{v + 0.01 * i + 0.1 * s:.3f}" for i in range(12))
            + "]" for s in range(2))
        return f"[{rows}]"

    files = {
        "randperm": "[2 1 3]",
        "PEMS_trainlabels": "[1 2]",
        "PEMS_testlabels": "[3]",
        "PEMS_train": day(0.0) + "\n" + day(1.0) + "\n",
        "PEMS_test": day(2.0) + "\n",
        "stations_list": "[400001 400002]",
    }
    zipped = _zip_of(src / "src.zip", files)
    return Replica(urls={"traffic": _file_url(zipped)})


def _air_quality(src):
    def station(name):
        n = 48
        return pd.DataFrame({
            "No": np.arange(1, n + 1),
            "year": 2013, "month": 3, "day": np.repeat([1, 2], n // 2),
            "hour": list(range(24)) * (n // 24),
            "PM2.5": np.random.default_rng(0).uniform(1, 80, n).round(1),
            "NO2": 30.0, "CO": 0.8,
            "TEMP": 10.0, "PRES": 1010.0, "RAIN": 0.0,
            "station": name,
        }).to_csv(index=False)

    folder = "PRSA_Data_20130301-20170228"
    zipped = _zip_of(src / "src.zip", {
        f"{folder}/PRSA_Data_Dingling_20130301-20170228.csv":
            station("Dingling"),
        f"{folder}/PRSA_Data_Changping_20130301-20170228.csv":
            station("Changping"),
    })
    return Replica(urls={"air_quality": _file_url(zipped)})


def _exchange(src):
    arr = np.random.default_rng(1).uniform(0.5, 2.0, (40, 8)).round(6)
    gz_src = src / "exchange_rate.txt.gz"
    with gzip.open(gz_src, "wt") as f:
        for row in arr:
            f.write(",".join(f"{v}" for v in row) + "\n")
    return Replica(urls={"exchange": _file_url(gz_src)},
                   kwargs={"source_csv": str(src / "definitely-missing.csv")})


def _watershed(src):
    sites = ["BDC", "BEF", "DCF", "GOF", "HBF", "LMP", "MCQ", "SBM", "TPB",
             "WHB"]
    idx = pd.date_range("2013-03-28", periods=64, freq="15min")

    def place(data_folder):
        for site in sites:
            pd.DataFrame({
                "Date": idx.astype(str),
                "Site": site,
                "TempC": np.random.default_rng(2).uniform(5, 15, 64).round(2),
                "Conductivity":
                    np.random.default_rng(3).uniform(40, 90, 64).round(2),
                "Q": np.random.default_rng(3).uniform(1, 9, 64).round(2),
            }).to_csv(os.path.join(data_folder, f"{site}_WQual_Level4.csv"))

    return Replica(place=place)


def _covid(src):
    dates = pd.date_range("2020-03-01", periods=30, freq="1D")
    cases = pd.DataFrame({
        "REPORT_DATE": np.tile(dates.astype(str), 2),
        "COUNTY_FIPS_NUMBER": np.repeat([1001, 1003], len(dates)),
        "COUNTY_NAME": np.repeat(["Autauga", "Baldwin"], len(dates)),
        "PEOPLE_POSITIVE_NEW_CASES_COUNT": np.arange(2 * len(dates)),
        "PEOPLE_DEATH_COUNT": np.arange(2 * len(dates)) // 10,
    })
    trips = pd.DataFrame({
        "Date": np.tile(dates.astype(str), 2),
        "County FIPS": np.repeat([1001, 1003], len(dates)),
        "Number of Trips": 1000.0,
        "Population Staying at Home": 500.0,
        "Population Not Staying at Home": 700.0,
    })
    cases_csv = src / "covid-data.csv"
    trips_csv = src / "Trips_by_Distance.csv"
    cases.to_csv(cases_csv, index=False)
    trips.to_csv(trips_csv, index=False)
    return Replica(kwargs={"cases_csv": str(cases_csv),
                           "trips_csv": str(trips_csv)})


def _weather(src):
    def half(start):
        # span past day 12 of the month: DD.MM.YYYY inference locks onto
        # %m.%d and raises at day 13 unless the handler pins the format
        idx = pd.date_range(start, periods=80, freq="6h")
        n = len(idx)
        return pd.DataFrame({
            "p (mbar)": 996.5, "T (degC)":
                np.random.default_rng(4).uniform(-5, 5, n).round(2),
            "rh (%)": 75.0,
        }, index=idx.strftime("%d.%m.%Y %H:%M:%S")).to_csv(
            index_label="Date Time")

    stems = ["mpi_roof_2008a", "mpi_roof_2008b"]
    starts = {"mpi_roof_2008a": "2008-01-01", "mpi_roof_2008b": "2008-07-01"}
    for stem in stems:
        _zip_of(src / f"{stem}_src.zip", {f"{stem}.csv": half(starts[stem])})
    return Replica(attrs={"_WEATHER_STEMS": stems,
                          "_WEATHER_URL": _file_url(src) + "/{stem}_src.zip"})


def _ett(src):
    idx = pd.date_range("2016-07-01", periods=96, freq="15min")

    def place(data_folder):
        pd.DataFrame({
            "HUFL": 5.0, "HULL": 2.0, "MUFL": 1.0, "MULL": 0.5,
            "LUFL": 4.0, "LULL": 1.2,
            "OT": np.random.default_rng(5).uniform(20, 40, 96).round(3),
        }, index=idx).to_csv(os.path.join(data_folder, "ETT_raw.csv"),
                             index_label="date")

    return Replica(place=place)


def _camel(src):
    def basin(gauge, flows):
        return "\n".join(
            f"{gauge} 1980 01 {d + 1:02d} {f} A"
            for d, f in enumerate(flows)) + "\n"

    root = "basin_dataset_public_v1p2/usgs_streamflow"
    zipped = _zip_of(src / "src.zip", {
        f"{root}/01/01013500_streamflow_qc.txt":
            basin("01013500", ["200.00", "-999.00", "210.00", "190.00"]),
        f"{root}/02/02177000_streamflow_qc.txt":
            basin("02177000", ["55.00", "60.00", "52.00", "58.00"]),
    })
    return Replica(urls={"camel": _file_url(zipped)})


def _favorita(src):
    dates = pd.date_range("2015-02-01", periods=20, freq="1D")
    train = pd.DataFrame({
        "id": np.arange(2 * len(dates)),
        "date": np.tile(dates.astype(str), 2),
        "store_nbr": np.repeat([1, 2], len(dates)),
        "item_nbr": np.repeat([100, 200], len(dates)),
        "unit_sales": np.random.default_rng(6).uniform(1, 9,
                                                       2 * len(dates)).round(2),
        "onpromotion": False,
    }).set_index("id")
    stores = pd.DataFrame({
        "store_nbr": [1, 2], "city": ["Quito", "Cuenca"],
        "state": ["Pichincha", "Azuay"], "type": ["A", "B"],
        "cluster": [1, 2],
    }).set_index("store_nbr")
    items = pd.DataFrame({
        "item_nbr": [100, 200], "family": ["GROCERY I", "DAIRY"],
        "class": [1000, 2000], "perishable": [0, 1],
    }).set_index("item_nbr")
    oil = pd.DataFrame({
        "date": dates.astype(str), "dcoilwtico": 50.0}).set_index("date")
    holidays = pd.DataFrame({
        "date": [str(dates[3].date())], "type": ["Holiday"],
        "locale": ["National"], "locale_name": ["Ecuador"],
        "description": ["Carnaval"], "transferred": [False],
    })
    transactions = pd.DataFrame({
        "date": np.tile(dates.astype(str), 2),
        "store_nbr": np.repeat([1, 2], len(dates)),
        "transactions": 1500,
    })
    files = {
        "train.csv": train.to_csv(),
        "stores.csv": stores.to_csv(),
        "items.csv": items.to_csv(),
        "oil.csv": oil.to_csv(index=True),
        "holidays_events.csv": holidays.to_csv(index=False),
        "transactions.csv": transactions.to_csv(index=False),
    }

    def place(data_folder):
        _zip_of(os.path.join(data_folder,
                             "favorita-grocery-sales-forecasting.zip"), files)

    return Replica(place=place)


_WRITERS = {
    "exchange": _exchange,
    "ETTm2": _ett,
    "solar": _solar,
    "electricity": _electricity,
    "air_quality": _air_quality,
    "watershed": _watershed,
    "weather": _weather,
    "camel": _camel,
    "traffic": _traffic,
    "covid": _covid,
    "favorita": _favorita,
}


def build(name: str, src) -> Replica:
    """Writes the raw sources of experiment ``name`` under ``src`` (a
    ``pathlib.Path``, created)."""
    os.makedirs(src, exist_ok=True)
    return _WRITERS[name](src)


def run(module, config_cls, name: str, replica: Replica, root: str,
        monkeypatch) -> str:
    """Runs ``module``'s handler for ``name`` on ``replica`` into the
    experiment layout under ``root``; returns the CSV it wrote."""
    for key, url in replica.urls.items():
        monkeypatch.setitem(module._URLS, key, url)
    for attr, value in replica.attrs.items():
        monkeypatch.setattr(module, attr, value)
    config = config_cls(24, name, root_folder=str(root))
    replica.place(config.data_folder)
    getattr(module, HANDLERS[name])(config, **replica.kwargs)
    return config.data_csv_path
