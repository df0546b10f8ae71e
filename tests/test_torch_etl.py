"""The port's ETL (``data/download.py`` on ``data/table.py``) against the
JAX package's pandas ETL.

Each handler runs on the local replica of its public raw files
(``tests/_torch_etl_replicas.py``, the replica writers of
``tests/test_etl_handlers.py``, served through ``file://`` URLs) in both
packages, into two roots.  The two CSVs, read back with
``pandas.read_csv``, have the same columns in the same order, the same rows
in the same order, numbers exactly equal and text equal; the files are
also byte-equal (the port reads numbers as pandas' default converter does,
``table._pandas_float``).  Then the CLI (``--synthetic``, the offline
exit, ``--force_download no``), the manual-download errors, and the table
helpers the handlers stand on (``write_csv``, the dates, ``resample``)
against pandas.  No test reaches the network.
"""

import io
import os

import numpy as np
import pandas as pd
import pytest

import _torch_etl_replicas as replicas
import chip_smoke
from fine_grained_gaussian_process_forcasting_torch.data import download as tdl
from fine_grained_gaussian_process_forcasting_torch.data import table
from fine_grained_gaussian_process_forcasting_torch.data.experiment import (
    ExperimentConfig as TorchConfig,
)
from fine_grained_gaussian_process_forcasting_tpu.data import download as jdl
from fine_grained_gaussian_process_forcasting_tpu.data.experiment import (
    ExperimentConfig as JaxConfig,
)


def _assert_same_csv(jax_csv, torch_csv):
    want, got = pd.read_csv(jax_csv), pd.read_csv(torch_csv)
    assert list(got.columns) == list(want.columns)
    assert got.shape == want.shape
    for col in want.columns:
        w, g = want[col], got[col]
        assert g.dtype == w.dtype, col
        if w.dtype.kind == "f":
            np.testing.assert_array_equal(g.to_numpy(), w.to_numpy(),
                                          err_msg=col)
        else:
            assert g.tolist() == w.tolist(), col
    with open(jax_csv, "rb") as a, open(torch_csv, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("name", list(replicas.HANDLERS))
def test_handler_matches_jax(name, tmp_path, monkeypatch):
    replica = replicas.build(name, tmp_path / "src")
    want = replicas.run(jdl, JaxConfig, name, replica, tmp_path / "jax",
                        monkeypatch)
    got = replicas.run(tdl, TorchConfig, name, replica, tmp_path / "torch",
                       monkeypatch)
    assert got.endswith(os.path.relpath(want, tmp_path / "jax"))
    _assert_same_csv(want, got)


@pytest.mark.parametrize("name", ["exchange", "ETTm2"])
def test_handler_matches_jax_at_published_shapes(name, tmp_path,
                                                 monkeypatch):
    """The card smoke's replicas (``chip_smoke.write_etl_replicas``: 7,588
    x 8 exchange rates, 69,680 ETTm2 rows) through both packages."""
    src = chip_smoke.write_etl_replicas(str(tmp_path / "src"))
    kw = ({"source_csv": str(tmp_path / "none.csv")} if name == "exchange"
          else {})
    paths = []
    for module, cls, root in ((jdl, JaxConfig, "jax"),
                              (tdl, TorchConfig, "torch")):
        monkeypatch.setitem(module._URLS, name, "file://" + src[name])
        config = cls(96, name, root_folder=str(tmp_path / root))
        getattr(module, replicas.HANDLERS[name])(config, **kw)
        paths.append(config.data_csv_path)
    _assert_same_csv(*paths)
    rows = {"exchange": chip_smoke.DT_EXCHANGE[0],
            "ETTm2": chip_smoke.DT_ETT_ROWS}[name]
    assert chip_smoke._check_etl_output(name, paths[1], name, rows)[
        "rows"] == rows


def test_download_functions_match():
    assert list(tdl.DOWNLOAD_FUNCTIONS) == list(jdl.DOWNLOAD_FUNCTIONS)
    assert set(tdl.DOWNLOAD_FUNCTIONS) == set(replicas.HANDLERS)
    assert tdl._URLS == jdl._URLS
    assert tdl._WEATHER_STEMS == jdl._WEATHER_STEMS
    assert tdl._WEATHER_URL == jdl._WEATHER_URL


def _error(fn, *args, **kw):
    with pytest.raises(Exception) as info:
        fn(*args, **kw)
    return type(info.value), str(info.value)


def test_manual_download_errors_match(tmp_path):
    """covid's missing sources and favorita's missing archive: the same
    exception and message in both packages."""
    cases = tmp_path / "covid-data.csv"
    cases.write_text("REPORT_DATE,COUNTY_FIPS_NUMBER\n")
    got, want = [], []
    for module, cls, out in ((jdl, JaxConfig, want), (tdl, TorchConfig, got)):
        covid = cls(24, "covid", root_folder=str(tmp_path / "root"))
        out.append(_error(module.process_covid, covid,
                          cases_csv=str(cases),
                          trips_csv=str(tmp_path / "missing.csv")))
        out.append(_error(module.process_covid, covid,
                          cases_csv=str(tmp_path / "missing.csv")))
        favorita = cls(24, "favorita", root_folder=str(tmp_path / "root"))
        out.append(_error(module.process_favorita, favorita))
    assert got == want
    assert got[0][0] is FileNotFoundError and "Trips by Distance" in got[0][1]


def test_synthetic_cli_matches_jax(tmp_path):
    """``--synthetic``: the port's generator written by ``table.write_csv``
    is the JAX package's frame written by ``to_csv``, byte for byte."""
    want = jdl.main(["--expt_name", "electricity", "--synthetic",
                     "--output_folder", str(tmp_path / "jax")])
    got = tdl.main(["--expt_name", "electricity", "--synthetic",
                    "--output_folder", str(tmp_path / "torch")])
    _assert_same_csv(want, got)


def test_cli_offline_exit_and_skip(tmp_path, monkeypatch):
    """A download that fails (a ``file://`` URL to nothing) exits with the
    offline message; ``--force_download no`` skips a processed dataset."""
    messages = []
    for module in (jdl, tdl):
        monkeypatch.setitem(module._URLS, "solar",
                            "file://" + str(tmp_path / "nowhere.zip"))
        root = tmp_path / module.__name__.split(".")[0]
        with pytest.raises(SystemExit) as info:
            module.main(["--expt_name", "solar", "--output_folder",
                         str(root)])
        messages.append(str(info.value))
        path = module.main(["--expt_name", "solar", "--synthetic",
                            "--output_folder", str(root)])
        before = os.path.getmtime(path)
        assert module.main(["--expt_name", "solar", "--force_download",
                            "no", "--output_folder", str(root)]) == path
        assert os.path.getmtime(path) == before
    assert messages[0] == messages[1]
    assert "appears to be offline" in messages[1]


def test_write_csv_matches_to_csv(tmp_path):
    """Every column kind the handlers write, with and without an index,
    as ``DataFrame.to_csv`` writes it."""
    rng = np.random.default_rng(0)
    n = 40
    floats = rng.normal(size=n) * 10.0 ** rng.integers(-8, 18, n)
    floats[[3, 7]] = np.nan
    floats[5] = 0.0
    text = np.array([f"s,{i}" if i % 5 == 0 else f'q"{i}' if i % 7 == 0
                     else f"t{i}" for i in range(n)])
    mixed = np.array(["1.50", None, 0.0, "x"] * (n // 4), dtype=object)
    midnight = table.date_range("2020-02-27", n)
    timed = midnight + np.arange(n) * np.timedelta64(37, "m")
    frame = {"f": floats, "i": rng.integers(-5, 5, n),
             "b": rng.integers(0, 2, n).astype(bool), "t": text,
             "o": mixed, "d": midnight, "dt": timed,
             "d_nat": np.where(np.arange(n) == 2, np.datetime64("NaT"),
                               midnight)}
    pdf = pd.DataFrame({k: (pd.to_datetime(v) if v.dtype.kind == "M" else
                            pd.Series(v, dtype=object) if k == "o" else v)
                        for k, v in frame.items()})
    for index, label in ((None, ""), (timed, ""), (np.arange(n) * 3, ""),
                         (midnight, "day")):
        path = tmp_path / "t.csv"
        table.write_csv(str(path), frame, index, label)
        want = pdf.copy()
        if index is None:
            text_want = want.to_csv(index=False)
        else:
            want.index = (pd.to_datetime(index) if index.dtype.kind == "M"
                          else index)
            want.index.name = label or None
            text_want = want.to_csv()
        assert path.read_text() == text_want


def test_pandas_float_matches_read_csv():
    """``float_precision="high"`` reads numbers as pandas' default
    converter, an ulp away from the correctly rounded value where it is."""
    rng = np.random.default_rng(1)
    vals = np.concatenate([rng.uniform(0, 1, 3000),
                           rng.normal(0, 1e5, 3000),
                           np.exp(rng.uniform(-700, 700, 1000))])
    texts = ([repr(float(v)) for v in vals]
             + [f"{v:.20g}" for v in vals[:500]]
             + ["1e-320", "-0.0", "00012.5000000000000000001",
                "123456789012345678901234.5", "7", "-3.25e+2"])
    got = np.array([table._pandas_float(t) for t in texts])
    want = pd.read_csv(io.StringIO("x\n" + "\n".join(texts)))["x"].to_numpy()
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))
    assert any(float(t) != g for t, g in zip(texts, got))


def test_dates_match_pandas():
    """to_datetime (ISO and day first), the calendar fields, ``since`` and
    ``sort_index_order`` against pandas."""
    rng = np.random.default_rng(2)
    secs = rng.integers(0, 40 * 365 * 86400, 500) // 600 * 600
    stamps = (np.datetime64("1990-01-01T00:00:00") + secs.astype(
        "timedelta64[s]"))
    idx = pd.DatetimeIndex(stamps)
    iso = idx.strftime("%Y-%m-%d %H:%M:%S").to_numpy()
    np.testing.assert_array_equal(table.to_datetime(iso), stamps)
    dayfirst = idx.strftime("%d.%m.%Y %H:%M:%S").to_numpy()
    np.testing.assert_array_equal(
        table.to_datetime(dayfirst, fmt="%d.%m.%Y %H:%M:%S"), stamps)
    np.testing.assert_array_equal(table.to_datetime(dayfirst, dayfirst=True),
                                  stamps)
    for name, fn in (("dayofweek", table.dayofweek), ("hour", table.hour),
                     ("day", table.day), ("month", table.month)):
        np.testing.assert_array_equal(fn(stamps), getattr(idx, name),
                                      err_msg=name)
    earliest = stamps.min()
    days, seconds = table.since(stamps, earliest)
    delta = idx - pd.Timestamp(earliest)
    np.testing.assert_array_equal(days, delta.days)
    np.testing.assert_array_equal(seconds, delta.seconds)
    days_only = stamps.astype("datetime64[D]")  # many equal stamps
    frame = pd.DataFrame({"row": np.arange(len(stamps))},
                         index=pd.DatetimeIndex(days_only))
    order = table.sort_index_order(days_only)
    np.testing.assert_array_equal(order, frame.sort_index()["row"])
    assert table.sort_index_order(np.sort(stamps)) is None


@pytest.mark.parametrize("freq_s, freq", [(3600, "1h"), (900, "15min")])
def test_resample_mean_matches_pandas(freq_s, freq):
    """pandas' resampled means, bit for bit: the bins from the first row's
    midnight, empty ones NaN, the sums compensated."""
    rng = np.random.default_rng(3)
    n = 2000
    stamps = np.sort(np.datetime64("2011-01-01T00:05:00") + (
        rng.integers(0, 30 * 86400, n) // 300 * 300).astype("timedelta64[s]"))
    vals = rng.normal(size=(n, 2)) * np.array([1.0, 1e8])
    vals[rng.integers(0, n, 50), 0] = np.nan
    frame = {"a": vals[:, 0], "b": vals[:, 1]}
    edges, got = table.resample(stamps, frame, freq_s)
    want = pd.DataFrame(frame, index=pd.DatetimeIndex(stamps)).resample(
        freq).mean()
    np.testing.assert_array_equal(edges, want.index.to_numpy())
    for k in frame:
        np.testing.assert_array_equal(got[k], want[k].to_numpy())
