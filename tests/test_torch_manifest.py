"""The port's manifest (``data/manifest.py``) against the JAX package's.

Every case of ``tests/test_manifest.py``, run on both packages against one
file: the reports are equal, and so are the errors, word for word.  The
pin stores are files under ``tmp_path`` (``pin_store=`` or
``$FGP_MANIFEST_PINS``), never the checkout's ``.manifest_pins.json``.
"""

import json
import os

import pandas as pd
import pytest

from fine_grained_gaussian_process_forcasting_torch.data import (
    manifest as tman,
)
from fine_grained_gaussian_process_forcasting_torch.data.download import (
    main as torch_download,
)
from fine_grained_gaussian_process_forcasting_tpu.data import (
    manifest as jman,
)
from fine_grained_gaussian_process_forcasting_tpu.data.download import (
    main as jax_download,
)
from fine_grained_gaussian_process_forcasting_tpu.data.synthetic import (
    make_synthetic_frame,
)

PACKAGES = (jman, tman)


@pytest.fixture(autouse=True)
def _pins_in_tmp(tmp_path, monkeypatch):
    monkeypatch.setenv("FGP_MANIFEST_PINS", str(tmp_path / "env_pins.json"))


@pytest.fixture()
def solar_csv(tmp_path):
    frame = make_synthetic_frame("solar", num_entities=2,
                                 steps_per_entity=50, seed=0)
    path = tmp_path / "solar.csv"
    frame.to_csv(path, index=False)
    return str(path)


def _both(fn):
    """``fn(module, store)`` for each package, a fresh pin store each
    at one path (the reports and messages name it)."""
    out = []
    for module in PACKAGES:
        store = os.environ["FGP_MANIFEST_PINS"] + ".run"
        if os.path.exists(store):
            os.remove(store)
        out.append(fn(module, store))
    return out


def _message(fn, *args, **kw):
    with pytest.raises(ValueError) as info:
        fn(*args, **kw)
    return str(info.value)


@pytest.mark.parametrize("experiment", sorted(jman.SHA256))
def test_expected_columns_match(experiment):
    assert tman.expected_columns(experiment) == jman.expected_columns(
        experiment)
    assert tman.SHA256 == jman.SHA256


def test_expected_columns_match_formatter():
    cols = tman.expected_columns("solar")
    assert "Power(MW)" in cols and "id" in cols
    assert tman.expected_columns("weather") == []


def test_verify_csv_passes_on_schema_match(solar_csv):
    want, got = _both(lambda m, store: m.verify_csv("solar", solar_csv,
                                                    pin_store=store))
    assert got == want
    assert got["columns_ok"] and len(got["sha256"]) == 64
    assert got["pin_origin"] == "captured_now"
    assert got["sha256_pinned"] == got["sha256"]


def test_verify_csv_trust_on_first_use_catches_drift(solar_csv, tmp_path):
    drifted = tmp_path / "drifted.csv"
    drifted.write_bytes(open(solar_csv, "rb").read() + b"\n")

    def run(m, store):
        first = m.verify_csv("solar", solar_csv, pin_store=store)
        again = m.verify_csv("solar", solar_csv, pin_store=store)
        with open(store) as f:
            pins = json.load(f)
        error = _message(m.verify_csv, "solar", str(drifted),
                         pin_store=store)
        return first, again, pins, error

    want, got = _both(run)
    assert got == want
    assert got[1]["pin_origin"] == "first_use_store"
    assert got[1]["sha256_pinned"] == got[0]["sha256"]
    assert "differs from the previously" in got[3]


def test_verify_csv_rejects_missing_columns(tmp_path, solar_csv):
    bad = pd.read_csv(solar_csv).drop(columns=["Power(MW)"])
    bad_path = tmp_path / "bad.csv"
    bad.to_csv(bad_path, index=False)
    # an unnamed index and repeated names, as pandas names them
    odd_path = tmp_path / "odd.csv"
    bad.rename(columns={"hour": "id", "capacity": "id"}).to_csv(odd_path)
    for path in (bad_path, odd_path):
        want, got = (_message(m.verify_csv, "solar", str(path))
                     for m in PACKAGES)
        assert got == want
        assert "Power(MW)" in got
    assert "'Unnamed: 0'" in got and "'id.1'" in got
    want, got = (_message(m.verify_csv, "solar", str(tmp_path / "none.csv"))
                 for m in PACKAGES)
    assert got == want


def test_verify_csv_rejects_checksum_mismatch(solar_csv, monkeypatch):
    for m in PACKAGES:
        monkeypatch.setitem(m.SHA256, "solar", "0" * 64)
    want, got = (_message(m.verify_csv, "solar", solar_csv)
                 for m in PACKAGES)
    assert got == want
    assert "sha256" in got and "(origin: code)" in got


def test_install_local_csv_via_download_cli(solar_csv, tmp_path,
                                            monkeypatch):
    outs = []
    for name, main in (("jax", jax_download), ("torch", torch_download)):
        monkeypatch.setenv("FGP_MANIFEST_PINS", str(tmp_path / f"{name}.json"))
        out = main(["--expt_name", "solar", "--from_local_csv", solar_csv,
                    "--output_folder", str(tmp_path / name)])
        assert os.path.exists(out)
        assert out.endswith(os.path.join("solar", "solar.csv"))
        outs.append(out)
        with open(tmp_path / f"{name}.json") as f:
            assert list(json.load(f)) == ["solar"]
    assert open(outs[0], "rb").read() == open(outs[1], "rb").read()
    assert pd.read_csv(outs[1]).shape[0] > 0


def test_manifest_cli_matches(solar_csv, capsys):
    """``manifest verify`` and ``manifest pin`` print the same lines."""
    printed = []
    for m in PACKAGES:
        store = os.environ["FGP_MANIFEST_PINS"]
        if os.path.exists(store):
            os.remove(store)
        m.main(["verify", "solar", solar_csv])
        m.main(["pin", "solar", solar_csv])
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1]
    report = json.loads(printed[1].splitlines()[0])
    assert report["pin_origin"] == "captured_now"
    assert printed[1].splitlines()[1] == (
        f'    "solar": "{report["sha256"]}",')
