"""Checksum + schema manifest for the dataset CSVs: the port's own copy of
the JAX package's ``data/manifest.py``, without pandas.

- ``verify_csv(experiment, path)`` validates the header against the
  experiment's formatter column definition (the schema every downstream
  layer assumes) and checks the file's sha256 against its pin.
- ``python -m fine_grained_gaussian_process_forcasting_torch.data.download
  --expt_name solar --from_local_csv f.csv`` verifies and installs a
  user-supplied csv into the experiment layout without network access.

Pinning, as in the JAX package: the upstream projects publish no sha256 of
the *processed* per-experiment csvs (they are products of the ETL in
``data/download.py``), so ``verify_csv`` records a **trust-on-first-use**
pin: the first schema-verified file per experiment has its sha256 captured
into the pin store (``.manifest_pins.json`` at the root of the checkout,
or ``$FGP_MANIFEST_PINS``), and every later verification checks against
it.  A code-level pin in ``SHA256`` (printed by ``manifest pin``) always
takes precedence over the store.  The schema check applies, pin or no pin.

CLI:  python -m fine_grained_gaussian_process_forcasting_torch.data.manifest
          verify|pin <experiment> <csv>
"""

from __future__ import annotations

import csv
import hashlib
import json
import os
from typing import Dict, List, Optional

# Pinned sha256 of the PROCESSED per-experiment csv (the output of the ETL
# in data/download.py).  None = not yet pinned; fill via ``pin`` on a
# machine that has the data and later runs become byte-verified.
SHA256: Dict[str, Optional[str]] = {
    "electricity": None,
    "traffic": None,
    "solar": None,
    "air_quality": None,
    "watershed": None,
    "covid": None,
    "exchange": None,
    "weather": None,
    "ETTm2": None,
    "camel": None,
    "favorita": None,
}


def expected_columns(experiment: str) -> List[str]:
    """Column names the experiment's formatter requires, from its
    ``_column_definition`` (Utils/base.py:41-148 equivalent)."""
    from fine_grained_gaussian_process_forcasting_torch.data.experiment import (
        ExperimentConfig,
    )

    config = ExperimentConfig.__new__(ExperimentConfig)
    config.experiment = experiment
    config.pred_len = 24  # formatters only read it for windowing params,
    # which never touch the column definition
    try:
        formatter = ExperimentConfig.make_data_formatter(config)
    except ValueError:
        # experiments with an ETL handler but no formatter (the reference
        # defines none either) have no schema contract to enforce
        return []
    return [t[0] for t in formatter.get_column_definition()]


def _default_pin_store() -> str:
    env = os.environ.get("FGP_MANIFEST_PINS")
    if env:
        return env
    # the checkout's root: two levels above this package's data/ dir
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), ".manifest_pins.json")


def _load_pins(store: str) -> Dict[str, str]:
    if os.path.exists(store):
        with open(store) as f:
            return json.load(f)
    return {}


def _save_pin(store: str, experiment: str, digest: str) -> None:
    pins = _load_pins(store)
    pins[experiment] = digest
    tmp = store + ".tmp"
    with open(tmp, "w") as f:
        json.dump(pins, f, indent=2, sort_keys=True)
    os.replace(tmp, store)  # atomic: no torn pin file on crash


def file_sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def read_header(path: str) -> List[str]:
    """The column names ``pandas.read_csv(path, nrows=0).columns`` gives:
    the first row that is not blank, an empty name ``Unnamed: {i}``, and
    repeats renamed as pandas' C parser renames them (named columns before
    unnamed ones; ``a``, ``a.1``, ``a.2``, ..., past the names the row
    already holds)."""
    with open(path, newline="") as f:
        header = next((r for r in csv.reader(f) if r), [])
    unnamed = set()
    for i, name in enumerate(header):
        if name == "":
            header[i] = f"Unnamed: {i}"
            unnamed.add(header[i])
    counts: Dict[str, int] = {}
    order = ([i for i, c in enumerate(header) if c not in unnamed]
             + [i for i, c in enumerate(header) if c in unnamed])
    for i in order:
        col = old = header[i]
        cur = counts.get(col, 0)
        while cur > 0:
            counts[old] = cur + 1
            col = f"{old}.{cur}"
            cur = cur + 1 if col in header else counts.get(col, 0)
        header[i] = col
        counts[col] = cur + 1
    return header


def verify_csv(experiment: str, path: str,
               pin_store: Optional[str] = None) -> dict:
    """Validate a csv against the manifest.

    Always checks the header contains every formatter-required column.
    Checksum policy: a code-level pin (``SHA256``) is authoritative;
    otherwise the trust-on-first-use store applies — the first verified
    file per experiment captures its sha256 there, and later runs must
    match it (tamper/drift-evident from the second run on).  Returns a
    report dict; raises ValueError on any failure with an actionable
    message.
    """
    if not os.path.exists(path):
        raise ValueError(f"{path} does not exist")
    header = read_header(path)
    missing = [c for c in expected_columns(experiment) if c not in header]
    if missing:
        raise ValueError(
            f"{path} is missing required columns for {experiment!r}: "
            f"{missing}. Found: {header}. The formatter "
            "(data/formatters/) cannot run without them — the file is "
            "not the processed per-experiment csv this pipeline expects "
            "(see data/download.py for the ETL that produces it)."
        )
    digest = file_sha256(path)
    store = pin_store or _default_pin_store()
    pinned = SHA256.get(experiment)
    pin_origin = "code" if pinned is not None else None
    if pinned is None:
        pinned = _load_pins(store).get(experiment)
        pin_origin = "first_use_store" if pinned is not None else None
    if pinned is not None and digest != pinned:
        raise ValueError(
            f"{path} sha256 {digest} != pinned {pinned} "
            f"(origin: {pin_origin}) for {experiment!r}. The file differs "
            "from the previously verified copy (source drift, corruption, "
            "or tampering). If the upstream data legitimately changed, "
            f"delete the {experiment!r} entry from {store} (or update "
            "SHA256 in data/manifest.py) and re-verify."
        )
    if pinned is None:
        # trust-on-first-use: capture so every later run is checked
        _save_pin(store, experiment, digest)
        pin_origin = "captured_now"
        pinned = digest
    return {
        "experiment": experiment,
        "path": path,
        "sha256": digest,
        "sha256_pinned": pinned,
        "pin_origin": pin_origin,
        "columns_ok": True,
    }


def install_local_csv(experiment: str, src_path: str,
                      root_folder: Optional[str] = None) -> str:
    """Verify ``src_path`` and copy it into the experiment layout
    (the --from_local_csv bypass for offline machines)."""
    import shutil

    from fine_grained_gaussian_process_forcasting_torch.data.experiment import (
        ExperimentConfig,
    )

    verify_csv(experiment, src_path)
    config = ExperimentConfig(experiment=experiment, root_folder=root_folder)
    if os.path.abspath(src_path) != os.path.abspath(config.data_csv_path):
        shutil.copyfile(src_path, config.data_csv_path)
    return config.data_csv_path


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description="dataset manifest tool")
    sub = parser.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("verify", help="verify a csv against the manifest")
    v.add_argument("experiment")
    v.add_argument("csv")
    p = sub.add_parser("pin", help="print the sha256 line to pin a "
                                   "verified csv into SHA256")
    p.add_argument("experiment")
    p.add_argument("csv")
    args = parser.parse_args(argv)

    if args.cmd == "verify":
        print(json.dumps(verify_csv(args.experiment, args.csv)))
    else:
        digest = file_sha256(args.csv)
        print(f'    "{args.experiment}": "{digest}",')


if __name__ == "__main__":
    main()
