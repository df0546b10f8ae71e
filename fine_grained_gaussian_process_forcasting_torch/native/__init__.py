"""ctypes bindings for the native (C++) host-side data engine: the port's
own copy of the JAX package's ``native/``.

``fgp_native.cpp`` is compiled once with the system g++ into
``build/native/libfgp_native-<source hash>.so`` at the root of the checkout
(never beside the source), written under a name of its own process and
renamed into place, so that parallel test workers never load a
half-written library.  Every entry point has a numpy version, its plain
version, which runs where no toolchain is found or with
``FGP_DISABLE_NATIVE=1``; ``available()`` says which one runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "fgp_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "native")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libfgp_native-{digest}.so")


def _build(path: str) -> bool:
    # Compile to a process-unique temp path and rename into place (rename
    # is atomic on the same filesystem) so concurrent importers — parallel
    # pytest, multi-process data prep — never load a half-written .so.
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
        _SRC, "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.rename(tmp, path)
        return True
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("FGP_DISABLE_NATIVE") == "1":
        return None
    path = _lib_path()
    if not os.path.exists(path) and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None

    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.fgp_gather_windows.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_int64, i64p, ctypes.c_int64,
        ctypes.c_int64, f32p,
    ]
    lib.fgp_standardize_per_entity.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_int64, i64p, ctypes.c_int64,
        f32p, f32p,
    ]
    lib.fgp_valid_window_starts.argtypes = [
        i64p, ctypes.c_int64, ctypes.c_int64, i64p,
    ]
    lib.fgp_valid_window_starts.restype = ctypes.c_int64
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def gather_windows(values: np.ndarray, starts: np.ndarray,
                   time_steps: int) -> np.ndarray:
    """values: (rows, cols) f32 C-contig; starts: (n,) int64 ->
    (n, time_steps, cols) f32."""
    values = np.ascontiguousarray(values, dtype=np.float32)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    n = len(starts)
    out = np.empty((n, time_steps, values.shape[1]), dtype=np.float32)
    lib = _load()
    if lib is None:
        idx = starts[:, None] + np.arange(time_steps, dtype=np.int64)[None, :]
        out[:] = values[idx]
        return out
    lib.fgp_gather_windows(
        _f32p(values), values.shape[0], values.shape[1], _i64p(starts), n,
        time_steps, _f32p(out),
    )
    return out


def standardize_per_entity(
    values: np.ndarray, offsets: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """In-place per-entity z-score over row runs [offsets[e], offsets[e+1]).

    Returns (values, means, stds); sklearn StandardScaler semantics
    (ddof=0, zero-variance columns left unscaled)."""
    values = np.ascontiguousarray(values, dtype=np.float32)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n_entities = len(offsets) - 1
    means = np.empty((n_entities, values.shape[1]), dtype=np.float32)
    stds = np.empty((n_entities, values.shape[1]), dtype=np.float32)
    lib = _load()
    if lib is None:
        for e in range(n_entities):
            lo, hi = offsets[e], offsets[e + 1]
            mu = values[lo:hi].mean(axis=0)
            sd = values[lo:hi].std(axis=0)
            sd = np.where(sd == 0.0, 1.0, sd)
            means[e], stds[e] = mu, sd
            values[lo:hi] = (values[lo:hi] - mu) / sd
        return values, means, stds
    lib.fgp_standardize_per_entity(
        _f32p(values), values.shape[0], values.shape[1], _i64p(offsets),
        n_entities, _f32p(means), _f32p(stds),
    )
    return values, means, stds


def valid_window_starts(offsets: np.ndarray, time_steps: int) -> np.ndarray:
    """All window start rows across entity runs (the start enumeration of
    ``data/window.py``'s ``_entity_windows``)."""
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n_entities = len(offsets) - 1
    upper = int(offsets[-1])
    out = np.empty(max(upper, 1), dtype=np.int64)
    lib = _load()
    if lib is None:
        starts = []
        for e in range(n_entities):
            lo, hi = int(offsets[e]), int(offsets[e + 1])
            if hi - lo >= time_steps:
                starts.append(np.arange(lo, hi - time_steps + 1))
        return (np.concatenate(starts) if starts
                else np.zeros(0, dtype=np.int64))
    k = lib.fgp_valid_window_starts(_i64p(offsets), n_entities, time_steps,
                                    _i64p(out))
    return out[:k].copy()
