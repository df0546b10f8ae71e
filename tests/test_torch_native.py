"""The port's native data engine (``native/``) against the JAX package's
and against its own numpy versions.

Each entry point on the same inputs: the port's library, JAX's library and
the port's numpy path (``FGP_DISABLE_NATIVE=1``, or no library) give the
same arrays, bit for bit where the work is a copy (windows, starts) and
equal where it is the same C++ arithmetic (the standardization).  The
library is built into ``build/native/``, never beside the source; the
port's windows (``data/window.py``) are bit-equal either way.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from fine_grained_gaussian_process_forcasting_torch import native as tnative
from fine_grained_gaussian_process_forcasting_torch.data import window
from fine_grained_gaussian_process_forcasting_torch.data.synthetic import (
    make_synthetic_frame,
)
from fine_grained_gaussian_process_forcasting_tpu import native as jnative

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def numpy_path(monkeypatch):
    """The port's entry points through their numpy versions."""
    monkeypatch.setattr(tnative, "_load", lambda: None)


def test_native_builds_outside_the_source():
    assert tnative.available()
    path = tnative._lib_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == os.path.join(ROOT, "build", "native")
    src_dir = os.path.dirname(tnative._SRC)
    assert not [f for f in os.listdir(src_dir) if f.endswith(".so")]


def test_disable_native_env():
    """``FGP_DISABLE_NATIVE=1``: no library, the numpy paths, the same
    windows."""
    code = ("import numpy as np; from fine_grained_gaussian_process_"
            "forcasting_torch import native; v = np.arange(40, dtype="
            "np.float32).reshape(10, 4); w = native.gather_windows(v, "
            "np.array([0, 3, 6]), 4); print(native.available(), "
            "float(w.sum()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, FGP_DISABLE_NATIVE="1"),
                         capture_output=True, text=True, check=True)
    values = np.arange(40, dtype=np.float32).reshape(10, 4)
    want = tnative.gather_windows(values, np.array([0, 3, 6]), 4).sum()
    assert out.stdout.split() == ["False", str(float(want))]


@pytest.mark.parametrize("rows, cols, n, steps", [(500, 7, 64, 32),
                                                  (300, 1, 9, 300),
                                                  (50, 3, 0, 5)])
def test_gather_windows_matches(rows, cols, n, steps):
    rng = np.random.default_rng(rows)
    values = rng.normal(size=(rows, cols)).astype(np.float32)
    starts = rng.integers(0, rows - steps + 1, size=n).astype(np.int64)
    got = tnative.gather_windows(values, starts, steps)
    np.testing.assert_array_equal(got, jnative.gather_windows(values, starts,
                                                              steps))
    idx = starts[:, None] + np.arange(steps)
    np.testing.assert_array_equal(got, values[idx])
    # a column-major matrix, as data/table.py lays frames out
    np.testing.assert_array_equal(
        tnative.gather_windows(np.asfortranarray(values), starts, steps), got)


def test_gather_windows_numpy_path(numpy_path):
    rng = np.random.default_rng(3)
    values = rng.normal(size=(300, 5)).astype(np.float32)
    starts = rng.integers(0, 300 - 16, size=32).astype(np.int64)
    np.testing.assert_array_equal(tnative.gather_windows(values, starts, 16),
                                  jnative.gather_windows(values, starts, 16))


def test_standardize_per_entity_matches():
    rng = np.random.default_rng(1)
    values = rng.normal(loc=3.0, scale=2.5, size=(300, 4)).astype(np.float32)
    values[:, 2] = 7.0  # a zero-variance column: left unscaled
    offsets = np.array([0, 120, 300], dtype=np.int64)
    got = tnative.standardize_per_entity(values.copy(), offsets)
    want = jnative.standardize_per_entity(values.copy(), offsets)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for e, (lo, hi) in enumerate([(0, 120), (120, 300)]):
        ref = values[lo:hi].astype(np.float64)
        sd = ref.std(axis=0)
        sd[sd == 0] = 1.0
        np.testing.assert_allclose(got[0][lo:hi], (ref - ref.mean(0)) / sd,
                                   rtol=1e-4, atol=1e-4)


def test_standardize_numpy_path(numpy_path):
    rng = np.random.default_rng(3)
    values = rng.normal(size=(300, 5)).astype(np.float32)
    offsets = np.array([0, 150, 300], dtype=np.int64)
    got = tnative.standardize_per_entity(values.copy(), offsets)
    want = jnative.standardize_per_entity(values.copy(), offsets)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("offsets, steps", [([0, 10, 13, 30], 5),
                                            ([0, 4, 8], 5), ([0, 7], 7)])
def test_valid_window_starts_matches(offsets, steps):
    offsets = np.array(offsets, dtype=np.int64)
    got = tnative.valid_window_starts(offsets, steps)
    np.testing.assert_array_equal(got,
                                  jnative.valid_window_starts(offsets, steps))
    expected = [np.arange(lo, hi - steps + 1)
                for lo, hi in zip(offsets[:-1], offsets[1:])
                if hi - lo >= steps]
    np.testing.assert_array_equal(
        got, np.concatenate(expected) if expected else np.zeros(0, np.int64))


def test_valid_window_starts_numpy_path(numpy_path):
    offsets = np.array([0, 10, 13, 30], dtype=np.int64)
    np.testing.assert_array_equal(tnative.valid_window_starts(offsets, 5),
                                  jnative.valid_window_starts(offsets, 5))


def test_windows_bit_equal_with_and_without_native(monkeypatch):
    """``data/window.py``'s split gathered by the library and by numpy."""
    from fine_grained_gaussian_process_forcasting_torch.data.base import (
        InputTypes,
    )

    frame = make_synthetic_frame("electricity", num_entities=3,
                                 steps_per_entity=120, seed=4)
    columns = [("id", None, "ID"), ("hours_from_start", None, "TIME"),
               ("power_usage", None, "TARGET"), ("hour", None, "KNOWN")]
    kinds = {"ID": InputTypes.ID, "TIME": InputTypes.TIME,
             "TARGET": InputTypes.TARGET,
             "KNOWN": InputTypes.KNOWN_INPUT}
    definition = [(c, d, kinds[k]) for c, d, k in columns]
    args = (frame, 0.8, (40, 16), 48, 24, 12, definition, 8)
    with_lib = window.batch_sampled_data(*args)
    monkeypatch.setattr(tnative, "_load", lambda: None)
    without = window.batch_sampled_data(*args)
    for a, b in zip(with_lib, without):
        for x, y in ((a.enc, b.enc), (a.dec, b.dec), (a.y, b.y)):
            assert x.shape == y.shape and x.size
            np.testing.assert_array_equal(x, y)
