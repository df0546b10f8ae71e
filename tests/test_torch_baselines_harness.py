"""PyTorch port vs the JAX package: ``BaselinesHarness``, one study of each
baseline (DLinear, NBeats, DeepAR, CMGP) at a test's size.

Both harnesses window the same synthetic electricity frame with the loader
cut to one batch of 16 (each harness takes the loader's defaults, so each
one's ``UnivariateLoader`` is handed the sizes), history 48, horizon 8, 1
trial and 2 epochs.  They start from the same parameters: each JAX model's Flax
``init`` is wrapped to record what it returns, and the port's model is
loaded with them through ``params.from_flax``.  DeepAR's test samples take
JAX's own normal draws (``PRNGKey(i)`` for batch i, split as
``DeepAR.sample`` splits it).  JAX's per-epoch losses are read from the
epoch functions its harness jits.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from fine_grained_gaussian_process_forcasting_tpu.data import (
    synthetic as jsyn,
)
from fine_grained_gaussian_process_forcasting_tpu.data import (
    univariate as juni,
)
from fine_grained_gaussian_process_forcasting_tpu.models import (
    cmgp as jcmgp,
    deepar as jdeepar,
    dlinear as jdlinear,
    nbeats as jnbeats,
)
from fine_grained_gaussian_process_forcasting_tpu.train import (
    baselines_harness as jharness,
)
from fine_grained_gaussian_process_forcasting_torch.data import (
    synthetic as tsyn,
)
from fine_grained_gaussian_process_forcasting_torch.data import table
from fine_grained_gaussian_process_forcasting_torch.data import (
    univariate as tuni,
)
from fine_grained_gaussian_process_forcasting_torch.params import from_flax
from fine_grained_gaussian_process_forcasting_torch.train import (
    baselines_harness as tharness,
)

# per-epoch loss sums, best validation loss and test errors of the same
# model trained 2 steps from the same parameters in fp32 by two
# frameworks: 1e-4 relative
TOL = 1e-4
MODELS = ("DLinear", "NBeats", "DeepAR", "CMGP")
JAX_MODELS = {"DLinear": jdlinear.DLinear, "NBeats": jnbeats.NBeats,
              "DeepAR": jdeepar.DeepAR, "CMGP": jcmgp.CMGP}
ARGS = dict(exp_name="electricity", pred_len=8, seed=7, n_trials=1,
            num_epochs=2, max_encoder_length=48)
LOADER = dict(batch_size=16, max_train_sample=16, max_test_sample=16)
FRAME = dict(num_entities=3, steps_per_entity=400, seed=3)


def _jax_draws(batch, b, pred_len):
    """The normal draws JAX's ``DeepAR.sample`` takes for test batch
    ``batch`` of its harness, as (1, pred_len, b)."""
    (key,) = jax.random.split(jax.random.PRNGKey(batch), 1)
    keys = jax.random.split(key, pred_len)
    return np.stack([np.asarray(jax.random.normal(k, (b,)))
                     for k in keys])[None]


class _EpochRecorder:
    """Stands in for ``jax`` inside JAX's harness module: its ``jit`` keeps
    what the jitted epoch functions return."""

    def __init__(self, log):
        self._log = log

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn):
        compiled = jax.jit(fn)

        def run(*args):
            out = compiled(*args)
            loss = out[2] if fn.__name__ == "train_epoch" else out
            self._log.append((fn.__name__, float(loss)))
            return out

        return run


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    """One study of each model on each side, from the same parameters."""
    recorded, jax_epochs = {}, {}
    mp = pytest.MonkeyPatch()

    def recording_init(name, original):
        def init(self, *a, **kw):
            variables = original(self, *a, **kw)
            recorded[name] = jax.device_get(variables["params"])
            return variables
        return init

    for name, cls in JAX_MODELS.items():
        mp.setattr(cls, "init", recording_init(name, cls.init))
    mp.setattr(jharness, "UnivariateLoader",
               functools.partial(juni.UnivariateLoader, **LOADER))
    mp.setattr(tharness, "UnivariateLoader",
               functools.partial(tuni.UnivariateLoader, **LOADER))

    port_make = tharness.BaselinesHarness._make_model

    def from_jax(self, d_model, stack_size):
        model = port_make(self, d_model, stack_size)
        model.load_state_dict(from_flax(recorded[self.model_id]))
        return model

    mp.setattr(tharness.BaselinesHarness, "_make_model", from_jax)
    mp.setattr(tharness.BaselinesHarness, "deepar_eps",
               lambda self, batch, b: torch.from_numpy(
                   _jax_draws(batch, b, self.pred_len)))
    jdir = tmp_path_factory.mktemp("jax")
    tdir = tmp_path_factory.mktemp("torch")
    runs = {}
    try:
        for name in MODELS:
            log = jax_epochs.setdefault(name, [])
            mp.setattr(jharness, "jax", _EpochRecorder(log))
            jh = jharness.BaselinesHarness(
                jsyn.make_synthetic_frame("electricity", **FRAME),
                jharness.BaselineArgs(**ARGS, model_name=name,
                                      out_dir=str(jdir)))
            jh.run_study()
            jres = jh.evaluate()
            th = tharness.BaselinesHarness(
                tsyn.make_synthetic_frame("electricity", **FRAME),
                tharness.BaselineArgs(**ARGS, model_name=name,
                                      out_dir=str(tdir)), device="cpu")
            th.run_study()
            tres = th.evaluate()
            runs[name] = (jh, jres, th, tres)
    finally:
        mp.undo()
    return runs, jax_epochs, jdir, tdir


@pytest.mark.parametrize("name", MODELS)
def test_baselines_windows_and_names_match_jax(both_runs, name):
    jh, _, th, _ = both_runs[0][name]
    assert th.model_name == jh.model_name == f"{name}_electricity_7_8"
    for split in ("train_loader", "valid_loader", "test_loader"):
        for part in ("x_enc", "x_dec", "y"):
            got = getattr(getattr(th.loader, split), part)
            want = getattr(getattr(jh.loader, split), part)
            assert got.shape[:2] == (1, 16)
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", MODELS)
def test_baselines_epoch_losses_match_jax(both_runs, name):
    """Each epoch's train and valid loss sums, and the best validation
    loss, within TOL."""
    runs, jax_epochs, _, _ = both_runs
    jh, _, th, _ = runs[name]
    log = jax_epochs[name]
    # JAX calls each epoch function once an epoch
    want = np.array([[v for f, v in log if f == fn]
                     for fn in ("train_epoch", "valid_epoch")]).T
    got = np.array([(t, v) for _, _, t, v in th.epoch_losses])
    assert got.shape == want.shape == (2, 2)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=TOL)
    np.testing.assert_allclose(th.best_val, jh.best_val, rtol=TOL)
    assert set(from_flax(jax.device_get(jh.best_params))) == set(
        th.best_params)


@pytest.mark.parametrize("name", MODELS)
def test_baselines_evaluation_matches_jax(both_runs, name):
    _, jres, _, tres = both_runs[0][name]
    np.testing.assert_allclose(tres["mse"], jres["mse"], rtol=TOL)
    np.testing.assert_allclose(tres["mae"], jres["mae"], rtol=TOL)
    assert tres["predictions"].shape == (1, 16, 8, 1)
    assert np.isfinite(tres["predictions"]).all()


def test_baselines_error_csv_equals_jax(both_runs):
    """The four studies' ``Previous_set_up_Final_errors_electricity.csv``:
    the same text, the earlier rows rewritten as pandas rewrites them."""
    _, _, jdir, tdir = both_runs
    name = "Previous_set_up_Final_errors_electricity.csv"
    want = (jdir / name).read_text()
    assert (tdir / name).read_text() == want
    assert len(want.splitlines()) == 1 + len(MODELS)
    assert (tdir / "models_electricity_8" / "CMGP_electricity_7_8").exists()


def test_errors_csv_rewrites_numbers_as_pandas(tmp_path):
    """Four appends of numeric errors (the baselines' format) through the
    port and through pandas: the same file after each."""
    ours, theirs = tmp_path / "ours.csv", tmp_path / "theirs.csv"
    for name, mse, mae in (("A", 0.25, 0.1234), ("B", 1.5, 12.0),
                           ("C", 0.1004, -0.3), ("D", 3.0, 1e-4)):
        errors = {"MSE": f"{mse:.3f}", "MAE": f"{mae: .3f}"}
        table.append_errors_csv(str(ours), name, errors)
        df = pd.DataFrame.from_dict({name: errors}, orient="index")
        if theirs.exists():
            df = pd.concat([pd.read_csv(theirs, index_col=0), df], axis=0)
        df.to_csv(theirs)
        assert ours.read_text() == theirs.read_text()
