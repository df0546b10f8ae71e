"""The port's multi-seed harness, the CLI's ``--multiseed True`` and
``train/evaluate_checkpoints.py``: against sequential single-seed
harnesses, on a restart, and against the JAX package's
``evaluate_checkpoints`` on the same parameters.

At a test's size: d_model 16, one layer, 16 inducing points, a few dozen
windows of synthetic solar, the port on the CPU.
"""

import os
import random

import jax
import numpy as np
import pytest
import torch

from fine_grained_gaussian_process_forcasting_tpu.data import (
    synthetic as jsyn,
)
from fine_grained_gaussian_process_forcasting_tpu.models import (
    forecast_denoising as jfd,
)
from fine_grained_gaussian_process_forcasting_tpu.train import (
    checkpoint as jcheckpoint,
)
from fine_grained_gaussian_process_forcasting_tpu.train import (
    evaluate_checkpoints as jeval,
)
from fine_grained_gaussian_process_forcasting_tpu.train.trainer import (
    Trainer as JTrainer,
)
from fine_grained_gaussian_process_forcasting_torch.data import (
    synthetic as tsyn,
)
from fine_grained_gaussian_process_forcasting_torch.params import from_flax
from fine_grained_gaussian_process_forcasting_torch.train import cli as tcli
from fine_grained_gaussian_process_forcasting_torch.train import (
    harness as tharness,
)
from fine_grained_gaussian_process_forcasting_torch.train import (
    evaluate_checkpoints as teval,
)
from fine_grained_gaussian_process_forcasting_torch.train import (
    multiseed as tmultiseed,
)
from fine_grained_gaussian_process_forcasting_torch.train.checkpoint import (
    save_checkpoint,
)

# the JAX package's tolerance for a multi-seed harness against sequential
# ones (tests/test_multiseed.py); the port against the JAX package on the
# same parameters, fp32 forward only
RTOL_MS, ATOL_MS = 2e-4, 2e-5
TOL_JAX = 1e-4
FRAME = dict(num_entities=4, steps_per_entity=600, seed=0)
ARGS = dict(exp_name="solar", model_name="ms", attn_type="basic",
            pred_len=8, n_trials=1, num_epochs=2, d_model_choices=(16,),
            stack_choices=(1,), num_inducing=16, gp_ls_init=-1.0,
            w_steps_choices=(100,), max_train_samples=32,
            max_valid_samples=16)
SEEDS = (11, 23)
CLI_ARGS = ["--exp_name", "solar", "--attn_type", "ATA", "--model_name",
            "ATA", "--denoising", "True", "--gp", "True", "--synthetic",
            "--pred_len", "8", "--d_model_choices", "16", "--stack_choices",
            "1", "--n_trials", "1", "--num_epochs", "2",
            "--num_inducing", "16", "--max_train_samples", "32",
            "--max_valid_samples", "16"]


@pytest.fixture(autouse=True)
def one_thread():
    """These models are a few thousand parameters: one intra-op thread runs
    them as fast as many, and keeps them from contending with the suite's
    other workers for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _args(out_dir, seed=SEEDS[0], **kw):
    return tharness.HarnessArgs(**{**ARGS, **kw, "seed": seed,
                                   "out_dir": str(out_dir)})


def _frame():
    return tsyn.make_synthetic_frame("solar", **FRAME)


def test_cli_multiseed_end_to_end(tmp_path):
    """``--multiseed True --n_seeds 2`` trains the two seeds as one group
    and writes each seed's checkpoint, loss curves, predictions and CSV
    row; it returns a result per seed."""
    results = tcli.main(CLI_ARGS + ["--multiseed", "True", "--n_seeds", "2",
                                    "--out_dir", str(tmp_path)],
                        device="cpu")
    assert len(results) == 2
    assert all(np.isfinite(r["mse"]) and np.isfinite(r["mae"])
               for r in results)
    rng = random.Random(1234)  # the CLI's seeds, as the reference draws them
    names = [f"ATA_solar_8_{rng.randint(1000, 9999)}_denoise_gp"
             for _ in range(2)]
    for name in names:
        assert (tmp_path / "models_solar_8" / name).exists()
        assert (tmp_path / "solar" / f"{name}.npz").exists()
        for curve in ("train", "valid"):
            got = np.load(tmp_path / "losses_lists"
                          / f"{name}_mse_losses_{curve}.npy")
            assert got.shape == (2,) and np.isfinite(got).all()
    lines = (tmp_path / "reported_errors_solar.csv").read_text().splitlines()
    assert lines[0] == ",MSE,MAE"
    assert [line.split(",")[0] for line in lines[1:]] == names


def test_multiseed_harness_matches_sequential_harnesses(tmp_path):
    """The multi-seed harness == N sequential ``ExperimentHarness`` runs
    with the same seeds: each seed's evaluation, best validation loss and
    loss curves."""
    frame = _frame()
    ms = tharness.MultiSeedExperimentHarness(frame, _args(tmp_path / "ms"),
                                             seeds=SEEDS, device="cpu")
    ms.run_study()
    ms_results = ms.evaluate()
    assert len(ms_results) == len(SEEDS)
    for i, seed in enumerate(SEEDS):
        single = tharness.ExperimentHarness(
            frame, _args(tmp_path / f"seq{seed}", seed=seed), device="cpu")
        single.run_study()
        want = single.evaluate()
        np.testing.assert_allclose(ms_results[i]["mse"], want["mse"],
                                   rtol=RTOL_MS, atol=ATOL_MS)
        np.testing.assert_allclose(ms.best_val_seed[i], single.best_val,
                                   rtol=RTOL_MS, atol=ATOL_MS)
        name = ms._name_for_seed(seed)
        assert name == single.model_name
        for curve in ("train", "valid"):
            got, ref = (np.load(d / "losses_lists"
                                / f"{name}_mse_losses_{curve}.npy")
                        for d in (tmp_path / "ms", tmp_path / f"seq{seed}"))
            np.testing.assert_allclose(got, ref, rtol=RTOL_MS, atol=ATOL_MS)
        assert (tmp_path / "ms" / "models_solar_8" / name).exists()


def test_multiseed_study_resumes_from_its_state(tmp_path, monkeypatch):
    """A restarted multi-seed study skips its finished trial, restores each
    seed's best value and configuration, and evaluates from the
    checkpoints."""
    frame = _frame()
    first = tharness.MultiSeedExperimentHarness(frame, _args(tmp_path),
                                                seeds=SEEDS, device="cpu")
    first.run_study()
    want = first.evaluate()

    def no_training(*a, **kw):
        raise AssertionError("a completed trial was trained again")

    monkeypatch.setattr(tmultiseed.MultiSeedTrainer, "train_epoch",
                        no_training)
    again = tharness.MultiSeedExperimentHarness(frame, _args(tmp_path),
                                                seeds=SEEDS, device="cpu")
    assert again.best_val_seed == first.best_val_seed
    assert again.best_config_seed == first.best_config_seed == [(16, 1)] * 2
    again.run_study()
    got = again.evaluate()
    assert [r["mse"] for r in got] == [r["mse"] for r in want]


def test_evaluate_checkpoints_roundtrip(tmp_path):
    """Train -> checkpoint -> reload through the evaluator -> figures; a
    run-labelled prefix resolves its checkpoints, and a width the checkpoint
    does not have is skipped (tests/test_harness_surfaces.py)."""
    seed = 77
    harness = tharness.ExperimentHarness(
        _frame(), _args(tmp_path, seed=seed, model_name="basic",
                        num_epochs=1), device="cpu")
    harness.run_study()
    eval_kw = dict(exp_name="solar", pred_len=8, seeds=(seed,),
                   attn_types=("basic",), stack_sizes=(1,), denoising=True,
                   gp=True, out_dir=str(tmp_path), num_inducing=16,
                   max_samples=16, batch_size=8)
    results = teval.evaluate_checkpoints(
        _frame(), teval.EvalArgs(d_models=(16,), **eval_kw), device="cpu")
    assert len(results) == 1
    r = next(iter(results.values()))
    assert r["per_step_mse"].shape == (8,)
    assert np.isfinite(r["mse"]) and np.isfinite(r["mae"])
    p1 = teval.plot_per_step_errors(results, "solar", str(tmp_path))
    p2 = teval.plot_forecasts(results, "solar", str(tmp_path))
    assert os.path.exists(p1) and os.path.exists(p2)
    results = teval.evaluate_checkpoints(
        _frame(), teval.EvalArgs(d_models=(16, 32), model_prefix="basic",
                                 **eval_kw), device="cpu")
    assert len(results) == 1 and "_d16_" in next(iter(results))
    assert teval.evaluate_checkpoints(
        _frame(), teval.EvalArgs(d_models=(16,), **dict(eval_kw, seeds=(5,))),
        device="cpu") == {}


def test_evaluate_checkpoints_matches_jax(tmp_path):
    """The port's evaluator against the JAX package's on the same
    parameters, each saved as its package saves them: the same names and
    the same per-step MSE and MAE."""
    seed, d_model = 8220, 16
    kw = dict(exp_name="solar", pred_len=8, seeds=(seed,),
              attn_types=("basic",), d_models=(d_model,), stack_sizes=(1,),
              denoising=True, gp=True, num_inducing=16, max_samples=16,
              batch_size=8)
    args = jeval.EvalArgs(out_dir=str(tmp_path / "jax"), **kw)
    name = jeval._model_name(args, "basic", seed)
    assert teval._model_name(teval.EvalArgs(**kw), "basic", seed) == name
    model = jfd.ForecastDenoising(
        src_input_size=5, tgt_input_size=5, d_model=d_model, n_heads=4,
        d_k=4, stack_size=1, pred_len=8, attn_type="basic", gp=True,
        denoise=True, num_inducing=16)
    enc = np.zeros((2, 24, 5), np.float32)
    state = JTrainer(model, d_model=d_model).init_state(
        jax.random.PRNGKey(3), enc, enc[:, :16], np.zeros((2, 8, 1),
                                                          np.float32))
    params = jax.device_get(state.params)
    for out in ("jax", "torch"):
        os.makedirs(tmp_path / out / "models_solar_8")
    jcheckpoint.save_checkpoint(str(tmp_path / "jax" / "models_solar_8"),
                                name, params)
    save_checkpoint(str(tmp_path / "torch" / "models_solar_8"), name,
                    from_flax(jax.tree_util.tree_map(np.asarray, params)))
    want = jeval.evaluate_checkpoints(
        jsyn.make_synthetic_frame("solar", **FRAME), args)
    got = teval.evaluate_checkpoints(
        _frame(), teval.EvalArgs(out_dir=str(tmp_path / "torch"), **kw),
        device="cpu")
    assert list(got) == list(want) == [f"{name}_d16_s1"]
    g, w = got[f"{name}_d16_s1"], want[f"{name}_d16_s1"]
    np.testing.assert_array_equal(g["test_y"], w["test_y"])
    np.testing.assert_allclose(g["per_step_mse"], w["per_step_mse"],
                               rtol=TOL_JAX)
    np.testing.assert_allclose(g["per_step_mae"], w["per_step_mae"],
                               rtol=TOL_JAX)


def test_plots_need_matplotlib(monkeypatch):
    """Where matplotlib is missing (the card's machine), a figure raises a
    clear ImportError."""
    import builtins

    real = builtins.__import__

    def no_matplotlib(name, *a, **kw):
        if name.startswith("matplotlib"):
            raise ImportError("no module named matplotlib")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    result = {"m": {"per_step_mse": np.ones(3), "predictions": np.ones(
        (1, 1, 3)), "test_y": np.ones((1, 1, 3))}}
    with pytest.raises(ImportError, match="need matplotlib"):
        teval.plot_per_step_errors(result, "solar")
    with pytest.raises(ImportError, match="need matplotlib"):
        teval.plot_forecasts(result, "solar")
    assert teval.plot_forecasts({}, "solar") is None


@pytest.mark.parametrize("flags", [
    ["--backbone", "lstm"],
    ["--gp_kind", "exact", "--exact_noise_init", "0.1"]],
    ids=["lstm", "exact"])
def test_cli_multiseed_takes_the_lifted_options(tmp_path, flags):
    """``--multiseed True`` with the LSTM backbone and with the exact GP:
    the two seeds train as one group, end to end, each with its checkpoint
    and CSV row and finite test errors."""
    results = tcli.main(CLI_ARGS + flags + [
        "--multiseed", "True", "--n_seeds", "2", "--out_dir",
        str(tmp_path)], device="cpu")
    assert len(results) == 2
    assert all(np.isfinite(r["mse"]) and np.isfinite(r["mae"])
               for r in results)
    assert len(list((tmp_path / "models_solar_8").iterdir())) == 2
    lines = (tmp_path / "reported_errors_solar.csv").read_text().splitlines()
    assert len(lines) == 3


def test_multiseed_harness_with_hidden_layers_matches_sequential(tmp_path):
    """A lifted option through the harness: hidden GP layers on the rbf
    route (each seed's eps from its own generator), the multi-seed harness
    against sequential ``ExperimentHarness`` runs of the same seeds."""
    frame = _frame()
    kw = dict(gp_hidden_dims=(3,), use_pallas_gp=True, num_epochs=1)
    ms = tharness.MultiSeedExperimentHarness(
        frame, _args(tmp_path / "ms", **kw), seeds=SEEDS, device="cpu")
    ms.run_study()
    ms_results = ms.evaluate()
    for i, seed in enumerate(SEEDS):
        single = tharness.ExperimentHarness(
            frame, _args(tmp_path / f"seq{seed}", seed=seed, **kw),
            device="cpu")
        single.run_study()
        want = single.evaluate()
        np.testing.assert_allclose(ms_results[i]["mse"], want["mse"],
                                   rtol=RTOL_MS, atol=ATOL_MS)
        np.testing.assert_allclose(ms.best_val_seed[i], single.best_val,
                                   rtol=RTOL_MS, atol=ATOL_MS)
