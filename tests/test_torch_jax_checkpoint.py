"""The JAX package's checkpoints carried into the PyTorch port:
``scripts/convert_jax_checkpoints.py`` and ``train/checkpoint.py``'s
``payload_from_jax``, ``opt_state_from_optax`` and ``opt_state_to_optax``.

Each test writes its checkpoints with the JAX package (``save_checkpoint``,
``Trainer.save_state``, a multi-seed harness run, a baselines study) at a
test's size, the flagship family (autoformer + GP + denoise) at d_model 8
with 16 inducing points, converts them with the script's ``convert`` and
holds what the port does with them on the CPU against what the JAX package
does with the originals: serve, resume training, evaluate, forecast.
"""

import ast
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fine_grained_gaussian_process_forcasting_tpu.data import (
    synthetic as jsyn,
)
from fine_grained_gaussian_process_forcasting_tpu.data import (
    univariate as juni,
)
from fine_grained_gaussian_process_forcasting_tpu.models import (
    forecast_denoising as jfd,
)
from fine_grained_gaussian_process_forcasting_tpu.train import (
    baselines_harness as jbaselines,
)
from fine_grained_gaussian_process_forcasting_tpu.train import (
    checkpoint as jcheckpoint,
)
from fine_grained_gaussian_process_forcasting_tpu.train import (
    evaluate_checkpoints as jeval,
)
from fine_grained_gaussian_process_forcasting_tpu.train import (
    harness as jharness,
)
from fine_grained_gaussian_process_forcasting_tpu.train.predict import (
    InferenceSession as JInferenceSession,
)
from fine_grained_gaussian_process_forcasting_tpu.train.schedule import (
    noam_adam as jnoam_adam,
)
from fine_grained_gaussian_process_forcasting_tpu.train.trainer import (
    Trainer as JTrainer,
    TrainState as JTrainState,
)
from fine_grained_gaussian_process_forcasting_torch.data import (
    synthetic as tsyn,
)
from fine_grained_gaussian_process_forcasting_torch.data import (
    univariate as tuni,
)
from fine_grained_gaussian_process_forcasting_torch.models.forecast_denoising import (  # noqa: E501
    ForecastDenoising,
)
from fine_grained_gaussian_process_forcasting_torch.params import to_flax
from fine_grained_gaussian_process_forcasting_torch.train import (
    baselines_harness as tbaselines,
)
from fine_grained_gaussian_process_forcasting_torch.train import (
    evaluate_checkpoints as teval,
)
from fine_grained_gaussian_process_forcasting_torch.train import Trainer
from fine_grained_gaussian_process_forcasting_torch.train.checkpoint import (
    opt_state_from_optax,
    opt_state_to_optax,
    payload_from_jax,
)
from fine_grained_gaussian_process_forcasting_torch.train.predict import (
    InferenceSession,
)

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "convert_jax_checkpoints", ROOT / "scripts" / "convert_jax_checkpoints.py")
convert_script = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(convert_script)

# fp32 through the whole model in two frameworks (tests/test_torch_predict.py
# and tests/test_torch_multiseed_harness.py): 1e-4.  A resumed step: the
# loss, the MSE and the gradient-sized results of tests/test_torch_train.py
TOL = 1e-4
TOL_LOSS = 1e-4
RTOL_GRAD, ATOL_GRAD = 3e-4, 3e-5

F, DM, PRED, ENC_LEN, DEC_LEN, BS, WARMUP = 4, 8, 8, 24, 8, 8, 100
SMALL = dict(src_input_size=F, tgt_input_size=F, d_model=DM, n_heads=2,
             d_k=DM // 2, stack_size=1, pred_len=PRED, num_inducing=16,
             gp_ls_init=-1.0, attn_type="autoformer", gp=True, denoise=True)
NAME = "autoformer_solar_8_7_denoise_gp"
GUARDS = [(0.0, "off"), (0.0, "skip"), (0.5, "off"), (0.5, "skip")]
GUARD_IDS = [f"clip{c}-{g}" for c, g in GUARDS]


@pytest.fixture(autouse=True)
def one_thread():
    """Models of a few thousand parameters: one intra-op thread runs them as
    fast as many, and keeps them from contending with the other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    enc = rng.normal(size=(n, BS, ENC_LEN, F)).astype(np.float32)
    dec = rng.normal(size=(n, BS, DEC_LEN, F)).astype(np.float32)
    y = (0.5 * dec[..., -PRED:, :1]
         + 0.1 * rng.normal(size=(n, BS, PRED, 1))).astype(np.float32)
    return enc, dec, y


@functools.lru_cache(maxsize=None)
def _jax_init():
    """The JAX model's initial parameters, as numpy arrays."""
    enc, dec, y = _batches(1, seed=9)
    keys = {k: jax.random.PRNGKey(i)
            for i, k in enumerate(("params", "noise", "sampling"))}
    # jitted: one compile, where an eager init compiles op by op
    init = jax.jit(jfd.ForecastDenoising(**SMALL).init)
    return jax.tree_util.tree_map(np.asarray, init(keys, enc[0], dec[0],
                                                   y[0])["params"])


def _jax_params():
    """A copy of ``_jax_init``'s parameters, q(u) moved off the prior and
    the ELBO counted (as tests/test_torch_train.py starts), so that every
    GP leaf takes a gradient."""
    params = jax.tree_util.tree_map(np.copy, _jax_init())
    params["lam"] = np.array([0.003], np.float32)
    rng = np.random.default_rng(5)
    layer = params["deep_gp"]["output_layer"]
    for name, scale in (("variational_mean", 0.5),
                        ("variational_log_stddev", 0.3)):
        layer[name] = (scale * rng.normal(size=layer[name].shape)).astype(
            np.float32)
    return params


@functools.lru_cache(maxsize=None)
def _jax_trainer(clip=0.0, guard="off"):
    """One JAX trainer a chain, so that each compiles its epoch once."""
    return JTrainer(jfd.ForecastDenoising(**SMALL), d_model=DM,
                    warmup_steps=WARMUP, clip_grad_norm=clip,
                    nonfinite_guard=guard)


def _jax_start(trainer):
    """A first state of ``trainer``, from ``_jax_params``."""
    params = jax.tree_util.tree_map(jnp.asarray, _jax_params())
    return JTrainState(params=params, opt_state=jax.jit(
        trainer.optimizer.init)(params), rng=jax.random.PRNGKey(0))


def _jax_steps(trainer, state, batches, steps):
    """``steps`` single-batch epochs of the JAX trainer."""
    for i in steps:
        state, _, _ = trainer.train_epoch(
            state, tuple(jnp.asarray(a[i: i + 1]) for a in batches))
    return state


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _assert_trees_equal(got, want):
    """The same paths, dtypes and values, bit for bit."""
    got, want = _leaves(got), _leaves(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))


def _adam(opt_state, clip, guard):
    """scale_by_adam's state and the guard's counters of an optax
    ``noam_adam`` state."""
    counters = None
    if guard == "skip":
        counters = tuple(int(np.asarray(c)) for c in opt_state[:3])
        opt_state = opt_state.inner_state
    if clip:
        opt_state = opt_state[1]
    return opt_state[0], counters


# -- (1) serve -------------------------------------------------------- #

def test_served_checkpoint_matches_jax(tmp_path, capsys):
    """A harness-style checkpoint (parameters only) after 2 JAX steps,
    converted by the script's command line, every name found, served by
    the port's
    ``from_checkpoint``: JAX's ``from_checkpoint`` predictions."""
    trainer = _jax_trainer()
    state = _jax_steps(trainer, _jax_start(trainer), _batches(2, seed=1),
                       range(2))
    params = jax.device_get(state.params)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jcheckpoint.save_checkpoint(jdir, NAME, params)
    assert convert_script.main([jdir, tdir]) == 0  # the CLI, every name
    assert capsys.readouterr().out.split() == [str(tmp_path / "torch"
                                                   / NAME)]
    rng = np.random.default_rng(2)
    enc = rng.normal(size=(21, ENC_LEN, F)).astype(np.float32)
    dec = rng.normal(size=(21, DEC_LEN, F)).astype(np.float32)
    jmodel = jfd.ForecastDenoising(**SMALL)
    want = JInferenceSession.from_checkpoint(jmodel, jdir, NAME, params,
                                             batch_size=BS).predict(enc, dec)
    model = ForecastDenoising(**SMALL, device="cpu")
    got = InferenceSession.from_checkpoint(
        model, tdir, NAME, template_params=model.state_dict(),
        batch_size=BS, device="cpu").predict(enc, dec)
    assert got.shape == want.shape == (21, PRED, 1)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


# -- (2) resume ------------------------------------------------------- #

@pytest.mark.parametrize("clip,guard", GUARDS, ids=GUARD_IDS)
def test_resumed_training_matches_jax(tmp_path, clip, guard):
    """``Trainer.save_state`` after 3 JAX steps (under the skip guard the
    third one non-finite, so dropped), converted: Adam's moments, its count
    and the guard's counters carried exactly, then one step after the
    port's ``restore_state`` equal to one after JAX's."""
    trainer = _jax_trainer(clip, guard)
    state = _jax_start(trainer)
    batches = _batches(4, seed=3)
    if guard == "skip":
        batches[0][2, 0, 0, 0] = np.nan
    state = _jax_steps(trainer, state, batches, range(3))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    trainer.save_state(jdir, NAME, state)
    saved = jax.device_get(state.opt_state)

    model = convert_script.port_model(SMALL)
    convert_script.convert(jdir, tdir, [NAME], model=model,
                           clip_grad_norm=clip, nonfinite_guard=guard)
    port = Trainer(model, DM, warmup_steps=WARMUP, clip_grad_norm=clip,
                   nonfinite_guard=guard, device="cpu")
    restored = port.restore_state(tdir, NAME, port.init_state())

    adam, counters = _adam(saved, clip, guard)
    group = restored.opt_state["param_groups"][0]
    names = [n for n, _ in model.named_parameters()]
    entries = [restored.opt_state["state"][i] for i in range(len(names))]
    assert group["count"] == int(adam.count) == (2 if guard == "skip" else 3)
    assert all(int(e["step"]) == group["count"] for e in entries)
    for key, want in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        _assert_trees_equal(to_flax({n: e[key] for n, e in zip(names,
                                                                 entries)}),
                            want)
    _assert_trees_equal(to_flax(restored.params),
                        jax.device_get(state.params))
    if guard == "skip":
        assert counters == (1, 0, 1)  # one dropped step, the last one
        assert (group["notfinite_count"], int(group["last_finite"]),
                group["total_notfinite"]) == counters

    jstate = trainer.restore_state(jdir, NAME, state)
    jstate, jloss, jmse = trainer.train_epoch(
        jstate, tuple(jnp.asarray(a[3:4]) for a in batches))
    after, loss, mse = port.train_epoch(
        restored, tuple(torch.from_numpy(a[3:4]) for a in batches))
    np.testing.assert_allclose(loss, jloss, rtol=TOL_LOSS)
    np.testing.assert_allclose(mse, jmse, rtol=TOL_LOSS)
    want = dict(_leaves(jax.device_get(jstate.params)))
    for path, got in _leaves(to_flax(after.params)):
        np.testing.assert_allclose(got, want[path], rtol=RTOL_GRAD,
                                   atol=ATOL_GRAD, err_msg=str(path))
    adam, counters = _adam(jax.device_get(jstate.opt_state), clip, guard)
    group = after.opt_state["param_groups"][0]
    assert group["count"] == int(adam.count)
    if guard == "skip":
        assert (group["notfinite_count"], int(group["last_finite"]),
                group["total_notfinite"]) == counters == (0, 1, 1)


# -- (3) evaluate ----------------------------------------------------- #

MS_ARGS = dict(exp_name="solar", model_name="ms", attn_type="autoformer",
               pred_len=PRED, n_trials=1, num_epochs=1, d_model_choices=(DM,),
               stack_choices=(1,), w_steps_choices=(WARMUP,),
               num_inducing=16, gp_ls_init=-1.0, max_train_samples=16,
               max_valid_samples=16)
MS_SEEDS = (11, 23)
MS_FRAME = dict(num_entities=4, steps_per_entity=600, seed=0)


def test_evaluate_converted_multiseed_run_matches_jax(tmp_path):
    """A JAX multi-seed harness run's per-seed checkpoints, converted:
    the port's ``evaluate_checkpoints`` gives JAX's per-step MSE and MAE
    for every seed."""
    jout, tout = tmp_path / "jax", tmp_path / "torch"
    harness = jharness.MultiSeedExperimentHarness(
        jsyn.make_synthetic_frame("solar", **MS_FRAME),
        jharness.HarnessArgs(**MS_ARGS, out_dir=str(jout)), MS_SEEDS)
    harness.run_study()
    names = [harness._name_for_seed(s) for s in MS_SEEDS]
    written = convert_script.convert(str(jout / "models_solar_8"),
                                     str(tout / "models_solar_8"))
    assert [Path(p).name for p in written] == sorted(names)
    kw = dict(exp_name="solar", pred_len=PRED, seeds=MS_SEEDS,
              attn_types=("autoformer",), d_models=(DM,), stack_sizes=(1,),
              num_inducing=16, max_samples=16, batch_size=BS,
              model_prefix="ms")
    want = jeval.evaluate_checkpoints(
        jsyn.make_synthetic_frame("solar", **MS_FRAME),
        jeval.EvalArgs(out_dir=str(jout), **kw))
    got = teval.evaluate_checkpoints(
        tsyn.make_synthetic_frame("solar", **MS_FRAME),
        teval.EvalArgs(out_dir=str(tout), **kw), device="cpu")
    assert list(got) == list(want) == [f"{n}_d{DM}_s1" for n in names]
    for key, w in want.items():
        np.testing.assert_array_equal(got[key]["test_y"], w["test_y"])
        for metric in ("per_step_mse", "per_step_mae"):
            np.testing.assert_allclose(got[key][metric], w[metric], rtol=TOL,
                                       err_msg=f"{key} {metric}")


# -- (4) baselines ---------------------------------------------------- #

BL_ARGS = dict(exp_name="electricity", model_name="DeepAR", pred_len=PRED,
               seed=7, n_trials=1, num_epochs=1, max_encoder_length=48)
BL_LOADER = dict(batch_size=16, max_train_sample=16, max_test_sample=16)
BL_FRAME = dict(num_entities=3, steps_per_entity=400, seed=3)


def _deepar_draws(batch, b):
    """The normal draws of JAX's ``DeepAR.sample`` for test batch
    ``batch`` (tests/test_torch_baselines_harness.py), (1, pred_len, b)."""
    (key,) = jax.random.split(jax.random.PRNGKey(batch), 1)
    return np.stack([np.asarray(jax.random.normal(k, (b,)))
                     for k in jax.random.split(key, PRED)])[None]


def test_converted_baseline_checkpoint_forecasts_like_jax(tmp_path,
                                                          monkeypatch):
    """A JAX baselines study's best DeepAR (its LSTM cells ``rnn{i}/cell``),
    converted, loaded by the port's ``BaselinesHarness.load_best``: JAX's
    test forecasts, MSE and MAE, on JAX's sampling draws."""
    monkeypatch.setattr(jbaselines, "UnivariateLoader",
                        functools.partial(juni.UnivariateLoader, **BL_LOADER))
    monkeypatch.setattr(tbaselines, "UnivariateLoader",
                        functools.partial(tuni.UnivariateLoader, **BL_LOADER))
    monkeypatch.setattr(tbaselines.BaselinesHarness, "deepar_eps",
                        lambda self, batch, b: torch.from_numpy(
                            _deepar_draws(batch, b)))
    jh = jbaselines.BaselinesHarness(
        jsyn.make_synthetic_frame("electricity", **BL_FRAME),
        jbaselines.BaselineArgs(**BL_ARGS, out_dir=str(tmp_path / "jax")))
    best = jh.run_study().best_trial.params
    want = jh.evaluate()
    tl = jh.loader.test_loader
    x = np.concatenate([tl.x_enc, tl.x_dec], axis=2)
    want_preds = np.stack([np.asarray(jh._predict(
        jh.best_model, jh.best_params, jnp.asarray(x[i]),
        jax.random.PRNGKey(i))) for i in range(x.shape[0])])
    convert_script.convert(jh.model_path,
                           str(tmp_path / "torch" / "models_electricity_8"))
    th = tbaselines.BaselinesHarness(
        tsyn.make_synthetic_frame("electricity", **BL_FRAME),
        tbaselines.BaselineArgs(**BL_ARGS, out_dir=str(tmp_path / "torch")),
        device="cpu")
    th.load_best(best["d_model"], best["stack_size"])
    got = th.evaluate()
    np.testing.assert_allclose(got["predictions"], want_preds, rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got["mse"], want["mse"], rtol=TOL)
    np.testing.assert_allclose(got["mae"], want["mae"], rtol=TOL)
    with pytest.raises(RuntimeError, match="size mismatch"):
        th.load_best(2 * best["d_model"], best["stack_size"])


# -- (5) a tree that does not match ------------------------------------ #

def test_mismatched_tree_raises_naming_its_leaves(tmp_path):
    """Parameters or Adam moments that are not the model's: the missing
    and the unexpected leaves named, the checkpoint too where the script
    converts it."""
    params = _jax_params()
    model = convert_script.port_model(SMALL)
    del params["deep_gp"]["output_layer"]["variational_mean"]
    params["extra"] = {"kernel": np.zeros((2, 3), np.float32)}
    with pytest.raises(ValueError, match=r"missing \['deep_gp\.output_layer"
                       r"\.variational_mean'\], unexpected "
                       r"\['extra\.weight'\]"):
        payload_from_jax({"params": params}, model)
    jcheckpoint.save_checkpoint(str(tmp_path / "jax"), NAME, params)
    with pytest.raises(ValueError, match=f"checkpoint '{NAME}'.*missing"):
        convert_script.convert(str(tmp_path / "jax"), str(tmp_path / "t"),
                               model=model)

    params = _jax_params()
    opt_state = jnoam_adam(DM, WARMUP).init(params)
    del opt_state[0].mu["lam"]
    tree = {"params": params, "opt_state": opt_state}
    with pytest.raises(ValueError, match=r"adam's mu does not match the "
                       r"model: missing \['lam'\], unexpected \[\]"):
        payload_from_jax(tree, model)
    with pytest.raises(ValueError, match="needs the model"):
        payload_from_jax(tree)
    guarded = jnoam_adam(DM, WARMUP, nonfinite_guard="skip").init(params)
    with pytest.raises(ValueError, match="skip guard off"):
        payload_from_jax({"params": params, "opt_state": guarded}, model)


# -- (6) the round trip ----------------------------------------------- #

def _with_count(opt_state, clip, guard, count):
    """``opt_state`` with Adam's and the schedule's count ``count``."""
    def chain(c):  # (ScaleByAdamState, ScaleByScheduleState)
        return (c[0]._replace(count=count), c[1]._replace(count=count))

    if guard == "skip":
        inner = opt_state.inner_state
        inner = (inner[0], chain(inner[1])) if clip else chain(inner)
        return opt_state._replace(inner_state=inner)
    return (opt_state[0], chain(opt_state[1])) if clip else chain(opt_state)


@pytest.mark.parametrize("clip,guard", GUARDS, ids=GUARD_IDS)
def test_opt_state_round_trip(tmp_path, clip, guard):
    """``opt_state_to_optax(opt_state_from_optax(t)) == t`` for ``t`` as
    orbax restores a ``save_state`` checkpoint without a template, every
    leaf drawn at random; with a template (optax's NamedTuples) the same
    port state."""
    params = _jax_params()
    rng = np.random.default_rng(4)

    def draw(x):
        x = np.asarray(x)
        if x.dtype == np.bool_:
            return np.bool_(rng.integers(0, 2))
        if x.dtype == np.int32:
            return np.int32(rng.integers(0, 9))
        return rng.normal(size=x.shape).astype(x.dtype)

    tx = jnoam_adam(DM, WARMUP, clip_grad_norm=clip, nonfinite_guard=guard)
    opt_state = _with_count(jax.tree_util.tree_map(draw, tx.init(params)),
                            clip, guard, np.int32(rng.integers(1, 50)))
    jcheckpoint.save_checkpoint(str(tmp_path), NAME, params,
                                opt_state=opt_state)
    plain = jax.tree_util.tree_map(
        np.asarray, jcheckpoint.load_checkpoint(str(tmp_path), NAME)
        ["opt_state"])
    model = convert_script.port_model(SMALL)
    named = dict(model.named_parameters())
    flags = dict(clip=clip > 0, guard=guard == "skip")
    port = opt_state_from_optax(plain, list(named), **flags)
    _assert_trees_equal(opt_state_to_optax(port, named, **flags), plain)
    templated = opt_state_from_optax(opt_state, list(named), **flags)
    assert templated["param_groups"] == port["param_groups"]
    for i, entry in port["state"].items():
        for key, value in entry.items():
            assert torch.equal(templated["state"][i][key], value)


# -- the converter is the one file that imports both packages ---------- #

def test_only_the_converter_imports_both_packages():
    """Outside ``tests/``: the scripts and the root's modules."""
    both = []
    for path in sorted(ROOT.glob("*.py")) + sorted(
            (ROOT / "scripts").glob("*.py")):
        tops = set()
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                tops.update(a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module:
                tops.add(node.module.split(".")[0])
        if {"fine_grained_gaussian_process_forcasting_tpu",
                "fine_grained_gaussian_process_forcasting_torch"} <= tops:
            both.append(path.relative_to(ROOT).as_posix())
    assert both == ["scripts/convert_jax_checkpoints.py"]
