"""PyTorch port vs the JAX package: the data layer on column tables (no
pandas in the port) against the JAX package's pandas one, and the HPO
study.  Synthetic frames, formatters and windows must be *equal*: the same
numpy draws, the same float64 scaler sums, the same gathered windows."""

import numpy as np
import pandas as pd
import pytest

from fine_grained_gaussian_process_forcasting_tpu.data import (
    synthetic as jsyn,
)
from fine_grained_gaussian_process_forcasting_tpu.data import window as jwin
from fine_grained_gaussian_process_forcasting_tpu.data.experiment import (
    ExperimentConfig as JExperimentConfig,
)
from fine_grained_gaussian_process_forcasting_tpu.train import hpo as jhpo
from fine_grained_gaussian_process_forcasting_torch.data import (
    synthetic as tsyn,
)
from fine_grained_gaussian_process_forcasting_torch.data import table
from fine_grained_gaussian_process_forcasting_torch.data import window as twin
from fine_grained_gaussian_process_forcasting_torch.data.experiment import (
    ExperimentConfig as TExperimentConfig,
)
from fine_grained_gaussian_process_forcasting_torch.data.formatters.scaling import (
    StandardScaler,
)
from fine_grained_gaussian_process_forcasting_torch.train import hpo as thpo

SCHEMAS = ["electricity", "solar", "traffic", "exchange", "covid",
           "air_quality", "watershed", "weather", "ETTm2", "camel"]
FORMATTED = ["electricity", "solar", "traffic", "exchange", "covid",
             "air_quality", "watershed"]


def _assert_frame_equal(got: table.Frame, want: pd.DataFrame):
    """Same columns in the same order, same values: floats bit for bit,
    integers exactly, text as text."""
    assert list(got) == list(want.columns)
    for name in want.columns:
        w = want[name]
        g = got[name]
        assert len(g) == len(w), name
        if pd.api.types.is_float_dtype(w.dtype):
            assert g.dtype == np.float64, name
            np.testing.assert_array_equal(g, w.to_numpy(), err_msg=name)
        elif pd.api.types.is_integer_dtype(w.dtype):
            assert g.dtype.kind == "i", name
            np.testing.assert_array_equal(g, w.to_numpy(), err_msg=name)
        else:
            assert g.dtype.kind == "U", name
            assert g.tolist() == [str(v) for v in w.tolist()], name


@pytest.mark.parametrize("schema", SCHEMAS)
def test_synthetic_frame_matches_jax(schema):
    kw = dict(num_entities=3, steps_per_entity=300, seed=4)
    _assert_frame_equal(tsyn.make_synthetic_frame(schema, **kw),
                        jsyn.make_synthetic_frame(schema, **kw))


@pytest.mark.parametrize("noise,profile", [("ar1", "stationary"),
                                           ("gp", "stationary"),
                                           ("iid", "field"),
                                           ("ar1", "field")])
def test_synthetic_noise_and_profile_match_jax(noise, profile):
    kw = dict(num_entities=2, steps_per_entity=400, seed=7, noise=noise,
              noise_scale=0.5, profile=profile)
    _assert_frame_equal(tsyn.make_synthetic_frame("solar", **kw),
                        jsyn.make_synthetic_frame("solar", **kw))


def _frames(exp, pred_len=8, num_entities=3, steps=300):
    kw = dict(num_entities=num_entities, steps_per_entity=steps, seed=1)
    return (tsyn.make_synthetic_frame(exp, **kw),
            jsyn.make_synthetic_frame(exp, **kw))


def _formatters(exp, pred_len, tmp_path):
    return (TExperimentConfig(pred_len, exp, root_folder=str(tmp_path / "t"))
            .make_data_formatter(),
            JExperimentConfig(pred_len, exp, root_folder=str(tmp_path / "j"))
            .make_data_formatter())


@pytest.mark.parametrize("exp", FORMATTED)
def test_formatter_transform_matches_jax(exp, tmp_path):
    tdf, jdf = _frames(exp)
    tfmt, jfmt = _formatters(exp, 8, tmp_path)
    got, want = tfmt.transform_data(tdf), jfmt.transform_data(jdf)
    _assert_frame_equal(got, want.reset_index(drop=True))
    assert tfmt._num_classes_per_cat_input == jfmt._num_classes_per_cat_input
    assert tfmt.get_experiment_params() == jfmt.get_experiment_params()


@pytest.mark.parametrize("exp", FORMATTED)
def test_batch_sampled_windows_match_jax_bit_for_bit(exp, tmp_path):
    """Sort, split, draw (numpy's global generator at seed 2436) and gather
    as the JAX package does; the caller's global generator is restored."""
    tdf, jdf = _frames(exp, steps=260)
    tfmt, jfmt = _formatters(exp, 8, tmp_path)
    params = jfmt.get_experiment_params()
    args = (0.8, (40, 12), params["total_time_steps"],
            params["num_encoder_steps"], 8, params["column_definition"], 4)
    np.random.seed(11)
    before = np.random.get_state()[1].copy()
    got = twin.batch_sampled_data(tfmt.transform_data(tdf), *args)
    np.testing.assert_array_equal(np.random.get_state()[1], before)
    want = jwin.batch_sampled_data(jfmt.transform_data(jdf), *args)
    for g, w in zip(got, want):
        assert g.n_batches == w.n_batches > 0
        for name in ("enc", "dec", "y"):
            a, b = getattr(g, name), getattr(w, name)
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("max_samples", [50, 2 * (215 - 208 + 1)],
                         ids=["padded", "real_only"])
def test_sample_windows_when_samples_are_scarce(max_samples, tmp_path):
    """No more windows than asked: all of them, shuffled, zero-padded to
    ``max_samples`` (nothing to pad when the count is met exactly)."""
    tdf, jdf = _frames("electricity", num_entities=2, steps=215)
    tfmt, jfmt = _formatters("electricity", 8, tmp_path)
    p = jfmt.get_experiment_params()
    args = (max_samples, p["total_time_steps"], p["num_encoder_steps"], 8,
            p["column_definition"])
    np.random.seed(3)
    got = twin.sample_windows(tfmt.transform_data(tdf), *args)
    np.random.seed(3)
    want = jwin.sample_windows(jfmt.transform_data(jdf), *args)
    assert len(got) == len(want) == max_samples
    for name in ("enc_inputs", "dec_inputs", "outputs"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


def test_categorical_misalignment_quirk(tmp_path):
    """The reference's quirk, kept: codes of the unfiltered frame's first
    rows, assigned by position after a short entity is dropped."""
    tfmt, jfmt = _formatters("electricity", 24, tmp_path)
    T = jfmt.get_fixed_params()["total_time_steps"]
    frames = []
    for syn in (tsyn, jsyn):
        df = syn.make_synthetic_frame("electricity", num_entities=2,
                                      steps_per_entity=T + 10)
        short = (np.asarray(df["id"]) == 0.0) & (
            np.asarray(df["hours_from_start"]) >= 5)
        frames.append(df)
        frames.append(~short)
    tdf = table.take(frames[0], frames[1])
    jdf = frames[2][frames[3]].reset_index(drop=True)
    got, want = tfmt.transform_data(tdf), jfmt.transform_data(jdf)
    assert (got["id"] == 1.0).all()
    np.testing.assert_array_equal(got["categorical_id"],
                                  want["categorical_id"].to_numpy())
    codes = got["categorical_id"]
    assert (codes[:5] != codes[5]).all()  # the misalignment is real


def test_scaler_matches_sklearn_bits():
    from sklearn.preprocessing import StandardScaler as Sk

    rng = np.random.default_rng(2)
    cols = {"a": rng.normal(3.0, 2.0, 1000), "b": np.full(1000, 7.25),
            "c": rng.integers(0, 9, 1000).astype(np.float64)}
    x = table.matrix(cols, ["a", "b", "c"])
    df = pd.DataFrame(cols)
    sk = Sk().fit(df.values)
    ours = StandardScaler().fit(x)
    for attr in ("mean_", "var_", "scale_"):
        np.testing.assert_array_equal(getattr(ours, attr), getattr(sk, attr))
    np.testing.assert_array_equal(ours.transform(x), sk.transform(df.values))


def test_read_csv_matches_pandas(tmp_path):
    path = tmp_path / "data.csv"
    rng = np.random.default_rng(5)
    n = 40
    df = pd.DataFrame({
        "date": [f"2020-01-{(i % 28) + 1:02d} {i % 24:02d}:00" for i in
                 range(n)],
        "id": np.repeat([3, 1], n // 2),
        "value": rng.normal(size=n),
        "missing": np.where(np.arange(n) % 7 == 0, np.nan,
                            rng.uniform(size=n)),
        "name": [f"site {i % 3}" for i in range(n)],
        "flag": np.arange(n) % 2,
    })
    df.to_csv(path, index=False)
    # Python's float() rounds correctly, as pandas' round_trip parser does;
    # pandas' default parser can land one ulp off
    want = pd.read_csv(path, dtype={"date": str}, float_precision="round_trip")
    got = table.read_csv(str(path), str_columns=("date",))
    assert list(got) == list(want.columns)
    for name in want.columns:
        if pd.api.types.is_numeric_dtype(want[name].dtype):
            assert got[name].dtype == want[name].dtype, name
            np.testing.assert_array_equal(got[name], want[name].to_numpy())
        else:
            assert got[name].tolist() == want[name].tolist(), name


def test_reported_errors_csv_matches_pandas(tmp_path):
    """Two appends through the port and through pandas, as the JAX
    harness's evaluate() writes them: the same file."""
    rows = [("ATA_solar_96_8220_denoise_gp",
             {"MSE": "0.213 0.3310", "MAE": " 0.351 0.2972"}),
            ("ATA_solar_96_1122_denoise_gp",
             {"MSE": "0.209 0.3207", "MAE": " 0.349 0.2911"})]
    ours, theirs = tmp_path / "ours.csv", tmp_path / "theirs.csv"
    for name, errors in rows:
        table.append_errors_csv(str(ours), name, errors)
        df = pd.DataFrame.from_dict({name: errors}, orient="index")
        if theirs.exists():
            df = pd.concat([pd.read_csv(theirs, index_col=0), df], axis=0)
        df.to_csv(theirs)
    assert ours.read_text() == theirs.read_text()


def _objective(trial):
    d = trial.suggest_categorical("d_model", [32, 16])
    w = trial.suggest_categorical("w_steps", [4000])
    s = trial.suggest_categorical("stack_size", [1, 3])
    return d / 10 + s + w / 1e4


@pytest.mark.parametrize("sampler", ["grid", "random", "tpe"])
def test_hpo_study_matches_jax(sampler):
    studies = []
    for hpo in (thpo, jhpo):
        study = hpo.create_study(sampler=sampler, seed=5)
        study.optimize(_objective, n_trials=9)
        studies.append([(t.params, t.state, t.value) for t in study.trials])
    assert studies[0] == studies[1]


@pytest.mark.parametrize("exp", ["electricity", "traffic"])
def test_format_predictions_matches_jax(exp, tmp_path):
    """The target scaling inverted per entity (electricity) or globally
    (traffic)."""
    tdf, jdf = _frames(exp)
    tfmt, jfmt = _formatters(exp, 8, tmp_path)
    tfmt.transform_data(tdf)
    jfmt.transform_data(jdf)
    rng = np.random.default_rng(9)
    preds = {"identifier": np.repeat([2.0, 0.0, 1.0], 5),
             "t+0": rng.normal(size=15), "t+1": rng.normal(size=15)}
    got = tfmt.format_predictions(dict(preds))
    want = jfmt.format_predictions(pd.DataFrame(preds))
    _assert_frame_equal(got, want.reset_index(drop=True))
