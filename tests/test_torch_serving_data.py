"""PyTorch port vs the JAX package: the serving runtime's data side --
``InferenceSession.predict_dataframe`` on the same synthetic electricity
frame, ``from_checkpoint``, ``utils/normalizers`` and ``utils/config``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fine_grained_gaussian_process_forcasting_tpu.data import (
    synthetic as jsyn,
)
from fine_grained_gaussian_process_forcasting_tpu.data.experiment import (
    ExperimentConfig as JExperimentConfig,
)
from fine_grained_gaussian_process_forcasting_tpu.models.forecast_denoising import (
    ForecastDenoising as JaxForecastDenoising,
)
from fine_grained_gaussian_process_forcasting_tpu.train.predict import (
    InferenceSession as JaxInferenceSession,
)
from fine_grained_gaussian_process_forcasting_tpu.utils import (
    config as jconfig,
)
from fine_grained_gaussian_process_forcasting_tpu.utils import (
    normalizers as jnorm,
)
from fine_grained_gaussian_process_forcasting_torch.data import (
    synthetic as tsyn,
)
from fine_grained_gaussian_process_forcasting_torch.data.experiment import (
    ExperimentConfig as TExperimentConfig,
)
from fine_grained_gaussian_process_forcasting_torch.models.forecast_denoising import (
    ForecastDenoising,
)
from fine_grained_gaussian_process_forcasting_torch.params import from_flax
from fine_grained_gaussian_process_forcasting_torch.train.checkpoint import (
    save_checkpoint,
)
from fine_grained_gaussian_process_forcasting_torch.train.predict import (
    InferenceSession,
)
from fine_grained_gaussian_process_forcasting_torch.utils import (
    config as tconfig,
)
from fine_grained_gaussian_process_forcasting_torch.utils import (
    normalizers as tnorm,
)

# fp32 through the whole model in two frameworks: 1e-4 of the largest
# prediction (tests/test_torch_predict.py), unscaled per entity
TOL = 1e-4
# the normalizers: a few fp32 reductions in another order
TOL_NORM = 1e-5
PRED = 24
# tests/test_predict.py's model
KW = dict(src_input_size=4, tgt_input_size=4, d_model=16, n_heads=4, d_k=4,
          stack_size=1, pred_len=PRED, attn_type="basic", gp=True,
          denoise=True, num_inducing=8)


@pytest.fixture(scope="module")
def sessions():
    jmod = JaxForecastDenoising(**KW)
    enc0 = np.zeros((2, 192, 4), np.float32)
    dec0 = np.zeros((2, PRED, 4), np.float32)
    params = jax.jit(lambda: jmod.init(
        {"params": jax.random.PRNGKey(0)}, enc0, dec0))()["params"]
    state = from_flax(jax.tree_util.tree_map(np.asarray, params))
    port = InferenceSession(ForecastDenoising(**KW, device="cpu"), state,
                            batch_size=16, device="cpu")
    return JaxInferenceSession(jmod, params, batch_size=16), port, state


@pytest.mark.parametrize("max_windows", [8, 0], ids=["8", "all"])
def test_predict_dataframe_matches_jax(sessions, tmp_path, max_windows):
    """The same windows (seed 2436, real windows only), the same entities
    in the same order, the forecasts unscaled per entity."""
    jax_session, port, _ = sessions
    kw = dict(num_entities=2, steps_per_entity=260, seed=9)
    jraw = jsyn.make_synthetic_frame("electricity", **kw)
    traw = tsyn.make_synthetic_frame("electricity", **kw)
    jfmt = JExperimentConfig(PRED, "electricity", root_folder=str(
        tmp_path / "j")).make_data_formatter()
    tfmt = TExperimentConfig(PRED, "electricity", root_folder=str(
        tmp_path / "t")).make_data_formatter()
    state = np.random.get_state()
    want = jax_session.predict_dataframe(jraw, jfmt, PRED,
                                         max_windows=max_windows)
    got = port.predict_dataframe(traw, tfmt, PRED, max_windows=max_windows)
    n = 8 if max_windows else 2 * (260 - 240 + 1)
    assert list(got) == list(want.columns)
    assert len(got["identifier"]) == len(want) == n
    assert list(got["identifier"]) == list(want["identifier"])
    values = np.stack([got[f"t+{i + 1}"] for i in range(PRED)], 1)
    ref = want[[f"t+{i + 1}" for i in range(PRED)]].to_numpy()
    np.testing.assert_allclose(values, ref, rtol=0,
                               atol=TOL * np.abs(ref).max())
    # numpy's global generator is left as it was
    after = np.random.get_state()
    assert state[0] == after[0] and np.array_equal(state[1], after[1])


def test_from_checkpoint_round_trip(sessions, tmp_path):
    """A ``train/checkpoint.py`` checkpoint serves as the state dict it
    holds; ``template_params`` is the key set it must hold."""
    _, port, state = sessions
    save_checkpoint(str(tmp_path), "m", state)
    rng = np.random.default_rng(4)
    enc = rng.normal(size=(37, 192, 4)).astype(np.float32)
    dec = rng.normal(size=(37, PRED, 4)).astype(np.float32)
    loaded = InferenceSession.from_checkpoint(
        ForecastDenoising(**KW, device="cpu"), str(tmp_path), "m", state,
        batch_size=16, device="cpu")
    np.testing.assert_array_equal(loaded.predict(enc, dec),
                                  port.predict(enc, dec))
    int8 = InferenceSession.from_checkpoint(
        ForecastDenoising(**KW, device="cpu"), str(tmp_path), "m",
        batch_size=16, quantize="int8", device="cpu")
    assert int8.quantize == "int8"
    assert np.all(np.isfinite(int8.predict(enc[:4], dec[:4])))
    wrong = dict(state, extra=torch.zeros(1))
    with pytest.raises(ValueError, match="extra"):
        InferenceSession.from_checkpoint(
            ForecastDenoising(**KW, device="cpu"), str(tmp_path), "m",
            wrong, device="cpu")


def _data(seed):
    return np.random.default_rng(seed).normal(
        2.0, 3.0, size=(12, 5, 3)).astype(np.float32)


@pytest.mark.parametrize("name", ["UnitGaussianNormalizer",
                                  "GaussianNormalizer", "RangeNormalizer"])
def test_normalizers_match_jax(name):
    x, y = _data(0), _data(1)
    jn = getattr(jnorm, name)(jnp.asarray(x))
    tn = getattr(tnorm, name)(torch.from_numpy(x))
    for way in ("encode", "decode"):
        want = np.asarray(getattr(jn, way)(jnp.asarray(y)))
        got = getattr(tn, way)(torch.from_numpy(y)).numpy()
        np.testing.assert_allclose(got, want, rtol=TOL_NORM,
                                   atol=TOL_NORM * np.abs(want).max())
    back = tn.decode(tn.encode(torch.from_numpy(y))).numpy()
    np.testing.assert_allclose(back, y, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("p", [1, 2, 3])
@pytest.mark.parametrize("size_average, reduction",
                         [(True, True), (False, True), (True, False)])
def test_lp_loss_matches_jax(p, size_average, reduction):
    x, y = _data(2), _data(3)
    jl = jnorm.LpLoss(d=2, p=p, size_average=size_average,
                      reduction=reduction)
    tl = tnorm.LpLoss(d=2, p=p, size_average=size_average,
                      reduction=reduction)
    for way in ("abs", "rel", "__call__"):
        want = np.asarray(getattr(jl, way)(jnp.asarray(x), jnp.asarray(y)))
        got = getattr(tl, way)(torch.from_numpy(x),
                               torch.from_numpy(y)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=TOL_NORM)
    with pytest.raises(ValueError):
        tnorm.LpLoss(p=0)


@pytest.mark.parametrize("name", ["DataConfig", "ModelConfig",
                                  "OptimConfig", "ParallelConfig",
                                  "ExperimentSpec"])
def test_config_defaults_match_jax(name):
    want = getattr(jconfig, name)
    got = getattr(tconfig, name)
    assert ([f.name for f in dataclasses.fields(got)]
            == [f.name for f in dataclasses.fields(want)])
    assert dataclasses.asdict(got()) == dataclasses.asdict(want())
    assert tconfig.ModelConfig().num_inducing == 512
