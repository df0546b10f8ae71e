"""PyTorch port vs the JAX package: ``ForecastDenoising`` with the model's
last options (informer and fedformer attention, the LSTM backbone, 16-bit
autoformer and the 16-bit conv family), eval and training passes, and the
16-bit autoformer served (``_torch_zoo_cases`` has the configurations and
how the random draws and delays are matched)."""

import jax
import numpy as np
import pytest
import torch

from _torch_zoo_cases import (  # noqa: F401 (pinned_samples: a fixture)
    B,
    CASES,
    PRED,
    TOL,
    TOL_BF16_MODEL,
    _JaxDelays,
    _pair,
    _windows,
    pinned_samples,
)
from fine_grained_gaussian_process_forcasting_torch.params import from_flax
from fine_grained_gaussian_process_forcasting_torch.train.predict import (
    InferenceSession,
)


_JAX_RUNS = {}


def _jax_outputs(case, jmod, params, batch):
    """JAX's (eval, train) outputs of a case, both from one compiled
    call, kept for the case's other test."""
    if case not in _JAX_RUNS:
        _JAX_RUNS[case] = jax.jit(lambda p, *b: tuple(
            jmod.apply({"params": p}, *b, training=t) for t in (False, True)))(
                params, *batch)
    return _JAX_RUNS[case]


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", list(CASES))
def test_model_matches_jax(case, training, pinned_samples, monkeypatch):
    """Predictions, MSE and loss: fp32 at ``TOL``, 16-bit at
    ``TOL_BF16_MODEL``."""
    jmod, params, tmod, (enc, dec, y) = _pair(case)
    bf16 = "compute_dtype" in CASES[case]
    if case == "autoformer_bf16":  # eager, to read the delays it takes
        delays = _JaxDelays(monkeypatch)
        want = jmod.apply({"params": params}, enc, dec, y, training=training)
        delays.replay()
    else:
        want = _jax_outputs(case, jmod, params, (enc, dec, y))[training]
    with torch.no_grad():
        got = tmod(*(torch.from_numpy(a) for a in (enc, dec, y)),
                   training=training)
    assert got.predictions.shape == (B, PRED, 1)
    assert got.predictions.dtype == torch.float32
    wp = np.asarray(want.predictions)
    if bf16:
        assert (np.abs(got.predictions.numpy() - wp).max()
                <= TOL_BF16_MODEL * np.abs(wp).max())
    else:
        np.testing.assert_allclose(got.predictions.numpy(), wp, rtol=TOL,
                                   atol=TOL)
    for field in ("mse", "loss"):
        np.testing.assert_allclose(
            float(getattr(got, field)), float(getattr(want, field)),
            rtol=TOL_BF16_MODEL if bf16 else TOL, err_msg=field)


def test_bf16_session_matches_jax(monkeypatch):
    """16-bit autoformer served through ``InferenceSession.predict``: a
    batch of 4 and a ragged 3 (padded, as JAX's session pads)."""
    jmod, params, tmod, (enc, dec, _) = _pair("autoformer_bf16", seed=6)
    more = _windows(8, b=3)
    enc, dec = (np.concatenate([a, m]) for a, m in zip((enc, dec), more))
    delays = _JaxDelays(monkeypatch)
    want = [np.asarray(jmod.apply({"params": params}, e, d).predictions)
            for e, d in ((enc[:4], dec[:4]),
                         (np.concatenate([enc[4:], enc[-1:]]),
                          np.concatenate([dec[4:], dec[-1:]])))]
    want = np.concatenate([want[0], want[1][:3]])
    delays.replay()
    session = InferenceSession(tmod, from_flax(params), batch_size=4,
                               device="cpu")
    got = session.predict(enc, dec)
    assert got.shape == (7, PRED, 1) and got.dtype == np.float32
    assert np.abs(got - want).max() <= TOL_BF16_MODEL * np.abs(want).max()
