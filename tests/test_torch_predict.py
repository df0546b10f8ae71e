"""PyTorch port vs the JAX package: ``InferenceSession.predict`` with a
ragged tail."""

import jax
import numpy as np
import pytest

from fine_grained_gaussian_process_forcasting_tpu.models.forecast_denoising import (
    ForecastDenoising as JaxForecastDenoising,
)
from fine_grained_gaussian_process_forcasting_tpu.train.predict import (
    InferenceSession as JaxInferenceSession,
)
from fine_grained_gaussian_process_forcasting_torch.models.forecast_denoising import (
    ForecastDenoising,
)
from fine_grained_gaussian_process_forcasting_torch.params import from_flax
from fine_grained_gaussian_process_forcasting_torch.train.predict import (
    InferenceSession,
)

# fp32 through the whole model in two frameworks: 1e-4
TOL = 1e-4
N, BATCH, ENC, DEC, F = 37, 16, 24, 12, 4
SMALL = dict(src_input_size=F, tgt_input_size=F, d_model=16, n_heads=4,
             d_k=4, stack_size=1, pred_len=DEC, num_inducing=32,
             gp_ls_init=-1.0)


def _windows(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, ENC, F)).astype(np.float32),
            rng.normal(size=(N, DEC, F)).astype(np.float32))


@pytest.mark.parametrize("attn_type", ["basic", "autoformer"])
def test_inference_session_matches_jax(attn_type):
    enc, dec = _windows()
    jmod = JaxForecastDenoising(**SMALL, attn_type=attn_type)
    params = jmod.init({"params": jax.random.PRNGKey(0)}, enc[:2],
                       dec[:2])["params"]
    want = JaxInferenceSession(jmod, params, batch_size=BATCH).predict(enc,
                                                                       dec)
    session = InferenceSession(
        ForecastDenoising(**SMALL, attn_type=attn_type, device="cpu"),
        from_flax(jax.tree_util.tree_map(np.asarray, params)),
        batch_size=BATCH, device="cpu")
    got = session.predict(enc, dec)
    assert got.shape == (N, DEC, 1)  # 37 = 2 batches of 16 + a tail of 5
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_tail_padding_does_not_change_answers():
    enc, dec = _windows(1)
    model = ForecastDenoising(**SMALL, device="cpu")
    state = model.state_dict()
    whole = InferenceSession(model, state, batch_size=N,
                             device="cpu").predict(enc, dec)
    padded = InferenceSession(model, state, batch_size=BATCH,
                              device="cpu").predict(enc, dec)
    np.testing.assert_allclose(padded, whole, rtol=1e-5, atol=1e-6)
