"""PyTorch port vs the JAX package: int8 serving (``train/quantize.py``).

The same numpy-seeded inputs and ``params.from_flax`` weights go through
JAX's int8 path and the port's: the quantized weights and scales, the
int8 dense layer at the widths the flagship pads on the card (K 1 and 4,
N 1), the set of layers quantized, and the int8 session.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_zoo_cases import CASES, SMALL, _dtypes, _windows
from fine_grained_gaussian_process_forcasting_tpu.models import (
    forecast_denoising as jfd,
)
from fine_grained_gaussian_process_forcasting_tpu.train import (
    quantize as jq,
)
from fine_grained_gaussian_process_forcasting_tpu.train.predict import (
    InferenceSession as JaxInferenceSession,
)
from fine_grained_gaussian_process_forcasting_torch.models import (
    forecast_denoising as tfd,
)
from fine_grained_gaussian_process_forcasting_torch.params import (
    dense,
    from_flax,
)
from fine_grained_gaussian_process_forcasting_torch.train import (
    quantize as tq,
)
from fine_grained_gaussian_process_forcasting_torch.train.predict import (
    InferenceSession,
)

# the int8 dense layer: the same int8 operands and an exact int32 sum on
# both sides; the dequantization is two fp32 products and a bias add, in
# the same order, so only XLA's and torch's division (x / x_s) may differ
# in the last bit
TOL_DENSE = 1e-6
# the int8 session against JAX's: the activations entering each int8
# layer agree to fp32 rounding, as the fp32 sessions do (1e-4,
# tests/test_torch_predict.py); a rounding of x / x_s within that of a half
# would move one int8 code by a step (1/127 of its token's largest
# activation) and show as ~1e-3 here; on these inputs none moves (1.2e-7)
TOL_SESSION = 1e-4
# JAX's own bound for the int8 session against fp32
# (tests/test_quantize.py)
TOL_INT8_VS_FP32 = 0.15
N, BATCH = 6, 4


@pytest.mark.parametrize("k", [1, 4, 32])
@pytest.mark.parametrize("n", [1, 32])
def test_int8_dense_matches_jax(k, n):
    rng = np.random.default_rng(10 * k + n)
    x = rng.normal(size=(5, 7, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)  # Flax's (in, out)
    b = rng.normal(size=(n,)).astype(np.float32)
    jwq, jws = jq._quantize_weight(jnp.asarray(w))
    twq, tws = tq._quantize_weight(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(twq.numpy().T, np.asarray(jwq))
    np.testing.assert_array_equal(tws.numpy(), np.asarray(jws))
    want = np.asarray(jq.int8_dense(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b)))
    got = tq.int8_dense(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                        torch.from_numpy(b)).numpy()
    assert got.shape == (5, 7, n) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=TOL_DENSE,
                               atol=TOL_DENSE * np.abs(want).max())


def test_int8_dense_pads_to_whole_eights():
    """K 4 and N 1: the quantized weight is held zero-padded to 8 x 8 and
    the product is the unpadded layer's, at fewer than 17 rows too."""
    rng = np.random.default_rng(3)
    exact = torch.nn.Linear(4, 1)
    layer = tq.Int8Dense(dense(4, 1, bias=True, device="cpu",
                               generator=torch.Generator().manual_seed(0)))
    assert tuple(layer.qweight.shape) == (8, 8)
    assert layer.qweight[1:].abs().sum() == 0
    assert layer.qweight[:, 4:].abs().sum() == 0
    assert tuple(layer.int8_weight.shape) == (1, 4)
    x = torch.from_numpy(rng.normal(size=(3, 4)).astype(np.float32))
    with torch.no_grad():
        exact.weight.copy_(layer.int8_weight.float() * layer.scale[:, None])
        exact.bias.copy_(layer.bias)
        want = exact(x)
    got = layer(x)
    assert tuple(got.shape) == (3, 1)
    # the int8 layer quantizes x; its exact-weight twin does not
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0.05,
                               atol=0.05)


def _jax_dense_paths(jmod, params, enc, dec):
    """The paths of the Dense layers whose call JAX's int8 interceptor
    replaces (``type(mod) is nn.Dense``, ``train/quantize.py``)."""
    seen = set()

    def recording(next_fun, args, kwargs, context):
        mod = context.module
        if (type(mod) is nn.Dense and context.method_name == "__call__"
                and mod.has_variable("params", "kernel")):
            seen.add(".".join(mod.path))
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(recording):
        jax.eval_shape(lambda p: jmod.apply(
            {"params": p}, enc, dec, training=False,
            rngs={"noise": jax.random.PRNGKey(0),
                  "sampling": jax.random.PRNGKey(1)}), params)
    return seen


FP32_CASES = {"basic": dict(attn_type="basic"),
              "autoformer": dict(attn_type="autoformer"),
              "ATA": dict(attn_type="ATA")}


@pytest.mark.parametrize("case", list(FP32_CASES) + list(CASES))
def test_quantized_layers_are_jax_interceptors(case):
    """The port swaps exactly the layers JAX's interceptor replaces, by
    their ``from_flax`` names; the LSTM's gates stay unquantized in both."""
    kw = {**FP32_CASES, **CASES}[case]
    enc, dec, _ = _windows(0)
    jmod = jfd.ForecastDenoising(**{**SMALL, **_dtypes(kw, jnp)})
    params = jax.eval_shape(lambda: jmod.init(
        {"params": jax.random.PRNGKey(0)}, enc, dec))["params"]
    want = _jax_dense_paths(jmod, params, enc, dec)
    tmod = tfd.ForecastDenoising(**{**SMALL, **_dtypes(kw, torch)},
                                 device="cpu")
    assert set(tq.quantized_layers(tmod)) == want
    int8 = tq.quantize_model(tmod)
    swapped = {name for name, mod in int8.named_modules()
               if isinstance(mod, tq.Int8Dense)}
    assert swapped == want
    assert not tq.quantized_layers(int8)
    assert tq.quantized_layers(tmod)  # the model itself is left fp32


SESSION_KW = dict(src_input_size=4, tgt_input_size=4, d_model=16,
                  n_heads=4, d_k=4, stack_size=1, pred_len=8, gp=True,
                  denoise=True, num_inducing=16)


def _session_pair(attn_type, quantize):
    """JAX's session's predictions, the port's session on the same weights
    and their state dict, and the windows (tests/test_quantize.py's
    sizes)."""
    rng = np.random.default_rng(2)
    enc = rng.normal(size=(N, 24, 4)).astype(np.float32)
    dec = rng.normal(size=(N, 8, 4)).astype(np.float32)
    kw = dict(SESSION_KW, attn_type=attn_type)
    jmod = jfd.ForecastDenoising(**kw)
    params = jax.jit(lambda: jmod.init(
        {"params": jax.random.PRNGKey(0)}, enc[:2], dec[:2]))()["params"]
    want = JaxInferenceSession(jmod, params, batch_size=BATCH,
                               quantize=quantize).predict(enc, dec)
    state = from_flax(jax.tree_util.tree_map(np.asarray, params))
    session = InferenceSession(tfd.ForecastDenoising(**kw, device="cpu"),
                               state, batch_size=BATCH, device="cpu",
                               quantize=quantize)
    return want, session, state, (enc, dec)


@pytest.mark.parametrize("attn_type", ["basic", "autoformer"])
def test_int8_session_matches_jax(attn_type):
    want, session, _, (enc, dec) = _session_pair(attn_type, "int8")
    got = session.predict(enc, dec)
    assert got.shape == (N, 8, 1) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL_SESSION * np.abs(want).max())


def test_int8_session_close_to_fp32_session():
    """JAX's bound: int8 within 0.15 of the largest fp32 prediction, and
    really quantized."""
    _, session, state, (enc, dec) = _session_pair("basic", "int8")
    p8 = session.predict(enc, dec)
    p32 = InferenceSession(
        tfd.ForecastDenoising(**SESSION_KW, attn_type="basic", device="cpu"),
        state, batch_size=BATCH, device="cpu").predict(enc, dec)
    denom = np.abs(p32).max() + 1e-3
    assert np.max(np.abs(p8 - p32)) / denom < TOL_INT8_VS_FP32
    assert not np.allclose(p8, p32)


def test_int8_session_rejects_unknown_mode():
    model = tfd.ForecastDenoising(**SMALL, device="cpu")
    with pytest.raises(ValueError, match="fp4"):
        InferenceSession(model, model.state_dict(), device="cpu",
                         quantize="fp4")
