"""The model configurations, windows, weights and pinned draws that
``test_torch_zoo_model.py`` and ``test_torch_zoo_train.py`` share: the
model's last options (informer and fedformer attention, the LSTM backbone,
16-bit autoformer and the 16-bit conv family), the port against the JAX
package from the same Flax parameters (``params.from_flax``) and
numpy-seeded windows.

ProbSparse's key sample is pinned on both sides to one numpy draw per shape
(JAX's ``jax.random.randint`` is patched, the port is handed the draw as
``index_sample``), so that the jitted JAX trainer can be compared step by
step; the 16-bit autoformer replays JAX's delays (``auto_correlation(...,
delays=)``), which bf16 rounding can flip."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fine_grained_gaussian_process_forcasting_tpu.models import (
    forecast_denoising as jfd,
)
from fine_grained_gaussian_process_forcasting_torch.models import (
    forecast_denoising as tfd,
)
from fine_grained_gaussian_process_forcasting_torch.models import (
    transformer as ttr,
)
from fine_grained_gaussian_process_forcasting_torch.ops import (
    probsparse as tps,
)
from fine_grained_gaussian_process_forcasting_torch.params import from_flax

# fp32 through two model passes, a GP and LayerNorms, summed in another
# order by each framework: 1e-4 (tests/test_torch_model.py TOL); a step's
# gradients: the JAX package's fused-GP gradient tolerances (as
# tests/test_torch_train.py)
TOL = 1e-4
RTOL_GRAD, ATOL_GRAD = 3e-4, 3e-5
# 16-bit model against 16-bit model: 2^-6 of the largest prediction, the
# loss 2^-6 relative (tests/test_torch_model.py TOL_BF16_MODEL)
TOL_BF16_MODEL = 2.0 ** -6
# the decoder stream is 16 long: fedformer's 8 Fourier modes need a
# spectrum of 8 frequencies or more (length 14), in JAX as in the port
B, ENC, DEC, F, PRED = 4, 24, 16, 4, 12
SMALL = dict(src_input_size=F, tgt_input_size=F, d_model=16, n_heads=4,
             d_k=4, stack_size=1, pred_len=PRED, num_inducing=32,
             gp_ls_init=-1.0)
BF16 = dict(compute_dtype="bfloat16", gp_compute_dtype="bfloat16")
CASES = {
    "informer": dict(attn_type="informer"),
    "fedformer": dict(attn_type="fedformer"),
    "lstm": dict(backbone="lstm", stack_size=2),
    "fedformer_bf16": dict(attn_type="fedformer", **BF16),
    "autoformer_bf16": dict(attn_type="autoformer", **BF16),
    "ATA_bf16": dict(attn_type="ATA", **BF16),
    "ACAT_bf16": dict(attn_type="ACAT", **BF16),
    "conv_attn_bf16": dict(attn_type="conv_attn", **BF16),
    # the flag: the final attention on the head-folded kernel (JAX's in
    # interpret mode, the port's plain version), v widened to fp32
    "conv_attn_bf16_flag": dict(attn_type="conv_attn",
                                use_pallas_attention=True, **BF16),
}


def _dtypes(kw, module):
    return {k: getattr(module, v) if k.endswith("dtype") else v
            for k, v in kw.items()}


def _windows(seed, b=B):
    rng = np.random.default_rng(seed)
    enc = rng.normal(size=(b, ENC, F)).astype(np.float32)
    dec = rng.normal(size=(b, DEC, F)).astype(np.float32)
    y = (0.5 * dec[:, -PRED:, :1]
         + 0.1 * rng.normal(size=(b, PRED, 1))).astype(np.float32)
    return enc, dec, y


def _sample(shape, l_k):
    """The pinned key sample of one (L_Q, u_part) shape."""
    seed = 1000 * shape[0] + 10 * shape[1] + l_k
    return np.random.default_rng(seed).integers(0, l_k, size=shape)


@pytest.fixture
def pinned_samples(monkeypatch):
    """Both frameworks' ProbSparse calls take ``_sample`` for their key
    sample."""
    def jax_randint(key, shape, minval, maxval, *a, **kw):
        return jnp.asarray(_sample(shape, maxval), jnp.int32)

    monkeypatch.setattr(jax.random, "randint", jax_randint)
    original = ttr.prob_sparse_attention

    def port(q, k, v, generator=None, **kw):
        u_part, _ = tps.sample_sizes(q.shape[2], k.shape[2])
        sample = _sample((q.shape[2], u_part), k.shape[2])
        return original(q, k, v, index_sample=torch.from_numpy(sample), **kw)

    monkeypatch.setattr(ttr, "prob_sparse_attention", port)


class _JaxDelays:
    """Records the delays JAX's AutoCorrelation chooses (its ``top_k``);
    ``replay`` hands them to the port's calls in the same order."""

    def __init__(self, monkeypatch):
        self.delays, self.mp = [], monkeypatch
        self.top_k = top_k = jax.lax.top_k

        def recording(x, n):
            out = top_k(x, n)
            self.delays.append(np.array(out[1]))
            return out

        monkeypatch.setattr(jax.lax, "top_k", recording)

    def replay(self):
        self.mp.setattr(jax.lax, "top_k", self.top_k)
        original, given = ttr.auto_correlation, list(self.delays)

        def port(q, k, v, factor=1, training=True):
            delays = torch.from_numpy(given.pop(0)).long()
            return original(q, k, v, factor=factor, training=training,
                            delays=delays)

        self.mp.setattr(ttr, "auto_correlation", port)


@functools.lru_cache(maxsize=None)
def _flax_params(case, seed):
    """JAX's initial parameters, one init (compiled once) per case."""
    enc, dec, _ = _windows(seed)
    jmod = jfd.ForecastDenoising(**{**SMALL, **_dtypes(CASES[case], jnp)})
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda: jmod.init({"params": jax.random.PRNGKey(seed)}, enc,
                          dec))()["params"])


def _pair(case, seed=4):
    kw = CASES[case]
    enc, dec, y = _windows(seed)
    jmod = jfd.ForecastDenoising(**{**SMALL, **_dtypes(kw, jnp)})
    params = jax.tree_util.tree_map(np.copy, _flax_params(case, seed))
    params["lam"] = np.array([0.003], np.float32)  # the ELBO counts
    layer = params["deep_gp"]["output_layer"]  # q(u) away from the prior
    rng = np.random.default_rng(seed + 1)
    for name, scale in (("variational_mean", 0.5),
                        ("variational_log_stddev", 0.3)):
        layer[name] = (scale * rng.normal(size=32)).astype(np.float32)
    tmod = tfd.ForecastDenoising(**{**SMALL, **_dtypes(kw, torch)},
                                 device="cpu")
    tmod.load_state_dict(from_flax(params))
    return jmod, params, tmod, (enc, dec, y)
