"""PyTorch port vs the JAX package: the last attention ops of the zoo
(ProbSparse, the Fourier blocks and their modes) and AutoCorrelation at 16
bits, from the same Flax parameters (``params.from_flax``) and numpy-seeded
inputs.  The random draws JAX makes (ProbSparse's key sample) and the
choices a 16-bit rounding can flip (AutoCorrelation's delays) are recorded
from the JAX run and handed to the port."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fine_grained_gaussian_process_forcasting_tpu.ops import (
    autocorrelation as jac,
)
from fine_grained_gaussian_process_forcasting_tpu.ops import fourier as jfo
from fine_grained_gaussian_process_forcasting_tpu.ops import (
    probsparse as jps,
)
from fine_grained_gaussian_process_forcasting_torch.ops import (
    autocorrelation as tac,
)
from fine_grained_gaussian_process_forcasting_torch.ops import fourier as tfo
from fine_grained_gaussian_process_forcasting_torch.ops import (
    probsparse as tps,
)
from fine_grained_gaussian_process_forcasting_torch.params import from_flax

# fp32 transforms, products and softmaxes summed in another order by each
# framework: outputs 1e-5, gradients 1e-4
TOL_OP = 1e-5
TOL_GRAD = 1e-4
# the 16-bit op against JAX's: JAX rounds its DFT matrices and spectra to
# bf16, the port transforms the widened operands exactly and rounds the
# context once; a value may land a few bf16 steps apart: 2^-6 of the
# context's largest magnitude (the whole 16-bit model's tolerance,
# tests/test_torch_model.py TOL_BF16_MODEL); the fp32 correlation 2^-7
TOL_BF16 = 2.0 ** -6
TOL_BF16_CORR = 2.0 ** -7


def _np(t):
    return np.asarray(t)


@pytest.mark.parametrize("seq_len,modes,method,seed", [
    (96, 8, "random", 0), (96, 64, "random", 0), (40, 8, "random", 3),
    (24, 5, "list", 0), (7, 64, "random", 1)])
def test_get_frequency_modes_matches_jax(seq_len, modes, method, seed):
    assert tfo.get_frequency_modes(seq_len, modes, method, seed) == \
        jfo.get_frequency_modes(seq_len, modes, method, seed)


def _fourier_input(b, l, h, e, seed):
    return np.random.default_rng(seed).normal(
        size=(b, l, h, e)).astype(np.float32)


@pytest.mark.parametrize("length", [96, 40], ids=["seq_len", "shorter"])
def test_fourier_block_matches_jax(length):
    """The FEDformer block as the model builds it (seq_len 96, 8 random
    modes): at a length-96 sequence, and at length 40, where modes past the
    spectrum's 21 frequencies are read as its last one, as JAX's gather
    clamps them.  Output, and the gradients of the weights and the input."""
    h, e = 4, 4
    x = _fourier_input(2, length, h, e, seed=1)
    g = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)
    jmod = jfo.FourierBlock(in_channels=h * e, out_channels=h * e,
                            seq_len=96, modes=8, n_heads=h)
    params = jax.tree_util.tree_map(
        np.asarray, jmod.init(jax.random.PRNGKey(0), x)["params"])

    def jloss(p, xx):
        out, _ = jmod.apply({"params": p}, xx)
        return jnp.sum(out * g), out

    (_, want), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, x)
    tmod = tfo.FourierBlock(h * e, h * e, 96, 8, n_heads=h, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    tmod.load_state_dict(from_flax(params))
    xt = torch.from_numpy(x).requires_grad_(True)
    got, none = tmod(xt)
    assert none is None and got.shape == x.shape
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), _np(want),
                               rtol=TOL_OP, atol=TOL_OP)
    np.testing.assert_allclose(xt.grad.numpy(), _np(jgx), rtol=TOL_GRAD,
                               atol=TOL_GRAD)
    for name in ("w_real", "w_imag"):
        np.testing.assert_allclose(
            getattr(tmod, name).grad.numpy(), _np(jgp[name]), rtol=TOL_GRAD,
            atol=TOL_GRAD, err_msg=name)


def test_fourier_block_refuses_more_modes_than_frequencies():
    """At length 12 the spectrum has 7 frequencies for the 8 modes (JAX
    fails to broadcast there too)."""
    block = tfo.FourierBlock(16, 16, 96, 8, n_heads=4, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="8 modes"):
        block(torch.zeros(1, 12, 4, 4))


@pytest.mark.parametrize("activation", ["tanh", "softmax"])
@pytest.mark.parametrize("lq,lkv", [(32, 32), (32, 24)])
def test_fourier_cross_attention_matches_jax(activation, lq, lkv):
    h, e = 4, 4
    q = _fourier_input(2, lq, h, e, seed=3)
    k = _fourier_input(2, lkv, h, e, seed=4)
    kw = dict(in_channels=h * e, out_channels=h * e, seq_len_q=lq,
              seq_len_kv=lkv, modes=8, activation=activation, n_heads=h)
    jmod = jfo.FourierCrossAttention(**kw)
    params = jax.tree_util.tree_map(
        np.asarray, jmod.init(jax.random.PRNGKey(1), q, k)["params"])
    # weights of the size the products need to show: the init's scale is
    # 1 / (in * out)
    rng = np.random.default_rng(5)
    params = {n: rng.normal(size=p.shape).astype(np.float32)
              for n, p in params.items()}
    want, _ = jmod.apply({"params": params}, q, k)
    tmod = tfo.FourierCrossAttention(
        **kw, device="cpu", generator=torch.Generator().manual_seed(0))
    tmod.load_state_dict(from_flax(params))
    with torch.no_grad():
        got, _ = tmod(torch.from_numpy(q), torch.from_numpy(k))
    want = _np(want)
    assert np.abs(want).max() > 1e-3  # the products reach the output
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL_OP,
                               atol=TOL_OP * np.abs(want).max())


def _psp_inputs(lq, lk, seed, b=2, h=3, d=8):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, h, n, d)).astype(np.float32)
                 for n in (lq, lk, lk))


def _jax_sample(lq, lk, rng):
    u_part, _ = tps.sample_sizes(lq, lk)
    return np.array(jax.random.randint(rng, (lq, u_part), 0, lk))


@pytest.mark.parametrize("mask_flag,lq,lk", [(False, 40, 40),
                                             (False, 24, 40),
                                             (True, 40, 40)],
                         ids=["mean_self", "mean_cross", "causal"])
def test_prob_sparse_matches_jax(mask_flag, lq, lk):
    """Both ``mask_flag`` variants with JAX's own key sample injected
    (``index_sample=``): the same queries chosen, the same context, and
    the same gradients of q, k and v."""
    q, k, v = _psp_inputs(lq, lk, seed=6)
    g = np.random.default_rng(7).normal(size=q.shape[:2] + (lq, q.shape[3]))
    g = g.astype(np.float32)
    rng = jax.random.PRNGKey(11)

    def jloss(q_, k_, v_):
        ctx, _ = jps.prob_sparse_attention(q_, k_, v_, rng,
                                           mask_flag=mask_flag)
        return jnp.sum(ctx * g), ctx

    (_, want), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    sample = torch.from_numpy(_jax_sample(lq, lk, rng))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got, none = tps.prob_sparse_attention(*ts, mask_flag=mask_flag,
                                          index_sample=sample)
    assert none is None
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), _np(want), rtol=TOL_OP,
                               atol=TOL_OP)
    for name, t, w in zip("qkv", ts, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), _np(w), rtol=TOL_GRAD,
                                   atol=TOL_GRAD, err_msg=name)


def test_prob_sparse_masked_needs_self_attention():
    q, k, v = (torch.from_numpy(a) for a in _psp_inputs(24, 40, seed=1))
    with pytest.raises(ValueError, match="L_Q == L_K"):
        tps.prob_sparse_attention(q, k, v, mask_flag=True)


def test_prob_sparse_draws_from_its_generator():
    """The key sample comes from the generator (the same seed, the same
    context), from a fixed seed-0 generator without one, and an injected
    ``m_top`` is the set of queries that attend."""
    q, k, v = (torch.from_numpy(a) for a in _psp_inputs(40, 40, seed=2))
    run = lambda gen: tps.prob_sparse_attention(q, k, v, generator=gen)[0]
    a, b = (run(torch.Generator().manual_seed(3)) for _ in range(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(run(None),
                               run(torch.Generator().manual_seed(0)),
                               rtol=0, atol=0)
    _, u = tps.sample_sizes(40, 40)
    m_top = torch.arange(u).expand(2, 3, u)
    got, _ = tps.prob_sparse_attention(q, k, v, m_top=m_top)
    mean = v.mean(dim=-2, keepdim=True)
    torch.testing.assert_close(got[:, :, u:], mean.expand_as(got[:, :, u:]))
    full = torch.softmax(q[:, :, :u] @ k.transpose(-1, -2)
                         / math.sqrt(q.shape[-1]), dim=-1) @ v
    torch.testing.assert_close(got[:, :, :u], full, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("lq,lk", [(36, 36), (24, 36), (36, 20)])
def test_auto_correlation_bf16_matches_jax(monkeypatch, training, lq, lk):
    """bf16 operands: JAX's DFT-by-GEMM rounds its matrices and spectra to
    bf16; the port takes the widened operands through the fp32 route and
    rounds the context to bf16.  JAX's delays are replayed (``delays=``);
    the context in bf16 and the correlation in fp32, each within its
    tolerance of JAX's."""
    rng = np.random.default_rng(8)
    q, k, v = (rng.normal(size=(3, 4, n, 8)).astype(np.float32)
               for n in (lq, lk, lk))
    chosen, top_k = [], jax.lax.top_k

    def recording(x, n):
        out = top_k(x, n)
        chosen.append(np.asarray(out[1]))
        return out

    monkeypatch.setattr(jax.lax, "top_k", recording)
    want, want_corr = jac.auto_correlation(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
        training=training)
    monkeypatch.undo()
    assert want.dtype == jnp.bfloat16 and want_corr.dtype == jnp.float32
    got, got_corr = tac.auto_correlation(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
        training=training, delays=torch.from_numpy(chosen[0]).long())
    assert got.dtype == torch.bfloat16 and got_corr.dtype == torch.float32
    want = np.asarray(want.astype(jnp.float32))
    want_corr = np.asarray(want_corr)
    assert (np.abs(got.float().numpy() - want).max()
            <= TOL_BF16 * np.abs(want).max())
    assert (np.abs(got_corr.numpy() - want_corr).max()
            <= TOL_BF16_CORR * np.abs(want_corr).max())
    # and the 16-bit op is another function than the fp32 one
    fp32, _ = tac.auto_correlation(
        *(torch.from_numpy(a) for a in (q, k, v)), training=training,
        delays=torch.from_numpy(chosen[0]).long())
    assert (got.float() - fp32).abs().max() > 0
