"""PyTorch port vs the JAX package: attention ops and the ``basic`` route.

The port runs on the CPU (its kernels' plain versions); the JAX package runs
its head-folded Pallas kernel in interpret mode, as its own tests do.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fine_grained_gaussian_process_forcasting_tpu.ops import attention as jatt
from fine_grained_gaussian_process_forcasting_tpu.ops import (
    autocorrelation as jac,
)
from fine_grained_gaussian_process_forcasting_tpu.ops.pallas import (
    head_folded_attention as jhfa,
)
from fine_grained_gaussian_process_forcasting_torch.models.transformer import (
    basic_attention_route,
)
from fine_grained_gaussian_process_forcasting_torch.ops import attention as tatt
from fine_grained_gaussian_process_forcasting_torch.ops import (
    autocorrelation as tac,
)
from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (
    head_folded_attention as thfa,
)

# fp32 softmax attention in both frameworks: 1e-5, the JAX package's own
# kernel-vs-XLA tolerance (tests/test_pallas_kernels.py)
TOL = 1e-5


def _qkv(b, h, lq, lk, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, lq, d)).astype(np.float32),
            rng.normal(size=(b, h, lk, d)).astype(np.float32),
            rng.normal(size=(b, h, lk, d)).astype(np.float32))


def test_scaled_dot_attention_matches_jax():
    q, k, v = _qkv(2, 4, 12, 24, 4, seed=0)
    want_ctx, want_attn = jatt.scaled_dot_attention(
        *(jnp.asarray(a) for a in (q, k, v)))
    got_ctx, got_attn = tatt.scaled_dot_attention(
        *(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got_ctx.numpy(), np.asarray(want_ctx),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_attn.numpy(), np.asarray(want_attn),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("lq,lk", [(24, 24), (12, 24)], ids=["self",
                                                              "cross"])
def test_head_folded_plain_matches_jax_pallas(lq, lk):
    q, k, v = _qkv(4, 4, lq, lk, 4, seed=lq + lk)
    want = jhfa.head_folded_attention(*(jnp.asarray(a) for a in (q, k, v)))
    got = thfa.head_folded_attention(
        *(torch.from_numpy(a) for a in (q, k, v)))
    assert got.shape == (4, 4, lq, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


# gradients: the JAX package's kernel-gradient tolerances
# (tests/test_pallas_kernels.py)
RTOL_GRAD, ATOL_GRAD = 1e-4, 1e-5


@pytest.mark.parametrize("lq,lk", [(24, 24), (12, 24)], ids=["self",
                                                              "cross"])
def test_head_folded_bwd_plain_matches_jax_vjp(lq, lk):
    q, k, v = _qkv(4, 4, lq, lk, 4, seed=3 * lq + lk)
    do = np.random.default_rng(lq).normal(size=q.shape).astype(np.float32)
    _, vjp = jax.vjp(jhfa.head_folded_attention,
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    got = thfa.head_folded_attention_bwd_plain(
        *(torch.from_numpy(a) for a in (q, k, v, do)))
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL_GRAD,
                                   atol=ATOL_GRAD, err_msg=name)


@pytest.mark.parametrize("lq,lk", [(24, 24), (12, 24)], ids=["self",
                                                              "cross"])
def test_head_folded_bwd_plain_matches_autograd(lq, lk):
    arrays = _qkv(3, 2, lq, lk, 7, seed=lq + 2 * lk)
    do = torch.from_numpy(np.random.default_rng(1).normal(
        size=arrays[0].shape).astype(np.float32))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    thfa.head_folded_attention(*leaves).backward(do)  # CPU: plain
    got = thfa.head_folded_attention_bwd_plain(
        *(torch.from_numpy(a) for a in arrays), do)
    for g, leaf, name in zip(got, leaves, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(),
                                   rtol=RTOL_GRAD, atol=ATOL_GRAD,
                                   err_msg=name)


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("lq,lk", [(24, 24), (12, 24), (24, 12)])
def test_auto_correlation_matches_jax(training, lq, lk):
    q, k, v = _qkv(4, 4, lq, lk, 4, seed=7 * lq + lk)
    want_ctx, want_corr = jac.auto_correlation(
        *(jnp.asarray(a) for a in (q, k, v)), training=training)
    got_ctx, got_corr = tac.auto_correlation(
        *(torch.from_numpy(a) for a in (q, k, v)), training=training)
    top_k = int(math.log(lq))
    want_corr, got_corr = np.asarray(want_corr), got_corr.numpy()
    if training:
        want_delays = jax.lax.top_k(want_corr.mean(0), top_k)[1]
        got_delays = torch.topk(torch.from_numpy(got_corr).mean(0),
                                top_k).indices
    else:
        want_delays = jax.lax.top_k(want_corr, top_k)[1]
        got_delays = torch.topk(torch.from_numpy(got_corr), top_k,
                                dim=-1).indices
    # the same delays first: a flipped near-tie would be a different answer
    np.testing.assert_array_equal(np.sort(got_delays.numpy(), -1),
                                  np.sort(np.asarray(want_delays), -1))
    np.testing.assert_allclose(got_corr, want_corr, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_ctx.numpy(), np.asarray(want_ctx),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_auto_correlation_replays_given_delays(training):
    b, h, L, d = 3, 2, 24, 4
    q, k, v = (torch.from_numpy(a) for a in _qkv(b, h, L, L, d, seed=11))
    ctx, corr = tac.auto_correlation(q, k, v, training=training)
    top_k = int(math.log(L))
    own = (torch.topk(corr.mean(0), top_k).indices if training
           else torch.topk(corr, top_k, dim=-1).indices)
    # its own choice, in another order: the same function
    replayed, _ = tac.auto_correlation(q, k, v, training=training,
                                       delays=own.flip(-1))
    np.testing.assert_allclose(replayed.numpy(), ctx.numpy(), rtol=TOL,
                               atol=TOL)
    # other delays: the weighted sum of those rolls, by hand
    rng = np.random.default_rng(12)
    shape = (top_k,) if training else (b, top_k)
    forced = np.stack([rng.choice(L, top_k, replace=False)
                       for _ in range(int(np.prod(shape[:-1])))]
                      ).reshape(shape)
    got, _ = tac.auto_correlation(q, k, v, training=training,
                                  delays=torch.from_numpy(forced))
    per_sample = np.broadcast_to(forced, (b, top_k))
    c, vn = corr.numpy(), v.numpy()
    want = np.zeros_like(vn)
    for i in range(b):
        w = np.exp(c[i, per_sample[i]] - c[i, per_sample[i]].max())
        w /= w.sum()
        for wj, delay in zip(w, per_sample[i]):
            want[i] += wj * np.roll(vn[i], -delay, axis=1)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


CPU, CUDA = torch.device("cpu"), torch.device("cuda")


@pytest.mark.parametrize("device,d_k,is_self,flag,route", [
    (CPU, 4, True, None, "plain"),
    (CPU, 4, False, True, "plain"),
    (CPU, 64, True, None, "plain"),
    (CUDA, 4, True, None, "head_folded"),
    (CUDA, 4, False, None, "head_folded"),
    (CUDA, 63, False, None, "head_folded"),
    (CUDA, 64, False, None, "plain"),
    (CUDA, 128, True, None, "plain"),
    (CUDA, 4, True, False, "plain"),
    (CUDA, 128, True, False, "plain"),
    (CUDA, 16, False, True, "head_folded"),
])
def test_basic_route_resolves_per_device(device, d_k, is_self, flag, route):
    assert basic_attention_route(device, d_k, is_self, flag) == route


@pytest.mark.parametrize("d_k,is_self,flag", [
    (64, True, None), (127, True, None), (64, False, True),
    (128, True, True)])
def test_basic_route_raises_where_flash_is_unported(d_k, is_self, flag):
    with pytest.raises(NotImplementedError, match="flash_attention"):
        basic_attention_route(CUDA, d_k, is_self, flag)
