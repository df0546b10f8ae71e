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


def test_scaled_dot_attention_bf16_matches_jax():
    """bf16 operands: fp32 scores and softmax, bf16 probabilities into the
    second product, bf16 context; within one bf16 step (2^-7 of the largest
    magnitude) where the two sum in another order."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(2, 2, 12, 24, 64, seed=4))
    want_ctx, want_attn = jatt.scaled_dot_attention(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (q, k, v)))
    got_ctx, got_attn = tatt.scaled_dot_attention(q, k, v)
    assert got_ctx.dtype == torch.bfloat16 and got_attn.dtype == torch.float32
    np.testing.assert_allclose(got_attn.numpy(), np.asarray(want_attn),
                               rtol=TOL, atol=TOL)
    want = np.asarray(want_ctx.astype(jnp.float32))
    assert (np.abs(got_ctx.float().numpy() - want).max()
            <= 2.0 ** -7 * np.abs(want).max())


def test_matmul16_rounds_once():
    """``matmul16`` on bf16 operands: exact products summed in fp32 and
    rounded once, so each element lies within half a bf16 step (2^-8
    relative) of the float64 product, up to the fp32 sum's own error, and
    within one bf16 step (2^-7 relative) of the JAX product of the same
    operands.  On the CPU it sums in the fp32 GEMM's order, as the JAX
    package's CPU runs do: with ``torch.matmul`` on the bf16 operands in its
    place (as accurate, another order, a few sums in ten thousand rounded
    the other way) ``test_first_step_gradients_match_jax[wide_basic_bf16]``
    of ``tests/test_torch_train.py`` fails its tolerance on the GP's
    parameters."""
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.normal(size=(48, 512)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(512, 40)).astype(np.float32))
    a, b = a.bfloat16(), b.bfloat16()
    got = tatt.matmul16(a, b)
    assert got.dtype == torch.bfloat16
    exact = a.double() @ b.double()
    slack = 1e-6 * (a.double().abs() @ b.double().abs())
    assert bool(((got.double() - exact).abs()
                 <= 2.0 ** -8 * exact.abs() + slack).all())
    want = np.asarray(jnp.matmul(
        jnp.asarray(a.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(b.float().numpy()).astype(jnp.bfloat16)).astype(
            jnp.float32))
    assert bool((np.abs(got.float().numpy() - want)
                 <= 2.0 ** -7 * np.abs(want) + 1e-6).all())


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


def _folded(b, h, length, d, seed):
    """A (b, L, h, d) buffer as the projections write it."""
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, length, h, d)).astype(np.float32)


@pytest.mark.parametrize("d", [4, 7])
@pytest.mark.parametrize("lq,lk", [(24, 24), (12, 24)], ids=["self",
                                                              "cross"])
def test_head_folded_takes_projection_views_like_jax(lq, lk, d):
    """The transformer hands the wrapper (b, h, L, d) views of (b, L, h, d)
    buffers (the projections' own layout, as the TPU kernel took its
    operands); forward and gradients equal the JAX Pallas kernel's on the
    same values, and the outputs have the documented shapes."""
    b, h = 2, 3
    bufs = [_folded(b, h, n, d, seed=10 * d + i)
            for i, n in enumerate((lq, lk, lk))]
    do_buf = _folded(b, h, lq, d, seed=d)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in bufs]
    views = [t.transpose(1, 2) for t in leaves]
    assert all(t.stride(-1) == 1 and not t.is_contiguous() for t in views)
    got = thfa.head_folded_attention(*views)
    assert tuple(got.shape) == (b, h, lq, d)
    jargs = [jnp.asarray(a.transpose(0, 2, 1, 3)) for a in bufs]
    want, vjp = jax.vjp(jhfa.head_folded_attention, *jargs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    do = torch.from_numpy(do_buf).transpose(1, 2)
    got.backward(do)
    want_grads = vjp(jnp.asarray(do_buf.transpose(0, 2, 1, 3)))
    plain = thfa.head_folded_attention_bwd_plain(
        *(t.detach() for t in views), do)
    for leaf, p, w, name in zip(leaves, plain, want_grads, ("dq", "dk",
                                                            "dv")):
        # the gradient reaches the (b, L, h, d) buffer itself
        assert tuple(leaf.grad.shape) == leaf.shape, name
        assert tuple(p.shape) == w.shape, name
        for g in (leaf.grad.transpose(1, 2), p):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=RTOL_GRAD, atol=ATOL_GRAD,
                                       err_msg=name)


def test_folded_empty_is_a_view_of_the_projection_layout():
    out = thfa.folded_empty(2, 3, 5, 4, "cpu")
    assert tuple(out.shape) == (2, 3, 5, 4)
    assert out.stride() == (60, 4, 12, 1)
    # back into (b, L, h d) rows without a copy
    rows = out.transpose(1, 2).reshape(2, 5, 12)
    assert rows.data_ptr() == out.data_ptr() and rows.is_contiguous()


@pytest.mark.parametrize("h,lq,lk,d,plan", [
    (8, 192, 192, 4, (4, 2)),   # the flagship's enc-self call
    (8, 96, 96, 4, (8, 1)),     # dec-self
    (8, 96, 192, 4, (4, 2)),    # dec-cross
    (1, 1, 1, 1, (1, 1)),
    (4, 50, 37, 7, (4, 1)),
    (3, 256, 385, 16, (1, 4)),  # the longest query rows the fused route holds
    (8, 257, 96, 4, (0, 0)),    # longer: the streamed route
    (2, 130, 65, 33, (0, 0)),   # d > 16: the streamed route
    (1, 256, 2000, 16, (0, 0)),  # keys past the card's shared memory
])
def test_head_folded_bwd_plan(h, lq, lk, d, plan):
    """The backward's route and its blocks: the fused route holds every
    query row and key of its heads in shared memory, within the card's
    227 KB, and at most 16 warps a block (8 above a padded head dim of
    4)."""
    assert thfa.bwd_plan(h, lq, lk, d) == plan
    hb, wph = plan
    if hb:
        dp = thfa.padded_head_dim(d)
        rows = -(-lq // (32 // dp)) * (32 // dp)
        smem = 4 * hb * (rows * (2 * dp + 2 + wph * dp) + 2 * lk * dp)
        assert smem == thfa.fused_smem_bytes(hb, wph, lq, lk, d)
        assert smem <= 227 * 1024
        assert hb * wph <= (16 if dp == 4 else 8)
        assert wph <= -(-lk // (32 * {4: 3, 8: 2, 16: 1}[dp]))


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
    (CUDA, 64, True, None, "flash"),
    (CUDA, 127, True, None, "flash"),
    (CUDA, 64, False, True, "flash"),
    (CUDA, 128, True, True, "flash"),
    (CUDA, 64, True, False, "plain"),
    (CPU, 64, True, True, "plain"),
])
def test_basic_route_resolves_per_device(device, d_k, is_self, flag, route):
    """The JAX rule (``models/transformer.py``), with the CPU always plain:
    auto takes a kernel below d_k 128 for self-attention and below 64 for
    cross-attention; the kernel is the flash one from d_k 64 on."""
    assert basic_attention_route(device, d_k, is_self, flag) == route
