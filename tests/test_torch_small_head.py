"""PyTorch port vs the JAX package: small-head attention (d <= 8), the
forward and the VJP.  JAX runs its Pallas kernel in interpret mode on the
CPU, as its own tests do; the port runs the kernel's plain versions, which
its CPU wrapper takes.  The cases of ``_torch_small_head_cases`` are the
card tests' inputs (``test_torch_gpu.py``), each held here against JAX."""

import _torch_small_head_cases as cases
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fine_grained_gaussian_process_forcasting_tpu.ops.pallas.small_head_attention import (
    small_head_attention as jax_small_head,
)
from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (
    small_head_attention as sha,
)

# the JAX package's own tolerances for this kernel
# (tests/test_pallas_kernels.py): forward rtol 1e-4 / atol 1e-5, gradients
# rtol 2e-3 / atol 1e-4
FWD = dict(rtol=1e-4, atol=1e-5)
BWD = dict(rtol=2e-3, atol=1e-4)


def _inputs(d, lq, lk, seed):
    rng = np.random.default_rng(seed)
    shapes = [(2, 3, lq, d), (2, 3, lk, d), (2, 3, lk, d), (2, 3, lq, d)]
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("lengths", [(24, 24), (12, 20)],
                         ids=["self", "cross"])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_small_head_forward_and_vjp_match_jax(d, lengths):
    q, k, v, do = _inputs(d, *lengths, seed=d)
    want, vjp = jax.vjp(jax_small_head, jnp.asarray(q), jnp.asarray(k),
                        jnp.asarray(v))
    want_grads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    got = sha.small_head_attention(tq, tk, tv)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
    got.backward(torch.from_numpy(do))
    plain = sha.small_head_attention_bwd_plain(
        *(torch.from_numpy(a) for a in (q, k, v, do)))
    for t, p, w in zip((tq, tk, tv), plain, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **BWD)
        np.testing.assert_array_equal(t.grad.numpy(), p.numpy())
    np.testing.assert_array_equal(
        sha.small_head_attention_plain(tq, tk, tv).detach().numpy(),
        got.detach().numpy())


def _assert_matches_jax(q, k, v, do):
    """The port's op and its VJP (the plain versions, on the CPU) against
    the JAX package's on the same inputs, at the JAX tolerances."""
    want, vjp = jax.vjp(jax_small_head, jnp.asarray(q), jnp.asarray(k),
                        jnp.asarray(v))
    want_grads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    got = sha.small_head_attention(tq, tk, tv)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
    got.backward(torch.from_numpy(do))
    for t, w in zip((tq, tk, tv), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **BWD)


@pytest.mark.parametrize("b,h,lq,lk,d", cases.SHAPES)
def test_small_head_card_cases_match_jax(b, h, lq, lk, d):
    """Every shape the card tests run, up to Lk 1600 and Lq 1153."""
    _assert_matches_jax(*cases.inputs(b, h, lq, lk, d, seed=lq + lk + d))


@pytest.mark.parametrize("name", cases.SCORE_CASES)
def test_small_head_rising_and_jumping_scores_match_jax(name):
    """Scores that rise along the keys, and one key far above the rest:
    the cases that take the card's forward through its rescale, at 3 and
    at 6 query rows a lane."""
    _assert_matches_jax(*cases.score_case(name))


def test_chip_smoke_counts_attention_work_by_one_formula():
    """The head-folded and small-head entries of ``chip_smoke.py`` take
    their bounds from one count: 4d + 3 flops a (query, key) pair forward,
    10d + 3 backward, one exponential a pair, and the bytes of q, k, v and
    the output (forward) or of q, dO, dq, k, v, dk, dv (backward)."""
    import chip_smoke

    n, lq, lk, d = 2048, 96, 192, 4
    pairs = n * lq * lk
    assert chip_smoke.attention_work(n, lq, lk, d, "fwd") == (
        (4 * d + 3) * pairs, pairs, 4 * n * d * (2 * lq + 2 * lk))
    assert chip_smoke.attention_work(n, lq, lk, d, "bwd") == (
        (10 * d + 3) * pairs, pairs, 4 * n * d * (3 * lq + 4 * lk))
    # the flagship's three calls at b 256, h 8, d 4: the bounds both
    # kernels' rows of the kernel table carry
    bounds = {way: [round(chip_smoke.bound(*chip_smoke.attention_work(
        n, lq_, lk_, d, way))[0], 4) for lq_, lk_ in chip_smoke.ATTENTION_CALLS
        .values()] for way in ("fwd", "bwd")}
    assert bounds == {"fwd": [0.0214, 0.0054, 0.0107],
                      "bwd": [0.0485, 0.0121, 0.0242]}


def test_small_head_returns_the_input_dtype():
    q, k, v, _ = _inputs(4, 8, 8, seed=3)
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    out = sha.small_head_attention(*args)
    assert out.dtype == torch.bfloat16
    want = sha.small_head_attention_plain(*(a.float() for a in args))
    torch.testing.assert_close(out, want.to(torch.bfloat16))


def test_small_head_refuses_wide_heads():
    q, k, v, _ = _inputs(9, 8, 8, seed=4)
    with pytest.raises(ValueError, match="1..8"):
        sha.small_head_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    with pytest.raises(ValueError, match="match"):
        sha.small_head_attention(torch.zeros(1, 1, 4, 4),
                                 torch.zeros(1, 1, 4, 2),
                                 torch.zeros(1, 1, 4, 2))
