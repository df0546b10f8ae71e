"""PyTorch port vs the JAX package: small-head attention (d <= 8), the
forward and the VJP.  JAX runs its Pallas kernel in interpret mode on the
CPU, as its own tests do; the port runs the kernel's plain versions, which
its CPU wrapper takes."""

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
