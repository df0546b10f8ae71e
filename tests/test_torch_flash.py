"""PyTorch port vs the JAX package: the fused (flash) attention op.

The port runs on the CPU (the kernels' plain versions); the JAX package runs
its Pallas kernel in interpret mode, which it selects itself on the CPU, as
its own tests do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fine_grained_gaussian_process_forcasting_tpu.ops.pallas import (
    flash_attention as jflash,
)
from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (
    flash_attention as tflash,
)

# fp32: the JAX package's own kernel-vs-XLA tolerances
# (tests/test_pallas_kernels.py): forward rtol 1e-4 / atol 1e-5, gradients
# rtol 2e-3 / atol 1e-4
RTOL_FWD, ATOL_FWD = 1e-4, 1e-5
RTOL_GRAD, ATOL_GRAD = 2e-3, 1e-4
# bf16 operands: both sides round P (and dS) to bf16 at the same places, but
# sum in another order, so a value next to a rounding boundary may land one
# bf16 step apart: 2^-7 of the largest magnitude
TOL_BF16 = 2.0 ** -7
# the sm_bf16 softmax: every probability is itself a bf16 value that went
# through three roundings (s - max, exp, the division), and XLA and torch
# evaluate the bf16 exp and division in their own ways, so a few
# probabilities differ by one bf16 step: 2^-6 of the largest magnitude, for
# fp32 operands too
TOL_SM16 = 2.0 ** -6

SHAPES = {"self": (24, 24), "cross": (12, 24), "ragged": (31, 17)}


def _qkv(lq, lk, seed, d=64, b=2, h=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, n, d)).astype(np.float32)
            for n in (lq, lk, lk)]


def _bf16_pair(a):
    """The same bf16 values as a jax and a torch array."""
    t = torch.from_numpy(a).bfloat16()
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


def _assert_close_bf16(got, want, name="", rel=TOL_BF16):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    tol = rel * np.abs(want).max()
    assert np.abs(got - want).max() <= tol, (name, np.abs(got - want).max(),
                                             tol)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_fused_attention_plain_matches_jax_pallas(shape):
    lq, lk = SHAPES[shape]
    q, k, v = _qkv(lq, lk, seed=lq + lk)
    want = jflash.fused_attention(*(jnp.asarray(a) for a in (q, k, v)))
    got = tflash.fused_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert got.shape == (2, 2, lq, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL_FWD,
                               atol=ATOL_FWD)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_fused_attention_bwd_plain_matches_jax_vjp(shape):
    lq, lk = SHAPES[shape]
    q, k, v = _qkv(lq, lk, seed=3 * lq + lk)
    do = np.random.default_rng(lq).normal(size=q.shape).astype(np.float32)
    _, vjp = jax.vjp(jflash.fused_attention,
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    got = tflash.fused_attention_bwd_plain(
        *(torch.from_numpy(a) for a in (q, k, v, do)))
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL_GRAD,
                                   atol=ATOL_GRAD, err_msg=name)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_fused_attention_bf16_plain_matches_jax_pallas(shape):
    lq, lk = SHAPES[shape]
    pairs = [_bf16_pair(a) for a in _qkv(lq, lk, seed=5 * lq + lk)]
    want = jflash.fused_attention(*(p[0] for p in pairs))
    got = tflash.fused_attention(*(p[1] for p in pairs))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _assert_close_bf16(got, want)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_fused_attention_bf16_bwd_plain_matches_jax_vjp(shape):
    lq, lk = SHAPES[shape]
    arrays = _qkv(lq, lk, seed=7 * lq + lk)
    do = np.random.default_rng(lk).normal(size=arrays[0].shape).astype(
        np.float32)
    pairs = [_bf16_pair(a) for a in arrays + [do]]
    _, vjp = jax.vjp(jflash.fused_attention, *(p[0] for p in pairs[:3]))
    want = vjp(pairs[3][0])
    got = tflash.fused_attention_bwd_plain(*(p[1] for p in pairs))
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16, name
        _assert_close_bf16(g, w, name)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_fused_attention_bf16sm_plain_matches_jax_pallas(shape, dtype):
    """The sm_bf16 variant, forward and VJP."""
    lq, lk = SHAPES[shape]
    arrays = _qkv(lq, lk, seed=11 * lq + lk)
    arrays.append(np.random.default_rng(lk).normal(
        size=arrays[0].shape).astype(np.float32))
    if dtype == "bf16":
        pairs = [_bf16_pair(a) for a in arrays]
    else:
        pairs = [(jnp.asarray(a), torch.from_numpy(a)) for a in arrays]
    want, vjp = jax.vjp(jflash.fused_attention_bf16sm,
                        *(p[0] for p in pairs[:3]))
    got = tflash.fused_attention_bf16sm(*(p[1] for p in pairs[:3]))
    assert got.dtype == pairs[0][1].dtype
    _assert_close_bf16(got, want, "out", TOL_SM16)
    grads = tflash.fused_attention_bwd_plain(*(p[1] for p in pairs),
                                             sm_bf16=True)
    for g, w, name in zip(grads, vjp(pairs[3][0]), ("dq", "dk", "dv")):
        assert g.dtype == pairs[0][1].dtype, name
        _assert_close_bf16(g, w, name, TOL_SM16)
    # another function than the fp32 softmax's
    exact = tflash.fused_attention(*(p[1] for p in pairs[:3]))
    assert (got.float() - exact.float()).abs().max() > 1e-4


@pytest.mark.parametrize("shape", ["self", "cross"])
def test_fused_attention_bwd_plain_matches_autograd(shape):
    """fp32: the VJP rule is the derivative of the plain forward."""
    lq, lk = SHAPES[shape]
    arrays = _qkv(lq, lk, seed=lq + 2 * lk, d=72)
    do = torch.from_numpy(np.random.default_rng(1).normal(
        size=arrays[0].shape).astype(np.float32))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    tflash.fused_attention_plain(*leaves).backward(do)
    got = tflash.fused_attention_bwd_plain(
        *(torch.from_numpy(a) for a in arrays), do)
    for g, leaf, name in zip(got, leaves, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(),
                                   rtol=RTOL_GRAD, atol=ATOL_GRAD,
                                   err_msg=name)


@pytest.mark.parametrize("sm_bf16", [False, True], ids=["sm_fp32", "sm_bf16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_fused_attention_on_cpu_differentiates_by_its_own_rule(dtype,
                                                               sm_bf16):
    """With inputs that require grad the CPU wrapper is an autograd Function
    over the plain forward and the plain VJP (which rounds P and dS for
    bf16), bit for bit."""
    arrays = [torch.from_numpy(a).to(dtype) for a in _qkv(24, 17, seed=2)]
    do = torch.from_numpy(np.random.default_rng(3).normal(
        size=arrays[0].shape).astype(np.float32)).to(dtype)
    leaves = [a.clone().requires_grad_(True) for a in arrays]
    wrapper = (tflash.fused_attention_bf16sm if sm_bf16
               else tflash.fused_attention)
    out = wrapper(*leaves)
    assert torch.equal(out, tflash.fused_attention_plain(*arrays, sm_bf16))
    out.backward(do)
    want = tflash.fused_attention_bwd_plain(*arrays, do, sm_bf16)
    for leaf, w, name in zip(leaves, want, ("dq", "dk", "dv")):
        assert leaf.grad.dtype == dtype and torch.equal(leaf.grad, w), name
    assert tflash.launches == 0 and tflash.bwd_launches == 0
    assert tflash.sm16_launches == 0 and tflash.sm16_bwd_launches == 0


# head dims that the kernels pad inside their tiles, as the Pallas kernel
# pads d to the lane width: the same function at every d
PADDED = [("fp32", 60), ("fp32", 100), ("fp32", 128), ("bf16", 60),
          ("bf16", 72), ("bf16", 100), ("bf16", 128)]


def _pairs(arrays, dtype):
    if dtype == "bf16":
        return [_bf16_pair(a) for a in arrays]
    return [(jnp.asarray(a), torch.from_numpy(a)) for a in arrays]


def _assert_close(got, want, dtype, name=""):
    if dtype == "bf16":
        _assert_close_bf16(got, want, name)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL_GRAD, atol=ATOL_GRAD,
                                   err_msg=name)


@pytest.mark.parametrize("dtype,d", PADDED)
def test_fused_attention_plain_matches_jax_pallas_at_padded_head_dims(
        dtype, d):
    """The head dims the kernels used to refuse: forward against the Pallas
    kernel (interpret mode, d zero-padded to the lane width)."""
    pairs = _pairs(_qkv(24, 17, seed=d, d=d), dtype)
    want = jflash.fused_attention(*(p[0] for p in pairs))
    got = tflash.fused_attention(*(p[1] for p in pairs))
    assert got.shape == (2, 2, 24, d)
    if dtype == "bf16":
        _assert_close_bf16(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL_FWD, atol=ATOL_FWD)


@pytest.mark.parametrize("dtype,d", PADDED)
def test_fused_attention_bwd_plain_matches_jax_vjp_at_padded_head_dims(
        dtype, d):
    arrays = _qkv(24, 17, seed=d + 1, d=d)
    arrays.append(np.random.default_rng(d).normal(
        size=arrays[0].shape).astype(np.float32))
    pairs = _pairs(arrays, dtype)
    _, vjp = jax.vjp(jflash.fused_attention, *(p[0] for p in pairs[:3]))
    want = vjp(pairs[3][0])
    got = tflash.fused_attention_bwd_plain(*(p[1] for p in pairs))
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert tuple(g.shape) == w.shape, name
        _assert_close(g, w, dtype, name)


@pytest.mark.parametrize("case,error,match", [
    ("d0", ValueError, "head dim 0"),
    ("fp16", TypeError, "bfloat16 or float32"),
    ("mixed", TypeError, "k is"),
    ("strided", ValueError, "contiguous"),
    ("shapes", ValueError, "do not match"),
])
def test_fused_attention_refuses_what_the_kernel_does_not_take(case, error,
                                                               match):
    """Every head dim d >= 1 is taken (the kernels pad inside their tiles);
    what stays refused: an empty head dim, fp16, mixed dtypes, strides and
    shape mismatches."""
    q, k, v = (torch.zeros(1, 2, 8, 64) for _ in range(3))
    if case == "d0":
        q, k, v = (torch.zeros(1, 2, 8, 0) for _ in range(3))
    elif case == "fp16":
        q, k, v = (t.half() for t in (q, k, v))
    elif case == "mixed":
        k = k.bfloat16()
    elif case == "strided":
        q = torch.zeros(1, 2, 16, 64)[:, :, ::2]
    else:
        v = torch.zeros(1, 2, 9, 64)
    with pytest.raises(error, match=match):
        tflash._check(q, k, v)
