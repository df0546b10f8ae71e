"""PyTorch port vs the JAX package: the batched Cholesky, the exact GP and
the exact-GP blur.

Inputs come from numpy seeds and go through both implementations; the port
runs on the CPU (the Cholesky kernel's plain version: the library's
factorization, NaN where it fails), the JAX package runs its Pallas
Cholesky in interpret mode, as its own tests do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fine_grained_gaussian_process_forcasting_tpu.gp import exact as jexact
from fine_grained_gaussian_process_forcasting_tpu.gp import (
    exact_blur as jblur,
)
from fine_grained_gaussian_process_forcasting_tpu.ops.pallas import (
    cholesky as jchol,
)
from fine_grained_gaussian_process_forcasting_torch import gp as tgp
from fine_grained_gaussian_process_forcasting_torch.gp import exact as texact
from fine_grained_gaussian_process_forcasting_torch.gp import (
    exact_blur as tblur,
)
from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (
    cholesky as tchol,
)
from fine_grained_gaussian_process_forcasting_torch.params import (
    from_flax,
    to_flax,
)

# the JAX package's Cholesky-kernel tolerance (tests/test_pallas_kernels.py)
TOL_CHOL = 2e-3
# fp32 through a factorization and its solves, summed in another order by
# each framework: 1e-4
TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _spd(b, n, seed):
    x = np.random.default_rng(seed).normal(size=(b, n, n)).astype(np.float32)
    return x @ x.transpose(0, 2, 1) + 5 * np.eye(n, dtype=np.float32)


@pytest.mark.parametrize("b,n", [(3, 64), (2, 100), (4, 192)])
def test_batched_cholesky_matches_jax(b, n):
    a = _spd(b, n, seed=7)
    want = np.asarray(jchol.batched_cholesky(jnp.asarray(a)))
    got = tchol.batched_cholesky(_t(a))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL_CHOL,
                               atol=TOL_CHOL)
    assert torch.equal(torch.triu(got, 1), torch.zeros_like(got))
    assert tchol.launches == 0  # the CPU runs the plain version


def test_batched_cholesky_indefinite_gives_nan_not_an_exception():
    a = _spd(3, 24, seed=1)
    a[1] -= 200.0 * np.eye(24, dtype=np.float32)  # not positive definite
    want = np.asarray(jchol.batched_cholesky(jnp.asarray(a)))
    got = tchol.batched_cholesky(_t(a)).numpy()
    assert np.isnan(got[1]).all()  # the whole matrix, as jnp's cholesky
    assert not np.isfinite(want[1]).all()
    for i in (0, 2):
        np.testing.assert_allclose(got[i], want[i], rtol=TOL_CHOL,
                                   atol=TOL_CHOL)


def test_batched_cholesky_gradients_match_jax():
    """Only the symmetric part of dA is defined; compared as the JAX
    package's own test compares it."""
    a = _spd(2, 32, seed=8)
    want = jax.grad(lambda m: jnp.sum(jnp.sin(jchol.batched_cholesky(m))))(
        jnp.asarray(a))
    leaf = _t(a).requires_grad_(True)
    torch.sin(tchol.batched_cholesky(leaf)).sum().backward()

    def sym(m):
        m = np.asarray(m)
        return 0.5 * (m + np.swapaxes(m, -1, -2))

    np.testing.assert_allclose(sym(leaf.grad.numpy()), sym(want),
                               rtol=TOL_CHOL, atol=TOL_CHOL)
    # the pullback is symmetric by construction
    np.testing.assert_allclose(leaf.grad.numpy(),
                               np.swapaxes(leaf.grad.numpy(), -1, -2),
                               rtol=1e-5, atol=1e-6)


def _exact_inputs(seed=4, n=30, d=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (np.sin(2 * x[:, 0]) + 0.1 * rng.normal(size=n)).astype(np.float32)
    x_star = rng.normal(size=(7, d)).astype(np.float32)
    params = [rng.normal(size=(d,)) * 0.3, 0.4, -1.0, 0.2]
    return x, y, x_star, [np.asarray(p, np.float32) for p in params]


@pytest.mark.parametrize("fn", ["posterior", "mll"])
def test_exact_gp_matches_jax(fn):
    """Values and the gradients of every parameter and of x."""
    x, y, x_star, params = _exact_inputs()
    if fn == "posterior":
        def jfn(p, xx):
            mean, var = jexact.exact_gp_posterior(jexact.ExactGPParams(*p),
                                                  xx, jnp.asarray(y),
                                                  jnp.asarray(x_star))
            return mean, var

        def tfn(p, xx):
            return texact.exact_gp_posterior(texact.ExactGPParams(*p), xx,
                                             _t(y), _t(x_star))
    else:
        def jfn(p, xx):
            return (jexact.exact_gp_mll(jexact.ExactGPParams(*p), xx,
                                        jnp.asarray(y)),)

        def tfn(p, xx):
            return (texact.exact_gp_mll(texact.ExactGPParams(*p), xx,
                                        _t(y)),)

    def jloss(p, xx):
        return sum(jnp.sum(jnp.sin(o)) for o in jfn(p, xx))

    jp = [jnp.asarray(p) for p in params]
    want = jfn(jp, jnp.asarray(x))
    want_grads = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = [_t(p).requires_grad_(True) for p in params]
    xl = _t(x).requires_grad_(True)
    got = tfn(leaves, xl)
    sum(torch.sin(o).sum() for o in got).backward()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=TOL, atol=TOL)
    for g, w, name in zip(leaves + [xl], list(want_grads[0]) + [want_grads[1]],
                          list(texact.ExactGPParams._fields) + ["x"]):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=name)


def test_gp_package_exports_what_jax_exports():
    from fine_grained_gaussian_process_forcasting_tpu import gp as jgp

    assert set(tgp.__all__) == set(jgp.__all__)
    params = tgp.init_exact_gp(3, device="cpu")
    assert all(float(p.abs().sum()) == 0.0 for p in params)
    assert params.raw_lengthscale.shape == (3,)


def _indefinite_gram(n=6):
    """A Gram matrix whose smallest eigenvalue is -1.6e-3 of the mean
    diagonal, a borderline case: the jitter 1e-4 and 1e-3 of the mean
    diagonal leave it indefinite, 1e-2 does not."""
    rng = np.random.default_rng(3)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    eig = np.linspace(1.0, 2.0, n)
    eig[0] = -1.6e-3 * eig.mean()
    return (q * eig) @ q.T


def test_psd_safe_cholesky_escalates_as_jax():
    k = _indefinite_gram().astype(np.float32)
    want = np.asarray(jexact.psd_safe_cholesky(jnp.asarray(k)))
    got = texact.psd_safe_cholesky(_t(k)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # the jitter it took: 1e-4 * mean diag * 10^2
    jit = 1e-2 * np.trace(k) / len(k)
    np.testing.assert_allclose(got @ got.T - k, jit * np.eye(len(k)),
                               rtol=0, atol=1e-5)


def _blur_pair(use_pallas, d=3, seed=0, **init):
    jmod = jblur.ExactGPBlur(input_dims=d, use_pallas=use_pallas, **init)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 4, d)))["params"])
    tmod = tblur.ExactGPBlur(d, use_pallas=use_pallas, device="cpu", **init)
    assert set(tmod.state_dict()) == set(params)
    return jmod, params, tmod


def _blur_check(jmod, params, tmod, x, y, grads=True):
    """smooth and mll, values and (``grads``) the gradients of every
    parameter and of x, against the JAX module with the same parameters."""
    c = np.random.default_rng(5).normal(size=y.shape).astype(np.float32)

    def jloss(p, xx):
        v = {"params": p}
        return (jnp.sum(jmod.apply(v, xx, method=jmod.smooth) * c)
                + jmod.apply(v, xx, jnp.asarray(y), method=jmod.mll))

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    v = {"params": jp}
    want_smooth = jmod.apply(v, jnp.asarray(x), method=jmod.smooth)
    want_mll = jmod.apply(v, jnp.asarray(x), jnp.asarray(y),
                          method=jmod.mll)
    want_grads = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tmod.load_state_dict(from_flax(params))
    xl = _t(x).requires_grad_(True)
    smooth = tmod.smooth(xl)
    mll = tmod.mll(xl, _t(y))
    ((smooth * _t(c)).sum() + mll).backward()
    np.testing.assert_allclose(smooth.detach().numpy(),
                               np.asarray(want_smooth), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(mll.detach()), float(want_mll),
                               rtol=TOL, atol=TOL)
    if not grads:
        return
    got_grads = to_flax({n: p.grad for n, p in tmod.named_parameters()})
    for name, w in want_grads[0].items():
        np.testing.assert_allclose(got_grads[name], np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=name)
    np.testing.assert_allclose(xl.grad.numpy(), np.asarray(want_grads[1]),
                               rtol=TOL, atol=TOL, err_msg="x")


@pytest.mark.parametrize("use_pallas", [False, True])
def test_exact_blur_matches_jax(use_pallas):
    jmod, params, tmod = _blur_pair(use_pallas, ls_init=-1.0,
                                    noise_init=0.1)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 12, 3)).astype(np.float32)
    y = rng.normal(size=(3, 12)).astype(np.float32)
    params["raw_outputscale"] = np.float32(0.7)
    params["mean_bias"] = np.float32(-0.3)
    _blur_check(jmod, params, tmod, x, y)
    assert tchol.launches == 0


@pytest.mark.parametrize("use_pallas", [False, True])
def test_exact_blur_escalation_matches_jax(use_pallas):
    """A batch whose Gram matrices are indefinite at the first jitter:
    integer points far from the origin, at lengthscale exactly 32, so that
    |x|^2 + |z|^2 - 2 x.z rounds the same way in any summation order and
    both frameworks compute the same K.  Both pick i = 2 (jitter 1e-2 of
    the mean diagonal).  Values only: the gradients of this batch are sums
    of terms of |x / 32|^2 ~ 1e7 that cancel, so each framework's rounding
    of them decides their value (the well-conditioned case above holds the
    gradients)."""
    jmod, params, tmod = _blur_pair(use_pallas, d=2)
    params["raw_lengthscale"] = np.full(2, 31.999, np.float32)  # + 1e-3 = 32
    params["raw_noise"] = np.float32(-20.0)  # the noise floor, 1e-4
    rng = np.random.default_rng(0)
    x = ((rng.integers(2048, 2600, size=(2, 1, 2))
          + rng.integers(0, 4, size=(2, 8, 2))) * 32).astype(np.float32)
    y = rng.normal(size=(2, 8)).astype(np.float32)
    tmod.load_state_dict(from_flax(params))
    with torch.no_grad():
        k, chol = tmod._factor(_t(x))
    noise = torch.nn.functional.softplus(tmod.raw_noise.detach()) + 1e-4
    a = k + noise * torch.eye(8)
    # the jitter it took: 1e-4 * the batch's mean diagonal * 10^2
    jit = 1e-2 * torch.diagonal(a, dim1=-2, dim2=-1).mean()
    torch.testing.assert_close(chol @ chol.transpose(-1, -2) - a,
                               jit * torch.eye(8).expand(2, 8, 8), rtol=0,
                               atol=1e-5)
    # JAX's factor is its factorization at the same jitter
    jk, jchol_ = jmod.apply({"params": params}, jnp.asarray(x),
                            method=jmod._factor)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), rtol=1e-6,
                               atol=1e-6)
    s0 = float(jnp.mean(jnp.diagonal(
        jk + (jax.nn.softplus(params["raw_noise"]) + 1e-4) * jnp.eye(8),
        axis1=-2, axis2=-1)))
    jfact = jchol.batched_cholesky if use_pallas else jnp.linalg.cholesky
    for i in (0, 1):  # the jitters JAX's probe rejects before i = 2
        a_i = jk + (jax.nn.softplus(params["raw_noise"]) + 1e-4
                    + 1e-4 * s0 * 10.0 ** i) * jnp.eye(8)
        assert not np.isfinite(np.asarray(jfact(a_i))).all(), i
    np.testing.assert_allclose(chol.numpy(), np.asarray(jchol_), rtol=TOL,
                               atol=TOL)
    _blur_check(jmod, params, tmod, x, y, grads=False)


def _needing(bumps, n=12, seed=7):
    """A symmetric matrix whose factorization first succeeds at jitter
    1e-4 * s0 * 10^bumps (s0 its mean diagonal): one eigenvalue between
    minus the jitters before and at that bump (geometric mean); bumps -1:
    positive definite; bumps 4: past every jitter (-1)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    eig = np.linspace(1.0, 2.0, n)
    s0 = eig.mean()  # the mean diagonal, to first order in the last one
    if bumps == 4:
        eig[0] = -1.0
    elif bumps >= 1:
        eig[0] = -1e-4 * s0 * 10.0 ** (bumps - 0.5)
    return ((q * eig) @ q.T).astype(np.float32)


@pytest.mark.parametrize("bumps", [0, 1, 2, 3, 4],
                         ids=["pd", "1", "2", "max_tries", "none_pd"])
def test_device_jitter_pick_is_jax_pick(bumps):
    """The candidates factored at once and picked on the device take JAX's
    jitter (0, 1, 2 and max_tries = 3 bumps), and NaN where no candidate
    is positive definite, as JAX's ``lax.while_loop`` gives."""
    k = _needing(bumps)
    want = np.asarray(jexact.psd_safe_cholesky(jnp.asarray(k)))
    got = texact.psd_safe_cholesky(_t(k)).numpy()
    if bumps == 4:  # NaN over the factor's triangle, on both sides
        lower = np.tril_indices(len(k))
        assert np.isnan(want[lower]).all() and np.isnan(got[lower]).all()
        return
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    jit = 1e-4 * np.trace(k) / len(k) * 10.0 ** min(bumps, 3)
    np.testing.assert_allclose(got @ got.T - k, jit * np.eye(len(k)),
                               rtol=0, atol=1e-5 + 1e-3 * jit)


def test_device_jitter_pick_is_shared_and_bit_equal():
    """A batch takes the jitter its neediest matrix takes; the factor is
    bit-equal to one factorization at that jitter (the eager result where
    the same i is chosen), and the pick reads nothing on the host: it
    exports."""
    a = np.stack([_needing(0), _needing(2)])
    t = _t(a)
    got = texact.psd_safe_cholesky(t)
    s0 = torch.diagonal(t, dim1=-2, dim2=-1).mean()
    eye = torch.eye(t.shape[-1])
    want = tchol.batched_cholesky_plain(
        t + 1e-4 * s0 * torch.tensor(10.0) ** 2 * eye)
    assert torch.equal(got, want)

    class Pick(torch.nn.Module):
        def forward(self, a):
            return texact.psd_safe_cholesky(a)

    program = torch.export.export(Pick(), (t,), strict=False)
    assert torch.equal(program.module()(t), want)
