"""PyTorch port vs the JAX package: GP kernels, fused-GP marginals, DeepGP.

Inputs come from numpy seeds and go through both implementations; the
port runs on the CPU (its kernels' plain versions), the JAX package runs
its Pallas kernels in interpret mode, as its own tests do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fine_grained_gaussian_process_forcasting_tpu.gp import deep_gp as jgp
from fine_grained_gaussian_process_forcasting_tpu.gp import kernels as jk
from fine_grained_gaussian_process_forcasting_tpu.ops.pallas import (
    fused_gp as jfused,
)
from fine_grained_gaussian_process_forcasting_torch.gp import deep_gp as tgp
from fine_grained_gaussian_process_forcasting_torch.gp import kernels as tk
from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (
    fused_gp as tfused,
)
from fine_grained_gaussian_process_forcasting_torch.params import from_flax

# fp32 in both frameworks, summed in another order: 1e-6 on O(1) values
# (the kernels), 2e-5 where an M-long reduction follows (the JAX package's
# own fused-GP tolerance, tests/test_fused_gp.py)
TOL_KERNELS = 1e-6
TOL_GP = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _kernel_inputs(seed=0, n=23, m=11, d=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, n, d)).astype(np.float32)
    z = rng.normal(size=(m, d)).astype(np.float32)
    ls = rng.uniform(0.8, 3.0, size=(d,)).astype(np.float32)
    return x, z, ls, np.float32(1.3)


@pytest.mark.parametrize("fn", ["softplus", "sq_dist", "rbf_ard"])
def test_gp_kernels_match_jax(fn):
    x, z, ls, os_ = _kernel_inputs()
    if fn == "softplus":
        raw = np.linspace(-6, 6, 41, dtype=np.float32)
        want, got = jk.softplus(jnp.asarray(raw)), tk.softplus(_t(raw))
    elif fn == "sq_dist":
        want = jk.sq_dist(jnp.asarray(x), jnp.asarray(z))
        got = tk.sq_dist(_t(x), _t(z))
    else:
        want = jk.rbf_ard(jnp.asarray(x), jnp.asarray(z), jnp.asarray(ls),
                          jnp.asarray(os_))
        got = tk.rbf_ard(_t(x), _t(z), _t(ls), torch.tensor(os_))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL_KERNELS, atol=TOL_KERNELS)


def _fused_inputs(b, n, d, m, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, d)).astype(np.float32)
    z = rng.normal(size=(m, d)).astype(np.float32)
    ls = np.full(d, np.sqrt(2.0 * d), np.float32)  # K far from 0
    lw = (0.1 * rng.normal(size=(m, m))).astype(np.float32)
    s2 = rng.uniform(0.0, 1.0, size=m).astype(np.float32)
    w = lw.T @ (lw * (1.0 - s2)[:, None])
    w = (0.5 * (w + w.T)).astype(np.float32)
    u = rng.normal(size=m).astype(np.float32)
    return (x, (z / ls).astype(np.float32), u, w, np.float32(0.9),
            (1.0 / ls).astype(np.float32),
            (rng.normal(size=d) / d).astype(np.float32), np.float32(0.2))


@pytest.mark.parametrize("b,n", [(4, 36), (3, 13)])
def test_fused_gp_plain_matches_jax_pallas(b, n):
    args = _fused_inputs(b, n, d=16, m=32, seed=n)
    want = jfused.whitened_marginals_affine(*(jnp.asarray(a) for a in args))
    got = tfused.whitened_marginals_affine(*(_t(a) for a in args))
    for g, w_ in zip(got, want):
        assert g.shape == (b, n)
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=TOL_GP,
                                   atol=TOL_GP)


# gradients: the JAX package's fused-GP gradient tolerances
# (tests/test_fused_gp.py)
RTOL_GRAD, ATOL_GRAD = 3e-4, 3e-5
GRAD_NAMES = ("x", "zs", "u", "w", "outputscale", "inv_ls", "mean_w",
              "mean_b")


def _cotangents(b, n, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, n)).astype(np.float32)
                 for _ in range(2))


@pytest.mark.parametrize("b,n", [(4, 36), (3, 13)])
def test_fused_gp_bwd_plain_matches_jax_vjp(b, n):
    """Row counts 144 and 39: neither is a multiple of any tile."""
    args = _fused_inputs(b, n, d=16, m=32, seed=n + 1)
    dmean, dvar = _cotangents(b, n, seed=n)
    _, vjp = jax.vjp(jfused.whitened_marginals_affine,
                     *(jnp.asarray(a) for a in args))
    want = vjp((jnp.asarray(dmean), jnp.asarray(dvar)))
    got = tfused.whitened_marginals_affine_bwd_plain(
        *(_t(a) for a in args), _t(dmean), _t(dvar))
    for g, w_, name in zip(got, want, GRAD_NAMES):
        assert tuple(g.shape) == np.shape(w_), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w_),
                                   rtol=RTOL_GRAD, atol=ATOL_GRAD,
                                   err_msg=name)


def test_fused_gp_bwd_plain_matches_autograd():
    args = [_t(a) for a in _fused_inputs(3, 13, d=16, m=32, seed=2)]
    dmean, dvar = (_t(c) for c in _cotangents(3, 13, seed=3))
    leaves = [a.clone().requires_grad_(True) for a in args]
    mean, var = tfused.whitened_marginals_affine(*leaves)  # CPU: plain
    torch.autograd.backward((mean, var), (dmean, dvar))
    got = tfused.whitened_marginals_affine_bwd_plain(*args, dmean, dvar)
    for g, leaf, name in zip(got, leaves, GRAD_NAMES):
        np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(),
                                   rtol=RTOL_GRAD, atol=ATOL_GRAD,
                                   err_msg=name)


def _gp_pair(use_fused, d=16, m=32, seed=0):
    x = np.random.default_rng(seed).normal(size=(4, 36, d)).astype(np.float32)
    jmod = jgp.DeepGP(input_dims=d, num_inducing=m, use_fused=use_fused,
                      ls_init=-1.0)
    params = jmod.init({"params": jax.random.PRNGKey(seed)},
                       jnp.asarray(x))["params"]
    tmod = tgp.DeepGP(input_dims=d, num_inducing=m, use_fused=use_fused,
                      device="cpu")
    tmod.load_state_dict(from_flax(jax.tree_util.tree_map(np.asarray,
                                                          params)))
    # non-trivial variational parameters: the init has m = 0, s = 1
    rng = np.random.default_rng(seed + 1)
    vm = (0.5 * rng.normal(size=m)).astype(np.float32)
    vs = (0.3 * rng.normal(size=m)).astype(np.float32)
    params = jax.tree_util.tree_map(lambda a: a, params)
    params["output_layer"]["variational_mean"] = jnp.asarray(vm)
    params["output_layer"]["variational_log_stddev"] = jnp.asarray(vs)
    with torch.no_grad():
        tmod.output_layer.variational_mean.copy_(_t(vm))
        tmod.output_layer.variational_log_stddev.copy_(_t(vs))
    return x, jmod, params, tmod


@pytest.mark.parametrize("use_fused", [True, False])
def test_deep_gp_matches_jax(use_fused):
    x, jmod, params, tmod = _gp_pair(use_fused)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tmod(_t(x))
    for field in ("mean", "var", "kl", "noise"):
        np.testing.assert_allclose(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)),
            rtol=TOL_GP, atol=TOL_GP, err_msg=field)


def test_variational_elbo_matches_jax():
    x, jmod, params, tmod = _gp_pair(True, seed=3)
    y = np.random.default_rng(9).normal(size=x.shape[:2]).astype(np.float32)
    want = jgp.variational_elbo(
        jnp.asarray(y), jmod.apply({"params": params}, jnp.asarray(x)),
        num_data=16)
    with torch.no_grad():
        got = tgp.variational_elbo(_t(y), tmod(_t(x)), num_data=16)
    np.testing.assert_allclose(float(got), float(want), rtol=TOL_GP,
                               atol=TOL_GP)


@pytest.mark.parametrize("kwargs", [
    {"hidden_dims": (4,)},
    {"use_pallas": True},
    {"compute_dtype": torch.bfloat16},
])
def test_deep_gp_unported_options_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tgp.DeepGP(input_dims=8, num_inducing=8, device="cpu", **kwargs)
