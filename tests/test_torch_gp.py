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
from fine_grained_gaussian_process_forcasting_tpu.ops.pallas import (
    rbf as jrbf,
)
from fine_grained_gaussian_process_forcasting_torch.gp import deep_gp as tgp
from fine_grained_gaussian_process_forcasting_torch.gp import kernels as tk
from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (
    fused_gp as tfused,
)
from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (
    rbf as trbf,
)
from fine_grained_gaussian_process_forcasting_torch.params import from_flax

# fp32 in both frameworks, summed in another order: 1e-6 on O(1) values
# (the kernels), 2e-5 where an M-long reduction follows (the JAX package's
# own fused-GP tolerance, tests/test_fused_gp.py)
TOL_KERNELS = 1e-6
TOL_GP = 2e-5
# bf16 products: both frameworks round the same operands (K, W, dvar o K; the
# cast points; L^-1 and kzx) to bf16 and sum exact products in fp32, so they
# differ only where the fp32 values being rounded differ in their last bit
# and land one bf16 step apart: 2^-8 of the output's largest magnitude
TOL_BF16 = 2.0 ** -8


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _kernel_inputs(seed=0, n=23, m=11, d=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, n, d)).astype(np.float32)
    z = rng.normal(size=(m, d)).astype(np.float32)
    ls = rng.uniform(0.8, 3.0, size=(d,)).astype(np.float32)
    return x, z, ls, np.float32(1.3)


@pytest.mark.parametrize("fn", ["softplus", "sq_dist", "rbf_ard",
                                "matern_ard"])
def test_gp_kernels_match_jax(fn):
    x, z, ls, os_ = _kernel_inputs()
    if fn == "softplus":
        raw = np.linspace(-6, 6, 41, dtype=np.float32)
        want, got = jk.softplus(jnp.asarray(raw)), tk.softplus(_t(raw))
    elif fn == "sq_dist":
        want = jk.sq_dist(jnp.asarray(x), jnp.asarray(z))
        got = tk.sq_dist(_t(x), _t(z))
    elif fn == "matern_ard":
        want = np.stack([jk.matern_ard(jnp.asarray(x), jnp.asarray(z),
                                       jnp.asarray(ls), jnp.asarray(os_), nu)
                         for nu in (0.5, 1.5, 2.5)])
        got = torch.stack([tk.matern_ard(_t(x), _t(z), _t(ls),
                                         torch.tensor(os_), nu)
                           for nu in (0.5, 1.5, 2.5)])
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


@pytest.mark.parametrize("m", [512, 720, 721, 1024, 2048, 4096])
def test_fused_gp_bf16_fwd_scratch_at_any_m(m):
    """The bf16 forward's device scratch (``fwd_plan``, the layout of the
    library's ``wgb::fwd_plan``): one launch sequence at every M, rows and
    inducing points padded to whole 128 x 128 tiles and d to whole 64-column
    stages, every array 256-byte aligned; the fp32 forward's arrays (K in
    fp32, (Mp, Rp), which the K W launch rounds to bf16 as it loads it) and,
    on top of them, bf16(W^T) (Mp, Mp).  At prod_basic's 40,960 rows and d
    512."""
    r, d = 40960, 512
    plan = tfused.fwd_plan(r, d, m, bf16=True)
    fp32 = tfused.fwd_plan(r, d, m)
    assert (plan.rp, plan.dk) == (r, d)
    assert plan.mp % 128 == 0 and m <= plan.mp < m + 128
    assert all(v % 256 == 0 for v in plan.arrays.values())
    assert plan.arrays["w_bf16"] == plan.mp * plan.mp * 2
    assert plan.arrays["k"] == plan.mp * plan.rp * 4
    assert fp32.arrays["w_bf16"] == 0
    assert plan.total == fp32.total + plan.arrays["w_bf16"]
    # a ragged row count and d pad to the next tile and stage
    ragged = tfused.fwd_plan(r + 1, d - 1, m, bf16=True)
    assert (ragged.rp, ragged.dk, ragged.mp) == (r + 128, d, plan.mp)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_fused_gp_plain_matches_jax_pallas_at_m_1024(bf16):
    """M 1024, past the 720 inducing points: the plain forward and VJP
    against the Pallas kernel (interpret mode)."""
    args = list(_fused_inputs(2, 9, d=8, m=1024, seed=1024 + bf16))
    args[3] = (args[3] * (32 / 1024)).astype(np.float32)  # var of O(1)
    dmean, dvar = _cotangents(2, 9, seed=5)
    jfn = (jfused.whitened_marginals_affine_bf16 if bf16
           else jfused.whitened_marginals_affine)
    want, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in args))
    want_grads = vjp((jnp.asarray(dmean), jnp.asarray(dvar)))
    got = tfused.whitened_marginals_affine_plain(*(_t(a) for a in args),
                                                 bf16=bf16)
    grads = tfused.whitened_marginals_affine_bwd_plain(
        *(_t(a) for a in args), _t(dmean), _t(dvar), bf16=bf16)
    for g, w_, name in zip((*got, *grads), (*want, *want_grads),
                           ("mean", "var") + GRAD_NAMES):
        if bf16:
            _assert_close_bf16(g.numpy(), w_, name)
        else:
            np.testing.assert_allclose(
                g.numpy(), np.asarray(w_), rtol=RTOL_GRAD if name in
                GRAD_NAMES else TOL_GP, atol=ATOL_GRAD if name in GRAD_NAMES
                else TOL_GP, err_msg=name)


def _assert_close_bf16(got, want, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    tol = TOL_BF16 * max(np.abs(want).max(), 1e-6)
    assert err <= tol, (name, err, tol)


@pytest.mark.parametrize("fn", ["sq_dist", "rbf_ard"])
def test_gp_kernels_bf16_match_jax(fn):
    x, z, ls, os_ = _kernel_inputs(seed=1)
    if fn == "sq_dist":
        want = jk.sq_dist(jnp.asarray(x), jnp.asarray(z), jnp.bfloat16)
        got = tk.sq_dist(_t(x), _t(z), torch.bfloat16)
    else:
        want = jk.rbf_ard(jnp.asarray(x), jnp.asarray(z), jnp.asarray(ls),
                          jnp.asarray(os_), jnp.bfloat16)
        got = tk.rbf_ard(_t(x), _t(z), _t(ls), torch.tensor(os_),
                         torch.bfloat16)
    assert got.dtype == torch.float32
    _assert_close_bf16(got.numpy(), want)
    # and it is a different function from the fp32 one
    exact = tk.sq_dist(_t(x), _t(z)) if fn == "sq_dist" else tk.rbf_ard(
        _t(x), _t(z), _t(ls), torch.tensor(os_))
    assert (got - exact).abs().max() > 1e-4


@pytest.mark.parametrize("b,n,d", [(4, 36, 32), (3, 13, 96)])
def test_fused_gp_bf16_plain_matches_jax_pallas(b, n, d):
    args = _fused_inputs(b, n, d=d, m=32, seed=n + d)
    want = jfused.whitened_marginals_affine_bf16(
        *(jnp.asarray(a) for a in args))
    got = tfused.whitened_marginals_affine_bf16(*(_t(a) for a in args))
    for g, w_, name in zip(got, want, ("mean", "var")):
        assert g.shape == (b, n) and g.dtype == torch.float32
        _assert_close_bf16(g.numpy(), w_, name)
    fp32 = tfused.whitened_marginals_affine(*(_t(a) for a in args))
    assert (got[1] - fp32[1]).abs().max() > 1e-5  # the variance is rounded
    torch.testing.assert_close(got[0], fp32[0], rtol=0, atol=0)  # not K u


@pytest.mark.parametrize("b,n,d", [(4, 36, 32), (3, 13, 96)])
def test_fused_gp_bf16_bwd_plain_matches_jax_vjp(b, n, d):
    args = _fused_inputs(b, n, d=d, m=32, seed=n + d + 1)
    dmean, dvar = _cotangents(b, n, seed=n)
    _, vjp = jax.vjp(jfused.whitened_marginals_affine_bf16,
                     *(jnp.asarray(a) for a in args))
    want = vjp((jnp.asarray(dmean), jnp.asarray(dvar)))
    got = tfused.whitened_marginals_affine_bf16_bwd_plain(
        *(_t(a) for a in args), _t(dmean), _t(dvar))
    for g, w_, name in zip(got, want, GRAD_NAMES):
        _assert_close_bf16(g.numpy(), w_, name)


def test_fused_gp_bf16_on_cpu_differentiates_by_its_own_rule():
    """With inputs that require grad the CPU wrapper is an autograd Function
    over the plain forward and the plain VJP, bit for bit; torch's autograd
    through the rounded plain forward agrees with that rule to bf16."""
    args = [_t(a) for a in _fused_inputs(3, 13, d=16, m=32, seed=2)]
    dmean, dvar = (_t(c) for c in _cotangents(3, 13, seed=3))
    leaves = [a.clone().requires_grad_(True) for a in args]
    mean, var = tfused.whitened_marginals_affine_bf16(*leaves)
    torch.autograd.backward((mean, var), (dmean, dvar))
    rule = tfused.whitened_marginals_affine_bf16_bwd_plain(*args, dmean,
                                                           dvar)
    for g, leaf, name in zip(rule, leaves, GRAD_NAMES):
        assert torch.equal(g, leaf.grad), name
    plain = [a.clone().requires_grad_(True) for a in args]
    torch.autograd.backward(
        tfused.whitened_marginals_affine_bf16_plain(*plain), (dmean, dvar))
    for g, leaf, name in zip(rule, plain, GRAD_NAMES):
        _assert_close_bf16(g.numpy(), leaf.grad.numpy(), name)
    assert tfused.bf16_launches == 0 and tfused.bf16_bwd_launches == 0


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


def _gp_pair(use_fused, d=16, m=32, seed=0, bf16=False):
    x = np.random.default_rng(seed).normal(size=(4, 36, d)).astype(np.float32)
    jmod = jgp.DeepGP(input_dims=d, num_inducing=m, use_fused=use_fused,
                      ls_init=-1.0,
                      compute_dtype=jnp.bfloat16 if bf16 else None)
    params = jmod.init({"params": jax.random.PRNGKey(seed)},
                       jnp.asarray(x))["params"]
    tmod = tgp.DeepGP(input_dims=d, num_inducing=m, use_fused=use_fused,
                      compute_dtype=torch.bfloat16 if bf16 else None,
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


@pytest.mark.parametrize("use_fused", [True, False])
def test_deep_gp_bf16_matches_jax(use_fused):
    x, jmod, params, tmod = _gp_pair(use_fused, bf16=True)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tmod(_t(x))
    for field in ("mean", "var"):
        _assert_close_bf16(getattr(got, field).numpy(),
                           getattr(want, field), field)
    for field in ("kl", "noise"):  # fp32 whatever the compute dtype
        np.testing.assert_allclose(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)),
            rtol=TOL_GP, atol=TOL_GP, err_msg=field)
    fp32 = _gp_pair(use_fused)[3]
    with torch.no_grad():
        assert (fp32(_t(x)).var - got.var).abs().max() > 1e-5


def test_deep_gp_float32_compute_dtype_stays_on_the_fp32_kernel():
    x, _, _, tmod = _gp_pair(True)
    tmod.output_layer.compute_dtype = torch.float32
    with torch.no_grad():
        got = tmod(_t(x))
        tmod.output_layer.compute_dtype = None
        want = tmod(_t(x))
    torch.testing.assert_close(got.var, want.var, rtol=0, atol=0)


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


# the rbf kernel: the JAX package's own tolerances for it
# (tests/test_pallas_kernels.py), forward and gradients
RTOL_RBF, ATOL_RBF = 1e-4, 1e-5
RTOL_RBF_GRAD, ATOL_RBF_GRAD = 2e-3, 1e-4


@pytest.mark.parametrize("case", ["unbatched", "batched_x", "h_gps"])
def test_rbf_cross_kernel_matches_jax(case):
    """Values and the gradients of all four inputs against the Pallas op
    (interpret mode); ``h_gps``: z (h, M, d), lengthscale (h, d),
    outputscale (h,) over one x, as the hidden layer's vmap calls it."""
    rng = np.random.default_rng(len(case))
    batch, h = {"unbatched": ((), 0), "batched_x": ((3,), 0),
                "h_gps": ((2,), 3)}[case]
    n, m, d = 21, 12, 5
    lead = (h,) if h else ()
    x = rng.normal(size=batch + (n, d)).astype(np.float32)
    z = rng.normal(size=lead + (m, d)).astype(np.float32)
    ls = rng.uniform(0.5, 2.0, size=lead + (d,)).astype(np.float32)
    os_ = rng.uniform(0.5, 1.5, size=lead).astype(np.float32)

    def jop(x, z, ls, os_):
        if h:
            return jax.vmap(jrbf.rbf_cross_kernel,
                            in_axes=(None, 0, 0, 0))(x, z, ls, os_)
        return jrbf.rbf_cross_kernel(x, z, ls, os_)

    def jloss(*args):
        k = jop(*args)
        return jnp.sum(jnp.sin(k) * k)

    args = (x, z, ls, os_)
    want = jop(*(jnp.asarray(a) for a in args))
    want_grads = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in args))
    leaves = [_t(a).requires_grad_(True) for a in args]
    got = trbf.rbf_cross_kernel(*leaves)
    assert tuple(got.shape) == lead + batch + (n, m)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL_RBF, atol=ATOL_RBF)
    (torch.sin(got) * got).sum().backward()
    for leaf, w, name in zip(leaves, want_grads, ("x", "z", "ls", "os")):
        assert leaf.grad.shape == leaf.shape, name
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   rtol=RTOL_RBF_GRAD, atol=ATOL_RBF_GRAD,
                                   err_msg=name)
    # the plain forward and the closed-form backward are the wrapper's
    plain = trbf.rbf_cross_kernel_plain(*(_t(a) for a in args))
    torch.testing.assert_close(plain, got.detach(), rtol=0, atol=0)
    assert trbf.launches == 0


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_fused_gp_nonaffine_matches_jax(bf16):
    """``whitened_marginals``(``_bf16``) at pre-scaled xs: (K u, var) and
    the gradients of its five inputs, at the affine variants' tolerances."""
    b, n = 3, 13
    args = _fused_inputs(b, n, d=16, m=32, seed=4)
    xs = (args[0] * args[5]).astype(np.float32)
    args = (xs,) + args[1:5]
    dmean, dvar = _cotangents(b, n, seed=6)
    jfn = (jfused.whitened_marginals_bf16 if bf16
           else jfused.whitened_marginals)
    tfn = (tfused.whitened_marginals_bf16 if bf16
           else tfused.whitened_marginals)
    want, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in args))
    want_grads = vjp((jnp.asarray(dmean), jnp.asarray(dvar)))
    leaves = [_t(a).requires_grad_(True) for a in args]
    got = tfn(*leaves)
    torch.autograd.backward(got, (_t(dmean), _t(dvar)))
    names = GRAD_NAMES[:5]
    for g, w, name in zip(got, want, ("mean", "var")):
        if bf16:
            _assert_close_bf16(g.detach().numpy(), w, name)
        else:
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                       rtol=TOL_GP, atol=TOL_GP,
                                       err_msg=name)
    for leaf, w, name in zip(leaves, want_grads, names):
        assert leaf.grad.shape == leaf.shape, name
        if bf16:
            _assert_close_bf16(leaf.grad.numpy(), w, name)
        else:
            np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                       rtol=RTOL_GRAD, atol=ATOL_GRAD,
                                       err_msg=name)
    # its plain versions are the ones the card is held to
    plain = (tfused.whitened_marginals_bf16_plain if bf16
             else tfused.whitened_marginals_plain)(*(_t(a) for a in args))
    for p, g in zip(plain, got):
        torch.testing.assert_close(p, g.detach(), rtol=0, atol=0)
    plain_bwd = (tfused.whitened_marginals_bf16_bwd_plain if bf16
                 else tfused.whitened_marginals_bwd_plain)(
        *(_t(a) for a in args), _t(dmean), _t(dvar))
    for p, leaf, name in zip(plain_bwd, leaves, names):
        np.testing.assert_allclose(p.numpy(), leaf.grad.numpy(),
                                   rtol=RTOL_GRAD, atol=ATOL_GRAD,
                                   err_msg=name)
    assert tfused.launches == tfused.bwd_launches == 0


def _hidden_pair(use_pallas, use_fused, d=4, m=8, h=3, seed=0):
    """A two-layer DeepGP (h hidden GPs) in both frameworks, same weights,
    q(u) away from the prior in both layers."""
    x = np.random.default_rng(seed).normal(size=(2, 9, d)).astype(np.float32)
    kw = dict(input_dims=d, num_inducing=m, use_pallas=use_pallas,
              use_fused=use_fused, hidden_dims=(h,), ls_init=-1.0)
    jmod = jgp.DeepGP(**kw)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(
        {"params": jax.random.PRNGKey(seed)}, jnp.asarray(x))["params"])
    rng = np.random.default_rng(seed + 1)
    for layer in ("hidden_layer0", "output_layer"):
        p = params[layer]
        p["variational_mean"] = (0.5 * rng.normal(
            size=p["variational_mean"].shape)).astype(np.float32)
        p["variational_log_stddev"] = (0.3 * rng.normal(
            size=p["variational_log_stddev"].shape)).astype(np.float32)
    tmod = tgp.DeepGP(**kw, device="cpu")
    tmod.load_state_dict(from_flax(params))
    return x, jmod, params, tmod


@pytest.mark.parametrize("use_fused", [False, True],
                         ids=["unfused", "fused"])
@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["xla", "pallas"])
def test_deep_gp_hidden_layers_match_jax(use_pallas, use_fused):
    """hidden_dims=(3,) at eps = 0 (JAX without a 'noise' rng, the port
    without draws or a generator).  The hidden layer is batched over its 3
    GPs (rbf with ``use_pallas``); the output layer is fused when asked."""
    x, jmod, params, tmod = _hidden_pair(use_pallas, use_fused)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tmod(_t(x))
    assert got.mean.shape == (2, 9)
    for field in ("mean", "var", "kl", "noise"):
        np.testing.assert_allclose(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)),
            rtol=TOL_GP, atol=TOL_GP, err_msg=field)
    assert tmod.hidden_layer0.inducing_points.shape == (3, 8, 4)


def test_deep_gp_hidden_draw_is_mean_plus_sqrt_var_eps():
    """With injected eps the hidden layer's draw x = mean + sqrt(var) eps
    feeds the output layer, composed here from the JAX package's own
    layers; a generator's draws are the same as injecting them."""
    x, _, params, tmod = _hidden_pair(True, True, seed=2)
    eps = np.random.default_rng(3).normal(size=(2, 9, 3)).astype(np.float32)
    hidden = jgp._VariationalLayer(input_dims=4, output_dims=3,
                                   num_inducing=8, use_pallas=True,
                                   ls_init=-1.0)
    output = jgp._VariationalLayer(input_dims=3, num_inducing=8,
                                   use_fused=True, ls_init=-1.0)
    mean, var, kl_h = hidden.apply({"params": params["hidden_layer0"]},
                                   jnp.asarray(x))
    x1 = mean + jnp.sqrt(var) * jnp.asarray(eps)
    mean, var, kl_o = output.apply({"params": params["output_layer"]}, x1)
    with torch.no_grad():
        got = tmod(_t(x), eps=[_t(eps)])
    for g, w, name in ((got.mean, mean, "mean"), (got.var, var, "var"),
                       (got.kl, kl_h + kl_o, "kl")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL_GP,
                                   atol=TOL_GP, err_msg=name)
    gen = torch.Generator().manual_seed(11)
    draws = torch.randn((2, 9, 3), generator=torch.Generator().manual_seed(11))
    with torch.no_grad():
        drawn = tmod(_t(x), generator=gen)
        injected = tmod(_t(x), eps=[draws])
        zero = tmod(_t(x))
    torch.testing.assert_close(drawn.mean, injected.mean, rtol=0, atol=0)
    assert (drawn.mean - zero.mean).abs().max() > 1e-3
