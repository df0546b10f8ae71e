"""The PyTorch port's CUDA kernels against their plain versions, on the card:
forward and backward kernels, the autograd Functions, serving and training.

Every test here needs a CUDA device and skips without one (decided in the
``cuda`` fixture, never at import).  The file imports no JAX, so it runs on
a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from fine_grained_gaussian_process_forcasting_torch.models.forecast_denoising import (
    ForecastDenoising,
)
from fine_grained_gaussian_process_forcasting_torch.gp.exact_blur import (
    ExactGPBlur,
)
from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (
    cholesky,
    flash_attention as flash,
    fused_gp,
    head_folded_attention as hfa,
    rbf,
    small_head_attention as sha,
)
from fine_grained_gaussian_process_forcasting_torch.train import Trainer
from fine_grained_gaussian_process_forcasting_torch.train.predict import (
    InferenceSession,
)

# kernel vs plain, both fp32 on the card, summed in another order: the JAX
# package's own tolerances (tests/test_fused_gp.py for the GP,
# tests/test_pallas_kernels.py for attention); the whole model 1e-4
TOL_GP = 2e-5
TOL_ATTENTION = 1e-5
TOL_MODEL = 1e-4
# gradients: the JAX package's fused-GP gradient tolerances
# (tests/test_fused_gp.py) and its attention-gradient tolerances
# (tests/test_pallas_kernels.py)
TOL_GRAD, ATOL_GRAD = 3e-4, 3e-5
TOL_GRAD_ATT, ATOL_GRAD_ATT = 1e-4, 1e-5
# flash attention, fp32: the JAX package's tolerances for that kernel
# (tests/test_pallas_kernels.py).  bf16 kernels against their plain versions:
# both round the same operands to bf16 but sum in another order (and the
# flash kernel rounds the unnormalised probabilities, its plain version the
# normalised ones), so values may land one bf16 step apart: 2^-7 of the
# output's largest magnitude
TOL_FLASH, ATOL_FLASH = 1e-4, 1e-5
TOL_FLASH_GRAD, ATOL_FLASH_GRAD = 2e-3, 1e-4
TOL_BF16 = 2.0 ** -7
# the sm_bf16 softmax: every probability is a bf16 value that went through
# three roundings, and the card's expf and division round a few of them to
# the neighbouring bf16 value: 2^-6 of the largest magnitude, for fp32
# operands too
TOL_SM16 = 2.0 ** -6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _fused_inputs(b, n, d, m, seed, device):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, d)).astype(np.float32)
    z = rng.normal(size=(m, d)).astype(np.float32)
    ls = np.full(d, np.sqrt(2.0 * d), np.float32)  # K far from 0
    lw = (0.1 * rng.normal(size=(m, m))).astype(np.float32)
    s2 = rng.uniform(0.0, 1.0, size=m).astype(np.float32)
    w = lw.T @ (lw * (1.0 - s2)[:, None])
    arrays = (x, z / ls, rng.normal(size=m), 0.5 * (w + w.T), np.float32(0.9),
              1.0 / ls, rng.normal(size=d) / d, np.float32(0.2))
    return [torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
            for a in arrays]


def _assert_close_bf16(got, want, name="", scale=None, rel=TOL_BF16):
    """Within ``rel`` of ``scale``, by default ``want``'s largest
    magnitude."""
    err = (got.float() - want.float()).abs().max().item()
    if scale is None:
        scale = want.float().abs().max().item()
    assert err <= rel * max(scale, 1e-6), (name, err, scale)


# M past 720, where an earlier bf16 forward took M in chunks; every kernel
# now tiles M as it tiles rows
LARGE_M = [(3, 77, 32, 721), (2, 60, 32, 1024), (2, 35, 8, 2048)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,d,m", [(4, 36, 16, 32), (3, 77, 32, 512),
                                     (2, 5, 7, 300), (3, 50, 96, 512),
                                     (2, 101, 512, 512), (1, 70, 130, 40),
                                     (4, 288, 8, 512), *LARGE_M])
def test_fused_gp_kernel_matches_plain(cuda, b, n, d, m):
    args = _fused_inputs(b, n, d, m, seed=m, device=cuda)
    before = fused_gp.launches
    got = fused_gp.whitened_marginals_affine(*args)
    torch.cuda.synchronize()
    assert fused_gp.launches == before + 1
    want = fused_gp.whitened_marginals_affine_plain(*args)
    for g, w in zip(got, want):
        assert g.shape == (b, n)
        torch.testing.assert_close(g, w, rtol=TOL_GP, atol=TOL_GP)


def _assert_grads_close(got, want, names):
    """Per-row outputs (the first) elementwise; the row-summed ones within
    the tolerance relative to their largest magnitude."""
    for i, (g, w, name) in enumerate(zip(got, want, names)):
        assert g.shape == w.shape, name
        if i == 0:
            torch.testing.assert_close(g, w, rtol=TOL_GRAD, atol=ATOL_GRAD,
                                       msg=name)
        else:
            err = (g - w).abs().max().item()
            scale = max(1.0, w.abs().max().item())
            assert err <= TOL_GRAD * scale, (name, err, scale)


GP_GRADS = ("x", "zs", "u", "w", "outputscale", "inv_ls", "mean_w", "mean_b")


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,d,m", [(4, 36, 16, 32), (3, 77, 32, 512),
                                     (2, 5, 7, 300), (3, 13, 1, 16),
                                     (3, 50, 96, 512), (2, 101, 512, 512),
                                     (1, 70, 130, 40), (4, 288, 8, 512),
                                     (2, 40, 100, 1024), *LARGE_M])
def test_fused_gp_bwd_kernel_matches_plain(cuda, b, n, d, m):
    args = _fused_inputs(b, n, d, m, seed=m + 1, device=cuda)
    rng = np.random.default_rng(d)
    cot = [torch.from_numpy(rng.normal(size=(b, n)).astype(np.float32)).to(
        cuda) for _ in range(2)]
    before = fused_gp.bwd_launches
    got = fused_gp.backward_kernel(*args, *cot)
    torch.cuda.synchronize()
    assert fused_gp.bwd_launches == before + 1
    want = fused_gp.whitened_marginals_affine_bwd_plain(*args, *cot)
    _assert_grads_close(got, want, GP_GRADS)
    again = fused_gp.backward_kernel(*args, *cot)
    for g, a in zip(got, again):  # no atomics: equal bit for bit
        assert torch.equal(g, a)


@pytest.mark.gpu
def test_fused_gp_kernel_takes_grad(cuda):
    """On a CUDA tensor that requires grad the wrapper runs the autograd
    Function (forward and backward kernels), never the plain version; its
    gradients equal torch's autograd through the plain forward."""
    args = _fused_inputs(3, 29, 16, 64, seed=4, device=cuda)
    leaves = [a.clone().requires_grad_(True) for a in args]
    fwd, bwd = fused_gp.launches, fused_gp.bwd_launches
    mean, var = fused_gp.whitened_marginals_affine(*leaves)
    (torch.sin(mean) * 1.7 + var ** 2 * 0.3).sum().backward()
    assert (fused_gp.launches, fused_gp.bwd_launches) == (fwd + 1, bwd + 1)
    plain = [a.clone().requires_grad_(True) for a in args]
    mean, var = fused_gp.whitened_marginals_affine_plain(*plain)
    (torch.sin(mean) * 1.7 + var ** 2 * 0.3).sum().backward()
    _assert_grads_close([t.grad for t in leaves], [t.grad for t in plain],
                        GP_GRADS)


# the last two: prod_basic's 40,960 rows at d 512, and M 720, the largest
# an earlier single-pass bf16 forward took (721 is in LARGE_M)
GP_SHAPES_BF16 = [(4, 36, 16, 32), (3, 77, 32, 512), (2, 5, 7, 300),
                  (3, 50, 96, 512), (2, 101, 512, 512), *LARGE_M,
                  (64, 640, 512, 512), (3, 40, 32, 720)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,d,m", GP_SHAPES_BF16)
def test_fused_gp_bf16_kernel_matches_plain(cuda, b, n, d, m):
    args = _fused_inputs(b, n, d, m, seed=m + 2, device=cuda)
    before = fused_gp.bf16_launches, fused_gp.launches
    got = fused_gp.whitened_marginals_affine_bf16(*args)
    torch.cuda.synchronize()
    assert (fused_gp.bf16_launches, fused_gp.launches) == (before[0] + 1,
                                                           before[1])
    want = fused_gp.whitened_marginals_affine_bf16_plain(*args)
    torch.testing.assert_close(got[0], want[0], rtol=TOL_GP, atol=TOL_GP)
    _assert_close_bf16(got[1], want[1], "var")
    # closer to its own plain version than to the fp32 function
    fp32 = fused_gp.whitened_marginals_affine_plain(*args)
    assert ((got[1] - want[1]).abs().max()
            < (got[1] - fp32[1]).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,d,m", GP_SHAPES_BF16)
def test_fused_gp_bf16_bwd_kernel_matches_plain(cuda, b, n, d, m):
    args = _fused_inputs(b, n, d, m, seed=m + 3, device=cuda)
    rng = np.random.default_rng(d)
    cot = [torch.from_numpy(rng.normal(size=(b, n)).astype(np.float32)).to(
        cuda) for _ in range(2)]
    before = fused_gp.bf16_bwd_launches
    got = fused_gp.backward_kernel(*args, *cot, bf16=True)
    torch.cuda.synchronize()
    assert fused_gp.bf16_bwd_launches == before + 1
    want = fused_gp.whitened_marginals_affine_bf16_bwd_plain(*args, *cot)
    for g, w, name in zip(got, want, GP_GRADS):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        _assert_close_bf16(g, w, name)
    again = fused_gp.backward_kernel(*args, *cot, bf16=True)
    for g, a in zip(got, again):  # no atomics: equal bit for bit
        assert torch.equal(g, a)


def _gp_like_inputs(rows, d, m, seed, device):
    """Inputs shaped as the GP layer makes them: lengthscale sqrt(2 d), W
    and u from the Cholesky factor of the inducing points' jittered Gram
    matrix (W reaches ~10 in magnitude, as in training)."""
    rng = np.random.default_rng(seed)
    ls = np.sqrt(2.0 * d)
    zs = torch.from_numpy(rng.normal(size=(m, d)) / ls)
    kzz = np.log(2.0) * torch.exp(-0.5 * torch.cdist(zs, zs) ** 2)
    chol = torch.linalg.cholesky(kzz + 1e-4 * torch.eye(m, dtype=torch.float64))
    li = torch.linalg.solve_triangular(chol, torch.eye(m, dtype=torch.float64),
                                       upper=False)
    s2 = torch.from_numpy(rng.uniform(size=m))
    arrays = (rng.normal(size=(1, rows, d)), zs.numpy(),
              (li.T @ torch.from_numpy(0.3 * rng.normal(size=m))).numpy(),
              (li.T @ (li * (1.0 - s2)[:, None])).numpy(), np.log(2.0),
              np.full(d, 1.0 / ls), rng.normal(size=d) / d, 0.1)
    cot = (rng.normal(size=(1, rows)), rng.normal(size=(1, rows)))
    return [torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
            for a in arrays + cot]


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d,m,affine",
                         [(40960, 512, 512, True), (18432, 32, 512, True),
                          (18432, 32, 512, False), (999, 96, 200, True)],
                         ids=["prod_basic", "d32", "d32_nonaffine", "ragged"])
def test_fused_gp_bf16_bwd_meets_the_float64_budget(cuda, rows, d, m, affine):
    """The `wgmma` backward runs the reference's fp32 products on bf16
    parts: every gradient is no farther from the float64 function -- the
    fp32 function, and the bf16 function rounded at the same places -- than
    twice the plain bf16 version is, the distances summed over 16 draws of
    the inputs (from the bf16 function, each version's distance comes mostly
    from the elements where its K and the float64 K round to different bf16
    values, a set of its own, so one draw compares two nearly independent
    errors).  Not affine: the kernel at the pre-scaled xs, inv_ls 1,
    mean_w 0, mean_b 0, as ``whitened_marginals_bf16`` runs it."""
    dist = {}
    for i in range(16):
        *args, dmean, dvar = _gp_like_inputs(rows, d, m, seed=1000 * i + d,
                                             device=cuda)
        if not affine:
            args = fused_gp._affine_args(args[0] * args[5], *args[1:5])
        got = fused_gp.backward_kernel(*args, dmean, dvar, bf16=True)
        plain = fused_gp.whitened_marginals_affine_bf16_bwd_plain(
            *args, dmean, dvar)
        wide = [a.double() for a in (*args, dmean, dvar)]
        for bf16 in (False, True):
            exact = fused_gp.whitened_marginals_affine_bwd_plain(*wide,
                                                                 bf16=bf16)
            for g, p, e, name in zip(got, plain, exact, GP_GRADS):
                sums = dist.setdefault((bf16, name), [0.0, 0.0])
                sums[0] += (g.double() - e).abs().max().item()
                sums[1] += (p.double() - e).abs().max().item()
    for key, (kernel, plain) in dist.items():
        assert kernel <= 2.0 * plain, (key, kernel, plain)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d,m,affine",
                         [(18432, 32, 512, True), (18432, 32, 512, False),
                          (40960, 512, 512, True), (999, 96, 200, True),
                          (4608, 32, 1024, True)],
                         ids=["d32", "d32_nonaffine", "d512", "ragged",
                              "m1024"])
def test_fused_gp_fp32_meets_the_float64_budget(cuda, rows, d, m, affine):
    """The fp32 forward and backward run every product on three bf16 parts
    of its fp32 operands (`wgmma`): every output, forward and backward, is
    no farther from the float64 function than twice the plain fp32 version
    (cuBLAS, TF32 off), the distances summed over 16 draws of the inputs.
    Not affine: the kernels at the pre-scaled xs, inv_ls 1, mean_w 0,
    mean_b 0, as ``whitened_marginals`` runs them."""
    assert not torch.backends.cuda.matmul.allow_tf32
    names = ("mean", "var") + GP_GRADS
    dist = {name: [0.0, 0.0] for name in names}
    for i in range(16):
        *args, dmean, dvar = _gp_like_inputs(rows, d, m, seed=1000 * i + d + 5,
                                             device=cuda)
        if not affine:
            args = fused_gp._affine_args(args[0] * args[5], *args[1:5])
        got = (fused_gp.forward_kernel(*args)
               + fused_gp.backward_kernel(*args, dmean, dvar))
        plain = (fused_gp.whitened_marginals_affine_plain(*args)
                 + fused_gp.whitened_marginals_affine_bwd_plain(*args, dmean,
                                                                dvar))
        wide = [a.double() for a in (*args, dmean, dvar)]
        exact = (fused_gp.whitened_marginals_affine_plain(*wide[:8])
                 + fused_gp.whitened_marginals_affine_bwd_plain(*wide))
        for g, p, e, name in zip(got, plain, exact, names):
            dist[name][0] += (g.double() - e).abs().max().item()
            dist[name][1] += (p.double() - e).abs().max().item()
    for name, (kernel, plain) in dist.items():
        assert kernel <= 2.0 * plain, (name, kernel, plain)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,d,m,affine",
                         [(40960, 512, 512, True), (18432, 32, 512, False),
                          (4608, 32, 1024, True), (4608, 32, 2048, True),
                          (999, 96, 200, True)],
                         ids=["prod_basic", "d32_nonaffine", "m1024", "m2048",
                              "ragged"])
def test_fused_gp_bf16_fwd_meets_the_float64_budget(cuda, rows, d, m, affine):
    """The bf16 forward runs the distance's cross term on three bf16 parts
    (`wgmma`) and K W on bf16(K) and bf16(W): mean and var each no farther
    than twice the plain bf16 version from the fp32 function in float64 and
    from the bf16 function in float64 (K and W rounded where they enter
    K W, the products exact), the distances summed over 16 draws."""
    names = ("mean", "var")
    dist = {(bf16, name): [0.0, 0.0] for bf16 in (False, True)
            for name in names}
    for i in range(16):
        args = _gp_like_inputs(rows, d, m, seed=1000 * i + d + 7,
                               device=cuda)[:8]
        if not affine:
            args = fused_gp._affine_args(args[0] * args[5], *args[1:5])
        got = fused_gp.forward_kernel(*args, bf16=True)
        plain = fused_gp.whitened_marginals_affine_bf16_plain(*args)
        wide = [a.double() for a in args]
        for bf16 in (False, True):
            exact = fused_gp.whitened_marginals_affine_plain(*wide, bf16=bf16)
            for g, p, e, name in zip(got, plain, exact, names):
                sums = dist[bf16, name]
                sums[0] += (g.double() - e).abs().max().item()
                sums[1] += (p.double() - e).abs().max().item()
    for key, (kernel, plain) in dist.items():
        assert kernel <= 2.0 * plain, (key, kernel, plain)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,d,m", [(3, 77, 32, 512), (2, 101, 512, 512),
                                     (2, 60, 32, 1024), (2, 5, 7, 300)])
def test_fused_gp_bf16_fwd_reruns_bit_equal(cuda, b, n, d, m):
    """Fixed-order sums and no atomics: two runs of the bf16 forward give
    equal mean and var bit for bit."""
    args = _fused_inputs(b, n, d, m, seed=m + 13, device=cuda)
    first = fused_gp.forward_kernel(*args, bf16=True)
    again = fused_gp.forward_kernel(*args, bf16=True)
    for g, a, name in zip(first, again, ("mean", "var")):
        assert torch.equal(g, a), name


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_fused_gp_fwd_plan_is_the_librarys(cuda, bf16):
    """``fused_gp.fwd_plan`` lays out the scratch the library asks for."""
    for r, d, m in [(40960, 512, 512), (73728, 32, 512), (999, 7, 300),
                    (4608, 32, 2048), (1, 1, 1)]:
        assert (4 * fused_gp.fwd_scratch_floats(r, d, m, bf16)
                == fused_gp.fwd_plan(r, d, m, bf16).total), (r, d, m)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,d,m", [(3, 77, 32, 512), (2, 101, 512, 512),
                                     (2, 60, 32, 1024)])
def test_fused_gp_fp32_kernels_rerun_bit_equal(cuda, b, n, d, m):
    """Fixed-order sums and no atomics: two runs of the fp32 forward, and two
    of the fp32 backward, give equal outputs bit for bit."""
    args = _fused_inputs(b, n, d, m, seed=m + 11, device=cuda)
    rng = np.random.default_rng(m)
    cot = [torch.from_numpy(rng.normal(size=(b, n)).astype(np.float32)).to(
        cuda) for _ in range(2)]
    first = (fused_gp.forward_kernel(*args)
             + fused_gp.backward_kernel(*args, *cot))
    again = (fused_gp.forward_kernel(*args)
             + fused_gp.backward_kernel(*args, *cot))
    for g, a, name in zip(first, again, ("mean", "var") + GP_GRADS):
        assert torch.equal(g, a), name


@pytest.mark.gpu
def test_fused_gp_bf16_kernel_takes_grad(cuda):
    args = _fused_inputs(3, 29, 64, 64, seed=5, device=cuda)
    leaves = [a.clone().requires_grad_(True) for a in args]
    fwd, bwd = fused_gp.bf16_launches, fused_gp.bf16_bwd_launches
    mean, var = fused_gp.whitened_marginals_affine_bf16(*leaves)
    (torch.sin(mean) * 1.7 + var ** 2 * 0.3).sum().backward()
    assert (fused_gp.bf16_launches, fused_gp.bf16_bwd_launches) == (
        fwd + 1, bwd + 1)
    cpu = [a.cpu().requires_grad_(True) for a in args]
    mean, var = fused_gp.whitened_marginals_affine_bf16(*cpu)  # its own rule
    (torch.sin(mean) * 1.7 + var ** 2 * 0.3).sum().backward()
    for a, c, name in zip(leaves, cpu, GP_GRADS):
        _assert_close_bf16(a.grad.cpu(), c.grad, name)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_fused_gp_nonaffine_kernels_match_plain(cuda, bf16):
    """``whitened_marginals``(``_bf16``): the affine kernels at inv_ls 1,
    mean_w 0, mean_b 0, forward and backward through the autograd Function,
    against the plain versions; counted on the affine kernels' counters."""
    b, n, d, m = 3, 77, 32, 512
    args = _fused_inputs(b, n, d, m, seed=9, device=cuda)
    args = [(args[0] * args[5]).contiguous()] + args[1:5]
    rng = np.random.default_rng(9)
    cot = [torch.from_numpy(rng.normal(size=(b, n)).astype(np.float32)).to(
        cuda) for _ in range(2)]
    counters = ("bf16_launches", "bf16_bwd_launches", "launches",
                "bwd_launches")
    if not bf16:
        counters = counters[2:] + counters[:2]
    before = [getattr(fused_gp, c) for c in counters]
    leaves = [a.clone().requires_grad_(True) for a in args]
    got = (fused_gp.whitened_marginals_bf16 if bf16
           else fused_gp.whitened_marginals)(*leaves)
    torch.autograd.backward(got, cot)
    torch.cuda.synchronize()
    assert [getattr(fused_gp, c) for c in counters] == [
        before[0] + 1, before[1] + 1, before[2], before[3]]
    want = fused_gp.whitened_marginals_plain(*args, bf16=bf16)
    want_grads = fused_gp.whitened_marginals_bwd_plain(*args, *cot,
                                                       bf16=bf16)
    torch.testing.assert_close(got[0].detach(), want[0], rtol=TOL_GP,
                               atol=TOL_GP)
    if bf16:
        _assert_close_bf16(got[1].detach(), want[1], "var")
        for leaf, w, name in zip(leaves, want_grads, GP_GRADS):
            _assert_close_bf16(leaf.grad, w, name)
    else:
        torch.testing.assert_close(got[1].detach(), want[1], rtol=TOL_GP,
                                   atol=TOL_GP)
        _assert_grads_close([t.grad for t in leaves], want_grads,
                            GP_GRADS[:5])


# the rbf kernel: the JAX package's own tolerances for it
# (tests/test_pallas_kernels.py), forward and gradients
TOL_RBF, ATOL_RBF = 1e-4, 1e-5
TOL_RBF_GRAD, ATOL_RBF_GRAD = 2e-3, 1e-4


def _rbf_inputs(h, batch, n, m, d, seed, device):
    rng = np.random.default_rng(seed)
    lead = (h,) if h else ()
    arrays = (rng.normal(size=batch + (n, d)), rng.normal(size=lead + (m, d)),
              np.sqrt(2.0 * d) * rng.uniform(0.5, 1.5, size=lead + (d,)),
              rng.uniform(0.5, 1.5, size=lead))
    return [torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
            for a in arrays]


# rows 231 and 65 are no multiple of the kernel's 128-row tile, M 300 and
# 129 none of its 128-column tiles (nor of 4: no float4 rows), d 7 and 40
# none of its 32-column chunks (40: two chunks, x staged per chunk)
RBF_SHAPES = [(0, (3,), 77, 300, 7), (8, (4,), 288, 512, 32),
              (3, (2,), 65, 129, 40), (2, (), 1, 1, 1), (0, (), 130, 64, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("h,batch,n,m,d", RBF_SHAPES)
def test_rbf_kernel_matches_plain(cuda, h, batch, n, m, d):
    x, z, ls, os_ = _rbf_inputs(h, batch, n, m, d, seed=n + m, device=cuda)
    before = rbf.launches
    got = rbf.rbf_cross_kernel(x, z, ls, os_)
    torch.cuda.synchronize()
    assert rbf.launches == before + 1  # one launch for all h GPs
    want = rbf.rbf_cross_kernel_plain(x, z, ls, os_)
    assert got.shape == want.shape == ((h,) if h else ()) + batch + (n, m)
    torch.testing.assert_close(got, want, rtol=TOL_RBF, atol=ATOL_RBF)


@pytest.mark.gpu
@pytest.mark.parametrize("h,batch,n,m,d", RBF_SHAPES)
def test_rbf_kernel_reruns_bit_equal(cuda, h, batch, n, m, d):
    """No atomics: two runs of the rbf kernel give equal K bit for bit."""
    args = _rbf_inputs(h, batch, n, m, d, seed=n + m + 1, device=cuda)
    assert torch.equal(rbf.rbf_cross_kernel(*args),
                       rbf.rbf_cross_kernel(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("h", [0, 3])
def test_rbf_kernel_takes_grad(cuda, h):
    """The Function on the card (kernel forward, plain closed-form VJP)
    against the same Function on the CPU."""
    args = _rbf_inputs(h, (2,), 45, 70, 6, seed=h, device=cuda)
    leaves = [a.clone().requires_grad_(True) for a in args]
    before = rbf.launches
    k = rbf.rbf_cross_kernel(*leaves)
    (torch.sin(k) * k).sum().backward()
    assert rbf.launches == before + 1
    cpu = [a.cpu().requires_grad_(True) for a in args]
    kc = rbf.rbf_cross_kernel(*cpu)
    (torch.sin(kc) * kc).sum().backward()
    for a, c, name in zip(leaves, cpu, ("x", "z", "ls", "os")):
        torch.testing.assert_close(a.grad.cpu(), c.grad, rtol=TOL_RBF_GRAD,
                                   atol=ATOL_RBF_GRAD, msg=name)


# the JAX package's Cholesky-kernel tolerance (tests/test_pallas_kernels.py)
TOL_CHOL = 2e-3


def _spd(b, n, seed, device):
    x = np.random.default_rng(seed).normal(size=(b, n, n)).astype(np.float32)
    a = x @ x.transpose(0, 2, 1) / n + 0.5 * np.eye(n, dtype=np.float32)
    return torch.from_numpy(a).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n", [(8, 96), (4, 192), (3, 240), (2, 241),
                                 (2, 384), (5, 1), (3, 33), (1, 31), (2, 97),
                                 (2, 191), (256, 192), (1, 1100)])
def test_cholesky_kernel_matches_plain(cuda, b, n):
    """Around the 32-column panels (n 31, 33, 97, 191, 241), one matrix and
    the exact blur's batch of 256, n 384 (the true sequence length), and
    past 1056, where the panel is staged from device memory."""
    a = _spd(b, n, seed=n, device=cuda)
    before = cholesky.launches
    got = cholesky.batched_cholesky(a)
    torch.cuda.synchronize()
    assert cholesky.launches == before + 1
    torch.testing.assert_close(got, cholesky.batched_cholesky_plain(a),
                               rtol=TOL_CHOL, atol=TOL_CHOL)
    assert torch.equal(torch.triu(got, 1), torch.zeros_like(got))
    torch.testing.assert_close(got @ got.transpose(-1, -2), a, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [96, 384])
def test_cholesky_kernel_gives_nan_where_not_positive_definite(cuda, n):
    a = _spd(3, n, seed=1, device=cuda)
    a[1] -= 2.0 * torch.eye(n, device=cuda)
    got = cholesky.batched_cholesky(a)  # no exception
    torch.cuda.synchronize()
    assert torch.isnan(got[1]).all()
    assert torch.isfinite(got[[0, 2]]).all()
    want = cholesky.batched_cholesky_plain(a)
    torch.testing.assert_close(got[[0, 2]], want[[0, 2]], rtol=TOL_CHOL,
                               atol=TOL_CHOL)
    assert torch.isnan(want[1]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("n,fail_at", [(97, 64), (191, 150), (384, 300)])
def test_cholesky_kernel_gives_nan_when_a_later_panel_fails(cuda, n,
                                                            fail_at):
    a = _spd(4, n, seed=2, device=cuda)
    a[2, fail_at, fail_at] = -1.0  # the pivot of a later panel goes negative
    got = cholesky.batched_cholesky(a)
    torch.cuda.synchronize()
    assert torch.isnan(got[2]).all()
    assert torch.isfinite(got[[0, 1, 3]]).all()
    assert torch.isnan(cholesky.batched_cholesky_plain(a)[2]).all()


@pytest.mark.gpu
def test_cholesky_kernel_takes_grad(cuda):
    a = _spd(3, 50, seed=4, device=cuda)
    leaf = a.clone().requires_grad_(True)
    before = cholesky.launches
    torch.sin(cholesky.batched_cholesky(leaf)).sum().backward()
    assert cholesky.launches == before + 1
    cpu = a.cpu().requires_grad_(True)
    torch.sin(cholesky.batched_cholesky(cpu)).sum().backward()
    torch.testing.assert_close(leaf.grad.cpu(), cpu.grad, rtol=TOL_CHOL,
                               atol=TOL_CHOL)


def _qkv(b, h, lq, lk, d, seed, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(b, h, n, d)).astype(
        np.float32)).to(device) for n in (lq, lk, lk)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,lq,lk,d", [
    (256, 8, 192, 192, 4), (256, 8, 96, 192, 4), (3, 4, 50, 37, 7),
    (2, 2, 130, 65, 33), (1, 1, 1, 1, 1)])
def test_head_folded_kernel_matches_plain(cuda, b, h, lq, lk, d):
    q, k, v = _qkv(b, h, lq, lk, d, seed=d, device=cuda)
    before = hfa.launches
    got = hfa.head_folded_attention(q, k, v)
    torch.cuda.synchronize()
    assert hfa.launches == before + 1
    torch.testing.assert_close(got, hfa.head_folded_attention_plain(q, k, v),
                               rtol=TOL_ATTENTION, atol=TOL_ATTENTION)


@pytest.mark.gpu
def test_head_folded_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(2, 2, 8, 8, 64, 0, cuda)
    with pytest.raises(ValueError, match="head dim"):
        hfa.head_folded_attention(q, k, v)
    q, k, v = _qkv(2, 2, 8, 8, 4, 0, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        hfa.head_folded_attention(q[:, :, ::2], k, v)


ATT_SHAPES = [(256, 8, 192, 192, 4), (256, 8, 96, 192, 4), (3, 4, 50, 37, 7),
              (2, 2, 130, 65, 33), (1, 1, 1, 1, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,lq,lk,d", ATT_SHAPES)
def test_head_folded_bwd_kernel_matches_plain(cuda, b, h, lq, lk, d):
    q, k, v = _qkv(b, h, lq, lk, d, seed=d + 1, device=cuda)
    do = torch.randn(b, h, lq, d, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(d))
    out, lse = hfa.forward_kernel(q, k, v, with_lse=True)
    want_lse = torch.logsumexp(
        torch.matmul(q, k.transpose(-1, -2)) / d ** 0.5, dim=-1)
    torch.testing.assert_close(lse, want_lse, rtol=TOL_ATTENTION,
                               atol=TOL_ATTENTION)
    before = hfa.bwd_launches
    got = hfa.backward_kernel(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    assert hfa.bwd_launches == before + 1
    want = hfa.head_folded_attention_bwd_plain(q, k, v, do)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        torch.testing.assert_close(g, w, rtol=TOL_GRAD_ATT,
                                   atol=ATOL_GRAD_ATT, msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("lq,lk", [(50, 50), (24, 61)])
def test_head_folded_kernel_takes_grad(cuda, lq, lk):
    """With inputs that require grad the wrapper runs the autograd Function
    (forward with lse, then the backward kernel); its gradients equal
    torch's autograd through the plain forward."""
    qkv = _qkv(3, 4, lq, lk, 4, seed=lk, device=cuda)
    leaves = [t.clone().requires_grad_(True) for t in qkv]
    fwd, bwd = hfa.launches, hfa.bwd_launches
    torch.sin(hfa.head_folded_attention(*leaves)).sum().backward()
    assert (hfa.launches, hfa.bwd_launches) == (fwd + 1, bwd + 1)
    plain = [t.clone().requires_grad_(True) for t in qkv]
    torch.sin(hfa.head_folded_attention_plain(*plain)).sum().backward()
    for a, p, name in zip(leaves, plain, "qkv"):
        torch.testing.assert_close(a.grad, p.grad, rtol=TOL_GRAD_ATT,
                                   atol=ATOL_GRAD_ATT, msg=name)


FLASH_SHAPES = [(64, 8, 512, 512, 64), (64, 8, 128, 128, 64),
                (2, 3, 130, 77, 64), (1, 2, 50, 200, 96), (2, 1, 65, 64, 112),
                (1, 1, 1, 1, 80)]
# head dims the kernels pad inside their tiles (every d >= 1 runs): the
# wgmma kernels' widths 64, 128 and 256 for bf16, the FFMA kernels' 64-column
# blocks for fp32, and past 256 the FFMA kernels for bf16 too
PADDED_D = [1, 8, 60, 72, 100, 128, 192, 256, 320]
PADDED_SHAPES = [(2, 2, 70, 33, d) for d in PADDED_D]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("b,h,lq,lk,d", FLASH_SHAPES + PADDED_SHAPES)
def test_flash_kernel_matches_plain(cuda, b, h, lq, lk, d, dtype):
    q, k, v = (t.to(dtype) for t in _qkv(b, h, lq, lk, d, seed=d, device=cuda))
    before = flash.launches
    got = flash.fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash.launches == before + 1 and got.dtype == dtype
    want = flash.fused_attention_plain(q, k, v)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=TOL_FLASH, atol=ATOL_FLASH)
    else:
        _assert_close_bf16(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("b,h,lq,lk,d", FLASH_SHAPES + PADDED_SHAPES)
def test_flash_bwd_kernel_matches_plain(cuda, b, h, lq, lk, d, dtype):
    q, k, v = (t.to(dtype) for t in _qkv(b, h, lq, lk, d, seed=d + 1,
                                         device=cuda))
    do = torch.randn(b, h, lq, d, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(d)).to(dtype)
    out, stats = flash.forward_kernel(q, k, v, with_stats=True)
    want_lse = torch.logsumexp(
        torch.matmul(q.float(), k.float().transpose(-1, -2)) / d ** 0.5,
        dim=-1)
    torch.testing.assert_close(stats.lse, want_lse, rtol=TOL_FLASH, atol=1e-4)
    assert (stats.o_lo is not None) == (dtype == torch.bfloat16)
    before = flash.bwd_launches
    got = flash.backward_kernel(q, k, v, out, stats, do)
    torch.cuda.synchronize()
    assert flash.bwd_launches == before + 1
    want = flash.fused_attention_bwd_plain(q, k, v, do)
    # bf16, relative to the largest of the three gradients: the kernel takes
    # D = rowsum(dO o (O + o_lo)), the reference's rowsum(dP o P) up to the
    # rounding of the bf16 residual o_lo, so where the exact gradient is 0
    # (a single key: dq = dk = 0) it leaves that rounding
    scale = max(w.float().abs().max().item() for w in want)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == dtype, name
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, rtol=TOL_FLASH_GRAD,
                                       atol=ATOL_FLASH_GRAD, msg=name)
        else:
            _assert_close_bf16(g, w, name,
                               scale if min(lq, lk) == 1 else None)
    again = flash.backward_kernel(q, k, v, out, stats, do)
    for g, a in zip(got, again):  # no atomics: equal bit for bit
        assert torch.equal(g, a)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("b,h,lq,lk,d", FLASH_SHAPES[1:])
def test_flash_bf16sm_kernels_match_plain(cuda, b, h, lq, lk, d, dtype):
    """The sm_bf16 variant, forward and backward, and bit-equal reruns."""
    q, k, v = (t.to(dtype) for t in _qkv(b, h, lq, lk, d, seed=d + 2,
                                         device=cuda))
    do = torch.randn(b, h, lq, d, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(d)).to(dtype)
    before = (flash.sm16_launches, flash.sm16_bwd_launches, flash.launches)
    got = flash.fused_attention_bf16sm(q, k, v)
    out, stats = flash.forward_kernel(q, k, v, True, sm_bf16=True)
    grads = flash.backward_kernel(q, k, v, out, stats, do, sm_bf16=True)
    torch.cuda.synchronize()
    assert (flash.sm16_launches, flash.sm16_bwd_launches, flash.launches) == (
        before[0] + 2, before[1] + 1, before[2])
    assert torch.equal(got, out) and stats.lse.shape == (2, b, h, lq)
    _assert_close_bf16(got, flash.fused_attention_plain(q, k, v, True),
                       "out", rel=TOL_SM16)
    want = flash.fused_attention_bwd_plain(q, k, v, do, True)
    scale = max(w.float().abs().max().item() for w in want)
    for g, w, name in zip(grads, want, ("dq", "dk", "dv")):
        assert g.dtype == dtype, name
        _assert_close_bf16(g, w, name, scale if min(lq, lk) == 1 else None,
                           rel=TOL_SM16)
    again = flash.backward_kernel(q, k, v, out, stats, do, sm_bf16=True)
    for g, a in zip(grads, again):
        assert torch.equal(g, a)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("lq,lk", [(70, 70), (24, 131)])
def test_flash_kernel_takes_grad(cuda, lq, lk, dtype):
    """With inputs that require grad the wrapper runs the autograd Function
    (forward with lse, then the backward kernels); its gradients equal the
    CPU Function's (plain forward, plain VJP)."""
    qkv = [t.to(dtype) for t in _qkv(3, 4, lq, lk, 64, seed=lk, device=cuda)]
    leaves = [t.clone().requires_grad_(True) for t in qkv]
    fwd, bwd = flash.launches, flash.bwd_launches
    torch.sin(flash.fused_attention(*leaves).float()).sum().backward()
    assert (flash.launches, flash.bwd_launches) == (fwd + 1, bwd + 1)
    cpu = [t.cpu().requires_grad_(True) for t in qkv]
    torch.sin(flash.fused_attention(*cpu).float()).sum().backward()
    for a, c, name in zip(leaves, cpu, "qkv"):
        if dtype == torch.float32:
            torch.testing.assert_close(a.grad.cpu(), c.grad,
                                       rtol=TOL_FLASH_GRAD,
                                       atol=ATOL_FLASH_GRAD, msg=name)
        else:
            _assert_close_bf16(a.grad.cpu(), c.grad, name)


N, BATCH, ENC, DEC, F = 37, 16, 24, 12, 4
SMALL = dict(src_input_size=F, tgt_input_size=F, d_model=16, n_heads=4,
             d_k=4, stack_size=1, pred_len=DEC, num_inducing=32,
             gp_ls_init=-1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("attn_type,expect", [
    ("basic", {"fused_gp": 3, "head_folded_attention": 18}),
    ("autoformer", {"fused_gp": 3, "head_folded_attention": 0})])
def test_session_on_card_runs_the_kernels_and_matches_cpu(cuda, attn_type,
                                                          expect):
    rng = np.random.default_rng(2)
    enc = rng.normal(size=(N, ENC, F)).astype(np.float32)
    dec = rng.normal(size=(N, DEC, F)).astype(np.float32)
    cpu_model = ForecastDenoising(**SMALL, attn_type=attn_type, device="cpu")
    state = cpu_model.state_dict()
    want = InferenceSession(cpu_model, state, batch_size=BATCH,
                            device="cpu").predict(enc, dec)
    session = InferenceSession(
        ForecastDenoising(**SMALL, attn_type=attn_type, device=cuda), state,
        batch_size=BATCH, device=cuda)
    fused_gp.launches = 0
    hfa.launches = 0
    got = session.predict(enc, dec)
    assert {"fused_gp": fused_gp.launches,
            "head_folded_attention": hfa.launches} == expect
    np.testing.assert_allclose(got, want, rtol=TOL_MODEL, atol=TOL_MODEL)


@pytest.mark.gpu
@pytest.mark.parametrize("attn_type,per_step", [
    ("basic", {"fused_gp": 1, "fused_gp_bwd": 1, "head_folded_attention": 6,
               "head_folded_attention_bwd": 6}),
    ("autoformer", {"fused_gp": 1, "fused_gp_bwd": 1,
                    "head_folded_attention": 0,
                    "head_folded_attention_bwd": 0})])
def test_training_step_on_card_matches_cpu(cuda, attn_type, per_step):
    """Two Trainer steps on the card and on the CPU from the same weights
    and batches: the same losses and parameters, through the kernels."""
    rng = np.random.default_rng(7)
    data = [rng.normal(size=(2, BATCH, n, f)).astype(np.float32)
            for n, f in ((ENC, F), (DEC, F), (DEC, 1))]
    cpu_model = ForecastDenoising(**SMALL, attn_type=attn_type, device="cpu")
    with torch.no_grad():  # q(u) away from the prior: every GP gradient
        layer = cpu_model.deep_gp.output_layer
        layer.variational_mean.copy_(torch.from_numpy(
            0.5 * rng.normal(size=32).astype(np.float32)))
        layer.variational_log_stddev.copy_(torch.from_numpy(
            0.3 * rng.normal(size=32).astype(np.float32)))
    state = {k: v.clone() for k, v in cpu_model.state_dict().items()}
    results = {}
    for device in ("cpu", cuda):
        model = (cpu_model if device == "cpu" else ForecastDenoising(
            **SMALL, attn_type=attn_type, device=cuda))
        trainer = Trainer(model, d_model=16, warmup_steps=100, device=device)
        s = trainer.init_state(state)
        fused_gp.launches = fused_gp.bwd_launches = 0
        hfa.launches = hfa.bwd_launches = 0
        s, loss, mse = trainer.train_epoch(
            s, tuple(torch.from_numpy(a).to(device) for a in data))
        counts = {"fused_gp": fused_gp.launches,
                  "fused_gp_bwd": fused_gp.bwd_launches,
                  "head_folded_attention": hfa.launches,
                  "head_folded_attention_bwd": hfa.bwd_launches}
        results[str(device)] = (loss, mse, s.params, counts)
    loss_c, mse_c, params_c, counts_c = results["cpu"]
    loss_g, mse_g, params_g, counts_g = results["cuda"]
    assert counts_c == dict.fromkeys(per_step, 0)
    assert counts_g == {k: 2 * v for k, v in per_step.items()}
    np.testing.assert_allclose(loss_g, loss_c, rtol=TOL_MODEL)
    np.testing.assert_allclose(mse_g, mse_c, rtol=TOL_MODEL)
    for name, p in params_c.items():
        torch.testing.assert_close(params_g[name].cpu(), p, rtol=TOL_MODEL,
                                   atol=TOL_MODEL, msg=name)


WIDE = dict(src_input_size=F, tgt_input_size=F, d_model=128, n_heads=2,
            d_k=64, stack_size=2, pred_len=DEC, num_inducing=32,
            gp_ls_init=-1.0, attn_type="basic")
BF16 = dict(compute_dtype=torch.bfloat16, gp_compute_dtype=torch.bfloat16)
# the bf16 model on the card against the port's CPU run: predictions and
# loss within 2^-6 (of the largest magnitude; relative), each gradient
# within 2^-3 of its largest magnitude, as tests/test_torch_train.py holds
# the CPU run to the JAX package
TOL_BF16_MODEL, TOL_BF16_GRAD = 2.0 ** -6, 2.0 ** -3


def _flash_counts():
    return {"flash": flash.launches, "flash_bwd": flash.bwd_launches,
            "head_folded": hfa.launches,
            "fused_gp": fused_gp.launches + fused_gp.bwd_launches,
            "fused_gp_bf16": fused_gp.bf16_launches,
            "fused_gp_bf16_bwd": fused_gp.bf16_bwd_launches}


def _zero_counts():
    flash.launches = flash.bwd_launches = hfa.launches = 0
    fused_gp.launches = fused_gp.bwd_launches = 0
    fused_gp.bf16_launches = fused_gp.bf16_bwd_launches = 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtypes", [{}, BF16], ids=["fp32", "bf16"])
def test_wide_session_on_card_takes_the_flash_route(cuda, dtypes):
    """d_k 64: self-attention through the flash kernel (two layers, two
    passes: 8 a batch), cross-attention plain, no head-folded launch."""
    rng = np.random.default_rng(3)
    enc = rng.normal(size=(N, ENC, F)).astype(np.float32)
    dec = rng.normal(size=(N, DEC, F)).astype(np.float32)
    cpu_model = ForecastDenoising(**WIDE, **dtypes, device="cpu")
    state = cpu_model.state_dict()
    want = InferenceSession(cpu_model, state, batch_size=BATCH,
                            device="cpu").predict(enc, dec)
    session = InferenceSession(
        ForecastDenoising(**WIDE, **dtypes, device=cuda), state,
        batch_size=BATCH, device=cuda)
    _zero_counts()
    got = session.predict(enc, dec)  # 37 windows: three batches of 16
    gp = {"fused_gp_bf16": 3} if dtypes else {"fused_gp": 3}
    assert _flash_counts() == {
        "flash": 24, "flash_bwd": 0, "head_folded": 0, "fused_gp": 0,
        "fused_gp_bf16": 0, "fused_gp_bf16_bwd": 0, **gp}
    if dtypes:
        assert np.abs(got - want).max() <= TOL_BF16_MODEL * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, rtol=TOL_MODEL, atol=TOL_MODEL)


def _step(model, batch):
    out = model(*batch, training=True)
    out.loss.backward()
    return out.loss.item(), {n: p.grad.cpu()
                             for n, p in model.named_parameters()}


# head dims the flash kernels pad: a bf16 model at d_k 72 (auto: self-
# attention on flash) and an fp32 model at d_k 128 with the flag (flash for
# self- and cross-attention, as JAX's flag takes its fused_attention there)
PADDED_MODELS = {
    "dk72_bf16": dict(WIDE, d_model=144, d_k=72, **BF16),
    "dk128_flag": dict(WIDE, d_model=256, d_k=128, use_pallas_attention=True),
}


def _flash_per_pass(kw):
    """flash launches of one model call: self-attention in each of the two
    layers of encoder and decoder, cross-attention too with the flag; the
    forecaster and the denoiser each make one pass"""
    return 2 * (6 if kw.get("use_pallas_attention") else 4)


@pytest.mark.gpu
@pytest.mark.parametrize("config", list(PADDED_MODELS))
def test_padded_head_dim_model_serves_on_card(cuda, config):
    """The models whose head dims the flash kernels used to refuse serve on
    the card through them, and match the CPU run."""
    kw = PADDED_MODELS[config]
    rng = np.random.default_rng(5)
    enc = rng.normal(size=(N, ENC, F)).astype(np.float32)
    dec = rng.normal(size=(N, DEC, F)).astype(np.float32)
    cpu_model = ForecastDenoising(**kw, device="cpu")
    state = cpu_model.state_dict()
    want = InferenceSession(cpu_model, state, batch_size=BATCH,
                            device="cpu").predict(enc, dec)
    session = InferenceSession(ForecastDenoising(**kw, device=cuda), state,
                               batch_size=BATCH, device=cuda)
    _zero_counts()
    got = session.predict(enc, dec)  # three batches
    assert flash.launches == 3 * _flash_per_pass(kw) and hfa.launches == 0
    assert np.isfinite(got).all()
    if "compute_dtype" in kw:
        assert np.abs(got - want).max() <= TOL_BF16_MODEL * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, rtol=TOL_MODEL, atol=TOL_MODEL)


@pytest.mark.gpu
@pytest.mark.parametrize("config", ["wide_fp32", "wide_bf16", "production",
                                    *PADDED_MODELS])
def test_wide_training_step_on_card_matches_cpu(cuda, config):
    """One forward and backward on the card (flash and fused-GP kernels,
    forward and backward) and on the CPU from the same weights and windows.
    ``production``: the full width (d_model 512, 8 heads, d_k 64, 2 layers,
    512 inducing points, enc 512, dec 128, bf16) on 2 windows; the padded
    head dims of ``PADDED_MODELS`` too."""
    if config == "production":
        kw = dict(WIDE, src_input_size=8, tgt_input_size=8, d_model=512,
                  n_heads=8, pred_len=128, num_inducing=512, **BF16)
        b, enc_len, dec_len, feats = 2, 512, 128, 8
    else:
        kw = PADDED_MODELS.get(config) or dict(
            WIDE, **(BF16 if config == "wide_bf16" else {}))
        b, enc_len, dec_len, feats = BATCH, ENC, DEC, F
    bf16 = "compute_dtype" in kw
    rng = np.random.default_rng(11)
    batch = [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
             for shape in ((b, enc_len, feats), (b, dec_len, feats),
                           (b, kw["pred_len"], 1))]
    cpu_model = ForecastDenoising(**kw, device="cpu")
    m = kw["num_inducing"]
    with torch.no_grad():  # q(u) away from the prior: every GP gradient
        layer = cpu_model.deep_gp.output_layer
        layer.variational_mean.copy_(torch.from_numpy(
            0.5 * rng.normal(size=m).astype(np.float32)))
        layer.variational_log_stddev.copy_(torch.from_numpy(
            0.3 * rng.normal(size=m).astype(np.float32)))
        cpu_model.lam.fill_(0.003)  # the ELBO counts
    gpu_model = ForecastDenoising(**kw, device=cuda)
    gpu_model.load_state_dict(cpu_model.state_dict())
    loss_c, grads_c = _step(cpu_model, batch)
    _zero_counts()
    loss_g, grads_g = _step(gpu_model, [t.to(cuda) for t in batch])
    gp = ({"fused_gp_bf16": 1, "fused_gp_bf16_bwd": 1} if bf16
          else {"fused_gp": 2})
    per_pass = _flash_per_pass(kw)
    assert _flash_counts() == {
        "flash": per_pass, "flash_bwd": per_pass, "head_folded": 0,
        "fused_gp": 0, "fused_gp_bf16": 0, "fused_gp_bf16_bwd": 0, **gp}
    np.testing.assert_allclose(loss_g, loss_c,
                               rtol=TOL_BF16_MODEL if bf16 else TOL_MODEL)
    for name, gc in grads_c.items():
        gg = grads_g[name]
        assert gg.dtype == torch.float32, name
        scale = gc.abs().max().item()
        tol = TOL_BF16_GRAD if bf16 else 1e-3  # fp32: as the smoke run's
        assert (gg - gc).abs().max().item() <= tol * scale, name


GP_KINDS = {
    # a hidden layer of 8 GPs on the rbf route (the smoke's width), the
    # output layer fused (d 8); in d 3 its 32-point Gram matrix is so
    # ill-conditioned that the CPU's own fp32 gradients lie 3e-3 from float64
    "multilayer": (dict(gp_hidden_dims=(8,), use_pallas_gp=True),
                   {"rbf": 1, "fused_gp": 1, "fused_gp_bwd": 1,
                    "cholesky": 0}),
    # the exact blur takes the library's factorization, as in JAX
    "exact": (dict(gp_kind="exact", exact_noise_init=0.1),
              {"rbf": 0, "fused_gp": 0, "fused_gp_bwd": 0, "cholesky": 0}),
}


@pytest.mark.gpu
@pytest.mark.parametrize("config", list(GP_KINDS))
def test_gp_kind_training_step_on_card_matches_cpu(cuda, config):
    """One forward and backward of the multi-layer (eps 0: no generator)
    and the exact-blur composites on the card and on the CPU from the same
    weights and windows, with the kernels' launches."""
    gp, expect = GP_KINDS[config]
    kw = dict(SMALL, attn_type="basic", **gp)
    rng = np.random.default_rng(12)
    batch = [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
             for shape in ((BATCH, ENC, F), (BATCH, DEC, F), (BATCH, DEC, 1))]
    cpu_model = ForecastDenoising(**kw, device="cpu")
    with torch.no_grad():
        cpu_model.lam.fill_(0.003)  # the GP's likelihood counts
        for name, p in cpu_model.deep_gp.named_parameters():
            if name.endswith(("variational_mean", "variational_log_stddev")):
                p.copy_(torch.from_numpy(0.4 * rng.normal(size=p.shape)))
    gpu_model = ForecastDenoising(**kw, device=cuda)
    gpu_model.load_state_dict(cpu_model.state_dict())
    loss_c, grads_c = _step(cpu_model, batch)
    rbf.launches = cholesky.launches = 0
    fused_gp.launches = fused_gp.bwd_launches = 0
    loss_g, grads_g = _step(gpu_model, [t.to(cuda) for t in batch])
    assert {"rbf": rbf.launches, "fused_gp": fused_gp.launches,
            "fused_gp_bwd": fused_gp.bwd_launches,
            "cholesky": cholesky.launches} == expect
    # the loss within 1e-4, each gradient within 1e-3 of its largest
    # magnitude on the CPU, as the smoke run's
    np.testing.assert_allclose(loss_g, loss_c, rtol=TOL_MODEL)
    for name, gc in grads_c.items():
        err = (grads_g[name] - gc).abs().max().item()
        assert err <= 1e-3 * gc.abs().max().item(), name


@pytest.mark.gpu
def test_exact_blur_pallas_on_card_matches_cusolver_and_cpu(cuda):
    """``ExactGPBlur(use_pallas=True)``: the Cholesky kernel, twice per
    factorization (the jitter probe, then the differentiable one), against
    the library route on the card and the CPU."""
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.normal(size=(6, 40, 8)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(6, 40)).astype(np.float32))
    ref = ExactGPBlur(8, ls_init=-1.0, noise_init=0.1, device="cpu")
    results = {}
    for name, use_pallas, device in (("kernel", True, cuda),
                                     ("cusolver", False, cuda),
                                     ("cpu", True, "cpu")):
        blur = ExactGPBlur(8, use_pallas=use_pallas, device=device)
        blur.load_state_dict(ref.state_dict())
        xl = x.to(device).requires_grad_(True)
        cholesky.launches = 0
        smooth, mll = blur(xl, y.to(device))
        (smooth.sum() - mll).backward()
        results[name] = [smooth.detach().cpu(), mll.detach().cpu(),
                         xl.grad.cpu()] + [p.grad.cpu()
                                           for p in blur.parameters()]
        if name == "kernel":
            assert cholesky.launches == 4  # two _factor calls
        else:
            assert cholesky.launches == 0
    for other in ("cusolver", "cpu"):
        for g, w in zip(results["kernel"], results[other]):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4,
                                       msg=other)


# small-head attention (d <= 8): the JAX package's tolerances for that
# kernel (tests/test_pallas_kernels.py), held as rtol / atol
TOL_SH, ATOL_SH = 1e-4, 1e-5
TOL_SH_GRAD, ATOL_SH_GRAD = 2e-3, 1e-4
SMALL_HEAD_SHAPES = [(4, 8, 192, 192, 4), (3, 8, 96, 96, 2),
                     (2, 8, 96, 192, 8), (2, 3, 1030, 20, 5),
                     (3, 2, 37, 600, 1), (2, 2, 70, 33, 3)]


def _small_head_inputs(b, h, lq, lk, d, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(b, h, n, d, device=device, generator=g)
            for n in (lq, lk, lk, lq)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,lq,lk,d", SMALL_HEAD_SHAPES)
def test_small_head_kernel_matches_plain(cuda, b, h, lq, lk, d):
    q, k, v, do = _small_head_inputs(b, h, lq, lk, d, cuda)
    before = sha.launches
    with torch.no_grad():
        got = sha.small_head_attention(q, k, v)
    torch.cuda.synchronize()
    assert sha.launches == before + 1
    torch.testing.assert_close(got, sha.small_head_attention_plain(q, k, v),
                               rtol=TOL_SH, atol=ATOL_SH)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,lq,lk,d", SMALL_HEAD_SHAPES)
def test_small_head_bwd_kernel_matches_plain_bit_for_bit_run_to_run(
        cuda, b, h, lq, lk, d):
    q, k, v, do = _small_head_inputs(b, h, lq, lk, d, cuda, seed=1)
    out, lse = sha.forward_kernel(q, k, v)
    first = sha.backward_kernel(q, k, v, out, lse, do)
    second = sha.backward_kernel(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    want = sha.small_head_attention_bwd_plain(q, k, v, do)
    for a, b_, w in zip(first, second, want):
        assert torch.equal(a, b_)  # no atomics: the same bits every run
        torch.testing.assert_close(a, w, rtol=TOL_SH_GRAD, atol=ATOL_SH_GRAD)


@pytest.mark.gpu
def test_small_head_function_counts_its_launches(cuda):
    q, k, v, do = _small_head_inputs(2, 4, 50, 61, 4, cuda, seed=2)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fwd, bwd = sha.launches, sha.bwd_launches
    hf_fwd, hf_bwd = hfa.launches, hfa.bwd_launches
    out = sha.small_head_attention(*leaves)
    out.backward(do)
    torch.cuda.synchronize()
    assert (sha.launches, sha.bwd_launches) == (fwd + 1, bwd + 1)
    # its own kernels, not the head-folded ones
    assert (hfa.launches, hfa.bwd_launches) == (hf_fwd, hf_bwd)
    want = sha.small_head_attention_bwd_plain(q, k, v, do)
    for t, w in zip(leaves, want):
        torch.testing.assert_close(t.grad, w, rtol=TOL_SH_GRAD,
                                   atol=ATOL_SH_GRAD)
    with pytest.raises(ValueError, match="1..8"):
        sha.small_head_attention(*(torch.zeros(1, 1, 4, 9, device=cuda)
                                   for _ in range(3)))


@pytest.mark.gpu
@pytest.mark.parametrize("attn_type", ["ATA", "conv_attn"])
def test_conv_family_with_the_flag_takes_head_folded(cuda, attn_type):
    """use_pallas_attention=True: the head-folded kernel six times each way
    per step (enc-self, dec-self, dec-cross, twice); auto: never."""
    enc = torch.randn(8, 48, 5, device=cuda)
    dec = torch.randn(8, 16, 5, device=cuda)
    y = torch.randn(8, 16, 1, device=cuda)
    for flag, per_step in ((True, 6), (None, 0)):
        model = ForecastDenoising(5, 5, 32, 8, 4, 1, 16, attn_type=attn_type,
                                  num_inducing=32, use_pallas_attention=flag,
                                  device=cuda)
        fwd, bwd = hfa.launches, hfa.bwd_launches
        out = model(enc, dec, y, training=True)
        out.loss.backward()
        torch.cuda.synchronize()
        assert (hfa.launches - fwd, hfa.bwd_launches - bwd) == (per_step,
                                                                per_step)
        assert torch.isfinite(out.loss)


@pytest.mark.gpu
@pytest.mark.parametrize("d_k", [64, 128])
@pytest.mark.parametrize("attn_type", ["ATA", "conv_attn"])
def test_conv_family_with_the_flag_above_63_takes_flash(cuda, attn_type, d_k):
    """use_pallas_attention=True past the head-folded kernel's d_k <= 63:
    the op's softmax attention runs the flash kernel, forward and backward,
    never the plain op, and matches the op with the plain attention."""
    from fine_grained_gaussian_process_forcasting_torch.ops import (
        conv_attention as tca,
    )

    make = tca.ATAAttention if attn_type == "ATA" else tca.ConvAttnAttention
    ops = [make(d_k, 2, use_kernel=flag, device="cpu",
                generator=torch.Generator().manual_seed(0))
           for flag in (True, False)]
    ops[1].load_state_dict(ops[0].state_dict())
    ops = [op.to(cuda) for op in ops]
    qkv = _qkv(3, 2, 40, 40, d_k, seed=d_k, device=cuda)
    grads, outs = [], []
    for op in ops:
        leaves = [t.clone().requires_grad_(True) for t in qkv]
        counts = (flash.launches, flash.bwd_launches, hfa.launches)
        out = op(*leaves)
        torch.sin(out).sum().backward()
        torch.cuda.synchronize()
        ran = (flash.launches - counts[0], flash.bwd_launches - counts[1],
               hfa.launches - counts[2])
        assert ran == ((1, 1, 0) if op.use_kernel else (0, 0, 0))
        outs.append(out.detach())
        grads.append([t.grad for t in leaves])
    torch.testing.assert_close(outs[0], outs[1], rtol=TOL_FLASH,
                               atol=ATOL_FLASH)
    for g, w, name in zip(*grads, "qkv"):
        torch.testing.assert_close(g, w, rtol=TOL_FLASH_GRAD,
                                   atol=ATOL_FLASH_GRAD, msg=name)


@pytest.mark.gpu
def test_harness_on_card(cuda, tmp_path):
    """A tiny ATA study through the harness on the card: trains, keeps the
    best checkpoint, evaluates and writes the reported errors."""
    from fine_grained_gaussian_process_forcasting_torch.data.synthetic import (
        make_synthetic_frame,
    )
    from fine_grained_gaussian_process_forcasting_torch.train.harness import (
        ExperimentHarness,
        HarnessArgs,
    )

    args = HarnessArgs(exp_name="solar", model_name="ATA", attn_type="ATA",
                       pred_len=8, seed=3, n_trials=1, num_epochs=2,
                       d_model_choices=(16,), stack_choices=(1,),
                       num_inducing=16, max_train_samples=64,
                       max_valid_samples=32, use_pallas_attention=True,
                       out_dir=str(tmp_path))
    frame = make_synthetic_frame("solar", num_entities=4,
                                 steps_per_entity=600)
    fwd = fused_gp.launches
    harness = ExperimentHarness(frame, args)
    harness.run_study()
    result = harness.evaluate()
    # 2 epochs x (2 train steps + 1 valid batch), then 1 test batch
    assert fused_gp.launches - fwd == 7
    assert np.isfinite(result["mse"])
    name = harness.model_name
    assert (tmp_path / "models_solar_8" / name).exists()
    preds = np.load(tmp_path / "solar" / f"{name}.npz")["predictions"]
    assert preds.shape == (1, 32, 8) and np.isfinite(preds).all()
    assert (tmp_path / "reported_errors_solar.csv").read_text().startswith(
        ",MSE,MAE\n" + name + ",")
