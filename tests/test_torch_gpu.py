"""The PyTorch port's CUDA kernels against their plain versions, on the card:
forward and backward kernels, the autograd Functions, serving and training.

Every test here needs a CUDA device and skips without one (decided in the
``cuda`` fixture, never at import).  The file imports no JAX, so it runs on
a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import copy

import _torch_small_head_cases as small_head_cases
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


def _dos_nearly_cancelling(seed, device):
    """The flagship-sized fused-GP inputs (73,728 rows, d 32, M 512) with
    a cotangent dvar that has lost its component along the rows' d var /
    d os, after dmean's share of dos: dos is 0 up to float32 rounding.
    Returns (args, dmean, dvar, the float64 inputs)."""
    *args, dmean, dvar = _gp_like_inputs(73728, 32, 512, seed=seed,
                                         device=device)
    wide = [a.double() for a in args]

    def marginals(outputscale):
        return fused_gp.whitened_marginals_affine_plain(
            *wide[:4], outputscale, *wide[5:])

    _, (dmean_dos, dvar_dos) = torch.func.jvp(
        marginals, (wide[4],), (torch.ones_like(wide[4]),))
    dm, dv = dmean.double(), dvar.double()
    dos = (dm * dmean_dos).sum() + (dv * dvar_dos).sum()
    dvar = (dv - dos / (dvar_dos * dvar_dos).sum() * dvar_dos).float()
    return args, dmean, dvar, wide + [dm, dvar.double()]


@pytest.mark.gpu
def test_fused_gp_fp32_dos_where_it_nearly_cancels(cuda):
    """dos sums a term for every row and inducing point (37.7 M at the
    flagship's 73,728 rows and M 512) that nearly cancel.  At inputs built
    so that dos is 0 up to float32 rounding (``_dos_nearly_cancelling``),
    the kernel's dos is no farther from the float64 function than twice the
    plain version's, the distances summed over 16 such inputs: on one, the
    two distances are nearly independent rounding errors of one size (the
    first input here: kernel 4.8e-2, plain 1.9e-2 from float64), the
    reason every float64 gate of the port sums 16 draws."""
    assert not torch.backends.cuda.matmul.allow_tf32
    kernel64 = plain64 = 0.0
    seen = []
    for i in range(16):
        args, dmean, dvar, wide = _dos_nearly_cancelling(11 + i, cuda)
        got = fused_gp.backward_kernel(*args, dmean, dvar)[4].item()
        plain = fused_gp.whitened_marginals_affine_bwd_plain(
            *args, dmean, dvar)[4].item()
        exact = fused_gp.whitened_marginals_affine_bwd_plain(*wide)[4].item()
        kernel64 += abs(got - exact)
        plain64 += abs(plain - exact)
        seen.append(f"seed {11 + i}: |dos| {abs(exact):.1e}, |kernel - "
                    f"plain| {abs(got - plain):.2e}, from float64 kernel "
                    f"{abs(got - exact):.2e} plain {abs(plain - exact):.2e}")
    reading = (f"summed from float64: kernel {kernel64:.3e}, plain "
               f"{plain64:.3e} (ratio {kernel64 / plain64:.3f}); "
               + "; ".join(seen))
    print(reading)
    assert kernel64 <= 2.0 * plain64, reading


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


def _layout(layout, *ts):
    """The tensors as given ("contiguous"), or their values as (b, h, L, d)
    views of (b, L, h, d) buffers ("folded"), as the transformer hands them
    to the head-folded kernels."""
    if layout == "contiguous":
        return list(ts)
    return [t.transpose(1, 2).contiguous().transpose(1, 2) for t in ts]


ATT_SHAPES = [(256, 8, 192, 192, 4), (256, 8, 96, 192, 4), (3, 4, 50, 37, 7),
              (2, 2, 130, 65, 33), (1, 1, 1, 1, 1)]
HF_LAYOUTS = ["contiguous", "folded"]


@pytest.mark.gpu
@pytest.mark.parametrize("layout", HF_LAYOUTS)
@pytest.mark.parametrize("b,h,lq,lk,d", ATT_SHAPES)
def test_head_folded_kernel_matches_plain(cuda, b, h, lq, lk, d, layout):
    q, k, v = _layout(layout, *_qkv(b, h, lq, lk, d, seed=d, device=cuda))
    before = hfa.launches
    got = hfa.head_folded_attention(q, k, v)
    torch.cuda.synchronize()
    assert hfa.launches == before + 1
    assert tuple(got.shape) == (b, h, lq, d)
    # the context is a view of (b, Lq, h, d) memory
    assert got.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(got, hfa.head_folded_attention_plain(q, k, v),
                               rtol=TOL_ATTENTION, atol=TOL_ATTENTION)


@pytest.mark.gpu
def test_head_folded_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(2, 2, 8, 8, 64, 0, cuda)
    with pytest.raises(ValueError, match="head dim"):
        hfa.head_folded_attention(q, k, v)
    # any (b, h, L) strides are taken; a head dim that is not unit-stride
    # is not
    q, k, v = _qkv(2, 2, 8, 8, 8, 0, cuda)
    with pytest.raises(ValueError, match="unit stride"):
        hfa.head_folded_attention(q[..., ::2], k[..., ::2], v[..., ::2])


@pytest.mark.gpu
@pytest.mark.parametrize("layout", HF_LAYOUTS)
@pytest.mark.parametrize("b,h,lq,lk,d", ATT_SHAPES)
def test_head_folded_bwd_kernel_matches_plain(cuda, b, h, lq, lk, d, layout):
    q, k, v = _qkv(b, h, lq, lk, d, seed=d + 1, device=cuda)
    do = torch.randn(b, h, lq, d, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(d))
    q, k, v, do = _layout(layout, q, k, v, do)
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
        assert tuple(g.shape) == tuple(w.shape), name
        torch.testing.assert_close(g, w, rtol=TOL_GRAD_ATT,
                                   atol=ATOL_GRAD_ATT, msg=name)


# heads past the backward's fused route (Lq > 256, or d > 16: two
# launches) and the forward's 192-key chunks, with a row or a key alone
LONG_LENGTHS = [1, 257, 385]


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 4, 8, 33, 63])
@pytest.mark.parametrize("lk", LONG_LENGTHS)
@pytest.mark.parametrize("lq", LONG_LENGTHS)
def test_head_folded_long_heads_match_plain(cuda, lq, lk, d):
    q, k, v = _layout("folded", *_qkv(2, 3, lq, lk, d, seed=lq + lk + d,
                                      device=cuda))
    do = _layout("folded", torch.randn(
        2, 3, lq, d, device=cuda,
        generator=torch.Generator(cuda).manual_seed(d)))[0]
    out, lse = hfa.forward_kernel(q, k, v, with_lse=True)
    torch.testing.assert_close(out, hfa.head_folded_attention_plain(q, k, v),
                               rtol=TOL_ATTENTION, atol=TOL_ATTENTION)
    got = hfa.backward_kernel(q, k, v, out, lse, do)
    want = hfa.head_folded_attention_bwd_plain(q, k, v, do)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        torch.testing.assert_close(g, w, rtol=TOL_GRAD_ATT,
                                   atol=ATOL_GRAD_ATT, msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,lq,lk,d", [
    (256, 8, 192, 192, 4), (256, 8, 96, 96, 4), (256, 8, 96, 192, 4),
    (3, 4, 50, 37, 7), (2, 3, 257, 385, 4), (2, 2, 130, 65, 33)])
def test_head_folded_kernels_rerun_bit_equal(cuda, b, h, lq, lk, d):
    """Every sum in a fixed order, no atomics: the forward and both
    backward routes give the same bits twice."""
    q, k, v = _layout("folded", *_qkv(b, h, lq, lk, d, seed=5, device=cuda))
    do = torch.randn(b, h, lq, d, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(5))
    first = hfa.forward_kernel(q, k, v, with_lse=True)
    again = hfa.forward_kernel(q, k, v, with_lse=True)
    assert all(torch.equal(a, b_) for a, b_ in zip(first, again))
    out, lse = first
    grads = hfa.backward_kernel(q, k, v, out, lse, do)
    grads_again = hfa.backward_kernel(q, k, v, out, lse, do)
    for a, b_, name in zip(grads, grads_again, ("dq", "dk", "dv")):
        assert torch.equal(a, b_), name


@pytest.mark.gpu
@pytest.mark.parametrize("at", [0, 300])
def test_head_folded_forward_rescales_where_a_later_key_dominates(cuda, at):
    """The forward takes its running max once a group of keys; one key
    scoring ~25 above the rest, first or in the second 192-key chunk, must
    rescale (or leave out) everything summed before it."""
    q, k, v = _layout("folded", *_qkv(2, 3, 40, 385, 4, seed=at,
                                      device=cuda))
    q[..., 1] = 1.0
    k[:, :, at] = torch.tensor([0.0, 50.0, 0.0, 0.0], device=cuda)
    out, lse = hfa.forward_kernel(q, k, v, with_lse=True)
    torch.testing.assert_close(out, hfa.head_folded_attention_plain(q, k, v),
                               rtol=TOL_ATTENTION, atol=TOL_ATTENTION)
    want_lse = torch.logsumexp(torch.matmul(q, k.transpose(-1, -2)) / 2.0,
                               dim=-1)
    torch.testing.assert_close(lse, want_lse, rtol=TOL_ATTENTION,
                               atol=TOL_ATTENTION)


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


@pytest.mark.gpu
def test_head_folded_kernel_takes_grad_through_projection_views(cuda):
    """As the transformer calls it: q, k, v sliced out of one (b, L, 3 h d)
    projection and viewed as (b, h, L, d); the gradient reaches that buffer,
    and the context goes back to (b, L, h d) rows without a copy."""
    b, h, length, d = 3, 4, 40, 4
    qkv = torch.randn(b, length, 3 * h * d, device=cuda,
                      generator=torch.Generator(cuda).manual_seed(2))
    leaf = qkv.clone().requires_grad_(True)
    plain = qkv.clone().requires_grad_(True)

    def heads(x):
        return [x[..., i * h * d:(i + 1) * h * d].reshape(
            b, length, h, d).transpose(1, 2) for i in range(3)]

    ctx = hfa.head_folded_attention(*heads(leaf))
    rows = ctx.transpose(1, 2).reshape(b, length, h * d)
    assert rows.data_ptr() == ctx.data_ptr()
    torch.sin(rows).sum().backward()
    want = hfa.head_folded_attention_plain(*heads(plain))
    torch.sin(want.transpose(1, 2).reshape(b, length, h * d)).sum().backward()
    torch.testing.assert_close(leaf.grad, plain.grad, rtol=TOL_GRAD_ATT,
                               atol=ATOL_GRAD_ATT)


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
# the shapes of ``_torch_small_head_cases`` (the CPU tests hold the same
# inputs against the JAX package): every d from 1 to 8, a one-key row, Lq on
# both sides of the fused backward's limit, Lk past 512 and 1536
SMALL_HEAD_SHAPES = small_head_cases.SHAPES


def _small_head_inputs(b, h, lq, lk, d, device):
    return [torch.from_numpy(a).to(device) for a in small_head_cases.inputs(
        b, h, lq, lk, d, seed=lq + lk + d)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,lq,lk,d", SMALL_HEAD_SHAPES)
def test_small_head_kernel_matches_plain(cuda, b, h, lq, lk, d):
    q, k, v, do = _small_head_inputs(b, h, lq, lk, d, cuda)
    before = sha.launches
    with torch.no_grad():
        got = sha.small_head_attention(q, k, v)
        again = sha.small_head_attention(q, k, v)
    torch.cuda.synchronize()
    assert sha.launches == before + 2
    assert torch.equal(got, again)
    torch.testing.assert_close(got, sha.small_head_attention_plain(q, k, v),
                               rtol=TOL_SH, atol=ATOL_SH)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,lq,lk,d", SMALL_HEAD_SHAPES)
def test_small_head_bwd_kernel_matches_plain_bit_for_bit_run_to_run(
        cuda, b, h, lq, lk, d):
    q, k, v, do = _small_head_inputs(b, h, lq, lk, d, cuda)
    out, lse = sha.forward_kernel(q, k, v)
    first = sha.backward_kernel(q, k, v, out, lse, do)
    second = sha.backward_kernel(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    want = sha.small_head_attention_bwd_plain(q, k, v, do)
    for a, b_, w in zip(first, second, want):
        assert torch.equal(a, b_)  # no atomics: the same bits every run
        torch.testing.assert_close(a, w, rtol=TOL_SH_GRAD, atol=ATOL_SH_GRAD)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,lq,lk,d", SMALL_HEAD_SHAPES)
def test_small_head_bwd_takes_one_launch_where_the_rows_fit(cuda, b, h, lq,
                                                            lk, d):
    """The backward computes each exponential once, in one launch, where a
    head's q, dO, dQ, lse and D (Lq rounded up to 32 rows) fit in 64 KB of
    shared memory, and streams the rows in two launches past that; either
    way one backward call counts once."""
    fits = 4 * (-(-lq // 32) * 32) * (3 * d + 2) <= 64 * 1024
    assert sha.bwd_launches_a_call(lq, d) == (1 if fits else 2)
    q, k, v, do = _small_head_inputs(b, h, lq, lk, d, cuda)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before, kernels = sha.bwd_launches, sha.kernels_launched()
    sha.small_head_attention(*leaves).backward(do)
    torch.cuda.synchronize()
    assert sha.bwd_launches == before + 1
    # as the library counts its launches: the forward's, the backward's
    assert sha.kernels_launched() - kernels == 1 + (1 if fits else 2)


@pytest.mark.gpu
@pytest.mark.parametrize("name", small_head_cases.SCORE_CASES)
def test_small_head_forward_rescales_where_scores_rise(cuda, name):
    """The forward keeps a lazy offset and rescales a row only where a
    group of 4 keys sums past 2^8 against it: scores rising a key by steps
    that leave the group sums just under and just over that threshold, and
    one key 20, 60 or 130 (an exponential past 2^127) above the rest --
    the offset kept, the row restarted, an inf dropped -- at 40 query rows
    (3 rows a lane) and 192 (6 rows a lane).  Output and lse against
    plain, the gradients too, two runs bit-equal."""
    q, k, v, do = (torch.from_numpy(a).to(cuda)
                   for a in small_head_cases.score_case(name))
    out, lse = sha.forward_kernel(q, k, v)
    again = sha.forward_kernel(q, k, v)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    torch.testing.assert_close(out, sha.small_head_attention_plain(q, k, v),
                               rtol=TOL_SH, atol=ATOL_SH)
    want_lse = torch.logsumexp(torch.matmul(q, k.transpose(-1, -2)) / 2.0,
                               dim=-1)
    torch.testing.assert_close(lse, want_lse, rtol=TOL_SH, atol=ATOL_SH)
    grads = sha.backward_kernel(q, k, v, out, lse, do)
    for g, w, n in zip(grads, sha.small_head_attention_bwd_plain(q, k, v, do),
                       ("dq", "dk", "dv")):
        torch.testing.assert_close(g, w, rtol=TOL_SH_GRAD, atol=ATOL_SH_GRAD,
                                   msg=lambda m, n=n: f"{n}: {m}")


@pytest.mark.gpu
def test_small_head_function_counts_its_launches(cuda):
    q, k, v, do = _small_head_inputs(2, 4, 50, 61, 4, cuda)
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


# the model's last options on the card against the CPU: informer (its key
# sample pinned on both devices), fedformer (a decoder stream of 16: its 8
# Fourier modes need 8 frequencies), the LSTM backbone, and the 16-bit
# autoformer (the card's delays replayed on the CPU) and conv family
OPTION_DEC = 16
OPTIONS = {
    "informer": dict(attn_type="informer"),
    "fedformer": dict(attn_type="fedformer"),
    "lstm": dict(backbone="lstm", stack_size=2),
    "autoformer_bf16": dict(attn_type="autoformer", **BF16),
    "conv_attn_bf16": dict(attn_type="conv_attn", **BF16),
}


def _pin_options(monkeypatch):
    """ProbSparse takes one numpy key sample per shape on both devices;
    AutoCorrelation replays, on the CPU, the delays the card chose."""
    from fine_grained_gaussian_process_forcasting_torch.models import (
        transformer as ttr,
    )
    from fine_grained_gaussian_process_forcasting_torch.ops import (
        probsparse as tps,
    )

    psp, auto = ttr.prob_sparse_attention, ttr.auto_correlation
    delays, replay = [], []

    def pinned(q, k, v, generator=None, **kw):
        u_part, _ = tps.sample_sizes(q.shape[2], k.shape[2])
        sample = np.random.default_rng(q.shape[2] * k.shape[2]).integers(
            0, k.shape[2], size=(q.shape[2], u_part))
        return psp(q, k, v, index_sample=torch.from_numpy(sample), **kw)

    def recorded(q, k, v, factor=1, training=True):
        given = None
        if q.device.type == "cpu" and replay:
            given = replay.pop(0)
            given = given if training else given[: q.shape[0]]
        ctx, corr = auto(q, k, v, factor, training, delays=given)
        if q.device.type == "cuda":
            top_k = int(factor * np.log(q.shape[2]))
            delays.append((torch.topk(corr.mean(0), top_k).indices
                           if training else
                           torch.topk(corr, top_k, dim=-1).indices).cpu())
        return ctx, corr

    def replay_next():
        """The card's delays so far, for the CPU's next run."""
        replay.extend(delays)
        delays.clear()

    monkeypatch.setattr(ttr, "prob_sparse_attention", pinned)
    monkeypatch.setattr(ttr, "auto_correlation", recorded)
    return replay_next


@pytest.mark.gpu
@pytest.mark.parametrize("option", list(OPTIONS))
def test_model_option_on_card_matches_cpu(cuda, option, monkeypatch):
    """Served (three batches of 16, the last ragged) and one training step
    on the card through the fused-GP kernels (the bf16 ones at 16 bits),
    against the CPU from the same weights: fp32 1e-4 (each gradient 1e-3
    of its largest magnitude), 16-bit 2^-6 (gradients 2^-3)."""
    kw = dict(SMALL, pred_len=OPTION_DEC, **OPTIONS[option])
    bf16 = "compute_dtype" in kw
    replay_next = _pin_options(monkeypatch)
    rng = np.random.default_rng(14)
    enc = rng.normal(size=(N, ENC, F)).astype(np.float32)
    dec = rng.normal(size=(N, OPTION_DEC, F)).astype(np.float32)
    y = rng.normal(size=(BATCH, OPTION_DEC, 1)).astype(np.float32)
    cpu_model = ForecastDenoising(**kw, device="cpu")
    with torch.no_grad():
        cpu_model.lam.fill_(0.003)  # the ELBO counts
    state = {k: v.clone() for k, v in cpu_model.state_dict().items()}
    session = InferenceSession(ForecastDenoising(**kw, device=cuda), state,
                               batch_size=BATCH, device=cuda)
    _zero_counts()
    got = session.predict(enc, dec)
    replay_next()
    want = InferenceSession(cpu_model, state, batch_size=BATCH,
                            device="cpu").predict(enc, dec)
    gp = "fused_gp_bf16" if bf16 else "fused_gp"
    assert _flash_counts()[gp] == 3
    tol = TOL_BF16_MODEL if bf16 else TOL_MODEL
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())

    gpu_model = ForecastDenoising(**kw, device=cuda)
    gpu_model.load_state_dict(state)
    batch = [torch.from_numpy(a[:BATCH]) for a in (enc, dec)] + [
        torch.from_numpy(y)]
    _zero_counts()
    loss_g, grads_g = _step(gpu_model, [t.to(cuda) for t in batch])
    counts = _flash_counts()
    assert (counts["fused_gp_bf16"], counts["fused_gp_bf16_bwd"]) == (
        (1, 1) if bf16 else (0, 0))
    assert counts["fused_gp"] == (0 if bf16 else 2)
    replay_next()
    loss_c, grads_c = _step(cpu_model, batch)
    np.testing.assert_allclose(loss_g, loss_c, rtol=tol)
    # a gradient a million times below the largest (fedformer's fed_q bias,
    # which reaches no selected mode: 0 in exact arithmetic) is rounding
    # residue on both devices, held to that floor as the smoke run holds it
    floor = 1e-6 * max(g.abs().max().item() for g in grads_c.values())
    for name, gc in grads_c.items():
        err = (grads_g[name] - gc).abs().max().item()
        scale = max(gc.abs().max().item(), floor)
        assert err <= (TOL_BF16_GRAD if bf16 else 1e-3) * scale, name


# ---- the seed axis (multi-seed training) ------------------------------- #

def _seeded_inputs(seeds, b, n, d, m, device):
    """Per-seed fused-GP inputs and cotangents, and both stacked."""
    per = [_fused_inputs(b, n, d, m, 40 + i, device) for i in range(seeds)]
    gen = torch.Generator(device).manual_seed(7)
    cot = [(torch.randn(b, n, device=device, generator=gen),
            torch.randn(b, n, device=device, generator=gen))
           for _ in range(seeds)]
    return (per, cot, [torch.stack(t) for t in zip(*per)],
            [torch.stack(t) for t in zip(*cot)])


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("m", [128, 512])
def test_fused_gp_seed_axis_bit_equal_to_single_seed_calls(cuda, bf16, m):
    """One call for 3 seeds, forward and backward, equals 3 calls of one
    seed bit for bit (the same kernels, offsets only), and counts one
    launch each way."""
    per, cot, args, cots = _seeded_inputs(3, 4, 96, 32, m, cuda)
    before = (fused_gp.bf16_launches if bf16 else fused_gp.launches,
              fused_gp.bf16_bwd_launches if bf16 else fused_gp.bwd_launches)
    fwd = fused_gp.forward_kernel(*args, bf16=bf16)
    bwd = fused_gp.backward_kernel(*args, *cots, bf16=bf16)
    after = (fused_gp.bf16_launches if bf16 else fused_gp.launches,
             fused_gp.bf16_bwd_launches if bf16 else fused_gp.bwd_launches)
    assert (after[0] - before[0], after[1] - before[1]) == (1, 1)
    for i in range(3):
        for got, want in zip(fwd, fused_gp.forward_kernel(*per[i],
                                                          bf16=bf16)):
            assert torch.equal(got[i], want)
        for got, want in zip(bwd, fused_gp.backward_kernel(
                *per[i], *cot[i], bf16=bf16)):
            assert torch.equal(got[i], want)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_fused_gp_one_seed_axis_is_the_call_without_it(cuda, bf16):
    """S = 1: the same kernels and results as the call without the axis."""
    per, cot, args, cots = _seeded_inputs(1, 2, 160, 16, 256, cuda)
    fwd = fused_gp.forward_kernel(*args, bf16=bf16)
    bwd = fused_gp.backward_kernel(*args, *cots, bf16=bf16)
    for got, want in zip(fwd, fused_gp.forward_kernel(*per[0], bf16=bf16)):
        assert got.shape[0] == 1 and torch.equal(got[0], want)
    for got, want in zip(bwd, fused_gp.backward_kernel(*per[0], *cot[0],
                                                       bf16=bf16)):
        assert got.shape[0] == 1 and torch.equal(got[0], want)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_fused_gp_vmap_rule_makes_one_seeded_call(cuda, bf16):
    """Under torch.func.vmap the Function's rule makes one seeded call each
    way, and each seed's outputs and gradients are its own call's."""
    per, cot, args, cots = _seeded_inputs(3, 2, 64, 8, 128, cuda)
    fn = (fused_gp.whitened_marginals_affine_bf16 if bf16
          else fused_gp.whitened_marginals_affine)
    leaves = [a.clone().requires_grad_() for a in args]
    n0 = (fused_gp.seeds_launches + fused_gp.bf16_seeds_launches,
          fused_gp.seeds_bwd_launches + fused_gp.bf16_seeds_bwd_launches)
    mean, var = torch.func.vmap(fn)(*leaves)
    torch.autograd.backward((mean, var), cots)
    n1 = (fused_gp.seeds_launches + fused_gp.bf16_seeds_launches,
          fused_gp.seeds_bwd_launches + fused_gp.bf16_seeds_bwd_launches)
    assert (n1[0] - n0[0], n1[1] - n0[1]) == (1, 1)
    for i in range(3):
        one = [a.clone().requires_grad_() for a in per[i]]
        m1, v1 = fn(*one)
        torch.autograd.backward((m1, v1), cot[i])
        assert torch.equal(mean[i], m1) and torch.equal(var[i], v1)
        for leaf, single in zip(leaves, one):
            assert torch.equal(leaf.grad[i], single.grad)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["head_folded", "flash_fp32",
                                    "flash_bf16"])
def test_attention_fold_rule_bit_equal_to_single_seed_calls(cuda, kernel):
    """Under torch.func.vmap the attention kernels fold the seeds into the
    batch: one launch each way for 3 seeds, each seed's context and dq, dk,
    dv equal to its own call's bit for bit (head-folded on the projections'
    (b, L, h, d) views)."""
    fn, module, d, dtype = {
        "head_folded": (hfa.head_folded_attention, hfa, 4, torch.float32),
        "flash_fp32": (flash.fused_attention, flash, 64, torch.float32),
        "flash_bf16": (flash.fused_attention, flash, 64, torch.bfloat16),
    }[kernel]
    gen = torch.Generator(cuda).manual_seed(3)
    s, b, h, length = 3, 4, 8, 96
    qkv = [torch.randn(s, b, length, h, d, device=cuda, generator=gen
                       ).to(dtype).transpose(2, 3) for _ in range(3)]
    if module is flash:
        qkv = [t.contiguous() for t in qkv]
    do = torch.randn(s, b, h, length, d, device=cuda, generator=gen).to(dtype)
    leaves = [t.detach().requires_grad_() for t in qkv]
    n0 = (module.launches, module.bwd_launches)
    out = torch.func.vmap(fn)(*leaves)
    out.backward(do)
    assert (module.launches - n0[0], module.bwd_launches - n0[1]) == (1, 1)
    for i in range(s):
        one = [t[i].detach().requires_grad_() for t in qkv]
        o = fn(*one)
        o.backward(do[i])
        assert torch.equal(out[i], o)
        for t, single in zip(leaves, one):
            assert torch.equal(t.grad[i], single.grad)


@pytest.mark.gpu
@pytest.mark.parametrize("attn_type, flag", [("autoformer", None),
                                             ("basic", None),
                                             ("ATA", True)])
def test_multiseed_step_matches_single_seed_steps(cuda, attn_type, flag):
    """One MultiSeedTrainer step for 3 seeds against 3 Trainer steps on the
    card: each seed's loss and gradients (TOL_MODEL relative to each
    gradient's largest magnitude), one fused-GP launch each way for all
    seeds."""
    from fine_grained_gaussian_process_forcasting_torch.train.multiseed import (
        MultiSeedTrainer,
    )

    def model(seed):
        return ForecastDenoising(
            src_input_size=4, tgt_input_size=4, d_model=32, n_heads=8,
            d_k=4, stack_size=1, pred_len=24, attn_type=attn_type,
            num_inducing=64, gp_ls_init=-1.0, use_pallas_attention=flag,
            device=cuda, generator=torch.Generator().manual_seed(seed))

    rng = np.random.default_rng(0)
    batch = tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                   ).to(cuda)
                  for shape in ((16, 48, 4), (16, 24, 4), (16, 24, 1)))
    seeds = (3, 4, 5)
    trainer = MultiSeedTrainer(model(0), 32, 3, warmup_steps=100,
                               device=cuda)
    state = trainer.init_state(seeds, lambda s: model(s).state_dict())
    n0 = (fused_gp.launches, fused_gp.bwd_launches)
    losses, grads = trainer.gradients(state, batch)
    assert (fused_gp.launches - n0[0], fused_gp.bwd_launches - n0[1]) == (1, 1)
    for i, s in enumerate(seeds):
        single = Trainer(model(s), 32, warmup_steps=100, device=cuda)
        single.init_state(seed=s)
        out = single.model(*batch, training=True, generator=single.generator)
        out.loss.backward()
        np.testing.assert_allclose(losses[i].item(), out.loss.item(),
                                   rtol=TOL_MODEL)
        largest = max(p.grad.abs().max().item()
                      for p in single.model.parameters())
        for name, p in single.model.named_parameters():
            if ".ata." in name and "_conv" in name and name.endswith("bias"):
                # 0 in exact arithmetic (the batch norm after each removes
                # it): rounding residue on both sides, below 1e-5 of the
                # largest gradient, as chip_smoke.py's ZERO_GRAD
                assert max(p.grad.abs().max().item(),
                           grads[name][i].abs().max().item()) <= 1e-5 * largest
                continue
            scale = max(p.grad.abs().max().item(), 1e-12)
            err = (grads[name][i] - p.grad).abs().max().item()
            assert err <= TOL_MODEL * scale, (name, err, scale)


# the exported program against session.predict: the JAX package's
# tolerances for its own artifact (tests/test_predict.py), (rtol, atol)
TOL_EXPORT = {None: (1e-6, 1e-7), "int8": (1e-5, 1e-6)}


@pytest.mark.gpu
@pytest.mark.parametrize("quantize", [None, "int8"], ids=["fp32", "int8"])
@pytest.mark.parametrize("attn_type", ["basic", "autoformer"])
def test_export_round_trip_on_card(cuda, tmp_path, attn_type, quantize):
    """export_serving -> load_exported on the card: the loaded program
    equals session.predict and launches the hand kernels (the fused GP; in
    basic, head-folded attention six times) through their registered
    ops."""
    model = ForecastDenoising(
        src_input_size=4, tgt_input_size=4, d_model=32, n_heads=8, d_k=4,
        stack_size=1, pred_len=24, attn_type=attn_type, num_inducing=64,
        gp_ls_init=-1.0, device=cuda,
        generator=torch.Generator().manual_seed(0))
    session = InferenceSession(model, model.state_dict(), batch_size=BATCH,
                               device=cuda, quantize=quantize)
    path = session.export_serving(str(tmp_path / "s.pt2"), 48, 24, 4)
    rng = np.random.default_rng(1)
    enc = rng.normal(size=(BATCH, 48, 4)).astype(np.float32)
    dec = rng.normal(size=(BATCH, 24, 4)).astype(np.float32)
    want = session.predict(enc, dec)
    served = InferenceSession.load_exported(path)
    n0 = (fused_gp.launches, hfa.launches)
    got = served(enc, dec)
    torch.cuda.synchronize()
    assert (fused_gp.launches - n0[0], hfa.launches - n0[1]) == (
        1, 6 if attn_type == "basic" else 0)
    rtol, atol = TOL_EXPORT[quantize]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("k, n", [(1, 32), (4, 32), (32, 1), (32, 32),
                                  (4, 1)])
@pytest.mark.parametrize("rows", [5, 300])
def test_int8_dense_padded_shapes_match_cpu(cuda, k, n, rows):
    """The card's int8 product at the widths it pads (K 1 and 4, N 1, fewer
    than 17 rows) against the CPU's: the same int8 codes, an exact int32
    sum and the same IEEE fp32 dequantization, so equal."""
    from fine_grained_gaussian_process_forcasting_torch.train import (
        quantize as tq,
    )

    rng = np.random.default_rng(k * 100 + n)
    x = torch.from_numpy(rng.normal(size=(rows, 3, k)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32))
    want = tq.int8_dense(x, w, b)
    got = tq.int8_dense(x.to(cuda), w.to(cuda), b.to(cuda))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


def _op_cases(device):
    g = torch.Generator().manual_seed(0)

    def t(*shape):
        return torch.randn(*shape, generator=g).to(device)

    q, k, v = t(2, 8, 40, 4), t(2, 8, 56, 4), t(2, 8, 56, 4)
    fq, fk, fv = (x.bfloat16() for x in (t(2, 4, 80, 64), t(2, 4, 96, 64),
                                         t(2, 4, 96, 64)))
    a = t(3, 40, 40)
    spd = a @ a.transpose(-1, -2) + 40 * torch.eye(40, device=device)
    m, d = 64, 8
    lw = 0.1 * t(m, m)
    gp = (t(2, 30, d), t(m, d) / 4, t(m), (lw @ lw.T).contiguous(),
          torch.tensor(0.9, device=device), torch.full((d,), 0.25,
                                                       device=device),
          t(d) / d, torch.tensor(0.2, device=device))
    return {"fused_gp": (fused_gp.fused_gp_fwd, (*gp, False)),
            "fused_gp_bf16": (fused_gp.fused_gp_fwd, (*gp, True)),
            "head_folded": (hfa.head_folded_attention_fwd, (q, k, v)),
            "flash_bf16": (flash.flash_attention_fwd, (fq, fk, fv, False)),
            "small_head": (sha.small_head_attention_fwd, (q, k, v)),
            "rbf": (rbf.rbf_cross_fwd, (t(2, 30, d), t(3, m, d),
                                        torch.full((3, d), 2.0,
                                                   device=device),
                                        torch.full((3,), 1.3,
                                                   device=device))),
            "cholesky": (cholesky.batched_cholesky_fwd, (spd,))}


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["fused_gp", "fused_gp_bf16", "head_folded",
                                  "flash_bf16", "small_head", "rbf",
                                  "cholesky"])
def test_registered_op_passes_opcheck_on_card(cuda, case):
    """Each kernel's registered op on CUDA tensors: ``opcheck``'s schema,
    fake (the kernel's output shapes, dtypes and strides) and dispatch
    checks."""
    op, args = _op_cases(cuda)[case]
    torch.library.opcheck(op, args)


# the baselines (DLinear, N-BEATS, DeepAR, CMGP; no hand kernel: cuBLAS,
# cuDNN's LSTM and cuSOLVER): forward and gradients on the card against
# the CPU within the fp32 training gate, 1e-3 of each output's largest
# magnitude; CMGP (a Cholesky of an ill-conditioned smooth kernel) against
# float64 on the CPU instead: the card's distance, summed over its outputs
# and gradients, at most twice the fp32 CPU's
TOL_BASELINE = 1e-3


def _baseline(name, device):
    from fine_grained_gaussian_process_forcasting_torch.models import (
        cmgp,
        deepar,
        dlinear,
        nbeats,
    )

    gen = torch.Generator().manual_seed(0)
    L, H = 96, 24
    if name == "DLinear":
        return dlinear.DLinear(L, H, device=device)
    if name == "NBeats":
        return nbeats.NBeats(L, H, hidden_layer_units=64, device=device,
                             generator=gen)
    if name == "DeepAR":
        return deepar.DeepAR(64, 64, 2, device=device, generator=gen)
    return cmgp.CMGP(H, 2, device=device)


def _baseline_run(name, model, x, y, eps):
    """(outputs, loss) of the harness's loss and of a forward."""
    from fine_grained_gaussian_process_forcasting_torch.models.deepar import (
        deepar_nll,
    )

    if name == "DeepAR":
        full = torch.cat([x, y], 1)
        mu, sigma = model(full[:, :-1])
        loss = deepar_nll(mu, sigma, full[:, 1:, 0])
        with torch.no_grad():
            samples = model.sample(x, y.shape[1], 2, eps=eps)
        return [mu, sigma, samples], loss
    if name == "NBeats":
        back, fore = model(x)
        return [back, fore], torch.mean((fore - y[..., 0]) ** 2)
    if name == "CMGP":
        return [model(x)], model.nll(x, y)
    out = model(x)
    return [out], torch.mean((out - y) ** 2)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["DLinear", "NBeats", "DeepAR", "CMGP"])
def test_baselines_match_cpu_on_card(cuda, name):
    rng = np.random.default_rng(3)
    t = np.arange(120) / 24.0
    series = (np.sin(2 * np.pi * t)[None] + rng.normal(size=(32, 120))
              * 0.3).astype(np.float32)
    x_np, y_np = series[:, :96, None], series[:, 96:, None]
    eps_np = rng.normal(size=(2, 24, 32)).astype(np.float32)
    state = _baseline(name, "cpu").state_dict()
    runs = []
    for device, dtype in ((cuda, torch.float32), ("cpu", torch.float32),
                          ("cpu", torch.float64)):
        model = _baseline(name, device)
        model.load_state_dict(state)
        model = model.to(dtype)
        x, y, eps = (torch.from_numpy(a).to(device, dtype)
                     for a in (x_np, y_np, eps_np))
        outs, loss = _baseline_run(name, model, x, y, eps)
        loss.backward()
        runs.append([t.detach().cpu().double() for t in (
            *outs, loss, *(p.grad for p in model.parameters()))])
    card, cpu, f64 = runs

    def dist(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    for t in card:
        assert torch.isfinite(t).all()
    if name == "CMGP":
        d_card = sum(dist(a, b) for a, b in zip(card, f64))
        d_cpu = sum(dist(a, b) for a, b in zip(cpu, f64))
        assert d_card <= 2.0 * d_cpu, (d_card, d_cpu)
    else:
        for i, (a, b) in enumerate(zip(card, cpu)):
            assert dist(a, b) <= TOL_BASELINE, (i, dist(a, b))


@pytest.mark.gpu
def test_export_platforms_card_to_cpu(cuda, tmp_path):
    """An artifact exported on the card with platforms=("cuda", "cpu")
    serves on the card by default and, moved, on the CPU: there equal to
    the CPU session within the fp32 serving gate (1e-3 of the largest
    prediction)."""
    kw = dict(src_input_size=4, tgt_input_size=4, d_model=32, n_heads=8,
              d_k=4, stack_size=1, pred_len=24, attn_type="basic",
              num_inducing=64, gp_ls_init=-1.0)
    model = ForecastDenoising(**kw, device=cuda,
                              generator=torch.Generator().manual_seed(0))
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    session = InferenceSession(model, state, batch_size=BATCH, device=cuda)
    path = session.export_serving(str(tmp_path / "s.pt2"), 48, 24, 4,
                                  platforms=("cuda", "cpu"))
    rng = np.random.default_rng(2)
    enc = rng.normal(size=(BATCH, 48, 4)).astype(np.float32)
    dec = rng.normal(size=(BATCH, 24, 4)).astype(np.float32)
    on_card = InferenceSession.load_exported(path)(enc, dec)
    np.testing.assert_allclose(on_card, session.predict(enc, dec),
                               rtol=1e-6, atol=1e-7)
    cpu = InferenceSession(ForecastDenoising(**kw, device="cpu"), state,
                           batch_size=BATCH, device="cpu")
    want = cpu.predict(enc, dec)
    n0 = fused_gp.launches
    got = InferenceSession.load_exported(path, device="cpu")(enc, dec)
    assert fused_gp.launches == n0  # the ops' CPU bodies
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1e-3, err


# the rest of models/ (FEDformer, the Informer stack, the denoising VAE,
# the batched ARIMA; no hand kernel: cuBLAS, cuFFT and cuDNN): the card
# against the CPU on the same weights and inputs, at the tolerances of the
# CPU tests against JAX (tests/test_torch_fedformer.py,
# tests/test_torch_baselines_rest.py): outputs 1e-5 of their largest
# magnitude; gradients 1e-4 (the whole FEDformer 5e-4), each over the
# larger of its own largest magnitude and 1e-2 of the largest gradient
# (the floor for gradients that are 0 in exact arithmetic); the ARIMA
# forecast after 100 Adam steps 1e-5.  The card's random draws
# (AutoCorrelation's delays, ProbSparse's key samples, the VAE's normals)
# are recorded there and replayed on the CPU.
TOL_REST, TOL_REST_GRAD, TOL_REST_FED_GRAD = 1e-5, 1e-4, 5e-4
REST_GRAD_FLOOR = 1e-2
FED_SMALL = dict(enc_in=3, dec_in=3, c_out=3, seq_len=32, label_len=16,
                 pred_len=8, d_model=16, n_heads=4, d_ff=16, e_layers=2,
                 d_layers=1, moving_avg=(9,), modes=4, wavelet_k=2, L=1)


def _rest_runs(make, run, inputs, cuda):
    """One model's outputs, loss and gradients on the card, then on the CPU
    with the card's weights; ``run(model, tensors, record)`` -> (outputs,
    loss, record), ``record`` the draws the card took (None on the card)."""
    card = make(cuda)
    cpu = make("cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    runs, record = [], None
    for model, device in ((card, cuda), (cpu, "cpu")):
        ts = [torch.from_numpy(a).to(device) for a in inputs]
        outs, loss, record = run(model, ts, record)
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in model.parameters()]
        runs.append(([t.detach().cpu().double() for t in (*outs, loss)],
                     [g.detach().cpu().double() for g in grads]))
    return runs


def _rest_close(runs, tol_grad):
    (outs_g, grads_g), (outs_c, grads_c) = runs
    for i, (a, b) in enumerate(zip(outs_g, outs_c)):
        assert torch.isfinite(a).all()
        err = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        assert err <= TOL_REST, (i, err)
    floor = REST_GRAD_FLOOR * max(float(g.abs().max()) for g in grads_c)
    for i, (a, b) in enumerate(zip(grads_g, grads_c)):
        err = float((a - b).abs().max()) / max(float(b.abs().max()), floor)
        assert err <= tol_grad, (i, err)


@pytest.mark.gpu
@pytest.mark.parametrize("version", ["Fourier", "Wavelets", "Autoformer"])
def test_fedformer_matches_cpu_on_card(cuda, version):
    from fine_grained_gaussian_process_forcasting_torch.models.fedformer import (  # noqa: E501
        FEDformer,
        FEDformerConfig,
    )
    from fine_grained_gaussian_process_forcasting_torch.ops.autocorrelation import (  # noqa: E501
        DelayTape,
    )

    cfg = FEDformerConfig(**FED_SMALL, version=version)
    rng = np.random.default_rng(15)
    inputs = [rng.normal(size=s).astype(np.float32) for s in (
        (3, 32, 3), (3, 32, 4), (3, 24, 3), (3, 24, 4), (3, 8, 3))]

    def run(model, ts, record):
        tape = DelayTape(None if record is None
                         else [d.cpu() for d in record.delays])
        out = model(*ts[:4], delays=tape)
        return [out], torch.mean((out - ts[4]) ** 2), tape

    runs = _rest_runs(lambda d: FEDformer(
        cfg, device=d, generator=torch.Generator().manual_seed(0)), run,
        inputs, cuda)
    _rest_close(runs, TOL_REST_FED_GRAD)


@pytest.mark.gpu
def test_informer_stack_matches_cpu_on_card(cuda):
    from fine_grained_gaussian_process_forcasting_torch import draws
    from fine_grained_gaussian_process_forcasting_torch.models import (
        informer_stack,
    )

    def make(device):
        gen = torch.Generator().manual_seed(0)
        return torch.nn.ModuleDict({
            "encoder": informer_stack.InformerEncoder(
                16, 2, 4, device=device, generator=gen),
            "decoder": informer_stack.InformerDecoderLayer(
                16, 4, device=device, generator=gen)})

    def run(model, ts, record):
        tape = (draws.DrawTape(torch.Generator(device=cuda).manual_seed(3))
                if record is None else
                draws.DrawTape(draws=[d.cpu() for d in record.draws]))
        enc = model["encoder"](ts[0], generator=tape)
        out = model["decoder"](ts[1], enc, generator=tape)
        return [enc, out], torch.mean((out - ts[2]) ** 2), tape

    rng = np.random.default_rng(20)
    inputs = [rng.normal(size=s).astype(np.float32)
              for s in ((2, 24, 16), (2, 8, 16), (2, 8, 16))]
    _rest_close(_rest_runs(make, run, inputs, cuda), TOL_REST_GRAD)


@pytest.mark.gpu
@pytest.mark.parametrize("gp", [True, False], ids=["gp", "plain"])
def test_denoise_vae_matches_cpu_on_card(cuda, gp):
    from fine_grained_gaussian_process_forcasting_torch import draws
    from fine_grained_gaussian_process_forcasting_torch.models.denoise_vae import (  # noqa: E501
        DenoiseVAE,
    )

    def run(model, ts, record):
        tape = (draws.DrawTape(torch.Generator(device=cuda).manual_seed(3))
                if record is None else
                draws.DrawTape(draws=[d.cpu() for d in record.draws]))
        out, kl = model(ts[0], ts[1], generator=tape)
        return [out, kl], torch.mean((out - ts[2]) ** 2) + kl, tape

    rng = np.random.default_rng(27)
    inputs = [rng.normal(size=s).astype(np.float32)
              for s in ((3, 20, 8), (3, 6, 1), (3, 20, 8))]
    _rest_close(_rest_runs(lambda d: DenoiseVAE(
        8, gp=gp, device=d, generator=torch.Generator().manual_seed(0)),
        run, inputs, cuda), TOL_REST_GRAD)


@pytest.mark.gpu
def test_fit_forecast_batch_matches_cpu_on_card(cuda):
    from fine_grained_gaussian_process_forcasting_torch.models import arima

    rng = np.random.default_rng(3)
    x = (10.0 + np.cumsum(rng.normal(size=(4, 120)), 1)).astype(np.float32)
    got = arima.fit_forecast_batch(x, 24, iters=100, device=cuda)
    want = arima.fit_forecast_batch(x, 24, iters=100, device="cpu")
    assert got.shape == (4, 24) and np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= TOL_REST, err


@pytest.mark.gpu
@pytest.mark.parametrize("h,batch,n,m,d", RBF_SHAPES)
def test_rbf_seed_axis_matches_plain_and_single_launches(cuda, h, batch, n,
                                                         m, d):
    """The rbf kernel with the seed axis: 3 seeds' K in one launch, within
    the JAX tolerances of the plain version's seed axis and bit-equal to 3
    launches of one seed (a single GP taking a GP axis of 1); the same
    through the vmap rule, which also takes the plain VJP per seed."""
    per = [_rbf_inputs(h, batch, n, m, d, seed=n + m + s, device=cuda)
           for s in range(3)]
    args = [torch.stack(ts) for ts in zip(*per)]
    if not h:  # the seeded call's GP axis
        args = [args[0]] + [t.unsqueeze(1) for t in args[1:]]
    before = (rbf.launches, rbf.seeds_launches)
    got = rbf.rbf_cross_kernel(*args)
    assert (rbf.launches, rbf.seeds_launches) == (before[0] + 1,
                                                  before[1] + 1)
    torch.testing.assert_close(got, rbf.rbf_cross_kernel_plain(*args),
                               rtol=TOL_RBF, atol=ATOL_RBF)
    for i in range(3):
        single = rbf.rbf_cross_kernel(*per[i])
        assert torch.equal(got[i] if h else got[i, 0], single)
    leaves = [torch.stack(ts).requires_grad_() for ts in zip(*per)]
    before = rbf.launches
    k = torch.func.vmap(rbf.rbf_cross_kernel)(*leaves)
    assert rbf.launches == before + 1
    cot = torch.randn(k.shape, device=cuda,
                      generator=torch.Generator(cuda).manual_seed(n))
    k.backward(cot)
    for i in range(3):
        one = [t.detach().requires_grad_() for t in per[i]]
        k1 = rbf.rbf_cross_kernel(*one)
        k1.backward(cot[i])
        assert torch.equal(k[i], k1)
        for leaf, single in zip(leaves, one):
            torch.testing.assert_close(leaf.grad[i], single.grad,
                                       rtol=TOL_RBF_GRAD, atol=ATOL_RBF_GRAD)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["cholesky", "small_head"])
def test_cholesky_and_small_head_folds_bit_equal_to_single_seed_calls(
        cuda, kernel):
    """The Cholesky's and small-head attention's vmap rules fold the seeds
    into the batch: one launch (each way, for small-head) for 3 seeds, each
    seed's output and gradients equal to its own call's bit for bit (the
    Cholesky's gradient is its plain pullback: within TOL_CHOL)."""
    gen = torch.Generator(cuda).manual_seed(5)
    if kernel == "cholesky":
        fn, module = cholesky.batched_cholesky, cholesky
        ins = [torch.stack([_spd(4, 40, s, cuda) for s in range(3)])]
    else:
        fn, module = sha.small_head_attention, sha
        ins = [torch.randn(3, 4, 8, 96, 4, device=cuda, generator=gen)
               for _ in range(3)]
    leaves = [t.detach().requires_grad_() for t in ins]
    before = module.launches
    out = torch.func.vmap(fn)(*leaves)
    assert module.launches == before + 1
    cot = torch.randn(out.shape, device=cuda, generator=gen)
    out.backward(cot)
    for i in range(3):
        one = [t[i].detach().requires_grad_() for t in ins]
        o = fn(*one)
        o.backward(cot[i])
        assert torch.equal(out[i], o)
        for t, single in zip(leaves, one):
            if kernel == "cholesky":
                torch.testing.assert_close(t.grad[i], single.grad,
                                           rtol=TOL_CHOL, atol=TOL_CHOL)
            else:
                assert torch.equal(t.grad[i], single.grad)


@pytest.mark.gpu
@pytest.mark.parametrize("option", ["exact", "exact_pallas", "hidden_layers",
                                    "lstm", "informer"])
def test_multiseed_option_step_matches_single_seed_steps(cuda, option):
    """One MultiSeedTrainer step for 3 seeds of the options lifted onto the
    seed axis against 3 Trainer steps on the card: each seed's loss and
    gradients within TOL_MODEL of each gradient's largest magnitude (each
    seed's eps and key samples from its own generator; behind hidden
    layers the output layer's q(u) within 1e-3); the rbf and Cholesky
    kernels once a call for all seeds."""
    from fine_grained_gaussian_process_forcasting_torch.train.multiseed import (
        MultiSeedTrainer,
    )

    kw = {"exact": dict(gp_kind="exact", exact_noise_init=0.1),
          "exact_pallas": dict(gp_kind="exact", exact_noise_init=0.1),
          "hidden_layers": dict(gp_hidden_dims=(4,), use_pallas_gp=True),
          "lstm": dict(backbone="lstm"),
          "informer": dict(attn_type="informer")}[option]

    def model(seed):
        m = ForecastDenoising(
            **{"src_input_size": 4, "tgt_input_size": 4, "d_model": 32,
               "n_heads": 8, "d_k": 4, "stack_size": 1, "pred_len": 24,
               "attn_type": "autoformer", "num_inducing": 64,
               "gp_ls_init": -1.0, "device": cuda,
               "generator": torch.Generator().manual_seed(seed), **kw})
        if option == "exact_pallas":
            m.deep_gp.use_pallas = True
        return m

    rng = np.random.default_rng(0)
    batch = tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                   ).to(cuda)
                  for shape in ((16, 48, 4), (16, 24, 4), (16, 24, 1)))
    seeds = (3, 4, 5)
    trainer = MultiSeedTrainer(model(0), 32, 3, warmup_steps=100,
                               device=cuda)
    state = trainer.init_state(seeds, lambda s: model(s).state_dict())
    n0 = (rbf.seeds_launches, cholesky.launches)
    losses, grads = trainer.gradients(state, batch)
    assert rbf.seeds_launches - n0[0] == (option == "hidden_layers")
    # three factorizations, each a jitter probe and the factor
    assert cholesky.launches - n0[1] == (6 if option == "exact_pallas"
                                         else 0)
    # behind hidden layers, the output layer's L^-1 (Kzz + 1e-4 I, its
    # condition up to ~1e4) turns the rounding of the rest of the vmapped
    # step's batched products into ~3e-4 of its q(u) gradients (its own
    # factorization and products run a call a seed: seedwise.py); those are
    # held to chip_smoke.py's vmapped-vs-single tolerance, 1e-3
    tol = {f"deep_gp.output_layer.{n}": 1e-3 for n in (
        "inducing_points", "raw_lengthscale", "raw_outputscale",
        "variational_log_stddev")} if option == "hidden_layers" else {}
    for i, s in enumerate(seeds):
        single = Trainer(model(s), 32, warmup_steps=100, device=cuda)
        single.init_state(seed=s)
        params = {k: v.detach().clone()
                  for k, v in single.model.state_dict().items()}
        drawn = single.model.noise_draws(16, 48, 24, True, single.generator,
                                         cuda)
        out = single.model(*batch, training=True, **drawn)
        out.loss.backward()
        np.testing.assert_allclose(losses[i].item(), out.loss.item(),
                                   rtol=TOL_MODEL)
        over = {}
        for name, p in single.model.named_parameters():
            scale = max(p.grad.abs().max().item(), 1e-12)
            err = (grads[name][i] - p.grad).abs().max().item()
            if err > tol.get(name, TOL_MODEL) * scale:
                over[name] = err / scale
        assert not over, over


# Wavelets' step reproducible (ROADMAP.md section 3): the circular
# convolutions' backward (models/embedding.py) is two GEMMs and a sum over
# the taps in a fixed order, where cuDNN's default weight gradient adds
# with atomics; at run.py's defaults (the smoke's FEDformer phase) two
# steps from the same weights are bit-equal
FED_RUN_PY = dict(enc_in=7, dec_in=7, c_out=7, seq_len=96, label_len=48,
                  pred_len=96, d_model=512, n_heads=8, d_ff=2048,
                  e_layers=2, d_layers=1, moving_avg=(24,), modes=64, L=3)


@pytest.mark.gpu
def test_wavelets_step_is_bit_equal_on_card(cuda):
    from fine_grained_gaussian_process_forcasting_torch.models.fedformer import (  # noqa: E501
        FEDformer,
        FEDformerConfig,
    )

    cfg = FEDformerConfig(**FED_RUN_PY, version="Wavelets")
    model = FEDformer(cfg, device=cuda,
                      generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    *inputs, y = (torch.from_numpy(rng.normal(size=s).astype(
        np.float32)).to(cuda) for s in (
        (32, 96, 7), (32, 96, 4), (32, 144, 7), (32, 144, 4), (32, 96, 7)))
    runs = []
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        torch.mean((model(*inputs) - y) ** 2).backward()
        runs.append({n: p.grad.clone() for n, p in model.named_parameters()
                     if p.grad is not None})
    assert [k for k in runs[0] if not torch.equal(runs[0][k], runs[1][k])
            ] == []


@pytest.mark.gpu
@pytest.mark.parametrize("pad,bias", [(1, False), (2, True)])
def test_circular_conv_backward_matches_cpu_on_card(cuda, pad, bias):
    """The fixed-order backward against the CPU's convolution (the JAX
    package's CPU-test tolerance for the embeddings, 1e-5), reruns bit-equal,
    at the token convolution's shapes."""
    from fine_grained_gaussian_process_forcasting_torch.models.embedding import (  # noqa: E501
        CircularConv1d,
    )

    conv = CircularConv1d(7, 512, pad, bias, device=cuda,
                          generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(32, 96, 7)).astype(np.float32))
    g = torch.from_numpy(np.random.default_rng(2).normal(
        size=(32, 96 + 2 * pad - 2, 512)).astype(np.float32))
    runs = []
    for module, device in ((conv, cuda), (conv, cuda),
                           (copy.deepcopy(conv).cpu(), "cpu")):
        xi = x.to(device).requires_grad_()
        module.zero_grad(set_to_none=True)
        module(xi).backward(g.to(device))
        runs.append([t.detach().cpu() for t in (
            xi.grad, module.weight.grad,
            *([module.bias.grad] if bias else []))])
    for a, b, c in zip(*runs):
        assert torch.equal(a, b)
        assert float((a - c).abs().max() / c.abs().max()) <= 1e-5


@pytest.mark.gpu
def test_data_parallel_step_matches_one_process_on_card(cuda, tmp_path):
    """Two ranks of an n_data 2 mesh on cuda:0 over gloo: the step's loss
    and gathered gradients equal the one-process card step (1e-4 of each
    gradient's largest magnitude: the batch's sums split in two), and the
    fused GP and head-folded kernels launch in each rank, forward and
    backward."""
    import socket

    import _torch_parallel_worker as worker
    from fine_grained_gaussian_process_forcasting_torch.data.window import (
        BatchedSplit,
    )

    trainer = Trainer(worker.option_model("basic").to(cuda),
                      d_model=worker.CFG["d_model"], warmup_steps=10,
                      device="cuda")
    state = trainer.init_state(seed=0)
    data = trainer.device_put_split(BatchedSplit(*worker.batches()))
    want_loss, want = trainer.gradients(state, tuple(t[0] for t in data))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=worker.card_rank,
                         args=(r, 2, port, str(tmp_path))) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
        if p.is_alive():
            p.terminate()
    assert [p.exitcode for p in procs] == [0, 0]
    for r in range(2):
        got = torch.load(tmp_path / f"card{r}.pt", weights_only=False)
        assert got["backend"] == "gloo"
        assert abs(got["loss"] - float(want_loss)) <= 1e-5 * abs(
            float(want_loss))
        for name, g in want.items():
            err = float((got["grads"][name] - g.cpu()).abs().max())
            assert err <= 1e-4 * max(float(g.abs().max()), 1e-30), name
        assert got["launches"]["fused_gp"][0] > 0
        assert got["launches"]["fused_gp"][1] > 0
        assert got["launches"]["head_folded_attention"] == (6, 6)
