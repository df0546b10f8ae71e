"""The fused GP's split arithmetic, emulated on the CPU.

On the card every fp32 product of the fused GP runs on bf16 tensor cores
(``csrc/fused_gp.cu``, the `wgmma` engine): each fp32 operand v is carried
as three bf16 parts p0 = bf16(v), p1 = bf16(v - p0), p2 = bf16(v - p0 - p1),
and a product as the part products p_i q_j with i + j < 3 (six products)
summed in fp32.

- The bf16 backward runs so the reference's three fp32 products -- the
  distance's cross term xs zs^T, E zs and E^T xs; K enters K W as bf16(K)
  and E in fp32, and dW takes bf16(K) and bf16(dvar o K), as the reference
  does (``_split_bwd``).
- The fp32 backward runs so every product: the cross term, K W (K and W
  in three parts each), E zs, E^T xs and dW = -K^T (dvar o K); the fp32
  forward its cross term, and K W as one fp32 FFMA chain an element in the
  plain version's order, which an fp32 matmul stands for here
  (``_split_fp32``).
- The bf16 forward runs so its cross term, and K W on bf16(K) and bf16(W)
  summed in fp32, as the reference does (``_split_bf16_fwd``).

The functions below repeat that arithmetic in plain PyTorch (bf16 products
of bf16 values are exact in fp32, so an fp32 matmul of them is the tensor
cores' product up to the order of the sum), and the tests hold them to the
budgets the card runs are held to: for every output, its distance from a
float64 evaluation of the function (bf16: the fp32 function, and the bf16
function rounded at the same places) is no more than twice the plain
version's, summed over draws of the inputs.
"""

import math

import numpy as np
import pytest
import torch

from fine_grained_gaussian_process_forcasting_torch.ops.cuda import fused_gp

NAMES = ("dx", "dzs", "du", "dW", "dos", "dinv_ls", "dmean_w", "dmean_b")
PARTS = 3
ROWS, DRAWS = 512, 16


def _hi(t):
    return t.bfloat16().float()


def _parts(t, n):
    out = []
    for _ in range(n):
        out.append(_hi(t - sum(out)) if out else _hi(t))
    return out


def _dot(a, b, n=PARTS):
    """a @ b on n bf16 parts of each operand: the products a_i b_j with
    i + j < n."""
    ap, bp = _parts(a, n), _parts(b, n)
    return sum(ap[i] @ bp[j] for i in range(n) for j in range(n - i))


def _split_bwd(x, zs, u, w, outputscale, inv_ls, mean_w, mean_b, dmean,
               dvar):
    b, n, d = x.shape
    xr = x.reshape(-1, d)
    xs = xr * inv_ls
    x2 = (xs * xs).sum(-1, keepdim=True)
    z2 = (zs * zs).sum(-1)
    k = outputscale * torch.exp(-0.5 * (x2 + z2 - 2.0 * _dot(xs, zs.T)))
    kh = _hi(k)
    g = kh @ _hi(w)
    dm = dmean.reshape(-1, 1)
    dv = dvar.reshape(-1, 1)
    e = (dm * u - 2.0 * dv * g) * k
    dxsc = _dot(e, zs) - e.sum(-1, keepdim=True) * xs
    dx = dxsc * inv_ls + dm * mean_w
    dzs = _dot(e.T, xs) - e.sum(0)[:, None] * zs
    du = (k * dm).sum(0)
    dw = -(kh.T @ _hi(dv * k))
    dos = e.sum() / outputscale + dv.sum()
    return (dx.reshape(b, n, d), dzs, du, dw, dos, (dxsc * xr).sum(0),
            (dm * xr).sum(0), dm.sum())


def _split_fp32(x, zs, u, w, outputscale, inv_ls, mean_w, mean_b, dmean,
                dvar):
    """The fp32 forward's (mean, var) and the fp32 backward's eight
    gradients, every product on three bf16 parts of each operand but the
    forward's K W, which stays fp32."""
    b, n, d = x.shape
    xr = x.reshape(-1, d)
    xs = xr * inv_ls
    x2 = (xs * xs).sum(-1, keepdim=True)
    z2 = (zs * zs).sum(-1)
    k = outputscale * torch.exp(-0.5 * (x2 + z2 - 2.0 * _dot(xs, zs.T)))
    g = _dot(k, w)
    mean = xr @ mean_w + mean_b + k @ u
    var = outputscale - ((k @ w) * k).sum(-1)
    dm = dmean.reshape(-1, 1)
    dv = dvar.reshape(-1, 1)
    e = (dm * u - 2.0 * dv * g) * k
    dxsc = _dot(e, zs) - e.sum(-1, keepdim=True) * xs
    dx = dxsc * inv_ls + dm * mean_w
    dzs = _dot(e.T, xs) - e.sum(0)[:, None] * zs
    du = (k * dm).sum(0)
    dw = -_dot(k.T, dv * k)
    dos = e.sum() / outputscale + dv.sum()
    return ((mean.reshape(b, n), var.reshape(b, n)),
            (dx.reshape(b, n, d), dzs, du, dw, dos, (dxsc * xr).sum(0),
             (dm * xr).sum(0), dm.sum()))


def _split_bf16_fwd(x, zs, u, w, outputscale, inv_ls, mean_w, mean_b):
    """The bf16 forward's (mean, var): the cross term on three bf16 parts of
    each operand, K W from bf16(K) and bf16(W) summed in fp32, met with K in
    fp32."""
    b, n, d = x.shape
    xr = x.reshape(-1, d)
    xs = xr * inv_ls
    x2 = (xs * xs).sum(-1, keepdim=True)
    z2 = (zs * zs).sum(-1)
    k = outputscale * torch.exp(-0.5 * (x2 + z2 - 2.0 * _dot(xs, zs.T)))
    mean = xr @ mean_w + mean_b + k @ u
    var = outputscale - ((_hi(k) @ _hi(w)) * k).sum(-1)
    return mean.reshape(b, n), var.reshape(b, n)


def _inputs(rows, d, m, affine, seed):
    """The smoke's fused-GP inputs, from numpy: raw x ~ N(0, 1) and
    lengthscale sqrt(2 d) (so that xs = x / sqrt(2 d) and K is far from 0);
    W and u from the fp32 Cholesky factor of the inducing points' Gram
    matrix with 1e-4 jitter, where W reaches ~100, as on the card.  Not
    affine: the pre-scaled xs, inv_ls 1, mean_w 0, mean_b 0."""
    rng = np.random.default_rng(seed)
    ls = math.sqrt(2.0 * d)
    x = torch.from_numpy(rng.normal(size=(1, rows, d)).astype(np.float32))
    zs = torch.from_numpy((rng.normal(size=(m, d)) / ls).astype(np.float32))
    kzz = math.log(2.0) * torch.exp(-0.5 * torch.cdist(zs, zs) ** 2)
    chol = torch.linalg.cholesky(kzz + 1e-4 * torch.eye(m))
    li = torch.linalg.solve_triangular(chol, torch.eye(m), upper=False)
    u = li.T @ torch.from_numpy((0.3 * rng.normal(size=m)).astype(np.float32))
    s2 = torch.from_numpy(rng.uniform(size=m).astype(np.float32))
    w = li.T @ (li * (1.0 - s2)[:, None])
    os_ = torch.tensor(math.log(2.0))
    if affine:
        inv_ls = torch.full((d,), 1.0 / ls)
        mean_w = torch.from_numpy((rng.normal(size=d) / d).astype(np.float32))
        mean_b = torch.tensor(0.1)
    else:
        x = x / ls
        inv_ls, mean_w, mean_b = torch.ones(d), torch.zeros(d), torch.tensor(0.0)
    cot = tuple(torch.from_numpy(rng.normal(size=(1, rows)).astype(np.float32))
                for _ in range(2))
    return (x.contiguous(), zs, u.contiguous(), w.contiguous(), os_, inv_ls,
            mean_w, mean_b), cot


@pytest.mark.parametrize("d,m,affine", [(512, 512, True), (512, 512, False),
                                        (32, 512, True), (32, 512, False)],
                         ids=["prod_basic", "prod_basic_nonaffine",
                              "flagship_width", "flagship_width_nonaffine"])
def test_split_arithmetic_meets_the_float64_budget(d, m, affine):
    """Distances summed over DRAWS draws of the inputs: from the bf16
    function, each version's distance comes mostly from the elements where
    its K and the float64 K round to different bf16 values, a set of its
    own, so that one draw compares two nearly independent errors."""
    dist = {(bf16, name): [0.0, 0.0] for bf16 in (False, True)
            for name in NAMES}
    for i in range(DRAWS):
        args, cot = _inputs(ROWS, d, m, affine, seed=1000 * i + d + affine)
        got = _split_bwd(*args, *cot)
        plain = fused_gp.whitened_marginals_affine_bwd_plain(*args, *cot,
                                                             bf16=True)
        for name, g, p in zip(NAMES, got, plain):
            # within the smoke's bf16 tolerance of the plain version
            scale = max(1.0, p.abs().max().item())
            assert (g - p).abs().max().item() <= 2.0 ** -7 * scale, name
        wide = [a.double() for a in args + cot]
        for bf16 in (False, True):
            exact = fused_gp.whitened_marginals_affine_bwd_plain(*wide,
                                                                 bf16=bf16)
            for name, g, p, e in zip(NAMES, got, plain, exact):
                dist[bf16, name][0] += (g.double() - e).abs().max().item()
                dist[bf16, name][1] += (p.double() - e).abs().max().item()
    for key, (split, plain) in dist.items():
        assert split <= 2.0 * plain, (key, split, plain)


@pytest.mark.parametrize("d,m,affine", [(512, 512, True), (512, 512, False),
                                        (32, 512, True), (32, 512, False)],
                         ids=["d512", "d512_nonaffine", "flagship_width",
                              "flagship_width_nonaffine"])
def test_fp32_split_arithmetic_meets_the_float64_budget(d, m, affine):
    """The fp32 forward and backward as the card splits their products'
    operands: each output within 1e-3 of max(1, its largest magnitude) of
    the plain version (the smoke's backward tolerance; at these inputs the
    CPU's plain fp32 variance itself lies up to 1.6e-4 from float64, so the
    card's 1e-4 for the forward is no yardstick here; dos, a sum of R M
    terms that nearly cancel, within 10x that, as the smoke's non-affine
    check allows it) and, summed over DRAWS draws, no farther from the
    float64 function than twice the plain fp32 version."""
    fwd_names = ("mean", "var")
    dist = {name: [0.0, 0.0] for name in fwd_names + NAMES}
    for i in range(DRAWS):
        args, cot = _inputs(ROWS, d, m, affine, seed=1000 * i + d + affine + 7)
        fwd, bwd = _split_fp32(*args, *cot)
        plain = (fused_gp.whitened_marginals_affine_plain(*args)
                 + fused_gp.whitened_marginals_affine_bwd_plain(*args, *cot))
        wide = [a.double() for a in args + cot]
        exact = (fused_gp.whitened_marginals_affine_plain(*wide[:8])
                 + fused_gp.whitened_marginals_affine_bwd_plain(*wide))
        for name, g, p, e in zip(fwd_names + NAMES, fwd + bwd, plain, exact):
            tol = (10.0 if name == "dos" else 1.0) * 1e-3 * max(
                1.0, p.abs().max().item())
            assert (g - p).abs().max().item() <= tol, name
            dist[name][0] += (g.double() - e).abs().max().item()
            dist[name][1] += (p.double() - e).abs().max().item()
    for name, (split, plain) in dist.items():
        assert split <= 2.0 * plain, (name, split, plain)


@pytest.mark.parametrize("d,m,affine", [(512, 512, True), (512, 512, False),
                                        (32, 512, True), (32, 512, False)],
                         ids=["d512", "d512_nonaffine", "flagship_width",
                              "flagship_width_nonaffine"])
def test_bf16_fwd_split_arithmetic_meets_the_float64_budget(d, m, affine):
    """The bf16 forward as the card splits its cross term's operands: mean
    within 1e-4 of the plain bf16 version and var within 2^-7 of max(1, its
    largest magnitude) (the smoke's tolerances), and, summed over DRAWS
    draws, each no farther than twice the plain bf16 version from the fp32
    function in float64 and from the bf16 function in float64 (K and W
    rounded to bf16 where they enter K W, the products exact)."""
    names = ("mean", "var")
    dist = {(bf16, name): [0.0, 0.0] for bf16 in (False, True)
            for name in names}
    for i in range(DRAWS):
        args, _ = _inputs(ROWS, d, m, affine, seed=1000 * i + d + affine + 11)
        got = _split_bf16_fwd(*args)
        plain = fused_gp.whitened_marginals_affine_plain(*args, bf16=True)
        assert (got[0] - plain[0]).abs().max().item() <= 1e-4
        scale = max(1.0, plain[1].abs().max().item())
        assert (got[1] - plain[1]).abs().max().item() <= 2.0 ** -7 * scale
        wide = [a.double() for a in args]
        for bf16 in (False, True):
            exact = fused_gp.whitened_marginals_affine_plain(*wide, bf16=bf16)
            for name, g, p, e in zip(names, got, plain, exact):
                dist[bf16, name][0] += (g.double() - e).abs().max().item()
                dist[bf16, name][1] += (p.double() - e).abs().max().item()
    for key, (split, plain) in dist.items():
        assert split <= 2.0 * plain, (key, split, plain)


def test_bwd_design_by_m():
    """One design a variant at every M: both on `wgmma`, the fp32 one with
    K and E split into their parts on the way into shared memory."""
    for m in (7, 512, 720, 721, 2048):
        assert fused_gp.bwd_design(m, bf16=True) == "wgmma"
        assert fused_gp.bwd_design(m) == "wgmma-split"
