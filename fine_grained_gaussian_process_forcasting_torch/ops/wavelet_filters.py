"""Alpert multiwavelet filter banks (host-side precompute).

Independent implementation of the filter construction the reference pulls
from ``layers/utils_fed.py:11-193`` (Legendre/Chebyshev scaling functions
phi, piecewise wavelets psi via Gram-Schmidt, and the two-scale filters
H0/H1/G0/G1).  Built with numpy polynomial algebra and Gauss quadrature
instead of sympy root-finding.

The wavelets are piecewise polynomials: psi_i = psi1_i on [0,1/2) and
psi2_i on [1/2,1].  All inner products are exact piecewise-polynomial
integrals: Legendre uses Gauss-Legendre quadrature on each half-interval
(exact for the polynomial degrees involved); Chebyshev follows the
reference's own scheme — a single Chebyshev-node rule on [0,1] with
support masks (the published construction's approximation).

Filter definitions (two-scale relations):
- H0[i,j] = 1/sqrt(2) <phi_i(x/2),     phi_j(x)>
  H1[i,j] = 1/sqrt(2) <phi_i((x+1)/2), phi_j(x)>
  G0[i,j] = 1/sqrt(2) <psi_i(x/2),     phi_j(x)>   (x/2 hits piece 1)
  G1[i,j] = 1/sqrt(2) <psi_i((x+1)/2), phi_j(x)>   ((x+1)/2 hits piece 2)

The port's own copy of the JAX package's ``ops/wavelet_filters.py``, line
for line (numpy only), so the filters are the same bits.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

import numpy as np
from numpy.polynomial import Polynomial, chebyshev, legendre


def _shifted_legendre(i: int) -> Polynomial:
    """sqrt(2i+1) * P_i(2x - 1): orthonormal on [0,1]."""
    coeffs = np.zeros(i + 1)
    coeffs[i] = 1.0
    p = legendre.Legendre(coeffs).convert(kind=Polynomial)
    return np.sqrt(2 * i + 1) * p(Polynomial([-1.0, 2.0]))


def _shifted_chebyshev(i: int) -> Polynomial:
    """Chebyshev scaling function on [0,1] with the standard norms."""
    coeffs = np.zeros(i + 1)
    coeffs[i] = 1.0
    p = chebyshev.Chebyshev(coeffs).convert(kind=Polynomial)
    norm = np.sqrt(2.0 / np.pi) if i == 0 else 2.0 / np.sqrt(np.pi)
    return norm * p(Polynomial([-1.0, 2.0]))


def _gauss(a: float, b: float, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre nodes/weights on [a, b]."""
    t, w = np.polynomial.legendre.leggauss(n)
    return a + (t + 1.0) * (b - a) / 2.0, w * (b - a) / 2.0


def _compress(p: Polynomial, tol: float = 1e-8) -> Polynomial:
    c = p.coef.copy()
    c[np.abs(c) < tol] = 0.0
    return Polynomial(c)


def _legendre_psis(k: int) -> Tuple[List[Polynomial], List[Polynomial]]:
    """Gram-Schmidt construction of the piecewise wavelets (Legendre)."""
    phis = [_shifted_legendre(i) for i in range(k)]
    xl, wl = _gauss(0.0, 0.5, 2 * k + 2)
    xu, wu = _gauss(0.5, 1.0, 2 * k + 2)

    def ip_lower(p: Polynomial, q: Polynomial) -> float:
        return float(np.sum(wl * p(xl) * q(xl)))

    def ip_upper(p: Polynomial, q: Polynomial) -> float:
        return float(np.sum(wu * p(xu) * q(xu)))

    psi1: List[Polynomial] = []
    psi2: List[Polynomial] = []
    for i in range(k):
        # phi-tilde_i = sqrt(2) phi_i(2x), supported on [0, 1/2]: piece 1
        # starts from its polynomial, piece 2 from zero (outside support).
        tilde = np.sqrt(2) * phis[i](Polynomial([0.0, 2.0]))
        p1 = Polynomial(tilde.coef.copy())
        p2 = Polynomial([0.0])
        # <phi-tilde_i, phi_j> integrates over [0,1/2] only (support)
        for j in range(k):
            proj = ip_lower(tilde, phis[j])
            p1 = p1 - proj * phis[j]
            p2 = p2 - proj * phis[j]
        # <phi-tilde_i, psi_j> also lives on [0,1/2] (psi piece 1)
        for j in range(i):
            proj = ip_lower(tilde, psi1[j])
            p1 = p1 - proj * psi1[j]
            p2 = p2 - proj * psi2[j]
        # second Gram-Schmidt pass: classical GS loses ~1 digit per basis
        # vector at k=8 (the reference's one-pass coefficient-convolution
        # construction ends up with O(1) reconstruction error there —
        # measured 2.75 at k=8 vs 5e-14 here); re-orthogonalizing the
        # residual restores orthogonality to machine precision.
        for j in range(k):
            proj = ip_lower(p1, phis[j]) + ip_upper(p2, phis[j])
            p1 = p1 - proj * phis[j]
            p2 = p2 - proj * phis[j]
        for j in range(i):
            proj = ip_lower(p1, psi1[j]) + ip_upper(p2, psi2[j])
            p1 = p1 - proj * psi1[j]
            p2 = p2 - proj * psi2[j]
        norm = np.sqrt(ip_lower(p1, p1) + ip_upper(p2, p2))
        if norm > 1e-12:
            p1, p2 = p1 / norm, p2 / norm
        psi1.append(_compress(p1))
        psi2.append(_compress(p2))
    return psi1, psi2


def _chebyshev_psis(k: int):
    """Reference-scheme construction (masked Chebyshev-node quadrature)."""
    phis = [_shifted_chebyshev(i) for i in range(k)]
    n = 2 * k
    j = np.arange(n)
    xm = (np.cos(np.pi * (2 * j + 1) / (2 * n)) + 1.0) / 2.0
    wm = np.pi / n / 2.0

    mask_l = (xm <= 0.5 + 1e-16).astype(np.float64)
    mask_u = 1.0 - (xm < 0.5 + 1e-16).astype(np.float64)

    psi1: List[Polynomial] = []
    psi2: List[Polynomial] = []
    for i in range(k):
        tilde = np.sqrt(2) * phis[i](Polynomial([0.0, 2.0]))
        p1 = Polynomial(tilde.coef.copy())
        p2 = Polynomial([0.0])  # outside phi-tilde's support
        tilde_vals = tilde(xm) * mask_l  # supported on [0, 1/2]
        for jj in range(k):
            proj = float(np.sum(wm * phis[jj](xm) * tilde_vals))
            p1 = p1 - proj * phis[jj]
            p2 = p2 - proj * phis[jj]
        for jj in range(i):
            pj_vals = psi1[jj](xm) * mask_l + psi2[jj](xm) * 0.0
            proj = float(np.sum(wm * pj_vals * tilde_vals))
            p1 = p1 - proj * psi1[jj]
            p2 = p2 - proj * psi2[jj]
        norm1 = float(np.sum(wm * (p1(xm) * mask_l) ** 2))
        norm2 = float(np.sum(wm * (p2(xm) * mask_u) ** 2))
        norm = np.sqrt(norm1 + norm2)
        if norm > 1e-12:
            p1, p2 = p1 / norm, p2 / norm
        psi1.append(_compress(p1))
        psi2.append(_compress(p2))
    return phis, psi1, psi2, xm, wm, mask_l, mask_u


@lru_cache(maxsize=None)
def filter_bank(base: str, k: int):
    """(H0, H1, G0, G1, PHI0, PHI1) each (k, k) float64."""
    if base not in ("legendre", "chebyshev"):
        raise ValueError(f"base {base!r} not supported")

    H0 = np.zeros((k, k)); H1 = np.zeros((k, k))
    G0 = np.zeros((k, k)); G1 = np.zeros((k, k))
    s = 1.0 / np.sqrt(2.0)

    if base == "legendre":
        phis = [_shifted_legendre(i) for i in range(k)]
        psi1, psi2 = _legendre_psis(k)
        xq, wq = _gauss(0.0, 1.0, 2 * k + 2)
        phi_vals = np.stack([p(xq) for p in phis])
        for i in range(k):
            for j in range(k):
                H0[i, j] = s * np.sum(wq * phis[i](xq / 2) * phi_vals[j])
                H1[i, j] = s * np.sum(wq * phis[i]((xq + 1) / 2) * phi_vals[j])
                G0[i, j] = s * np.sum(wq * psi1[i](xq / 2) * phi_vals[j])
                G1[i, j] = s * np.sum(wq * psi2[i]((xq + 1) / 2) * phi_vals[j])
        PHI0 = np.eye(k)
        PHI1 = np.eye(k)
    else:
        phis, psi1, psi2, xm, wm, mask_l, mask_u = _chebyshev_psis(k)
        phi_vals = np.stack([p(xm) for p in phis])
        for i in range(k):
            for j in range(k):
                H0[i, j] = s * np.sum(wm * phis[i](xm / 2) * phi_vals[j])
                H1[i, j] = s * np.sum(wm * phis[i]((xm + 1) / 2) * phi_vals[j])
                # x/2 <= 1/2: psi piece 1;  (x+1)/2 >= 1/2: piece 2
                G0[i, j] = s * np.sum(wm * psi1[i](xm / 2) * phi_vals[j])
                G1[i, j] = s * np.sum(wm * psi2[i]((xm + 1) / 2) * phi_vals[j])
        PHI0 = np.zeros((k, k))
        PHI1 = np.zeros((k, k))
        # phi has support [0,1]: phi(2x) lives on x<=1/2, phi(2x-1) on x>=1/2
        phi_2x = np.stack([p(2 * xm) * mask_l for p in phis])
        phi_2xm1 = np.stack([p(2 * xm - 1) * mask_u for p in phis])
        for i in range(k):
            for j in range(k):
                PHI0[i, j] = 2.0 * np.sum(wm * phi_2x[i] * phi_2x[j])
                PHI1[i, j] = 2.0 * np.sum(wm * phi_2xm1[i] * phi_2xm1[j])
        PHI0[np.abs(PHI0) < 1e-8] = 0
        PHI1[np.abs(PHI1) < 1e-8] = 0

    for m in (H0, H1, G0, G1):
        m[np.abs(m) < 1e-8] = 0.0
    return H0, H1, G0, G1, PHI0, PHI1
