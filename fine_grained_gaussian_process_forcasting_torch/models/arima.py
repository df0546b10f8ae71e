"""ARIMA(1,1,1), without statsmodels.

Counterpart of the JAX package's ``models/arima.py``.  The differenced
series follows ARMA(1,1):

    w_t = c + phi * w_{t-1} + theta * eps_{t-1} + eps_t

``fit_arima_111`` and ``forecast_arima_111`` fit one window by conditional
sum of squares (CSS) with scipy's L-BFGS-B and iterate the recursion, in
numpy float64: the JAX package's own lines, so the same bits.
``fit_forecast_batch`` is the device path: all windows at once in fp32,
Adam on the summed CSS loss (``torch.optim.Adam``, whose defaults are
optax's), phi and theta clipped to +-0.99 after each step.  The recursion
runs as a loop over time, as JAX's ``lax.scan`` runs it, and so does its
gradient, the adjoint recursion backwards in time (what autodiff of the scan
computes), written out so that a step costs two element-wise launches each
way and no autograd node; only the ``w_t - c - phi * w_{t-1}`` part, which
reads no earlier residual, is taken for all t at once (the same arithmetic
element by element).  No hand kernel: JAX computes it in XLA.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from scipy.optimize import minimize

from fine_grained_gaussian_process_forcasting_torch.device import resolve_device


def _css_residuals(params: np.ndarray, w: np.ndarray) -> np.ndarray:
    c, phi, theta = params
    eps = np.zeros_like(w)
    prev_w, prev_eps = 0.0, 0.0
    for t in range(len(w)):
        eps[t] = w[t] - c - phi * prev_w - theta * prev_eps
        prev_w, prev_eps = w[t], eps[t]
    return eps


def fit_arima_111(y: np.ndarray) -> Tuple[float, float, float]:
    """CSS fit of ARIMA(1,1,1) on a 1-D series; returns (c, phi, theta)."""
    w = np.diff(y.astype(np.float64))

    def loss(p):
        eps = _css_residuals(p, w)
        return float(np.sum(eps * eps))

    res = minimize(
        loss,
        x0=np.array([0.0, 0.1, 0.1]),
        method="L-BFGS-B",
        bounds=[(-10, 10), (-0.99, 0.99), (-0.99, 0.99)],
    )
    return tuple(res.x)


def forecast_arima_111(y: np.ndarray, steps: int) -> np.ndarray:
    """Fit on y, then forecast ``steps`` ahead."""
    c, phi, theta = fit_arima_111(y)
    w = np.diff(y.astype(np.float64))
    eps = _css_residuals(np.array([c, phi, theta]), w)
    last_w, last_eps = w[-1], eps[-1]
    level = float(y[-1])
    out = np.zeros(steps)
    for h in range(steps):
        w_hat = c + phi * last_w + theta * last_eps
        level += w_hat
        out[h] = level
        last_w, last_eps = w_hat, 0.0
    return out


class _Recursion(torch.autograd.Function):
    """eps_t = base_t - theta * eps_{t-1} (eps_{-1} = 0) over the time
    axis 0 of base (T, n); theta (n,).  Its backward runs the adjoint
    a_t = g_t - theta * a_{t+1} from the end: d base = a, d theta =
    -sum_t a_t eps_{t-1}."""

    @staticmethod
    def forward(ctx, base, theta):
        eps = torch.empty_like(base)
        eps[0] = base[0]
        for t in range(1, base.shape[0]):
            torch.sub(base[t], theta * eps[t - 1], out=eps[t])
        ctx.save_for_backward(theta, eps)
        return eps

    @staticmethod
    def backward(ctx, grad):
        theta, eps = ctx.saved_tensors
        adj = torch.empty_like(grad)
        adj[-1] = grad[-1]
        for t in range(grad.shape[0] - 2, -1, -1):
            torch.sub(grad[t], theta * adj[t + 1], out=adj[t])
        return adj, -(adj[1:] * eps[:-1]).sum(0)


def css_residuals_batch(params: torch.Tensor, w: torch.Tensor
                        ) -> torch.Tensor:
    """The CSS residuals of every window: params (n, 3) as (c, phi, theta),
    w (n, T) -> eps (n, T), with w_{-1} = eps_{-1} = 0."""
    c, phi, theta = params.unbind(1)
    wt = w.t()  # (T, n): a time step's windows contiguous
    w_prev = torch.cat([wt.new_zeros(1, wt.shape[1]), wt[:-1]])
    base = wt - c - phi * w_prev
    return _Recursion.apply(base, theta).t()


def fit_batch(w: torch.Tensor, iters: int, lr: float) -> torch.Tensor:
    """(n, 3) parameters fitted to the differenced windows w (n, T): from
    (0, 0.1, 0.1), ``iters`` Adam steps on the summed CSS loss."""
    params = torch.tensor([0.0, 0.1, 0.1], device=w.device).repeat(
        w.shape[0], 1).requires_grad_(True)
    opt = torch.optim.Adam([params], lr=lr)
    for _ in range(iters):
        opt.zero_grad(set_to_none=True)
        eps = css_residuals_batch(params, w)
        (eps * eps).sum().backward()
        opt.step()
        with torch.no_grad():
            params[:, 1:].clamp_(-0.99, 0.99)
    return params.detach()


def forecast_batch(params: torch.Tensor, w: torch.Tensor,
                   y_last: torch.Tensor, steps: int) -> torch.Tensor:
    """(n, steps) forecasts: the recursion from each window's last
    difference and residual, then with zero residuals, re-integrated from
    its last level."""
    with torch.no_grad():
        eps = css_residuals_batch(params, w)
        c, phi, theta = params.unbind(1)
        level, last_w, last_eps = y_last, w[:, -1], eps[:, -1]
        out = []
        for _ in range(steps):
            w_hat = c + phi * last_w + theta * last_eps
            level = level + w_hat
            out.append(level)
            last_w, last_eps = w_hat, torch.zeros_like(last_eps)
        return torch.stack(out, dim=1)


def fit_forecast_batch(x: np.ndarray, steps: int, iters: int = 200,
                       lr: float = 5e-2, *, device="cuda") -> np.ndarray:
    """ARIMA(1,1,1) over a batch of windows on ``device``: x (n, L) ->
    (n, steps) float32 forecasts, every window fitted at once."""
    device = resolve_device(device)
    xt = torch.as_tensor(np.asarray(x, np.float32), device=device)
    w = torch.diff(xt, dim=1)
    params = fit_batch(w, iters, lr)
    return forecast_batch(params, w, xt[:, -1], steps).cpu().numpy()
