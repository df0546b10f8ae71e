"""Synthetic dataset generators matching each formatter's schema.

The port's own copy of the JAX package's ``data/synthetic.py``: the same
draws from ``np.random.default_rng(seed)`` in the same order, so a seed gives
the same numbers, returned as a column table (``data/table.py``) instead of
a pandas frame.  Seasonal + trend + noise series with the exact column
schema of each experiment, so the whole pipeline (formatter -> windows ->
model) runs without a downloaded dataset.
"""

from __future__ import annotations

import numpy as np

from fine_grained_gaussian_process_forcasting_torch.data import table


def _noise(rng: np.random.Generator, n: int, kind: str,
           scale: float = 0.3) -> np.ndarray:
    """Additive noise component.

    - 'iid': white Gaussian (the round-1 default).
    - 'ar1': AR(1) with phi=0.9 — temporally *correlated* corruption, the
      structure a GP blur model can learn (iid noise has none, which is
      why the flagship D-GP treatment cannot beat D-Iso on iid synthetic
      data; see VERDICT round 1, weak #6).
    - 'gp': smooth RBF-like noise via Gaussian-filtered white noise
      (lengthscale ~6 steps), unit-variance scaled.
    """
    if kind == "iid":
        return rng.normal(0, scale, size=n)
    if kind == "ar1":
        phi = 0.9
        w = rng.normal(0, scale * np.sqrt(1 - phi**2), size=n)
        out = np.empty(n)
        acc = 0.0
        for i in range(n):
            acc = phi * acc + w[i]
            out[i] = acc
        return out
    if kind == "gp":
        ls = 6.0
        half = int(4 * ls)
        t = np.arange(-half, half + 1, dtype=np.float64)
        kern = np.exp(-0.5 * (t / ls) ** 2)
        kern /= np.sqrt((kern**2).sum())  # unit output variance
        w = rng.normal(0, scale, size=n + 2 * half)
        return np.convolve(w, kern, mode="valid")
    raise ValueError(f"unknown noise kind {kind!r}")


def _series(rng: np.random.Generator, n: int, period: int,
            noise: str = "iid", noise_scale: float = 0.3,
            profile: str = "stationary") -> np.ndarray:
    """``profile='stationary'`` is the round-1/2 protocol: fixed-amplitude
    seasonality + noise, fully learnable given enough windows (which is
    why the plain forecaster catches up in the full-data regime —
    RESULTS.md).  ``profile='field'`` adds the three properties the
    reference's REAL datasets (solar plants, electricity meters, traffic
    sensors — ``data_loader.py:97-917``) all exhibit and the stationary
    protocol lacks:

    - slowly-drifting amplitude (an OU random walk, tau ~ 3 periods —
      cloud cover / demand drift), so the mapping is never fully
      learnable from history alone;
    - occasional regime level-shifts (~2 per series);
    - heteroscedastic noise: the corruption scales with the local signal
      amplitude (bright days are noisier in MW terms).

    The irreducible structured corruption is what the GP blur models;
    on 'field' data denoising stays valuable even with abundant windows.
    """
    t = np.arange(n, dtype=np.float64)
    amp = rng.uniform(0.5, 2.0)
    phase = rng.uniform(0, 2 * np.pi)
    trend = rng.uniform(-0.001, 0.001) * t
    if profile == "field":
        # OU amplitude modulation, mean 1, sd ~0.35, timescale 3 periods
        tau = 3.0 * period
        rho = np.exp(-1.0 / tau)
        w = rng.normal(0, 0.35 * np.sqrt(1 - rho**2), size=n)
        a = np.empty(n)
        acc = rng.normal(0, 0.35)
        for i in range(n):
            acc = rho * acc + w[i]
            a[i] = acc
        amp_t = amp * np.clip(1.0 + a, 0.15, None)
        # ~2 regime level-shifts per series
        level = np.zeros(n)
        for _ in range(rng.poisson(2.0)):
            at = rng.integers(period, max(period + 1, n - period))
            level[at:] += rng.normal(0, 0.8)
        daily = amp_t * np.sin(2 * np.pi * t / period + phase)
        weekly = 0.4 * amp * np.sin(2 * np.pi * t / (7 * period) + phase / 2)
        eps = _noise(rng, n, noise, noise_scale)
        # heteroscedastic: corruption rides the local amplitude
        eps = eps * (0.5 + 0.5 * amp_t / amp)
        return 5.0 + trend + level + daily + weekly + eps
    daily = amp * np.sin(2 * np.pi * t / period + phase)
    weekly = 0.4 * amp * np.sin(2 * np.pi * t / (7 * period) + phase / 2)
    eps = _noise(rng, n, noise, noise_scale)
    return 5.0 + trend + daily + weekly + eps


def make_synthetic_frame(
    experiment: str,
    num_entities: int = 4,
    steps_per_entity: int = 1200,
    seed: int = 0,
    noise: str = "iid",
    noise_scale: float = 0.3,
    profile: str = "stationary",
) -> table.Frame:
    """A column table with the exact column schema of ``experiment``.

    ``noise`` selects the corruption structure on the *target* series
    ('iid' | 'ar1' | 'gp' — see ``_noise``); covariate series keep iid
    noise so only the signal to be denoised carries the structure.
    ``profile`` ('stationary' | 'field') controls the target's
    non-stationarity — see ``_series``."""
    rng = np.random.default_rng(seed)
    frames = []
    for ent in range(num_entities):
        n = steps_per_entity
        hours = np.arange(n, dtype=np.float64)
        target = _series(rng, n, period=24, noise=noise,
                         noise_scale=noise_scale, profile=profile)
        base = {
            "hours_from_start": hours,
            "hour": hours % 24,
            "day_of_week": (hours // 24) % 7,
            "id": float(ent),
            "categorical_id": str(ent),
        }
        if experiment == "electricity":
            cols = dict(base, power_usage=target)
        elif experiment == "solar":
            cols = dict(base, **{"Power(MW)": np.abs(target)}, capacity=str(ent % 2))
        elif experiment == "traffic":
            cols = dict(base, values=target, time_on_day=hours % 24)
            cols.pop("hour")
        elif experiment == "exchange":
            cols = dict(base, OT=target)
            for k in range(6):
                cols[str(k)] = _series(rng, n, period=24)
        elif experiment == "covid":
            cols = {
                "days_from_start": hours,
                "day_of_week": (hours // 24) % 7,
                "PEOPLE_POSITIVE_NEW_CASES_COUNT": np.abs(target) * 100,
                "PEOPLE_DEATH_COUNT": np.abs(target) * 3,
                "Population Staying at Home": _series(rng, n, period=7),
                "Population Not Staying at Home": _series(rng, n, period=7),
                "id": float(ent),
                "categorical_id": str(ent),
            }
        elif experiment == "air_quality":
            cols = {
                "hours_from_start": hours,
                "NO2": np.abs(target) * 10,
                "CO": np.abs(_series(rng, n, period=24)),
                "TEMP": _series(rng, n, period=24) * 5 + 15,
                "hour": hours % 24,
                "day_of_week": (hours // 24) % 7,
                "id": float(ent),
            }
        elif experiment == "watershed":
            cols = dict(base, Conductivity=target, Q=np.abs(_series(rng, n, period=24)))
        elif experiment == "weather":
            # bgc-jena roof schema (download.download_weather output)
            cols = dict(
                base,
                **{
                    "T (degC)": _series(rng, n, period=24) * 8 + 10,
                    "p (mbar)": _series(rng, n, period=24) * 5 + 990,
                    "rh (%)": np.abs(_series(rng, n, period=24)) * 20 + 50,
                },
                days_from_start=hours // 24,
            )
        elif experiment == "ETTm2":
            # ETT schema: OT target + HUFL/HULL/MUFL/MULL/LUFL/LULL loads
            cols = dict(base, OT=target, days_from_start=hours // 24)
            for name in ("HUFL", "HULL", "MUFL", "MULL", "LUFL", "LULL"):
                cols[name] = _series(rng, n, period=96)
        elif experiment == "camel":
            cols = dict(
                base,
                streamflow=np.abs(target) * 50,
                days_from_start=hours // 24,
            )
        else:
            raise ValueError(f"no synthetic schema for {experiment}")
        frames.append(table.from_columns(cols, n))
    return table.concat(frames)
