"""Normalizers and Lp loss on tensors: the port's counterpart of the JAX
package's ``utils/normalizers.py`` (the reference's ``layers/utils_fed.py:
196-391`` leftovers, unused by the main path, kept for capability parity).

``jnp.std`` is the population standard deviation, so the std here is
``torch.std(..., correction=0)``.
"""

from __future__ import annotations

import torch


class UnitGaussianNormalizer:
    """Per-element z-score over the sample dim (``utils_fed.py:196-239``)."""

    def __init__(self, x: torch.Tensor, eps: float = 1e-5):
        self.mean = torch.mean(x, dim=0)
        self.std = torch.std(x, dim=0, correction=0)
        self.eps = eps

    def encode(self, x):
        return (x - self.mean) / (self.std + self.eps)

    def decode(self, x):
        return x * (self.std + self.eps) + self.mean


class GaussianNormalizer:
    """Global z-score (``utils_fed.py:242-269``)."""

    def __init__(self, x: torch.Tensor, eps: float = 1e-5):
        self.mean = torch.mean(x)
        self.std = torch.std(x, correction=0)
        self.eps = eps

    def encode(self, x):
        return (x - self.mean) / (self.std + self.eps)

    def decode(self, x):
        return x * (self.std + self.eps) + self.mean


class RangeNormalizer:
    """Affine map to [low, high] (``utils_fed.py:272-291``)."""

    def __init__(self, x: torch.Tensor, low: float = 0.0, high: float = 1.0):
        mins = torch.amin(x.reshape(x.shape[0], -1), dim=0)
        maxs = torch.amax(x.reshape(x.shape[0], -1), dim=0)
        self.a = (high - low) / (maxs - mins)
        self.b = -self.a * maxs + high
        self._shape = x.shape[1:]

    def encode(self, x):
        s = x.shape
        return (self.a * x.reshape(s[0], -1) + self.b).reshape(s)

    def decode(self, x):
        s = x.shape
        return ((x.reshape(s[0], -1) - self.b) / self.a).reshape(s)


class LpLoss:
    """Relative/absolute Lp loss (``utils_fed.py:294-331``)."""

    def __init__(self, d: int = 2, p: int = 2, size_average: bool = True,
                 reduction: bool = True):
        if d <= 0 or p <= 0:
            raise ValueError(f"d and p must be positive, got d={d}, p={p}")
        self.d = d
        self.p = p
        self.size_average = size_average
        self.reduction = reduction

    def _reduce(self, values):
        if self.reduction:
            return (torch.mean(values) if self.size_average
                    else torch.sum(values))
        return values

    def abs(self, x, y):
        num_examples = x.shape[0]
        h = 1.0 / (x.shape[1] - 1.0)
        norms = (h ** (self.d / self.p)) * torch.linalg.vector_norm(
            x.reshape(num_examples, -1) - y.reshape(num_examples, -1),
            ord=self.p, dim=1)
        return self._reduce(norms)

    def rel(self, x, y):
        num_examples = x.shape[0]
        diff = torch.linalg.vector_norm(
            x.reshape(num_examples, -1) - y.reshape(num_examples, -1),
            ord=self.p, dim=1)
        ynorm = torch.linalg.vector_norm(y.reshape(num_examples, -1),
                                         ord=self.p, dim=1)
        return self._reduce(diff / ynorm)

    def __call__(self, x, y):
        return self.rel(x, y)
