"""DeepAR: an autoregressive LSTM emitting a Gaussian a step
(counterpart of the JAX package's ``models/deepar.py``).

The intended model, as the JAX package implements it: at step t the input
is z_{t-1}, embedded; ``n_layers`` LSTM layers run one after another and the
heads (mu, softplus sigma) read the hidden sequences of *every* layer,
concatenated.  Training minimizes the Gaussian NLL (``deepar_nll``);
prediction is ancestral sampling over the horizon (``DeepAR.sample``).

Each layer is its own one-layer cuDNN ``nn.LSTM`` (``rnn{i}.cell``), since
a stacked ``nn.LSTM`` returns only the last layer's sequence; each is laid
out as Flax's ``OptimizedLSTMCell`` (``models/lstm.py`` ``flax_lstm``: a
zero ``b_ih`` buffer), and ``params.from_flax`` maps Flax's ``rnn{i}/cell``
onto it.  JAX scans the cells in XLA (no Pallas kernel), and so this has no
hand kernel.

Sampling folds the samples into the batch and carries each layer's (h, c)
one step at a time.  Its normal draws are ``eps`` (n_samples, pred_len, b)
where the caller gives them (a parity test passes JAX's), else drawn from
the caller's ``torch.Generator``: JAX draws from ``jax.random``, which the
port cannot reproduce (a documented delta).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fine_grained_gaussian_process_forcasting_torch.device import resolve_device
from fine_grained_gaussian_process_forcasting_torch.models.lstm import (
    flax_lstm,
)
from fine_grained_gaussian_process_forcasting_torch.params import dense

Carry = Tuple[torch.Tensor, torch.Tensor]  # nn.LSTM's (h, c), (1, b, H)


class _RNN(nn.Module):
    """Flax's ``nn.RNN(OptimizedLSTMCell)`` named ``rnn{i}``: one layer."""

    def __init__(self, input_size: int, hidden_size: int, *, device,
                 generator: torch.Generator):
        super().__init__()
        self.cell = flax_lstm(input_size, hidden_size, device=device,
                              generator=generator)


class DeepAR(nn.Module):
    def __init__(self, embedding_dim: int = 32, hidden_dim: int = 32,
                 n_layers: int = 1, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        kw = dict(device=device, generator=generator)
        self.embedding = dense(1, embedding_dim, bias=True, **kw)
        self.n_layers = n_layers
        for i in range(n_layers):
            setattr(self, f"rnn{i}", _RNN(
                embedding_dim if i == 0 else hidden_dim, hidden_dim, **kw))
        self.distribution_mu = dense(hidden_dim * n_layers, 1, bias=True,
                                     **kw)
        self.distribution_presigma = dense(hidden_dim * n_layers, 1,
                                           bias=True, **kw)

    def _run(self, h: torch.Tensor, carries: Optional[List[Carry]] = None
             ) -> Tuple[List[Carry], torch.Tensor]:
        """h: (b, l, e) -> (each layer's last carry, every layer's hidden
        sequence concatenated (b, l, H * n_layers))."""
        new, outs = [], []
        for i in range(self.n_layers):
            h, carry = getattr(self, f"rnn{i}").cell(
                h, None if carries is None else carries[i])
            new.append(carry)
            outs.append(h)
        return new, torch.cat(outs, dim=-1)

    def _heads(self, feat: torch.Tensor):
        mu = self.distribution_mu(feat)[..., 0]
        sigma = F.softplus(self.distribution_presigma(feat)[..., 0])
        return mu, sigma

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced pass.  x: (b, l, 1) -> (mu, sigma), each (b, l)."""
        _, feat = self._run(self.embedding(x))
        return self._heads(feat)

    def sample(self, history: torch.Tensor, pred_len: int,
               n_samples: int = 1, *, eps: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Ancestral sampling.  history: (b, l, 1) observed prefix ->
        (n_samples, b, pred_len).  ``eps`` (n_samples, pred_len, b): the
        standard normal draws; without it they come from ``generator``
        (a generator on the history's device; None: seed 0)."""
        b = history.shape[0]
        if eps is None:
            if generator is None:
                generator = torch.Generator(history.device).manual_seed(0)
            eps = torch.randn((n_samples, pred_len, b), generator=generator,
                              device=history.device, dtype=history.dtype)
        if eps.shape != (n_samples, pred_len, b):
            raise ValueError(f"eps has shape {tuple(eps.shape)}, not "
                             f"{(n_samples, pred_len, b)}")
        carries, _ = self._run(self.embedding(history))
        # sample s of window j at row s * b + j
        carries = [(h.repeat(1, n_samples, 1), c.repeat(1, n_samples, 1))
                   for h, c in carries]
        prev = history[:, -1, :].repeat(n_samples, 1)  # (n * b, 1)
        zs = []
        for t in range(pred_len):
            carries, feat = self._run(self.embedding(prev)[:, None, :],
                                      carries)
            mu, sigma = self._heads(feat[:, 0])
            z = mu + sigma * eps[:, t].reshape(-1)
            zs.append(z)
            prev = z[:, None]
        return torch.stack(zs, dim=-1).reshape(n_samples, b, pred_len)


def deepar_nll(mu: torch.Tensor, sigma: torch.Tensor,
               labels: torch.Tensor) -> torch.Tensor:
    """Gaussian negative log likelihood, the mean over every point."""
    var = sigma**2
    logp = -0.5 * (torch.log(2 * math.pi * var) + (labels - mu) ** 2 / var)
    return -torch.mean(logp)


def accuracy_nd(mu: torch.Tensor, labels: torch.Tensor):
    """ND metric pieces: (sum |err|, sum |labels|) over nonzero labels."""
    mask = labels != 0
    diff = torch.sum(torch.abs(mu - labels) * mask)
    summation = torch.sum(torch.abs(labels) * mask)
    return diff, summation


def accuracy_rmse(mu: torch.Tensor, labels: torch.Tensor):
    """RMSE metric pieces: (sum of squared errors, sum |labels|, count)
    over nonzero labels."""
    mask = labels != 0
    diff = torch.sum(((mu - labels) * mask) ** 2)
    summation = torch.sum(torch.abs(labels) * mask)
    count = torch.sum(mask)
    return diff, summation, count
