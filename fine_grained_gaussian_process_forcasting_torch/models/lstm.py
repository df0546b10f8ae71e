"""LSTM forecasting backbone (counterpart of the JAX ``models/lstm.py``).

The embedded encoder and decoder streams run as one sequence through
``n_layers`` stacked LSTM cells, and the hidden states are split back at the
encoder's length: a drop-in backbone for ``ForecastDenoising``.  The JAX
package scans Flax's ``OptimizedLSTMCell`` in an XLA while-loop (no Pallas
kernel); here the recurrence is ``torch.nn.LSTM``, cuDNN's on the card,
one call for all the steps and layers.

Flax's cell has gates i, f, g, o with one bias each, on the hidden-state
side (``h{i,f,g,o}`` kernel and bias, ``i{i,f,g,o}`` kernel only);
``nn.LSTM`` has two, ``b_ih`` and ``b_hh``.  ``b_hh`` is Flax's bias and
``b_ih`` is a zero buffer, not a parameter: the optimizer and the global-
norm clip see exactly Flax's leaves (two trained biases would move their sum
twice as fast under Adam).  ``params.from_flax`` stacks the gates into
``weight_ih_l{i}``/``weight_hh_l{i}``/``bias_hh_l{i}`` and ``to_flax``
splits them.  Initialised as Flax does: lecun-normal input kernels,
orthogonal recurrent kernels (each gate's own), zero biases, and a zero
initial carry.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from fine_grained_gaussian_process_forcasting_torch.params import (
    lecun_normal_,
)


def orthogonal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """In-place orthogonal matrix (a square one: each gate's recurrent
    kernel), drawn on the CPU from ``generator``: Q of the QR of a normal
    matrix, its columns' signs fixed by R's diagonal."""
    a = torch.randn(weight.shape, generator=generator)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    with torch.no_grad():
        weight.copy_(q)


def flax_lstm(input_size: int, hidden_size: int, num_layers: int = 1, *,
              device, generator: torch.Generator) -> nn.LSTM:
    """A batch-first ``nn.LSTM`` laid out and initialised as ``num_layers``
    stacked Flax ``OptimizedLSTMCell``s: each layer's ``b_ih`` a zero
    buffer, its input kernel lecun-normal, each gate's recurrent kernel
    orthogonal, ``b_hh`` zero (the draws layer by layer)."""
    h = hidden_size
    lstm = nn.LSTM(input_size, h, num_layers=num_layers, batch_first=True,
                   device=device)
    for i in range(num_layers):
        delattr(lstm, f"bias_ih_l{i}")
        lstm.register_buffer(f"bias_ih_l{i}",
                             torch.zeros(4 * h, device=device))
        lecun_normal_(getattr(lstm, f"weight_ih_l{i}"), generator)
        recurrent = getattr(lstm, f"weight_hh_l{i}")
        for gate in range(4):
            orthogonal_(recurrent.data[gate * h:(gate + 1) * h], generator)
        nn.init.zeros_(getattr(lstm, f"bias_hh_l{i}"))
    lstm._init_flat_weights()  # the buffers in the weights' list
    return lstm


class LSTMBackbone(nn.Module):
    """Returns (enc_out, dec_out) hidden states, each (b, l, hidden_size);
    ignores ``training`` and ``generator`` (no dropout, nothing drawn)."""

    def __init__(self, hidden_size: int, n_layers: int = 1, *, device,
                 generator: torch.Generator):
        super().__init__()
        self.lstm = flax_lstm(hidden_size, hidden_size, n_layers,
                              device=device, generator=generator)

    def forward(self, enc_inputs, dec_inputs, training: bool = False,
                generator=None) -> Tuple[torch.Tensor, torch.Tensor]:
        x = torch.cat([enc_inputs, dec_inputs], dim=1)
        out, _ = self.lstm(x)
        n = enc_inputs.shape[1]
        return out[:, :n], out[:, n:]
