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

``torch.func.vmap`` has no batching rule for ``aten::lstm``.  Under a
functorch transform (multi-seed training: the weights stacked by seed) the
recurrence runs through ``seedwise``: one cuDNN call per seed on that
seed's weights, the outputs stacked, so that each seed's output is its
single-seed call's.  JAX's vmap batches the
scan's cell into one recurrence for all seeds; batching the seeds so here
(block-diagonal weights or a hand-written batched cell) is left to a
performance change.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from fine_grained_gaussian_process_forcasting_torch.params import (
    lecun_normal_,
)
from fine_grained_gaussian_process_forcasting_torch.seedwise import seedwise


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


def _lstm(x, weights, num_layers: int, train: bool):
    """The stacked LSTM over batch-first x from the zero carry, on the flat
    weights (per layer ``w_ih, w_hh, b_ih, b_hh``): its outputs, (b, l,
    hidden)."""
    hidden = weights[1].shape[-1]
    h0 = x.new_zeros((num_layers, x.shape[0], hidden))
    out, _, _ = torch._VF.lstm(x, (h0, h0), list(weights), True, num_layers,
                               0.0, train, False, True)
    return out


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
        if torch._C._are_functorch_transforms_active():
            # by name: functional_call swaps the module's parameters and
            # buffers, not the list nn.LSTM keeps of them (_flat_weights)
            lstm = self.lstm
            out = seedwise(
                lambda x_, *w: _lstm(x_, w, lstm.num_layers, lstm.training),
                x, *(getattr(lstm, n) for n in lstm._flat_weights_names))
        else:
            out, _ = self.lstm(x)
        n = enc_inputs.shape[1]
        return out[:, :n], out[:, n:]
