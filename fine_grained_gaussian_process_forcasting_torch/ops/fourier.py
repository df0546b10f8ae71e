"""Fourier-domain blocks (FEDformer).

Counterpart of the JAX package's ``ops/fourier.py``, in plain PyTorch (the
JAX version has no Pallas kernel): rFFT, keep a fixed subset of frequency
modes, a complex linear map per mode and head, irFFT.  The complex weights
are two real parameters, ``w_real`` and ``w_imag``, as in the JAX package,
so ``params.from_flax`` carries them across unchanged.  The transforms are
``torch.fft`` in fp32 (16-bit operands widened; cuFFT on the card), as the
JAX version's are ``jnp.fft``.

The modes are chosen on the host when the module is built, by numpy's
``RandomState(seed)``, so they are the JAX package's own.  A mode index past
the end of a shorter sequence's spectrum is read as the last frequency (and
passes no gradient back) and written nowhere, as JAX's gather clamps and its
scatter drops such an index.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from fine_grained_gaussian_process_forcasting_torch.ops.attention import widen


def get_frequency_modes(seq_len: int, modes: int = 64,
                        mode_select_method: str = "random",
                        seed: int = 0) -> List[int]:
    """The sorted frequency modes a block keeps: ``modes`` of the first
    ``seq_len // 2``, shuffled by ``RandomState(seed)`` ("random") or the
    lowest ones."""
    modes = min(modes, seq_len // 2)
    if mode_select_method == "random":
        rng = np.random.RandomState(seed)
        index = list(range(0, seq_len // 2))
        rng.shuffle(index)
        index = index[:modes]
    else:
        index = list(range(0, modes))
    index.sort()
    return index


def _uniform_weight(shape, scale: float, device,
                    generator: torch.Generator) -> nn.Parameter:
    """scale * U[0, 1), drawn on the CPU from ``generator``."""
    w = scale * torch.rand(shape, generator=generator)
    return nn.Parameter(w.to(device))


def _spectrum(x: torch.Tensor, modes: torch.Tensor,
              index: List[int]) -> torch.Tensor:
    """rfft over the last axis in fp32, at the modes ``index`` (``modes``
    on x's device): one past the spectrum reads its last frequency and
    passes no gradient back, as JAX's gather clamps such an index and its
    transpose, a scatter, drops it."""
    x_ft = torch.fft.rfft(widen(x), dim=-1)
    n_freq = x_ft.shape[-1]
    if max(index) < n_freq:
        return x_ft[..., modes]
    sel = x_ft[..., modes.clamp(max=n_freq - 1)]
    return torch.where(modes < n_freq, sel, sel.detach())


class FourierBlock(nn.Module):
    """Frequency-domain representation learning on Q: input and output
    (b, l, h, e); the selected modes' outputs are written to the compacted
    slots 0..M-1 of the spectrum, as the JAX package (and its reference)
    does."""

    def __init__(self, in_channels: int, out_channels: int, seq_len: int,
                 modes: int = 0, mode_select_method: str = "random",
                 n_heads: int = 8, seed: int = 0, *, device,
                 generator: torch.Generator):
        super().__init__()
        self.index = get_frequency_modes(seq_len, modes, mode_select_method,
                                         seed)
        self.register_buffer("modes", torch.tensor(self.index, device=device),
                             persistent=False)
        h = n_heads
        shape = (h, in_channels // h, out_channels // h, len(self.index))
        scale = 1.0 / (in_channels * out_channels)
        self.w_real = _uniform_weight(shape, scale, device, generator)
        self.w_imag = _uniform_weight(shape, scale, device, generator)

    def forward(self, q, k=None, v=None, mask=None
                ) -> Tuple[torch.Tensor, None]:
        b, l, h, e = q.shape
        n_freq = l // 2 + 1
        m = len(self.index)
        if m > n_freq:
            raise ValueError(f"{m} modes do not fit the {n_freq} "
                             f"frequencies of a length-{l} sequence")
        x_sel = _spectrum(q.permute(0, 2, 3, 1), self.modes, self.index)
        w = torch.complex(self.w_real, self.w_imag).to(x_sel.dtype)
        out_sel = torch.einsum("bhim,hiom->bhom", x_sel, w)
        out_ft = torch.cat([out_sel, out_sel.new_zeros(
            out_sel.shape[:-1] + (n_freq - m,))], dim=-1)
        out = torch.fft.irfft(out_ft, n=l, dim=-1)  # (b, h, e, l)
        return out.permute(0, 3, 1, 2).to(q.dtype), None


class FourierCrossAttention(nn.Module):
    """Cross attention in mode space: the query's and the key's selected
    modes, their products through ``activation`` (complex tanh, or a
    softmax of the magnitudes), back onto the key's modes, a complex linear
    map, and the query's modes written at their own frequencies."""

    def __init__(self, in_channels: int, out_channels: int, seq_len_q: int,
                 seq_len_kv: int, modes: int = 64,
                 mode_select_method: str = "random",
                 activation: str = "tanh", n_heads: int = 8, seed: int = 0,
                 *, device, generator: torch.Generator):
        super().__init__()
        if activation not in ("tanh", "softmax"):
            raise ValueError(f"{activation} activation is not implemented")
        self.in_channels, self.out_channels = in_channels, out_channels
        self.activation = activation
        self.index_q = get_frequency_modes(seq_len_q, modes,
                                           mode_select_method, seed)
        self.index_kv = get_frequency_modes(seq_len_kv, modes,
                                            mode_select_method, seed + 1)
        for name, index in (("modes_q", self.index_q),
                            ("modes_kv", self.index_kv)):
            self.register_buffer(name, torch.tensor(index, device=device),
                                 persistent=False)
        h = n_heads
        shape = (h, in_channels // h, out_channels // h, len(self.index_q))
        scale = 1.0 / (in_channels * out_channels)
        self.w_real = _uniform_weight(shape, scale, device, generator)
        self.w_imag = _uniform_weight(shape, scale, device, generator)

    def forward(self, q, k, v=None, mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, None]:
        b, l, h, e = q.shape
        xq_ft = _spectrum(q.permute(0, 2, 3, 1), self.modes_q, self.index_q)
        xk_ft = _spectrum(k.permute(0, 2, 3, 1), self.modes_kv,
                          self.index_kv)
        xqk_ft = torch.einsum("bhex,bhey->bhxy", xq_ft, xk_ft)
        if self.activation == "tanh":
            xqk_ft = torch.tanh(xqk_ft)
        else:
            xqk_ft = torch.softmax(xqk_ft.abs(), dim=-1).to(xqk_ft.dtype)
        xqkv_ft = torch.einsum("bhxy,bhey->bhex", xqk_ft, xk_ft)
        w = torch.complex(self.w_real, self.w_imag).to(xqkv_ft.dtype)
        xqkvw = torch.einsum("bhex,heox->bhox", xqkv_ft, w)
        n_freq = l // 2 + 1
        out_ft = xqkvw.new_zeros(xqkvw.shape[:-1] + (n_freq,))
        if max(self.index_q) < n_freq:
            out_ft = out_ft.index_copy(-1, self.modes_q, xqkvw)
        else:
            keep = self.modes_q < n_freq
            out_ft = out_ft.index_copy(-1, self.modes_q[keep],
                                       xqkvw[..., keep])
        out = torch.fft.irfft(out_ft / self.in_channels / self.out_channels,
                              n=l, dim=-1)
        return out.permute(0, 3, 1, 2).to(q.dtype), None
