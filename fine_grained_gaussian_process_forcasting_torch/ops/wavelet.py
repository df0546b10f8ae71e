"""Multiwavelet transform and cross attention (FEDformer's "Wavelets").

Counterpart of the JAX package's ``ops/wavelet.py``, in plain PyTorch (the
JAX version has no Pallas kernel): a recursive even/odd decomposition with
the Alpert filter banks (``ops/wavelet_filters.py``, computed on the host
when a module is built), a sparse kernel in the frequency domain at each
scale, and an even/odd reconstruction.  The pad to a power of two and the
recursion depth are Python ints, as in JAX: a length N is padded to
2^ceil(log2 N) by repeating its head, and the recursion runs
floor(log2 N) - L levels.  The products are ``torch.matmul`` and
``torch.einsum`` (cuBLAS on the card), the transforms ``torch.fft`` in fp32
(16-bit operands widened; cuFFT).  The complex weights are two real
parameters, ``w_real`` and ``w_imag``, as in the JAX package, so
``params.from_flax`` carries them across unchanged.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
from torch import nn

from fine_grained_gaussian_process_forcasting_torch.ops.attention import widen
from fine_grained_gaussian_process_forcasting_torch.ops.fourier import (
    _uniform_weight,
)
from fine_grained_gaussian_process_forcasting_torch.ops.wavelet_filters import (
    filter_bank,
)
from fine_grained_gaussian_process_forcasting_torch.params import dense


def _build_filters(base: str, k: int):
    """(ec_s, ec_d, rc_e, rc_o) as float32 numpy arrays: the decomposition
    filters (2k, k) and the reconstruction ones (2k, k)."""
    H0, H1, G0, G1, PHI0, PHI1 = filter_bank(base, k)
    H0r, G0r = H0 @ PHI0, G0 @ PHI0
    H1r, G1r = H1 @ PHI1, G1 @ PHI1
    for m in (H0r, H1r, G0r, G1r):
        m[np.abs(m) < 1e-8] = 0.0
    ec_s = np.concatenate([H0.T, H1.T], axis=0).astype(np.float32)
    ec_d = np.concatenate([G0.T, G1.T], axis=0).astype(np.float32)
    rc_e = np.concatenate([H0r, G0r], axis=0).astype(np.float32)
    rc_o = np.concatenate([H1r, G1r], axis=0).astype(np.float32)
    return ec_s, ec_d, rc_e, rc_o


def _register_filters(module: nn.Module, base: str, k: int, device):
    for name, m in zip(("ec_s", "ec_d", "rc_e", "rc_o"),
                       _build_filters(base, k)):
        module.register_buffer(name, torch.from_numpy(m).to(device),
                               persistent=False)


def _wavelet_transform(x, ec_s, ec_d):
    """One decomposition level: (B, N, c, k) -> (d, s), each
    (B, N/2, c, k)."""
    xa = torch.cat([x[:, ::2], x[:, 1::2]], dim=-1)  # (B, N/2, c, 2k)
    return xa @ ec_d, xa @ ec_s


def _even_odd(x, rc_e, rc_o):
    """One reconstruction level: (B, N, c, 2k) -> (B, 2N, c, k), the even
    rows from rc_e and the odd ones from rc_o."""
    B, N, c, _ = x.shape
    out = torch.stack([x @ rc_e, x @ rc_o], dim=2)  # (B, N, 2, c, k)
    return out.reshape(B, 2 * N, c, -1)


def _pad_pow2(x, n: int) -> Tuple[torch.Tensor, int]:
    """The length axis padded to the next power of two by repeating its
    head, and floor(log2 n)."""
    ns = math.floor(np.log2(n))
    nl = 2 ** math.ceil(np.log2(n))
    if nl > n:
        x = torch.cat([x, x[:, : nl - n]], dim=1)
    return x, ns


class SparseKernelFT(nn.Module):
    """rfft over the length, the lowest ``alpha`` modes through a complex
    (ck, ck) map each, irfft."""

    def __init__(self, k: int, alpha: int, c: int = 1, *, device,
                 generator: torch.Generator):
        super().__init__()
        ck = c * k
        shape, scale = (ck, ck, alpha), 1.0 / (ck * ck)
        self.w_real = _uniform_weight(shape, scale, device, generator)
        self.w_imag = _uniform_weight(shape, scale, device, generator)

    def forward(self, x):
        B, N, c, k = x.shape
        ck = c * k
        xf = x.reshape(B, N, ck).transpose(1, 2)  # (B, ck, N)
        x_fft = torch.fft.rfft(widen(xf), dim=-1)
        n_freq = N // 2 + 1
        l = min(self.w_real.shape[-1], n_freq)
        w = torch.complex(self.w_real[..., :l], self.w_imag[..., :l])
        out_modes = torch.einsum("bix,iox->box", x_fft[..., :l], w)
        out_ft = torch.cat([out_modes, out_modes.new_zeros(
            B, ck, n_freq - l)], dim=-1)
        out = torch.fft.irfft(out_ft, n=N, dim=-1)
        return out.transpose(1, 2).reshape(B, N, c, k).to(x.dtype)


class MWTCZ(nn.Module):
    """One multiwavelet block: decompose floor(log2 N) - L levels, the
    sparse kernels A, B, C at each and the linear T0 at the coarsest scale,
    reconstruct; (B, N, c, k) in and out."""

    def __init__(self, k: int = 8, alpha: int = 16, L: int = 0, c: int = 1,
                 base: str = "legendre", *, device, generator):
        super().__init__()
        self.L = L
        _register_filters(self, base, k, device)
        kw = dict(device=device, generator=generator)
        self.A = SparseKernelFT(k, alpha, c, **kw)
        self.B = SparseKernelFT(k, alpha, c, **kw)
        self.C = SparseKernelFT(k, alpha, c, **kw)
        self.T0 = dense(k, k, bias=True, **kw)

    def forward(self, x):
        N = x.shape[1]
        x, ns = _pad_pow2(x, N)
        Ud: List[torch.Tensor] = []
        Us: List[torch.Tensor] = []
        for _ in range(ns - self.L):
            d, x = _wavelet_transform(x, self.ec_s, self.ec_d)
            Ud.append(self.A(d) + self.B(x))
            Us.append(self.C(d))
        x = self.T0(x)
        for i in range(ns - 1 - self.L, -1, -1):
            x = x + Us[i]
            x = torch.cat([x, Ud[i]], dim=-1)
            x = _even_odd(x, self.rc_e, self.rc_o)
        return x[:, :N]


class MultiWaveletTransform(nn.Module):
    """The self-attention stand-in: (q, k, v, mask) with (B, L, H, E)
    operands, of which only v is read (cut or zero-padded to q's length)."""

    def __init__(self, ich: int, k: int = 8, alpha: int = 16, c: int = 128,
                 nCZ: int = 1, L: int = 0, base: str = "legendre", *,
                 device, generator):
        super().__init__()
        self.c, self.k, self.nCZ = c, k, nCZ
        kw = dict(device=device, generator=generator)
        self.Lk0 = dense(ich, c * k, bias=True, **kw)
        for i in range(nCZ):
            setattr(self, f"mwt_cz{i}", MWTCZ(k, alpha, L, c, base, **kw))
        self.Lk1 = dense(c * k, ich, bias=True, **kw)

    def forward(self, queries, keys, values, mask=None):
        B, L, H, E = queries.shape
        _, S, _, D = values.shape
        if L > S:
            values = torch.cat([values, values.new_zeros(B, L - S, H, D)],
                               dim=1)
        else:
            values = values[:, :L]
        v = self.Lk0(values.reshape(B, L, -1)).reshape(B, L, self.c, self.k)
        for i in range(self.nCZ):
            v = getattr(self, f"mwt_cz{i}")(v)
            if i < self.nCZ - 1:
                v = torch.relu(v)
        v = self.Lk1(v.reshape(B, L, -1))
        return v.reshape(B, L, -1, D), None


class FourierCrossAttentionW(nn.Module):
    """The weightless mode-space cross attention of the wavelet cross
    block: operands (B, L, c, k), read as (B, L, E, H); the lowest
    min(L // 2, modes) modes of q and of k, their products through a complex
    tanh or a softmax of the magnitudes, back onto k's modes.  Only v's
    length is read."""

    def __init__(self, in_channels: int, out_channels: int, modes: int = 16,
                 activation: str = "tanh"):
        super().__init__()
        if activation not in ("tanh", "softmax"):
            raise ValueError(f"{activation} activation not implemented")
        self.in_channels, self.out_channels = in_channels, out_channels
        self.modes, self.activation = modes, activation

    def forward(self, q, k, v, mask=None) -> Tuple[torch.Tensor, None]:
        B, L, E, H = q.shape
        xq = q.permute(0, 3, 2, 1)  # (B, H, E, L)
        xk = k.permute(0, 3, 2, 1)
        mq = min(L // 2, self.modes)
        mkv = min(v.shape[1] // 2, self.modes)
        xq_ft = torch.fft.rfft(widen(xq), dim=-1)[..., :mq]
        xk_ft = torch.fft.rfft(widen(xk), dim=-1)[..., :mkv]
        xqk_ft = torch.einsum("bhex,bhey->bhxy", xq_ft, xk_ft)
        if self.activation == "tanh":
            xqk_ft = torch.tanh(xqk_ft)
        else:
            xqk_ft = torch.softmax(xqk_ft.abs(), dim=-1).to(xqk_ft.dtype)
        xqkv_ft = torch.einsum("bhxy,bhey->bhex", xqk_ft, xk_ft)
        out_ft = torch.cat([xqkv_ft, xqkv_ft.new_zeros(
            B, H, E, L // 2 + 1 - mq)], dim=-1)
        out = torch.fft.irfft(out_ft / self.in_channels / self.out_channels,
                              n=L, dim=-1)
        return out.permute(0, 3, 2, 1).to(q.dtype), None


class MultiWaveletCross(nn.Module):
    """Cross attention in the wavelet domain: q, k and v projected to
    (c, k), decomposed alike, ``FourierCrossAttentionW`` at each scale
    (JAX's attn1..attn4, one module here: they hold no parameter),
    reconstructed, projected back."""

    def __init__(self, in_channels: int, out_channels: int, modes: int,
                 ich: int = 512, k: int = 8, c: int = 64, L: int = 0,
                 base: str = "legendre", activation: str = "tanh", *,
                 device, generator):
        super().__init__()
        self.c, self.k, self.L = c, k, L
        self.attn = FourierCrossAttentionW(in_channels, out_channels, modes,
                                           activation)
        _register_filters(self, base, k, device)
        kw = dict(device=device, generator=generator)
        self.Lq = dense(ich, c * k, bias=True, **kw)
        self.Lk = dense(ich, c * k, bias=True, **kw)
        self.Lv = dense(ich, c * k, bias=True, **kw)
        self.out = dense(c * k, ich, bias=True, **kw)

    def forward(self, q, k, v, mask=None):
        B, N, H, E = q.shape
        S = k.shape[1]
        c, kk = self.c, self.k
        q = self.Lq(q.reshape(B, N, -1)).reshape(B, N, c, kk)
        k = self.Lk(k.reshape(B, S, -1)).reshape(B, S, c, kk)
        v = self.Lv(v.reshape(B, S, -1)).reshape(B, S, c, kk)
        if N > S:
            zeros = q.new_zeros(B, N - S, c, kk)
            k = torch.cat([k, zeros], dim=1)
            v = torch.cat([v, zeros], dim=1)
        else:
            k, v = k[:, :N], v[:, :N]
        q, ns = _pad_pow2(q, N)
        k, _ = _pad_pow2(k, N)
        v, _ = _pad_pow2(v, N)

        def attn(*qkv):
            return self.attn(*qkv)[0]

        Ud, Us, levels = [], [], []
        sq, sk, sv = q, k, v
        for _ in range(ns - self.L):
            dq, sq = _wavelet_transform(sq, self.ec_s, self.ec_d)
            dk, sk = _wavelet_transform(sk, self.ec_s, self.ec_d)
            dv, sv = _wavelet_transform(sv, self.ec_s, self.ec_d)
            levels.append(((dq, sq), (dk, sk), (dv, sv)))
        for (dq, sq_i), (dk, sk_i), (dv, sv_i) in levels:
            # JAX's attn1 and attn3 compute this one function
            detail = attn(dq, dk, dv)
            Ud.append(detail + attn(sq_i, sk_i, sv_i))
            Us.append(detail)
        v_out = attn(sq, sk, sv)
        for i in range(ns - 1 - self.L, -1, -1):
            v_out = v_out + Us[i]
            v_out = torch.cat([v_out, Ud[i]], dim=-1)
            v_out = _even_odd(v_out, self.rc_e, self.rc_o)
        out = self.out(v_out[:, :N].reshape(B, N, -1))
        return out.reshape(B, N, H, -1), None
