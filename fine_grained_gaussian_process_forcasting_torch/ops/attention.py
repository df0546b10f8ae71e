"""Scaled dot-product attention: the ``basic`` op of the zoo.

Counterpart of the JAX package's ``ops/attention.py``.  Plain tensor ops,
no masking (the reference's decoder is intentionally unmasked).
"""

from __future__ import annotations

import math

import torch


def widen(t: torch.Tensor) -> torch.Tensor:
    """A 16-bit tensor widened to fp32; fp32 and float64 as they are (so a
    float64 reference run stays float64)."""
    return t.float() if t.dtype.itemsize == 2 else t


def matmul16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for 16-bit operands: exact products summed in fp32, rounded
    once to the operands' dtype.  Every GEMM here does that, each in its own
    order of summation, and a sum that lands between two 16-bit values
    rounds one way or the other with the order.  On the CPU the operands are
    widened and the product taken by the fp32 GEMM, the order in which the
    JAX package's CPU runs sum: the 16-bit model's GP-parameter gradients
    (sums that nearly cancel) follow those few roundings, and the port could
    not be held against the JAX package on the CPU otherwise.  Wider
    operands take the plain product."""
    if a.device.type == "cpu" and a.dtype.itemsize == 2:
        return torch.matmul(a.float(), b.float()).to(a.dtype)
    return torch.matmul(a, b)


def scaled_dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Softmax attention over (batch, heads, length, d_k) operands.

    Returns ``(context, attn)``.  With 16-bit values (and 16-bit or fp32
    queries and keys: the conv family's in a 16-bit model) the scores are
    exact products summed in fp32 and the softmax is fp32; the
    probabilities are cast to ``v``'s dtype for the second product and the
    context comes back in that dtype.
    """
    if v.dtype.itemsize > 2:
        scores = torch.matmul(q, k.transpose(-1, -2))
        attn = torch.softmax(scores / math.sqrt(q.shape[-1]), dim=-1)
        return torch.matmul(attn, v), attn
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    attn = torch.softmax(scores / math.sqrt(q.shape[-1]), dim=-1)
    return matmul16(attn.to(v.dtype), v), attn
