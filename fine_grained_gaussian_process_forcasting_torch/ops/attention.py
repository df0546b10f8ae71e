"""Scaled dot-product attention: the ``basic`` op of the zoo.

Counterpart of the JAX package's ``ops/attention.py``.  Plain tensor ops,
no masking (the reference's decoder is intentionally unmasked).
"""

from __future__ import annotations

import math

import torch


def scaled_dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Softmax attention over (batch, heads, length, d_k) operands.

    Returns ``(context, attn)``.
    """
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    attn = torch.softmax(scores, dim=-1)
    return torch.matmul(attn, v), attn
