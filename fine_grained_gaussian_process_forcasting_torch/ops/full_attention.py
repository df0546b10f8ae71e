"""Full, optionally causal, softmax attention for the FEDformer and
Informer stacks.

Counterpart of the JAX package's ``ops/full_attention.py``, in plain
PyTorch: JAX computes it in XLA, outside any Pallas kernel, so here it is
``torch.einsum`` (cuBLAS on the card), not one of the port's attention
kernels.  Layout (B, L, H, E) in and out; the scores and the softmax in
fp32 (16-bit operands widened), the causal mask a lower triangle.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from fine_grained_gaussian_process_forcasting_torch.ops.attention import widen


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask_flag: bool = False, scale: Optional[float] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, v (B, L, H, E) -> (context (B, L, H, E) in v's dtype, the
    probabilities (B, H, L, S) in fp32)."""
    L, E = q.shape[1], q.shape[3]
    S = k.shape[1]
    scale = scale or 1.0 / math.sqrt(E)
    scores = torch.einsum("blhe,bshe->bhls", widen(q), widen(k))
    if mask_flag:
        causal = torch.ones(L, S, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~causal, -math.inf)
    attn = torch.softmax(scale * scores, dim=-1)
    out = torch.einsum("bhls,bshe->blhe", widen(attn.to(v.dtype)),
                       widen(v))
    return out.to(v.dtype), attn
