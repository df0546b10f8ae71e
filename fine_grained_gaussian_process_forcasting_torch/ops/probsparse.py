"""ProbSparse attention (Informer).

Counterpart of the JAX package's ``ops/probsparse.py``, in plain PyTorch
(the JAX version has no Pallas kernel): sample ``ceil(ln L_k)`` keys per
query, rank the queries by the sparsity measure ``M = max - mean`` of their
sampled scores, let the top ``ceil(ln L_q)`` queries attend to every key and
give the rest the mean of the values (or, with ``mask_flag``, the running
sum of the values).  The JAX version gathers and scatters through one-hot
GEMMs, a choice made for the TPU's matrix unit; here they are
``torch.gather`` and ``scatter``, which select the same rows exactly.

The key sample is drawn from an explicit ``torch.Generator``; it cannot
reproduce ``jax.random.randint``, so a caller that must match another run
(a test against the JAX package, the card against the CPU) passes that
run's draw as ``index_sample`` and, where a near-tie in M could pick other
queries, its ``m_top``.  Without a generator the draw comes from a fixed
generator seeded 0, as the JAX version falls back to ``PRNGKey(0)`` (another
draw than JAX's).  Layout: (batch, heads, length, d) in and out.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from fine_grained_gaussian_process_forcasting_torch import draws
from fine_grained_gaussian_process_forcasting_torch.ops.attention import (
    matmul16,
    widen,
)


def sample_sizes(l_q: int, l_k: int, factor: int = 1) -> Tuple[int, int]:
    """(keys sampled per query, queries that attend fully)."""
    u_part = min(int(factor * math.ceil(math.log(l_k))), l_k)
    u = min(int(factor * math.ceil(math.log(l_q))), l_q)
    return u_part, u


def sample_keys(l_q: int, l_k: int, u_part: int,
                generator: Optional[torch.Generator],
                device) -> torch.Tensor:
    """The (l_q, u_part) key indices each query samples, uniform in
    [0, l_k), from ``generator`` (a fixed seed-0 generator without one)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return draws.randint(l_k, (l_q, u_part), generator, device=device)


def top_queries(q: torch.Tensor, k: torch.Tensor, index_sample: torch.Tensor,
                u: int) -> torch.Tensor:
    """The (b, h, u) queries of the largest sparsity measure, largest
    first: M = max - sum / l_k over each query's sampled scores, which are
    exact products summed in fp32."""
    l_k = k.shape[2]
    k_sample = k[:, :, index_sample, :]  # (b, h, l_q, u_part, d)
    qk = torch.matmul(widen(q)[..., None, :],
                      widen(k_sample).transpose(-1, -2))[..., 0, :]
    m = qk.amax(dim=-1) - qk.sum(dim=-1) / l_k
    return torch.topk(m, u, dim=-1).indices


def prob_sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          generator: Optional[torch.Generator] = None,
                          factor: int = 1, scale: Optional[float] = None,
                          mask_flag: bool = False,
                          index_sample: Optional[torch.Tensor] = None,
                          m_top: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, None]:
    """ProbSparse attention over (b, h, l, d) operands; returns
    ``(context, None)`` as the JAX op does.

    ``mask_flag=False`` (the model's use): the queries not chosen take the
    mean of the values.  ``mask_flag=True``, the causal variant (self-
    attention only): they take the running sum of the values, and each
    chosen query's scores are masked past its own position.
    ``index_sample`` ((l_q, u_part) key indices) and ``m_top`` ((b, h, u)
    chosen queries) replace this call's own draw and choice.

    With 16-bit operands the scores are exact products summed in fp32 and
    the softmax is fp32; the probabilities are cast to ``v``'s dtype for
    the second product and the context comes back in that dtype.
    """
    b, h, l_q, d = q.shape
    l_k = k.shape[2]
    u_part, u = sample_sizes(l_q, l_k, factor)
    if m_top is None:
        if index_sample is None:
            index_sample = sample_keys(l_q, l_k, u_part, generator, q.device)
        m_top = top_queries(q, k, index_sample.to(q.device, torch.long),
                            u)
    rows = m_top.to(q.device, torch.long)[..., None].expand(b, h, u, d)
    q_reduce = torch.gather(q, 2, rows)
    scores = torch.matmul(widen(q_reduce), widen(k).transpose(-1, -2))
    scores = scores * (scale or 1.0 / math.sqrt(d))
    if mask_flag:
        if l_q != l_k:
            raise ValueError(
                "masked ProbSparse attention requires L_Q == L_K "
                f"(self-attention only), got {l_q} != {l_k}")
        context = torch.cumsum(widen(v), dim=-2).to(v.dtype)
        causal = (torch.arange(l_k, device=q.device)[None, None, None, :]
                  > rows[..., :1])
        scores = scores.masked_fill(causal, -math.inf)
    else:
        context = widen(v).mean(dim=-2, keepdim=True).to(v.dtype).expand(
            b, h, l_q, d)
    attn = torch.softmax(scores, dim=-1)
    top_ctx = matmul16(attn.to(v.dtype), v)
    return context.scatter(2, rows, top_ctx), None
