"""Operations and bytes from a configuration's shapes alone.

The count ignores which kernel runs: it is the model's arithmetic, as the
reference computes it.  Conventions:

- a product of an (m, k) by a (k, n) operand is 2 m k n operations;
- each FFT of length N (``rfft`` or ``irfft``) is 5 N log2 N;
- AutoCorrelation's aggregation (k weights times k rolled values) is
  2 k L d a sample;
- the Cholesky of the M x M Gram matrix and the triangular inverse are
  M^3 / 3 each;
- elementwise work (softmax, LayerNorm, exponentials, the loss) is not
  counted;
- a training step is the forward and its backward, with nothing counted
  twice that a backward could keep from the forward: each product's
  backward is two products of its size (one where an operand is input
  data), each FFT's one transform of its size, the GP's backward
  E zs, E^T xs, K^T (dvar o K) (symmetric: R M (M + 1)) and the small
  M x M work twice.
"""

from __future__ import annotations

import math


def _fft(n_transforms: float, length: int) -> float:
    return n_transforms * 5.0 * length * math.log2(length)


def _attention(b, lq, lk, d, hd, self_attn):
    """One AutoCorrelation attention call: its projections ("dense"), its
    transforms ("fft") and its aggregation."""
    if self_attn:
        dense = 2 * b * lq * d * 3 * hd
    else:
        dense = 2 * b * lq * d * hd + 2 * 2 * b * lk * d * hd
    dense += 2 * b * lq * hd * d  # fc
    top_k = int(math.log(lq))
    fft = _fft(2 * b * hd, lq) + _fft(b, lq)  # q, k; the mean's inverse
    return {"dense": dense, "fft": fft,
            "aggregation": 2 * b * top_k * lq * hd}


def _add(total, part, times=1):
    for k, v in part.items():
        total[k] = total.get(k, 0.0) + times * v


def forward(model: dict, batch: int, enc_len: int, dec_len: int) -> dict:
    """The forward's operations by kind: "dense" (projections and
    feed-forward of both transformer passes), "embedding", "fft",
    "aggregation", "gp" (the marginals' products over R = b (enc + dec)
    rows: the distance's cross term 2 R M d, the mean's 2 R d, K u 2 R M,
    K W 2 R M^2), "gp_small" (the M x M products: the Gram matrix, u, W)
    and "factorization" (Cholesky, triangular inverse)."""
    d, hd = model["d_model"], model["n_heads"] * model["d_k"]
    dff, m = model["d_ff"], model["num_inducing"]
    b, le, ld = batch, enc_len, dec_len
    rows = b * (le + ld)
    pass_ = {}
    for _ in range(model["stack_size"]):
        _add(pass_, _attention(b, le, le, d, hd, True))
        _add(pass_, {"dense": 2 * 2 * b * le * d * dff})
        _add(pass_, _attention(b, ld, ld, d, hd, True))
        _add(pass_, _attention(b, ld, le, d, hd, False))
        _add(pass_, {"dense": 2 * 2 * b * ld * d * dff})
    total = {}
    _add(total, pass_, 2)  # the forecaster, then the denoiser
    total["embedding"] = 2 * b * (le * model["src_input_size"]
                                  + ld * model["tgt_input_size"]) * d
    total["dense"] += (2 * rows * d  # proj_up
                       + 2 * b * model["pred_len"] * d)  # the output
    total["gp"] = 2 * rows * m * d + 2 * rows * d + 2 * rows * m \
        + 2 * rows * m * m
    total["gp_small"] = 2 * m * m * d + 2 * m * m + 2 * m ** 3
    total["factorization"] = 2 * m ** 3 / 3
    return total


def matmul_products(model: dict, batch: int, enc_len: int,
                    dec_len: int) -> float:
    """The forward's matrix products alone (what a counter of GEMMs
    sees): dense, embedding, gp, gp_small."""
    f = forward(model, batch, enc_len, dec_len)
    return f["dense"] + f["embedding"] + f["gp"] + f["gp_small"]


def step(model: dict, batch: int, enc_len: int, dec_len: int,
         train: bool) -> float:
    """Operations of one forward (``train`` False) or one training step
    (forward and backward) of one model."""
    f = forward(model, batch, enc_len, dec_len)
    total = sum(f.values())
    if not train:
        return total
    d, m = model["d_model"], model["num_inducing"]
    rows = batch * (enc_len + dec_len)
    gp_bwd = 4 * rows * m * d + rows * m * (m + 1) + 2 * rows * m \
        + 2 * rows * d
    back = (2 * f["dense"] + f["embedding"] + f["fft"]
            + 2 * f["aggregation"] + gp_bwd
            + 2 * (f["gp_small"] + f["factorization"]))
    return total + back


def fused_gp_work(model: dict, rows: int, bf16: bool) -> dict:
    """The fused GP marginals' least work at ``rows`` rows of one seed:
    {"fwd"|"bwd": {"fp32", "bf16", "exp", "bytes"}}.  The forward needs K
    (cross term 2 R M d, R M exponentials), K u, K W (2 R M^2) and the row
    sums; the backward, from its inputs alone, K and K W again, E zs,
    E^T xs and dW = -K^T (dvar o K) (R M (M + 1), symmetric).  The cross
    term is a float32 product in both variants (the points over their
    lengthscales are no bfloat16 numbers); the 16-bit variant's K W and dW
    are bfloat16 products.  Bytes: each input read once, each output
    written once, in float32."""
    d, m = model["d_model"], model["num_inducing"]
    r = rows
    fwd_kw = 2 * r * m * m
    bwd_big = 2 * r * m * m + r * m * (m + 1)
    fwd32 = 2 * r * m * d + 2 * r * m + 2 * r * m + 2 * r * d
    bwd32 = 3 * 2 * r * m * d + 2 * r * m + 2 * r * d
    params = m * d + m + m * m + 1 + 2 * d + 1  # zs, u, W, os, inv_ls, ...
    fwd_bytes = 4 * (r * d + params + 2 * r)
    bwd_bytes = 4 * (r * d + params + 2 * r + r * d + params)
    fwd = {"fp32": fwd32 + (0 if bf16 else fwd_kw),
           "bf16": fwd_kw if bf16 else 0, "exp": r * m, "bytes": fwd_bytes}
    bwd = {"fp32": bwd32 + (0 if bf16 else bwd_big),
           "bf16": bwd_big if bf16 else 0, "exp": r * m, "bytes": bwd_bytes}
    return {"fwd": fwd, "bwd": bwd}


def least_seconds(work: dict) -> float:
    """The least time of one piece of work on any design, the largest of:
    its float32 operations over both units that deliver float32, the CUDA
    cores' FMAs and the tensor cores (``PEAK_FP32_SPLIT``), the tensor
    cores' share less what its bfloat16 operations take of them; its
    bfloat16 operations on the tensor cores alone; its exponentials; its
    bytes at the memory's peak.  (With F float32 and B bfloat16
    operations, F - x on the tensor cores: x <= PEAK_FP32 T and
    (F - x) / PEAK_FP32_SPLIT + B / PEAK_BF16 <= T give the first.)"""
    from benchmark.harness.peaks import (
        PEAK_BF16,
        PEAK_BYTES,
        PEAK_EXP,
        PEAK_FP32,
        PEAK_FP32_SPLIT,
    )

    both = (work["fp32"] + work["bf16"] * PEAK_FP32_SPLIT / PEAK_BF16) / (
        PEAK_FP32 + PEAK_FP32_SPLIT)
    return max(both, work["bf16"] / PEAK_BF16, work["exp"] / PEAK_EXP,
               work["bytes"] / PEAK_BYTES)
