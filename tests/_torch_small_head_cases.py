"""Inputs of the small-head attention tests, made with numpy from a seed.

Shared by the CPU tests (``test_torch_small_head.py``: the port's plain
versions against the JAX package's Pallas kernel in interpret mode) and the
card tests (``test_torch_gpu.py``: the CUDA kernels against the plain
versions), so that every card case has a CPU twin on the same inputs.
Imports numpy only: the card's machine has no JAX.
"""

import math

import numpy as np

# (b, h, Lq, Lk, d): the flagship's calls at a cut batch; every d from 1 to
# 8; a one-key row and a one-query head; Lq on both sides of the fused
# backward's limit (a head's rows in 64 KB of shared memory: 1152 rows at
# d 4, 608 at d 8, 960 at d 5); Lk past the streamed route's 512-key stage
# and past the forward's 1536-key chunk at d 4
SHAPES = [(4, 8, 192, 192, 4), (3, 8, 96, 96, 2), (2, 8, 96, 192, 8),
          (2, 3, 1030, 20, 5), (3, 2, 37, 600, 1), (2, 2, 70, 33, 3),
          (2, 3, 50, 61, 6), (2, 3, 45, 77, 7), (2, 2, 33, 1, 4),
          (1, 2, 1, 40, 8), (1, 2, 1152, 40, 4), (1, 2, 1153, 40, 4),
          (1, 2, 608, 30, 8), (1, 2, 609, 30, 8), (2, 2, 40, 700, 4),
          (1, 2, 20, 1600, 4)]

# scores that rise along the keys, in steps (log2 units a key) that put the
# forward's group sums (4 keys against the offset) just under ("under") and
# just over ("over") its rescale threshold of 2^8, or far past it ("steep")
RISING = {"under": 1.85, "over": 1.9, "steep": 3.0}
# one key scoring this far (log2 units) above the rest, at key 100 of 385:
# the forward keeps what it summed before ("keep"), restarts at that key
# ("restart"), or meets an exponential past 2^127 ("overflow")
JUMPS = {"keep": 20.0, "restart": 60.0, "overflow": 130.0}
# each at 40 query rows, where the card's forward runs 3 rows a lane, and
# at 192 ("..._192"), where it runs 6 (past 96 rows at d <= 4)
_BASE_CASES = [f"rising_{k}" for k in RISING] + [f"jump_{k}" for k in JUMPS]
SCORE_CASES = _BASE_CASES + [f"{c}_192" for c in _BASE_CASES]


def inputs(b, h, lq, lk, d, seed=0):
    """q, k, v, dO: standard normal float32, (b, h, L, d)."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, n, d)).astype(np.float32)
            for n in (lq, lk, lk, lq)]


def score_case(name, seed=0):
    """q, k, v, dO at d 4 whose scores follow ``name`` of SCORE_CASES: q's
    first component 1, k's first the score (in log2 units) times sqrt(d) /
    log2(e), the other components a tenth of a standard normal."""
    kind, what, *rows = name.split("_")
    b, h, d = 2, 3, 4
    lq = int(rows[0]) if rows else 40
    lk = 40 if kind == "rising" else 385
    q, k, v, do = inputs(b, h, lq, lk, d, seed)
    q[..., 1:] *= 0.1
    k[..., 1:] *= 0.1
    q[..., 0] = 1.0
    if kind == "rising":
        score = RISING[what] * np.arange(lk)
    else:
        score = np.zeros(lk)
        score[100] = JUMPS[what]
    k[..., 0] = (score * math.sqrt(d) / math.log2(math.e)).astype(np.float32)
    return q, k, v, do
