"""AutoCorrelation's top-k delays, taken by the reference or replayed.

The delays are a discrete choice: the k lags of largest correlation.  Where
the k-th and the next lag's correlations lie within rounding of each other,
two correct programs may choose differently, and each choice gives another
(equally right) output.  So the reference replays the lags that the
program recorded, and judges them apart: ``lag_gap`` is how far the weakest
replayed lag lies below the reference's own k-th best, over the row's
largest correlation.  A program that takes the top-k reads a rounding-sized
gap at a near-tie and 0 elsewhere; one that takes other lags reads the
shortfall of what it took.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch


class Choices:
    """The selector the reference's AutoCorrelation calls: ``(scores, k)``
    -> (n, k) lags, scores (n, L), rows independent.  Calls are numbered in
    the order the forward makes them; ``forced`` maps a call to the (n, k)
    lags it must take, and the others take the reference's own top-k.
    ``chosen`` keeps each call's lags, ``lag_gap`` the widest shortfall of
    a forced set (0 where every forced set is a top-k), ``flips`` the rows
    whose forced set is not the reference's own top-k."""

    def __init__(self, forced: Optional[Dict[int, torch.Tensor]] = None):
        self.forced = dict(forced or {})
        self.chosen: List[torch.Tensor] = []
        self.lag_gap, self.flips = 0.0, 0

    def __call__(self, scores: torch.Tensor, k: int) -> torch.Tensor:
        i = len(self.chosen)
        s = scores.detach().float()
        best = torch.topk(s, k, dim=-1)
        if i in self.forced:
            lags = self.forced[i].to(scores.device)
            weakest = torch.gather(s, -1, lags).amin(-1)
            scale = s.abs().amax(-1).clamp_min(1e-30)
            short = (best.values[:, k - 1] - weakest).clamp_min(0) / scale
            self.lag_gap = max(self.lag_gap, float(short.max()))
            self.flips += int((lags.sort(-1).values
                               != best.indices.sort(-1).values).any(-1).sum())
        else:
            lags = best.indices
        self.chosen.append(lags.cpu())
        return lags
