"""The random draws a forward takes, recorded or replayed.

The model draws at three places: the isotropic mode's noise and the hidden
GP layers' eps (``models/forecast_denoising.py`` ``noise_draws``,
``gp/deep_gp.py`` ``draw_eps``) and informer's key sample
(``ops/probsparse.py`` ``sample_keys``).  Each takes a ``torch.Generator``
or, in its place, a ``DrawTape``: a tape made with a generator draws from
it and keeps every draw in order; a tape made from such draws hands them
back in the same order.  The serving session draws from a fixed seed-0
generator every batch, as JAX's passes ``PRNGKey(0)``; ``torch.export``
cannot carry a generator, so the exported forward replays the draws the
session takes, held in the artifact as constants.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch


class DrawTape:
    """Records the draws of ``generator`` or replays ``draws``."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 draws: Optional[Sequence[torch.Tensor]] = None):
        if (generator is None) == (draws is None):
            raise ValueError("give a generator to record or draws to replay")
        self.generator = generator
        self.draws: List[torch.Tensor] = [] if draws is None else list(draws)
        self.replaying = draws is not None
        self._next = 0

    def _take(self, shape, dtype, draw):
        if not self.replaying:
            out = draw()
            self.draws.append(out)
            return out
        if self._next >= len(self.draws):
            raise RuntimeError(f"the tape holds {len(self.draws)} draws; "
                               "this forward takes more")
        out = self.draws[self._next]
        self._next += 1
        if tuple(out.shape) != tuple(shape) or out.dtype != dtype:
            raise RuntimeError(
                f"draw {self._next - 1} on the tape is {tuple(out.shape)} "
                f"{out.dtype}, this forward asks for {tuple(shape)} {dtype}")
        return out


def randn(shape, generator, *, dtype=torch.float32, device=None):
    """N(0, 1) draws of ``shape`` from a generator or a tape."""
    if isinstance(generator, DrawTape):
        return generator._take(shape, dtype, lambda: torch.randn(
            shape, generator=generator.generator, dtype=dtype, device=device))
    return torch.randn(shape, generator=generator, dtype=dtype, device=device)


def randint(high: int, shape, generator, *, device=None):
    """Integers uniform in [0, high) of ``shape`` from a generator or a
    tape."""
    if isinstance(generator, DrawTape):
        return generator._take(shape, torch.int64, lambda: torch.randint(
            0, high, shape, generator=generator.generator, device=device))
    return torch.randint(0, high, shape, generator=generator, device=device)
