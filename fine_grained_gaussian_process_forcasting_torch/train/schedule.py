"""Noam learning-rate schedule + Adam, global-norm clipping, and the
non-finite guard's arithmetic.

Counterpart of the JAX package's ``train/schedule.py`` (the reference's
``NoamOpt(Adam(lr=0, betas=(0.9, 0.98), eps=1e-9), 2, d_model, w_steps)``):
lr(n) = lr_mul * d_model^-0.5 * min(n^-0.5, n * warmup^-1.5), with n = 1 on
the first update.  ``clip_by_global_norm`` and ``all_finite`` follow
``optax.clip_by_global_norm`` and ``optax.apply_if_finite``.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence

import torch

#: consecutive non-finite steps the ``skip`` guard drops before it lets an
#: update through again (``optax.apply_if_finite``'s max_consecutive_errors)
MAX_CONSECUTIVE_ERRORS = 10


def noam_schedule(d_model: int, warmup_steps: int,
                  lr_mul: float = 2.0) -> Callable[[int], float]:
    """lr as a function of the count of updates already applied (0 on the
    first update)."""

    def schedule(count: int) -> float:
        n = count + 1.0  # the reference increments before computing
        return lr_mul * d_model ** -0.5 * min(n ** -0.5,
                                              n * warmup_steps ** -1.5)

    return schedule


class NoamAdam(torch.optim.Adam):
    """``torch.optim.Adam`` whose learning rate follows the Noam law.

    Each param group keeps ``count``, the number of updates applied, so the
    schedule travels with ``state_dict()`` and a step the caller does not
    take does not advance it.
    """

    def __init__(self, params, schedule: Callable[[int], float]):
        super().__init__(params, lr=schedule(0), betas=(0.9, 0.98),
                         eps=1e-9)
        self.schedule = schedule
        for group in self.param_groups:
            group.setdefault("count", 0)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            group["lr"] = self.schedule(group["count"])
        loss = super().step(closure)
        for group in self.param_groups:
            group["count"] += 1
        return loss


def noam_adam(params: Iterable[torch.Tensor], d_model: int,
              warmup_steps: int = 4000, lr_mul: float = 2.0) -> NoamAdam:
    """Adam (betas (0.9, 0.98), eps 1e-9) stepped by the Noam law."""
    return NoamAdam(params, noam_schedule(d_model, warmup_steps, lr_mul))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float,
                        weights: Optional[Sequence[float]] = None,
                        reduce: Optional[Callable] = None) -> None:
    """In place, as ``optax.clip_by_global_norm``: each g becomes
    g / |g| * max_norm when the global norm |g| >= max_norm, and stays as
    it is otherwise (no epsilon, unlike ``clip_grad_norm_``).  No host
    synchronisation.

    On a mesh ``reduce`` sums a 0-d tensor over every rank and ``weights``
    gives each leaf's share (1 / the ranks that hold the same elements), so
    that |g| is the norm of the whole gradient, the same on every rank."""
    norms = torch.stack(torch._foreach_norm(list(grads)))
    if reduce is None:
        norm = torch.linalg.vector_norm(norms)
    else:
        share = torch.as_tensor(weights, dtype=norms.dtype,
                                device=norms.device)
        norm = torch.sqrt(reduce((norms * norms * share).sum()))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def all_finite(tensors: Sequence[torch.Tensor],
               reduce: Optional[Callable] = None) -> torch.Tensor:
    """0-d bool tensor on the tensors' device: every element is finite.
    (x * 0 is 0 for finite x and NaN for inf or NaN.)  On a mesh
    ``reduce`` sums over every rank, so every rank decides alike."""
    zeros = torch._foreach_mul(list(tensors), 0.0)
    ok = torch.stack(torch._foreach_norm(zeros)).eq(0).all()
    if reduce is None:
        return ok
    return reduce((~ok).to(torch.float32)).eq(0)
