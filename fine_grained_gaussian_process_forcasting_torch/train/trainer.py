"""Training loop (counterpart of the JAX package's ``train/trainer.py``).

The JAX trainer runs an epoch as one ``lax.scan`` inside one jit.  Here an
epoch is a Python loop over batches that are already on the device; the
forward and backward run through the CUDA kernels on the card.  Losses and
the per-step health flags stay on the device until the epoch ends, so the
``off`` and ``raise`` guards read nothing back per step.  The ``skip``
guard reads one flag per step: whether the update is applied decides the
next step's learning rate on the host.

A state that ``init_state`` or ``train_epoch`` returns is the trainer's
live state: its tensors are the model's and the optimizer's own, so an
epoch that starts from it copies nothing, and that epoch advances it in
place (as the JAX trainer donates its state to the jitted epoch).  Any
other state (a restored checkpoint) is copied in.  Before the live tensors
are overwritten with another state, the live state is given copies of its
own, so it stays usable.  The ``raise`` guard keeps the state before the
epoch (the JAX trainer does not donate in that mode): after the error the
state passed in holds its values again.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from fine_grained_gaussian_process_forcasting_torch.data.window import (
    BatchedSplit,
)
from fine_grained_gaussian_process_forcasting_torch.device import resolve_device
from fine_grained_gaussian_process_forcasting_torch.train.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from fine_grained_gaussian_process_forcasting_torch.train.schedule import (
    MAX_CONSECUTIVE_ERRORS,
    all_finite,
    clip_by_global_norm,
    noam_adam,
)


@dataclasses.dataclass
class TrainState:
    params: dict  # the model's state dict (own tensors, on the device)
    opt_state: dict  # the optimizer's state dict (own tensors)
    rng: torch.Tensor  # state of the isotropic noise's generator
    step: int = 0


class NonFiniteLossError(RuntimeError):
    """Raised by ``nonfinite_guard='raise'`` with the offending step."""

    def __init__(self, msg: str, step: int = -1):
        super().__init__(msg)
        self.step = step


class Trainer:
    """Trains a ``ForecastDenoising``-like module whose forward takes
    (enc, dec, y, training=, generator=) and returns .loss/.mse/.predictions.
    """

    def __init__(self, model: torch.nn.Module, d_model: int,
                 warmup_steps: int = 4000, lr_mul: float = 2.0,
                 clip_grad_norm: float = 0.0, nonfinite_guard: str = "off",
                 *, device="cuda", mesh=None, fsdp: bool = False):
        """``nonfinite_guard``: 'off' = reference semantics; 'raise' = fail
        the epoch with the first non-finite step's index (loss or any
        gradient); 'skip' = drop an update whose gradients are not finite,
        leaving parameters and optimizer state untouched, until more than
        10 such steps come in a row (``optax.apply_if_finite``).
        ``clip_grad_norm > 0`` clips the global gradient norm before Adam.
        """
        if nonfinite_guard not in ("off", "raise", "skip"):
            raise ValueError(f"nonfinite_guard={nonfinite_guard!r}")
        if mesh is not None or fsdp:
            raise NotImplementedError(
                "mesh= and fsdp= are not ported yet (ROADMAP.md modules to "
                "port, item 13: parallel/mesh.py and parallel/sharding.py)")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.d_model, self.warmup_steps, self.lr_mul = (d_model,
                                                        warmup_steps, lr_mul)
        self.clip_grad_norm = clip_grad_norm
        self.nonfinite_guard = nonfinite_guard
        self.generator = torch.Generator(device=self.device)
        self.optimizer = self._new_optimizer()
        self._live: Optional[TrainState] = None

    def _new_optimizer(self):
        opt = noam_adam(self.model.parameters(), self.d_model,
                        self.warmup_steps, self.lr_mul)
        opt.param_groups[0]["notfinite_count"] = 0
        return opt

    # ------------------------------------------------------------------ #

    def init_state(self, params: Optional[Mapping[str, torch.Tensor]] = None,
                   seed: int = 0) -> TrainState:
        """The first state: the model's own initialisation, or ``params``
        (a state dict, e.g. ``params.from_flax(...)``); a fresh optimizer;
        the noise generator seeded with ``seed``."""
        self._release_live()
        if params is not None:
            self.model.load_state_dict(params)
        self.optimizer = self._new_optimizer()
        self.generator.manual_seed(seed)
        return self._view(step=0)

    def _view(self, step: int) -> TrainState:
        """The live state: the model's and optimizer's own tensors."""
        self._live = TrainState(params=self.model.state_dict(),
                                opt_state=self.optimizer.state_dict(),
                                rng=self.generator.get_state(), step=step)
        return self._live

    def _copy(self) -> TrainState:
        """Copies of the live tensors (``step`` is not tracked here)."""
        return TrainState(
            params={k: v.clone() for k, v in self.model.state_dict().items()},
            opt_state=copy.deepcopy(self.optimizer.state_dict()),
            rng=self.generator.get_state(), step=0)

    def _release_live(self) -> None:
        """Give the live state copies of its own tensors, before the
        model's and optimizer's are overwritten."""
        if self._live is not None:
            own = self._copy()
            self._live.params, self._live.opt_state = (own.params,
                                                       own.opt_state)
            self._live = None

    def _activate(self, state: TrainState) -> None:
        """Make ``state`` the model's and optimizer's: nothing to do for
        the live state, a copy of any other."""
        if state is self._live:
            return
        self._release_live()
        self.model.load_state_dict(state.params)
        # load_state_dict keeps tensors already on the right device as they
        # are; a copy keeps the caller's state from being updated in place
        self.optimizer.load_state_dict(copy.deepcopy(state.opt_state))
        self.generator.set_state(state.rng)

    def device_put_split(self, split: BatchedSplit):
        """(enc, dec, y) of a batched split as float32 tensors on the
        device, each (n_batches, batch, ...)."""
        return tuple(torch.as_tensor(np.asarray(a, np.float32),
                                     device=self.device)
                     for a in (split.enc, split.dec, split.y))

    # ------------------------------------------------------------------ #

    def _train_step(self, enc, dec, y):
        """One update; returns (loss, mse, ok) with ok, for the ``raise``
        guard, a 0-d bool on the device: loss and gradients finite."""
        params = list(self.model.parameters())
        for p in params:
            p.grad = None
        out = self.model(enc, dec, y, training=True,
                         generator=self.generator)
        out.loss.backward()
        for p in params:  # an unused parameter gets a zero gradient, as
            if p.grad is None:  # in JAX, so Adam's moments still decay
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        grads_ok = (None if self.nonfinite_guard == "off"
                    else all_finite(grads))  # before clipping, as optax
        if self.clip_grad_norm and self.clip_grad_norm > 0:
            clip_by_global_norm(grads, self.clip_grad_norm)
        if self.nonfinite_guard != "skip":
            self.optimizer.step()
        else:
            group = self.optimizer.param_groups[0]
            bad = 0 if bool(grads_ok) else group["notfinite_count"] + 1
            group["notfinite_count"] = bad
            if bad == 0 or bad > MAX_CONSECUTIVE_ERRORS:
                self.optimizer.step()
        ok = (grads_ok & torch.isfinite(out.loss)
              if self.nonfinite_guard == "raise" else None)
        return out.loss.detach(), out.mse.detach(), ok

    def train_epoch(self, state: TrainState, data
                    ) -> Tuple[TrainState, float, float]:
        """One pass over ``data`` = (enc, dec, y) tensors on the device, each
        (n_batches, batch, ...).  Returns the new state and the sums of the
        per-step losses and MSEs."""
        enc, dec, y = data
        self._activate(state)
        before = self._copy() if self.nonfinite_guard == "raise" else None
        losses, mses, oks = [], [], []
        for i in range(enc.shape[0]):
            loss, mse, ok = self._train_step(enc[i], dec[i], y[i])
            losses.append(loss)
            mses.append(mse)
            oks.append(ok)
        if self.nonfinite_guard == "raise":  # one read, at the epoch's end
            bad = ~torch.stack(oks)
            if bool(bad.any()):
                first = int(torch.argmax(bad.to(torch.int32)))
                self._live = None  # the epoch's values are dropped
                self._activate(before)
                state.params = self.model.state_dict()
                state.opt_state = self.optimizer.state_dict()
                self._live = state
                raise NonFiniteLossError(
                    f"non-finite training loss at batch {first} of this "
                    f"epoch (global step ~{state.step + first})",
                    step=state.step + first)
        new = self._view(state.step + enc.shape[0])
        return (new, float(torch.stack(losses).sum()),
                float(torch.stack(mses).sum()))

    def eval_epoch(self, state: TrainState, data):
        """(sum of losses, sum of MSEs, predictions (n_batches, batch,
        pred_len, 1)) with fresh isotropic noise per batch from the state's
        generator, which is not consumed."""
        enc, dec, y = data
        self._activate(state)
        generator = torch.Generator(device=self.device)
        generator.set_state(state.rng)
        losses, mses, preds = [], [], []
        with torch.no_grad():
            for i in range(enc.shape[0]):
                out = self.model(enc[i], dec[i], y[i], training=False,
                                 generator=generator)
                losses.append(out.loss)
                mses.append(out.mse)
                preds.append(out.predictions)
        return (float(torch.stack(losses).sum()),
                float(torch.stack(mses).sum()), torch.stack(preds))

    # -- checkpoint / resume ------------------------------------------- #

    def save_state(self, path: str, name: str, state: TrainState) -> str:
        """Full-state checkpoint: parameters and optimizer state."""
        return save_checkpoint(path, name, state.params,
                               opt_state=state.opt_state)

    def restore_state(self, path: str, name: str, template: TrainState
                      ) -> TrainState:
        # on the CPU: the optimizer moves the moments to the parameters'
        # devices and keeps Adam's step counts on the host, where it wants
        payload = load_checkpoint(path, name)
        return TrainState(params=payload["params"],
                          opt_state=payload["opt_state"],
                          rng=template.rng, step=template.step)

