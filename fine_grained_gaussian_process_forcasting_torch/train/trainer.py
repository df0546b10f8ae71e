"""Training loop (counterpart of the JAX package's ``train/trainer.py``).

The JAX trainer runs an epoch as one ``lax.scan`` inside one jit.  Here an
epoch is a Python loop over batches that are already on the device; the
forward and backward run through the CUDA kernels on the card.  Losses and
the per-step health flags stay on the device until the epoch ends, so the
``off`` and ``raise`` guards read nothing back per step.  The ``skip``
guard reads one flag per step: whether the update is applied decides the
next step's learning rate on the host.

On a mesh (``mesh=``, ``parallel.make_mesh``; one process a rank) each rank
trains on its slice of every batch (``device_put_split``) with its part of
the parameters (``parallel.sharding.ShardedParams``: the heads and hidden
units of its 'model' slot; with ``fsdp`` a 1/n_data shard of each leaf the
FSDP rule shards, and of its Adam moments).  A step's draws are the
single-device step's (the global batch's, from the one seeded generator,
sliced), its gradient that of the global mean loss, and the norm clipping
and the non-finite guard decide on every shard's gradients at once, so every
rank applies the same update and a step equals the single-device step.

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
import os
from typing import Mapping, Optional, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from fine_grained_gaussian_process_forcasting_torch.data.window import (
    BatchedSplit,
)
from fine_grained_gaussian_process_forcasting_torch.device import resolve_device
from fine_grained_gaussian_process_forcasting_torch.parallel import mesh as pm
from fine_grained_gaussian_process_forcasting_torch.parallel.sharding import (
    ShardedParams,
)
from fine_grained_gaussian_process_forcasting_torch.train.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from fine_grained_gaussian_process_forcasting_torch.train.schedule import (
    GUARD_START,
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
        if fsdp and mesh is None:
            raise ValueError("fsdp=True needs a mesh (parallel.make_mesh)")
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh= takes a DeviceMesh (parallel.make_mesh), "
                            f"not {type(mesh).__name__}")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.d_model, self.warmup_steps, self.lr_mul = (d_model,
                                                        warmup_steps, lr_mul)
        self.clip_grad_norm = clip_grad_norm
        self.nonfinite_guard = nonfinite_guard
        self.mesh, self.fsdp = mesh, fsdp
        self.sharded = None
        if mesh is not None:
            self.sharded = ShardedParams(self.model, mesh, fsdp)
        self.generator = torch.Generator(device=self.device)
        self.optimizer = self._new_optimizer()
        self._live: Optional[TrainState] = None

    def _opt_params(self) -> list:
        return (self.sharded.opt_params() if self.sharded
                else list(self.model.parameters()))

    def _new_optimizer(self):
        opt = noam_adam(self._opt_params(), self.d_model,
                        self.warmup_steps, self.lr_mul)
        opt.param_groups[0].update(GUARD_START)
        return opt

    def _state_dict(self) -> dict:
        """The rank's storage: the model's state dict, a shard in place of
        each FSDP leaf."""
        return (self.sharded.local_state() if self.sharded
                else self.model.state_dict())

    def _load(self, params: Mapping[str, torch.Tensor]) -> None:
        if self.sharded:
            self.sharded.load_local_state(params)
        else:
            self.model.load_state_dict(params)

    # ------------------------------------------------------------------ #

    def init_state(self, params: Optional[Mapping[str, torch.Tensor]] = None,
                   seed: int = 0) -> TrainState:
        """The first state: the model's own initialisation, or ``params``
        (a state dict, e.g. ``params.from_flax(...)``); a fresh optimizer;
        the noise generator seeded with ``seed``."""
        self._release_live()
        if params is not None:
            if self.sharded:  # a whole state dict, put on the mesh
                self.sharded.install(params)
            else:
                self.model.load_state_dict(params)
        self.optimizer = self._new_optimizer()
        self.generator.manual_seed(seed)
        return self._view(step=0)

    def _view(self, step: int) -> TrainState:
        """The live state: the model's and optimizer's own tensors."""
        self._live = TrainState(params=self._state_dict(),
                                opt_state=self.optimizer.state_dict(),
                                rng=self.generator.get_state(), step=step)
        return self._live

    def _copy(self) -> TrainState:
        """Copies of the live tensors (``step`` is not tracked here)."""
        return TrainState(
            params={k: v.clone() for k, v in self._state_dict().items()},
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
        self._load(state.params)
        # load_state_dict keeps tensors already on the right device as they
        # are; a copy keeps the caller's state from being updated in place
        self.optimizer.load_state_dict(copy.deepcopy(state.opt_state))
        self.generator.set_state(state.rng)

    def device_put_split(self, split: BatchedSplit):
        """(enc, dec, y) of a batched split as float32 tensors on the
        device, each (n_batches, batch, ...); on a mesh this rank's rows of
        each batch (raises unless n_data divides the batch)."""
        rows = slice(None)
        if self.mesh is not None:
            rows = pm.batch_slice(self.mesh, np.shape(split.enc)[1])
        return tuple(torch.as_tensor(np.asarray(a[:, rows], np.float32),
                                     device=self.device)
                     for a in (split.enc, split.dec, split.y))

    def _forward(self, enc, dec, y, training: bool, generator):
        """The model on this rank's rows; on a mesh with the draws of the
        global batch, from ``generator`` as the single-device forward draws
        them, cut to those rows."""
        if self.mesh is None:
            return self.model(enc, dec, y, training=training,
                              generator=generator)
        batch = enc.shape[0] * self.sharded.data.size
        drawn = self.model.noise_draws(batch, enc.shape[1], dec.shape[1],
                                       training, generator, enc.device)
        rows = pm.batch_slice(self.mesh, batch)
        if "noise" in drawn:
            drawn["noise"] = tuple(t[rows] for t in drawn["noise"])
        if "gp_eps" in drawn:
            drawn["gp_eps"] = [t[rows] for t in drawn["gp_eps"]]
        return self.model(enc, dec, y, training=training,
                          generator=generator, **drawn)

    def _world_sum(self, t: torch.Tensor) -> torch.Tensor:
        return pm.all_reduce(t, self.sharded.world)

    def _data_mean(self, t: torch.Tensor) -> torch.Tensor:
        """Per-step values of this rank's rows -> the global batch's."""
        if self.mesh is None:
            return t
        return pm.all_reduce(t, self.sharded.data) / self.sharded.data.size

    # ------------------------------------------------------------------ #

    def _backward(self, enc, dec, y, generator):
        """A training forward and its backward: (the output, the optimized
        tensors), each ``.grad`` the gradient of the (global) mean loss."""
        params = self._opt_params()
        for p in params:
            p.grad = None
        if self.sharded:
            self.sharded.materialize()
        out = self._forward(enc, dec, y, True, generator)
        out.loss.backward()
        if self.sharded:  # the global mean's gradient, on every shard
            self.sharded.reduce_grads()
        for p in params:  # an unused parameter gets a zero gradient, as
            if p.grad is None:  # in JAX, so Adam's moments still decay
                p.grad = torch.zeros_like(p)
        return out, params

    def _train_step(self, enc, dec, y):
        """One update; returns (loss, mse, ok) with ok, for the ``raise``
        guard, a 0-d bool on the device: loss and gradients finite."""
        out, params = self._backward(enc, dec, y, self.generator)
        grads = [p.grad for p in params]
        # on a mesh over every shard, each leaf's elements counted once
        reduce, weights = None, None
        if self.sharded:
            reduce = self._world_sum
            weights = [1.0 / self.sharded.copies(n)
                       for n, _ in self.model.named_parameters()]
        grads_ok = (None if self.nonfinite_guard == "off"
                    else all_finite(grads, reduce))  # before clipping
        if self.clip_grad_norm and self.clip_grad_norm > 0:
            clip_by_global_norm(grads, self.clip_grad_norm, weights, reduce)
        if self.nonfinite_guard != "skip":
            self.optimizer.step()
        else:
            group = self.optimizer.param_groups[0]
            finite = bool(grads_ok)
            bad = 0 if finite else group["notfinite_count"] + 1
            group.update(notfinite_count=bad, last_finite=finite,
                         total_notfinite=group.get("total_notfinite", 0)
                         + (not finite))
            if bad == 0 or bad > MAX_CONSECUTIVE_ERRORS:
                self.optimizer.step()
        ok = (grads_ok & torch.isfinite(out.loss)
              if self.nonfinite_guard == "raise" else None)
        return out.loss.detach(), out.mse.detach(), ok

    def gradients(self, state: TrainState, batch):
        """One step's loss and gradients at ``state`` on ``batch`` = (enc,
        dec, y), one batch as ``device_put_split`` gives it, without the
        update; the state, its generator included, is left as it is.  On a
        mesh (a collective) the global batch's loss and every gradient
        whole, {name: tensor} as a single device's."""
        enc, dec, y = batch
        self._activate(state)
        generator = torch.Generator(device=self.device)
        generator.set_state(state.rng)
        out, params = self._backward(enc, dec, y, generator)
        grads = {}
        for (name, _), p in zip(self.model.named_parameters(), params):
            grads[name] = (self.sharded.full(name, p.grad) if self.sharded
                           else p.grad.detach().clone())
            p.grad = None
        return self._data_mean(out.loss.detach()), grads

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
        both = self._data_mean(torch.stack([torch.stack(losses),
                                            torch.stack(mses)]))
        return new, float(both[0].sum()), float(both[1].sum())

    def eval_epoch(self, state: TrainState, data):
        """(sum of losses, sum of MSEs, predictions (n_batches, batch,
        pred_len, 1)) with fresh isotropic noise per batch from the state's
        generator, which is not consumed.  On a mesh the global batch's:
        the same sums, and every rank's rows of the predictions on every
        rank."""
        enc, dec, y = data
        self._activate(state)
        generator = torch.Generator(device=self.device)
        generator.set_state(state.rng)
        losses, mses, preds = [], [], []
        if self.sharded:
            self.sharded.materialize()
        with torch.no_grad():
            for i in range(enc.shape[0]):
                out = self._forward(enc[i], dec[i], y[i], False, generator)
                losses.append(out.loss)
                mses.append(out.mse)
                preds.append(out.predictions)
        preds = torch.stack(preds)
        if self.sharded:
            self.sharded.release()
            preds = pm.all_gather(preds, self.sharded.data, dim=1)
        both = self._data_mean(torch.stack([torch.stack(losses),
                                            torch.stack(mses)]))
        return float(both[0].sum()), float(both[1].sum()), preds

    # -- checkpoint / resume ------------------------------------------- #

    def full_params(self, state: TrainState) -> dict:
        """The whole state dict of ``state``; on a mesh gathered from every
        rank's storage (a collective), as a single device holds it."""
        if self.sharded is None:
            return state.params
        return self.sharded.full_state(state.params)

    def save_state(self, path: str, name: str, state: TrainState) -> str:
        """Full-state checkpoint: parameters and optimizer state.  On a mesh
        every rank takes part and rank 0 writes one whole, unsharded
        checkpoint, a single device's."""
        if self.sharded is None:
            return save_checkpoint(path, name, state.params,
                                   opt_state=state.opt_state)
        params = self.full_params(state)
        opt_state = self.sharded.full_opt_state(state.opt_state)
        out = os.path.abspath(os.path.join(path, name))
        if self.sharded.world.rank == 0:
            save_checkpoint(path, name, params, opt_state=opt_state)
        torch.distributed.barrier()
        return out

    def restore_state(self, path: str, name: str, template: TrainState
                      ) -> TrainState:
        """A ``save_state`` checkpoint (a single device's or a mesh's); on a
        mesh put back sharded, as this trainer places it."""
        # on the CPU: the optimizer moves the moments to the parameters'
        # devices and keeps Adam's step counts on the host, where it wants
        payload = load_checkpoint(path, name)
        params, opt_state = payload["params"], payload["opt_state"]
        if self.sharded is not None:
            names = dict(self.model.named_parameters())
            params = {k: (self.sharded.local(k, v) if k in names else v)
                      for k, v in params.items()}
            opt_state = self.sharded.local_opt_state(opt_state)
        return TrainState(params=params, opt_state=opt_state,
                          rng=template.rng, step=template.step)

