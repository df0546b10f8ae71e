"""Multi-seed training: N independent replicas of one model, one step per
batch for all of them (counterpart of the JAX package's
``train/multiseed.py``).

The reference's protocol trains 3 seeds one after the other.  Here the
seeds are a leading axis: every parameter and Adam moment is stacked by
seed, and one training step runs the model's forward under
``torch.func.vmap`` over that axis (``torch.func.functional_call`` on the
stacked parameters, the batch shared), so that each op runs once for all
seeds.  The hand kernels take the axis through their Functions' ``vmap``
rules: the fused GP and the rbf cross-covariance as their seed axes (one
launch sequence for all seeds), the attention kernels and the Cholesky
with the seeds folded into their batch, and the LSTM backbone as one cuDNN
call per seed on that seed's weights.  The summed
losses take one ordinary ``backward()``; the seeds share nothing, so each
seed's gradient is its own loss's.  Noam-Adam is elementwise, so Adam over
the stacked tensors is each seed's Adam, with each seed's own update count.

Each seed has its own parameters, optimizer state and random stream: its
step noise (the isotropic mode's draws, the hidden GP layers' eps and
informer's key samples) comes from its own ``torch.Generator``, drawn
outside the vmapped call through the model's ``noise_draws`` (the helper
the single-seed forward draws through) and passed in.  The exact GP's
jitter is picked on the device from each seed's own probes.  The result
equals N sequential ``Trainer`` runs with the same seeds (pinned by
``tests/test_torch_multiseed.py`` and
``tests/test_torch_multiseed_options.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional, Sequence, Union

import torch
from torch.utils import _pytree as pytree

from fine_grained_gaussian_process_forcasting_torch.device import resolve_device
from fine_grained_gaussian_process_forcasting_torch.train.schedule import (
    MAX_CONSECUTIVE_ERRORS,
    noam_schedule,
)
from fine_grained_gaussian_process_forcasting_torch.train.trainer import (
    NonFiniteLossError,
    Trainer,
)

_BETAS, _EPS = (0.9, 0.98), 1e-9  # the reference's Adam, as noam_adam's


@dataclasses.dataclass
class MultiSeedState:
    """params: the model's parameters stacked by seed, (n_seeds, ...) each;
    opt_state: Adam's moments ("exp_avg", "exp_avg_sq", stacked as the
    parameters), each seed's update count ("count") and, for the ``skip``
    guard, its run of non-finite steps ("notfinite_count"); rngs: each
    seed's generator state."""

    params: dict
    opt_state: dict
    rngs: list
    step: int = 0


class MultiSeedTrainer:
    """N-seed version of ``train.Trainer`` (the same model contract, the
    same optimizer, clipping and guards, applied to each seed)."""

    def __init__(self, model: torch.nn.Module, d_model: int, n_seeds: int,
                 warmup_steps: int = 4000, lr_mul: float = 2.0,
                 clip_grad_norm: float = 0.0, nonfinite_guard: str = "off",
                 *, device="cuda"):
        """``nonfinite_guard`` as in ``train.Trainer``, seed by seed: 'skip'
        drops a seed's update whose gradients are not finite (its own run
        of such steps counted); 'raise' checks once, at the epoch's end, and
        names the seed indices; 'off' reads nothing on the host.
        ``clip_grad_norm > 0`` clips each seed's global gradient norm."""
        if nonfinite_guard not in ("off", "raise", "skip"):
            raise ValueError(f"nonfinite_guard={nonfinite_guard!r}")
        if n_seeds < 1:
            raise ValueError(f"n_seeds={n_seeds}")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.n_seeds = n_seeds
        self.schedule = noam_schedule(d_model, warmup_steps, lr_mul)
        self.clip_grad_norm = clip_grad_norm
        self.nonfinite_guard = nonfinite_guard
        self.generators = [torch.Generator(device=self.device)
                           for _ in range(n_seeds)]
        self._names = [n for n, _ in self.model.named_parameters()]

    # ------------------------------------------------------------------ #

    def init_state(self, seeds: Sequence[int],
                   params: Union[None, Sequence[Mapping[str, torch.Tensor]],
                                 Callable[[int], Mapping]] = None
                   ) -> MultiSeedState:
        """The first state: seed i's parameters from ``params[i]`` (state
        dicts, e.g. ``params.from_flax``), or ``params(seeds[i])``, or
        without either the model's own for every seed; fresh Adam moments;
        seed i's generator seeded with ``seeds[i]``, as
        ``Trainer.init_state(seed=)`` seeds its own."""
        seeds = [int(s) for s in seeds]
        if len(seeds) != self.n_seeds:
            raise ValueError(f"{len(seeds)} seeds for {self.n_seeds} "
                             "replicas")
        if params is None:
            per = [self.model.state_dict()] * self.n_seeds
        elif callable(params):
            per = [params(s) for s in seeds]
        else:
            per = list(params)
        stacked = {
            name: torch.stack([torch.as_tensor(p[name]).to(self.device)
                               for p in per]).detach().requires_grad_()
            for name in self._names}
        opt_state = {
            "exp_avg": {k: torch.zeros_like(v) for k, v in stacked.items()},
            "exp_avg_sq": {k: torch.zeros_like(v)
                           for k, v in stacked.items()},
            "count": [0] * self.n_seeds,
            "notfinite_count": [0] * self.n_seeds}
        for g, s in zip(self.generators, seeds):
            g.manual_seed(s)
        return MultiSeedState(params=stacked, opt_state=opt_state,
                              rngs=[g.get_state() for g in self.generators])

    device_put_split = Trainer.device_put_split

    # ------------------------------------------------------------------ #

    def _draws(self, generators, enc, dec, training: bool) -> dict:
        """Each seed's step noise from its own generator, stacked by seed."""
        per = [self.model.noise_draws(enc.shape[0], enc.shape[1],
                                      dec.shape[1], training, g, self.device)
               for g in generators]
        if not per[0]:
            return {}
        return pytree.tree_map(lambda *ts: torch.stack(ts), *per)

    def _forward(self, params, draws, enc, dec, y, training: bool):
        """(loss, mse, predictions), each with the seed axis: the model
        under ``torch.func.vmap`` over the stacked parameters and draws."""
        buffers = dict(self.model.named_buffers())

        def one_seed(p, draw):
            out = torch.func.functional_call(
                self.model, {**p, **buffers}, (enc, dec, y),
                dict(training=training, **draw))
            return out.loss, out.mse, out.predictions

        return torch.func.vmap(one_seed, in_dims=(0, 0 if draws else None))(
            params, draws)

    @torch.no_grad()
    def _clip(self, grads) -> None:
        """Each seed's gradients scaled to its global norm
        ``clip_grad_norm`` where that norm is at least it
        (``optax.clip_by_global_norm``, seed by seed)."""
        s = self.n_seeds
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.reshape(s, -1), dim=1)
             for g in grads], dim=1), dim=1)
        keep = norm < self.clip_grad_norm
        for g in grads:
            lead = (s,) + (1,) * (g.dim() - 1)  # each seed's against its rows
            g.copy_(torch.where(keep.view(lead), g,
                                g / norm.view(lead) * self.clip_grad_norm))

    def _finite(self, grads) -> torch.Tensor:
        """(S,) bool on the device: each seed's gradients all finite."""
        s = self.n_seeds
        return torch.stack([torch.isfinite(g.reshape(s, -1)).all(1)
                            for g in grads]).all(0)

    @torch.no_grad()
    def _adam(self, state: MultiSeedState, grads, apply: Sequence[bool]):
        """Noam-Adam on the seeds in ``apply``: ``torch.optim.Adam``'s
        foreach arithmetic, all seeds at once where they share an update
        count (the usual case), else seed by seed on their slices."""
        opt = state.opt_state
        params = list(state.params.values())
        ms, vs = list(opt["exp_avg"].values()), list(opt["exp_avg_sq"].values())
        chosen = [i for i in range(self.n_seeds) if apply[i]]
        counts = {opt["count"][i] for i in chosen}
        if len(chosen) == self.n_seeds and len(counts) == 1:
            groups = [(counts.pop(), slice(None))]
        else:
            groups = [(opt["count"][i], i) for i in chosen]
        b1, b2 = _BETAS
        for count, at in groups:
            step = count + 1
            bc2_sqrt = (1 - b2 ** step) ** 0.5
            step_size = (self.schedule(count) / (1 - b1 ** step)) * -1
            p_, m_, v_, g_ = ([t[at] for t in ts]
                              for ts in (params, ms, vs, grads))
            torch._foreach_lerp_(m_, g_, 1 - b1)
            torch._foreach_mul_(v_, b2)
            torch._foreach_addcmul_(v_, g_, g_, 1 - b2)
            denom = torch._foreach_sqrt(v_)
            torch._foreach_div_(denom, bc2_sqrt)
            torch._foreach_add_(denom, _EPS)
            torch._foreach_addcdiv_(p_, m_, denom, step_size)
        for i in chosen:
            opt["count"][i] += 1

    def _train_step(self, state: MultiSeedState, enc, dec, y):
        """One update of every seed; returns (loss, mse, ok), each (S,) on
        the device, ok (for ``raise``) loss and gradients finite."""
        params = state.params
        for p in params.values():
            p.grad = None
        draws = self._draws(self.generators, enc, dec, True)
        loss, mse, _ = self._forward(params, draws, enc, dec, y, True)
        loss.sum().backward()  # each seed's gradient is its own loss's
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params.values()]
        ok = (None if self.nonfinite_guard == "off"
              else self._finite(grads))  # before clipping, as optax
        if self.clip_grad_norm and self.clip_grad_norm > 0:
            self._clip(grads)
        apply = [True] * self.n_seeds
        if self.nonfinite_guard == "skip":
            bad = state.opt_state["notfinite_count"]
            for i, fine in enumerate(ok.tolist()):  # one read a step
                bad[i] = 0 if fine else bad[i] + 1
                apply[i] = bad[i] == 0 or bad[i] > MAX_CONSECUTIVE_ERRORS
        self._adam(state, grads, apply)
        if self.nonfinite_guard == "raise":
            ok = ok & torch.isfinite(loss)
        return loss.detach(), mse.detach(), ok

    def gradients(self, state: MultiSeedState, batch):
        """One step's per-seed losses, (n_seeds,), and gradients, {name:
        (n_seeds, ...)}, at ``state`` on ``batch`` = (enc, dec, y), without
        the update: the state, its generators included, is left as it
        is."""
        generators = []
        for rng in state.rngs:
            g = torch.Generator(device=self.device)
            g.set_state(rng)
            generators.append(g)
        enc, dec, y = batch
        params = {k: v.detach().clone().requires_grad_()
                  for k, v in state.params.items()}
        loss, _, _ = self._forward(
            params, self._draws(generators, enc, dec, True), enc, dec, y,
            True)
        loss.sum().backward()
        return loss.detach(), {k: p.grad if p.grad is not None
                               else torch.zeros_like(p)
                               for k, p in params.items()}

    def train_epoch(self, state: MultiSeedState, data):
        """One pass over ``data`` = (enc, dec, y) tensors on the device, each
        (n_batches, batch, ...), for every seed.  Returns the new state and
        each seed's sums of the per-step losses and MSEs, (n_seeds,) numpy
        arrays.  The state's tensors advance in place (clone them to keep
        them), as the JAX trainer donates its state; under ``raise`` a
        failed epoch leaves them as they were."""
        enc, dec, y = data
        for g, rng in zip(self.generators, state.rngs):
            g.set_state(rng)
        before = (pytree.tree_map(
            lambda t: t.detach().clone() if isinstance(t, torch.Tensor)
            else t, (state.params, state.opt_state))
            if self.nonfinite_guard == "raise" else None)
        losses, mses, oks = [], [], []
        for i in range(enc.shape[0]):
            loss, mse, ok = self._train_step(state, enc[i], dec[i], y[i])
            losses.append(loss)
            mses.append(mse)
            oks.append(ok)
        if self.nonfinite_guard == "raise":  # one read, at the epoch's end
            bad = ~torch.stack(oks).all(0)
            if bool(bad.any()):
                params, opt = before
                with torch.no_grad():
                    for k, v in params.items():
                        state.params[k].copy_(v)
                    for key in ("exp_avg", "exp_avg_sq"):
                        for k, v in opt[key].items():
                            state.opt_state[key][k].copy_(v)
                state.opt_state["count"][:] = opt["count"]
                seeds = torch.nonzero(bad).flatten().tolist()
                raise NonFiniteLossError(
                    f"non-finite training loss or gradient for seed indices "
                    f"{seeds} in the epoch ending at global step "
                    f"{state.step + enc.shape[0]}", step=state.step)
        new = MultiSeedState(params=state.params, opt_state=state.opt_state,
                             rngs=[g.get_state() for g in self.generators],
                             step=state.step + enc.shape[0])
        return (new, torch.stack(losses).sum(0).double().cpu().numpy(),
                torch.stack(mses).sum(0).double().cpu().numpy())

    def eval_epoch(self, state: MultiSeedState, data):
        """Each seed's (sum of losses, sum of MSEs), (n_seeds,) numpy
        arrays, and predictions (n_seeds, n_batches, batch, pred_len, 1),
        with fresh step noise per batch from each seed's generator state,
        which is not consumed (as ``Trainer.eval_epoch``)."""
        enc, dec, y = data
        generators = []
        for rng in state.rngs:
            g = torch.Generator(device=self.device)
            g.set_state(rng)
            generators.append(g)
        losses, mses, preds = [], [], []
        with torch.no_grad():
            for i in range(enc.shape[0]):
                draws = self._draws(generators, enc[i], dec[i], False)
                loss, mse, pred = self._forward(state.params, draws, enc[i],
                                                dec[i], y[i], False)
                losses.append(loss)
                mses.append(mse)
                preds.append(pred)
        return (torch.stack(losses).sum(0).double().cpu().numpy(),
                torch.stack(mses).sum(0).double().cpu().numpy(),
                torch.stack(preds, dim=1))

    def seed_params(self, state: MultiSeedState, i: int) -> dict:
        """Seed i's state dict (copies), as ``Trainer``, ``save_checkpoint``
        and ``ExperimentHarness.evaluate`` take one."""
        return {k: (state.params[k][i] if k in state.params else v).detach()
                .clone() for k, v in self.model.state_dict().items()}
