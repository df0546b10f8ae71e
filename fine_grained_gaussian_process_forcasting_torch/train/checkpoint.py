"""Checkpoints keyed by model name (counterpart of the JAX package's
``train/checkpoint.py``, with ``torch.save`` in place of orbax).

A checkpoint is one file holding the model's state dict and, for a true
mid-run resume, the optimizer's.  It is written atomically: to a ``.tmp``
sibling first, then the old copy is renamed away and the new one renamed
into place, so a crash mid-save never loses the previous best.

The JAX package's checkpoints (orbax directories) carry over through
``payload_from_jax``: a restored ``{"params": ..., "opt_state": ...}`` tree
of numpy arrays becomes the payload ``save_checkpoint`` writes, under the
same model name (``scripts/convert_jax_checkpoints.py`` restores and
writes; this module imports nothing of JAX).  The parameters go through
``params.from_flax``; the optimizer state of the JAX ``noam_adam``, that is
``scale_by_adam``'s ``mu``/``nu``/``count`` (with ``scale_by_schedule``'s
count), optionally after ``clip_by_global_norm`` (no state) and under
``apply_if_finite`` (its three counters), through ``opt_state_from_optax``
into ``NoamAdam``'s state dict as the port's ``Trainer`` keeps it.  The
JAX ``TrainState.rng`` is not carried: the port cannot reproduce
``jax.random``'s draws.
"""

from __future__ import annotations

import os
import re
from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from fine_grained_gaussian_process_forcasting_torch.params import (
    from_flax,
    to_flax,
)
from fine_grained_gaussian_process_forcasting_torch.train.schedule import (
    GUARD_START,
    NoamAdam,
)


def save_checkpoint(model_path: str, model_name: str,
                    params: Mapping[str, torch.Tensor],
                    opt_state: Optional[Mapping[str, Any]] = None) -> str:
    """Write ``{"params": params, "opt_state": opt_state}`` (tensors moved
    to the CPU) to ``model_path/model_name``; returns the path."""
    path = os.path.abspath(os.path.join(model_path, model_name))
    tmp, old = path + ".tmp", path + ".old"
    payload = {"params": _to_cpu(params)}
    if opt_state is not None:
        payload["opt_state"] = _to_cpu(opt_state)
    torch.save(payload, tmp)
    if os.path.exists(old):
        os.remove(old)
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(tmp, path)
    if os.path.exists(old):
        os.remove(old)
    return path


def load_checkpoint(model_path: str, model_name: str,
                    map_location=None) -> dict:
    """The payload ``save_checkpoint`` wrote: ``{"params": ..., and
    "opt_state": ... if it was saved}``."""
    path = os.path.abspath(os.path.join(model_path, model_name))
    return torch.load(path, map_location=map_location, weights_only=True)


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, Mapping):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


# -- the JAX package's checkpoints -------------------------------------- #

# the fields of optax's states, in order: ScaleByAdamState,
# ScaleByScheduleState, ApplyIfFiniteState.  Restored with a template, a
# state is its NamedTuple; without one, orbax gives a dict keyed by field,
# a list for a tuple and None for clip_by_global_norm's EmptyState.
_ADAM = ("count", "mu", "nu")
_SCHEDULE = ("count",)
_GUARD = ("notfinite_count", "last_finite", "total_notfinite",
          "inner_state")
# the zero input-gate bias ``from_flax`` adds to an LSTM layer: a buffer of
# the port's, no Flax leaf
_BIAS_IH = re.compile(r"(?:^|\.)(?:lstm|cell)\.bias_ih_l\d+$")


def _shape_of(node) -> str:
    if isinstance(node, Mapping):
        return f"a dict of {sorted(node)}"
    if isinstance(node, (tuple, list)):
        return f"a {type(node).__name__} of {len(node)}"
    return type(node).__name__


def _fields(node, names: Sequence[str], what: str) -> list:
    """The fields ``names`` of one optax state, as a NamedTuple or as
    orbax's dict."""
    if isinstance(node, Mapping) and set(node) == set(names):
        return [node[n] for n in names]
    if isinstance(node, (tuple, list)) and len(node) == len(names):
        return list(node)
    raise ValueError(f"expected {what} ({', '.join(names)}), got "
                     f"{_shape_of(node)}")


def _optax_parts(tree, clip: bool, guard: bool):
    """(count, mu, nu, the guard's counters or None) of a ``noam_adam``
    state built with ``clip`` and ``guard``."""
    try:
        counters = None
        if guard:
            *counters, tree = _fields(tree, _GUARD, "apply_if_finite's state")
        if clip:
            empty, tree = _fields(tree, ("clip_by_global_norm", "adam"),
                                  "the clipped chain")
            if empty is not None and len(empty) != 0:
                raise ValueError(f"clip_by_global_norm's state holds "
                                 f"{_shape_of(empty)}")
        adam, schedule = _fields(tree, ("scale_by_adam", "scale_by_schedule"),
                                 "adam's chain")
        count, mu, nu = _fields(adam, _ADAM, "scale_by_adam's state")
        (schedule_count,) = _fields(schedule, _SCHEDULE,
                                    "scale_by_schedule's state")
    except ValueError as e:
        raise ValueError(f"{e}: not the state of noam_adam with clipping "
                         f"{'on' if clip else 'off'} and the skip guard "
                         f"{'on' if guard else 'off'}") from None
    count, schedule_count = (int(np.asarray(c)) for c in (count,
                                                          schedule_count))
    if count != schedule_count:
        raise ValueError(f"adam's count {count} and the schedule's "
                         f"{schedule_count} differ")
    return count, mu, nu, counters


def _check_keys(got, want, what: str) -> None:
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"{what} does not match the model: missing "
                         f"{missing}, unexpected {extra}")


def _moments(tree, keys: Sequence[str], what: str) -> dict:
    """A Flax-shaped moment tree -> {name: tensor} over ``keys``."""
    state = from_flax(tree)
    state = {k: v for k, v in state.items()
             if k in keys or not _BIAS_IH.search(k)}
    _check_keys(state, keys, what)
    return state


def opt_state_from_optax(tree, params_keys: Sequence[str], *,
                         clip: bool = False, guard: bool = False) -> dict:
    """The state of the JAX ``noam_adam`` (a tree of numpy arrays) -> the
    state dict of the port's ``NoamAdam`` as the ``Trainer`` keeps it.

    ``params_keys`` names the optimizer's parameters in its order (the
    model's ``named_parameters()``); ``clip`` and ``guard`` say how the
    chain was built (``clip_grad_norm > 0``, ``nonfinite_guard="skip"``).
    ``mu`` and ``nu`` take ``from_flax``'s leaf map, Adam's count becomes
    every parameter's ``step`` and the group's ``count``, and
    ``apply_if_finite``'s counters the guard's (``GUARD_START`` without the
    guard).  A tree that does not match raises, naming its leaves."""
    count, mu, nu, counters = _optax_parts(tree, clip, guard)
    keys = list(params_keys)
    mu, nu = _moments(mu, keys, "adam's mu"), _moments(nu, keys, "adam's nu")
    state = {i: {"step": torch.tensor(float(count)), "exp_avg": mu[k],
                 "exp_avg_sq": nu[k]} for i, k in enumerate(keys)}
    # Adam's defaults as this torch keeps them; NoamAdam sets lr from the
    # count before every update
    group = NoamAdam([torch.zeros(())], lambda n: 0.0).state_dict()[
        "param_groups"][0]
    group.update(GUARD_START, params=list(range(len(keys))), count=count)
    if counters is not None:
        bad, last, total = (np.asarray(c) for c in counters)
        group.update(notfinite_count=int(bad), last_finite=bool(last),
                     total_notfinite=int(total))
    return {"state": state, "param_groups": [group]}


def opt_state_to_optax(opt_state: Mapping[str, Any],
                       params: Mapping[str, torch.Tensor], *,
                       clip: bool = False, guard: bool = False):
    """The inverse of ``opt_state_from_optax``: a ``NoamAdam`` state dict
    -> the JAX ``noam_adam`` state as orbax restores it without a template
    (dicts keyed by field, lists for tuples, None for ``EmptyState``), of
    numpy arrays.  ``params`` maps the optimizer's parameters, in its
    order, to tensors of their shapes (``dict(model.named_parameters())``);
    a parameter not yet stepped has zero moments."""
    (group,) = opt_state["param_groups"]
    count = int(group["count"])
    mu, nu = {}, {}
    for i, (name, p) in enumerate(params.items()):
        entry = opt_state["state"].get(i)
        if entry is None:
            mu[name] = nu[name] = torch.zeros(p.shape)
            continue
        if int(entry["step"]) != count:
            raise ValueError(f"{name} took {int(entry['step'])} steps of "
                             f"the group's {count}: optax keeps one count")
        mu[name], nu[name] = entry["exp_avg"], entry["exp_avg_sq"]
    n = np.asarray(count, np.int32)
    tree = [{"count": n, "mu": to_flax(mu), "nu": to_flax(nu)},
            {"count": n.copy()}]
    if clip:
        tree = [None, tree]
    if guard:
        tree = {"notfinite_count": np.asarray(group["notfinite_count"],
                                              np.int32),
                "last_finite": np.asarray(group["last_finite"], np.bool_),
                "total_notfinite": np.asarray(group["total_notfinite"],
                                              np.int32),
                "inner_state": tree}
    return tree


def payload_from_jax(tree: Mapping[str, Any],
                     model: Optional[torch.nn.Module] = None, *,
                     clip: bool = False, guard: bool = False) -> dict:
    """A restored JAX checkpoint, ``{"params": ...}`` with
    ``"opt_state"`` where ``Trainer.save_state`` wrote one (numpy leaves),
    -> the payload ``save_checkpoint`` writes: ``{"params": state dict,
    "opt_state": NoamAdam state dict}``.  Given ``model``, the parameters
    must be its state dict's keys; the optimizer state needs it (its
    parameters' order).  A mismatch raises, naming the leaves."""
    if not isinstance(tree, Mapping) or "params" not in tree or not set(
            tree) <= {"params", "opt_state"}:
        raise ValueError(f"expected a checkpoint of params (and "
                         f"opt_state), got {_shape_of(tree)}")
    params = from_flax(tree["params"])
    if model is not None:
        _check_keys(params, model.state_dict(), "the checkpoint's params")
    payload = {"params": params}
    if "opt_state" in tree:
        if model is None:
            raise ValueError("an optimizer state needs the model (the order "
                             "of its parameters)")
        payload["opt_state"] = opt_state_from_optax(
            tree["opt_state"], [n for n, _ in model.named_parameters()],
            clip=clip, guard=guard)
    return payload
