"""Native hyper-parameter search (Optuna-equivalent for this framework).

The port's own copy of the JAX package's ``train/hpo.py`` (pure Python):
the same samplers, duplicate pruning and trial order.

The reference drives training through an Optuna study
(``train.py:82-103``) whose search space is a tiny categorical grid —
``d_model in {32,16} x stack_size in {1,3} x w_steps in {4000}``
(``train.py:117-119``) with duplicate-config pruning
(``train.py:121-123``), i.e. effectively an exhaustive grid of 4 points.
The baselines harness additionally attaches a ``TPESampler`` and a
``HyperbandPruner`` and runs trials thread-parallel
(``baselines.py:109-110``, ``train.py:86``).

This module provides a dependency-free study object with the same call
surface (``suggest_categorical`` / ``optimize`` / ``best_trial`` /
``get_trials``):

- sampler='grid' enumerates unseen grid points exhaustively;
- sampler='random' draws uniformly;
- sampler='tpe' implements categorical TPE: observed trials are split
  into good/bad halves by value and each choice is drawn proportionally
  to (count_good + 1) / (count_bad + 1);
- duplicate configs are pruned *before* training runs — as soon as a
  trial's suggestions cover the space and match a seen config,
  ``suggest_categorical`` raises ``TrialPruned`` (the reference prunes at
  the same point, ``train.py:121-123``);
- ``optimize(n_jobs=k)`` runs trials thread-parallel like the
  reference's ``n_jobs=4`` (useful when each trial under-fills the chip;
  a single saturating trainer should keep the default 1).
"""

from __future__ import annotations

import dataclasses
import itertools
import random
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence


class TrialPruned(Exception):
    """Raised to abandon a trial (Optuna-compatible)."""


@dataclasses.dataclass
class Trial:
    number: int
    study: "Study"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    value: Optional[float] = None
    state: str = "RUNNING"  # RUNNING | COMPLETE | PRUNED
    assigned: Optional[Dict[str, Any]] = None
    intermediate: Dict[int, float] = dataclasses.field(default_factory=dict)

    def suggest_categorical(self, name: str, choices: Sequence[Any]) -> Any:
        choices = list(choices)
        self.study._space.setdefault(name, choices)
        if self.assigned is not None and name in self.assigned:
            value = self.assigned[name]
        elif self.study.sampler == "tpe":
            value = self.study._tpe_choice(name, choices)
        else:
            value = self.study._rng.choice(choices)
        self.params[name] = value
        # Early duplicate pruning: once this trial's suggestions cover the
        # known space and coincide with an already-run config, abandon it
        # before any training happens (reference: train.py:121-123).
        if len(self.params) >= len(self.study._space) and (
            self.study._is_duplicate(self.params)
        ):
            self.state = "PRUNED"
            raise TrialPruned(f"duplicate config {self.params}")
        return value

    # -- pruning API (Optuna-compatible; the reference's baselines study
    # attaches a HyperbandPruner, ``baselines.py:109``) ------------------ #

    def report(self, value: float, step: int) -> None:
        self.intermediate[int(step)] = float(value)

    def should_prune(self) -> bool:
        """Median rule: prune when the latest reported value is worse than
        the median of other trials' values at the same step (after a
        warmup of 5 steps)."""
        if not self.intermediate:
            return False
        step = max(self.intermediate)
        if step < 5:
            return False
        others = [
            t.intermediate[step]
            for t in self.study.trials
            if t is not self and step in t.intermediate
        ]
        if not others:
            return False
        median = sorted(others)[len(others) // 2]
        return self.intermediate[step] > median


class Study:
    """Minimizing study over an ``objective(trial) -> float`` callable."""

    def __init__(self, study_name: str = "study", direction: str = "minimize",
                 sampler: str = "grid", seed: Optional[int] = None):
        if direction != "minimize":
            raise ValueError("only 'minimize' studies are supported")
        if sampler not in ("grid", "random", "tpe"):
            raise ValueError(f"unknown sampler {sampler!r}")
        self.study_name = study_name
        self.sampler = sampler
        self.trials: List[Trial] = []
        self._space: Dict[str, List[Any]] = {}
        self._seen_params: List[Dict[str, Any]] = []
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def _is_duplicate(self, params: Dict[str, Any]) -> bool:
        with self._lock:
            return params in self._seen_params

    def _next_grid_point(self) -> Optional[Dict[str, Any]]:
        if not self._space:
            return None  # space unknown until one trial has run
        keys = list(self._space)
        with self._lock:
            seen = list(self._seen_params)
        for combo in itertools.product(*(self._space[k] for k in keys)):
            point = dict(zip(keys, combo))
            if point not in seen:
                return point
        return {}  # grid exhausted

    # -- TPE ------------------------------------------------------------- #

    def _tpe_choice(self, name: str, choices: List[Any]) -> Any:
        """Categorical Tree-structured Parzen Estimator: rank completed
        trials by value, call the best ~25% 'good', and draw each choice
        with weight (1 + count_good) / (1 + count_bad) — the l(x)/g(x)
        ratio with add-one smoothing.  Falls back to uniform until 4
        observations exist (TPESampler's startup behavior)."""
        with self._lock:
            done = [t for t in self.trials
                    if t.state == "COMPLETE" and name in t.params]
        if len(done) < 4:
            return self._rng.choice(choices)
        done.sort(key=lambda t: t.value)
        n_good = max(1, len(done) // 4)
        good, bad = done[:n_good], done[n_good:]
        weights = []
        for c in choices:
            g = sum(1 for t in good if t.params[name] == c)
            b = sum(1 for t in bad if t.params[name] == c)
            weights.append((1.0 + g) / (1.0 + b))
        return self._rng.choices(choices, weights=weights, k=1)[0]

    # --------------------------------------------------------------------- #

    def _run_one(self, objective: Callable[[Trial], float],
                 assigned: Optional[Dict[str, Any]]) -> None:
        with self._lock:
            trial = Trial(number=len(self.trials), study=self,
                          assigned=assigned)
            self.trials.append(trial)
        try:
            value = objective(trial)
        except TrialPruned:
            trial.state = "PRUNED"
            return
        with self._lock:
            if trial.params in self._seen_params:
                trial.state = "PRUNED"
                return
            self._seen_params.append(dict(trial.params))
        trial.value = float(value)
        trial.state = "COMPLETE"

    def optimize(self, objective: Callable[[Trial], float], n_trials: int = 5,
                 n_jobs: int = 1) -> None:
        """Run up to n_trials; ``n_jobs > 1`` runs them thread-parallel
        (the reference's Optuna ``n_jobs=4``, ``train.py:86``).  Grid
        sampling stays sequential — each point depends on what has
        already been seen."""
        if n_jobs > 1 and self.sampler != "grid":
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=n_jobs) as pool:
                futures = [pool.submit(self._run_one, objective, None)
                           for _ in range(n_trials)]
                for f in futures:
                    f.result()
            return
        for _ in range(n_trials):
            assigned = None
            if self.sampler == "grid":
                assigned = self._next_grid_point()
                if assigned == {}:  # exhausted
                    break
            self._run_one(objective, assigned)

    def get_trials(self, deepcopy: bool = False, states=None) -> List[Trial]:
        if states is None:
            return list(self.trials)
        wanted = {s if isinstance(s, str) else str(s) for s in states}
        return [t for t in self.trials if t.state in wanted]

    @property
    def best_trial(self) -> Trial:
        complete = [t for t in self.trials if t.state == "COMPLETE"]
        if not complete:
            raise ValueError("no completed trials")
        return min(complete, key=lambda t: t.value)


def create_study(study_name: str = "study", direction: str = "minimize",
                 sampler: str = "grid", seed: Optional[int] = None) -> Study:
    return Study(study_name, direction, sampler, seed)
