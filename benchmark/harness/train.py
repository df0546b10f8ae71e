"""Training cells: the port's ``Trainer`` (one seed) or ``MultiSeedTrainer``
(several, on shared batches) over an epoch of windows on the device.

Set-up builds the model, the trainer and its state from the benchmark's
weights, makes the epoch's batches on the device, and drives that same
trainer through its first steps with the window's own call
(``train_epoch``) on batches 0, 1, 2, one call each, recording the lags
each AutoCorrelation call chose: those steps warm every shape up and are
what the reference follows, replaying those lags.  The window then calls
``train_epoch`` on consecutive slices of ``call_batches`` batches, each
call ending in the trainer's own read of its losses, until ``seconds`` have
passed; it counts every window once per seed that trains on it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import judge, program
from benchmark.harness import trace as tracing
from benchmark.harness.traffic import TRAIN_STREAM, windows
from benchmark.harness.weights import make_weights
from benchmark.reference.model import control_mode, dtype_mode

_MASK = (1 << 63) - 1


class Cell:
    kind = "train"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.n_seeds = traffic["n_seeds"]
        self.batch = cfg["shapes"]["batch"]

    # -- set-up ------------------------------------------------------- #
    def setup(self, fault=None):
        """``fault``: a function (trainer, data) -> data that breaks the
        timed path underneath (tests and the fault readings only)."""
        cfg, t = self.cfg, self.traffic
        m, sh = cfg["model"], cfg["shapes"]
        marks = self.marks = [("start", time.perf_counter())]
        self.weights = [make_weights(m, self.seed, i, self.device)
                        for i in range(self.n_seeds)]
        marks.append(("weights", time.perf_counter()))
        self.net = program.model(cfg, self.device)
        self.trainer = program.trainer(cfg, self.net, self.n_seeds,
                                       self.device)
        if self.n_seeds == 1:
            self.state = self.trainer.init_state(self.weights[0],
                                                 seed=self.seed & _MASK)
        else:
            self.state = self.trainer.init_state(
                [(self.seed + i) & _MASK for i in range(self.n_seeds)],
                self.weights)
        n = t["epoch_windows"] // self.batch
        data = windows(n * self.batch, sh, m["pred_len"], t["series"],
                       self.seed, TRAIN_STREAM, self.device)
        self.data = tuple(a.view(n, self.batch, *a.shape[1:]) for a in data)
        marks.append(("program_and_data", time.perf_counter()))
        self.fault = fault
        self.first = {"loss": [[] for _ in range(self.n_seeds)],
                      "lags": [[] for _ in range(self.n_seeds)]}
        for step in range(t["first_steps"]):
            with program.DelayRecorder() as rec:
                loss = self._call(step, 1)
            for i in range(self.n_seeds):
                self.first["loss"][i].append(float(loss[i]))
                self.first["lags"][i].append(
                    [d if self.n_seeds == 1 else d[i] for d in rec.delays])
            if step == 0:
                self.first["grad"] = self._first_gradient()
        self.first["change"] = self._change()
        marks.append(("first_steps", time.perf_counter()))
        self.batches = [tuple(a[s].clone() for a in self.data)
                        for s in range(t["first_steps"])]

    def _call(self, start: int, count: int):
        """One ``train_epoch`` over batches [start, start + count): each
        seed's loss sum, a numpy array."""
        part = tuple(a[start:start + count] for a in self.data)
        if self.fault is not None:
            part = self.fault(self.trainer, part)
        self.state, loss, _ = self.trainer.train_epoch(self.state, part)
        return np.atleast_1d(np.asarray(loss, dtype=np.float64))

    def _leaves(self):
        """{leaf: tensor with a leading seed axis} of the live params."""
        if self.n_seeds == 1:
            return {k: v.detach()[None] for k, v in
                    self.net.named_parameters()}
        return {k: v.detach() for k, v in self.state.params.items()}

    def _first_gradient(self):
        """Each seed's first gradient as Adam received it: its first
        moment after one step over (1 - beta1)."""
        if self.n_seeds == 1:
            opt = self.trainer.optimizer
            moments = {k: opt.state.get(p, {}).get(
                "exp_avg", torch.zeros_like(p))[None]
                for k, p in self.net.named_parameters()}
        else:
            moments = self.state.opt_state["exp_avg"]
        return [{k: (v[i] / (1 - judge.BETA1)).clone()
                 for k, v in moments.items()} for i in range(self.n_seeds)]

    def _change(self):
        live = self._leaves()
        return [{k: (live[k][i] - w[k]).clone() for k in w}
                for i, w in enumerate(self.weights)]

    # -- the window --------------------------------------------------- #
    def window(self, seconds: float, trace: bool) -> dict:
        """Calls until ``seconds`` have passed.  With ``trace``, the first
        call to start past half the window runs under the profiler (one
        more call past the window if none did), and the steps before it
        give the traced run's unprofiled rate: the profiler leaves the
        host slower after it."""
        per = self.traffic["call_batches"]
        n = self.data[0].shape[0]
        starts = list(range(0, n - per + 1, per))
        calls, failed, profile, at = [], 0, None, None
        t0 = last = time.perf_counter()
        while True:
            start = starts[len(calls) % len(starts)]
            if trace and at is None and calls and last - t0 >= seconds / 2:
                at = len(calls)
                loss, profile = tracing.profiled(
                    lambda: self._call(start, per))
            else:
                loss = self._call(start, per)
            now = time.perf_counter()
            calls.append(now - last)
            last = now
            failed += per * int(not np.all(np.isfinite(loss)))
            if now - t0 >= seconds and (at is not None or not trace):
                break
        elapsed = last - t0
        steps = len(calls) * per
        out = {"steps": steps, "failed": failed, "elapsed": elapsed,
               "calls_s": calls,
               "metrics": {"train_windows_per_s":
                           steps * self.batch * self.n_seeds / elapsed}}
        if profile is not None:
            out.update(trace=tracing.read(profile), slice_steps=per,
                       unprofiled_steps=at * per,
                       unprofiled_s=sum(calls[:at]))
        return out

    def release(self):
        """Free the program's state before the reference runs."""
        del self.trainer, self.state, self.net, self.data
        torch.cuda.empty_cache()

    # -- correct ------------------------------------------------------ #
    def program_readings(self):
        return [{key: self.first[key][i] for key in
                 ("loss", "grad", "change", "lags")}
                for i in range(self.n_seeds)]

    def check(self, readings=None) -> dict:
        """The numbers compared: the worst over the seeds.  ``readings``:
        another side's (the control's) in place of the program's."""
        readings = readings or self.program_readings()
        mode = dtype_mode(self.cfg["model"])
        numbers, self.detail = [], []
        for w, got in zip(self.weights, readings):
            ref = judge.reference_steps(self.cfg, mode, w, self.batches,
                                        got["lags"])
            numbers.append(judge.train_numbers(got, ref))
            self.detail.append(dict(judge.worst_leaves(got, ref),
                                    flips=ref["flips"], **numbers[-1]))
        return judge.worst(numbers)

    def control_readings(self):
        """The reference one precision below the configuration's, in the
        program's place: its own top-k, the same weights and batches."""
        mode = control_mode(self.cfg["model"])
        return [judge.reference_steps(self.cfg, mode, w, self.batches)
                for w in self.weights]


def half_batch(trainer, part):
    """A fault: half of each batch left out, the mean taken over the rest."""
    return tuple(a[:, : a.shape[1] // 2] for a in part)


def frozen(trainer, part):
    """A fault: steps that compute their losses and return the state
    unchanged (the update skipped)."""
    if hasattr(trainer, "optimizer"):
        trainer.optimizer.step = lambda *args, **kwargs: None
    else:
        trainer._adam = lambda *args, **kwargs: None
    return part


FAULTS = {"half_batch": half_batch, "frozen": frozen}
