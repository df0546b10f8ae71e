"""Serving cells: the port's ``InferenceSession.predict`` under a closed loop
of one client.

Set-up builds the model and a session (``batch`` rows a call) on the
benchmark's weights, makes a pool of windows from the seed on the device
and hands the client a host copy, and serves ``warmup_requests`` requests.
Each request of the window is one batch of windows drawn from the pool
(without replacement, from the seed), timed from the call to ``predict``
until its numpy forecasts are in hand; the next is sent when it returns.

The check serves a sample of the window's requests again once the window
has closed, with a recorder around the port's AutoCorrelation that keeps
the lags each call chose (a top-k, which two correct programs may break
differently at a near-tie).  The reference replays those lags and judges
them (how far the weakest chosen lag lies below its own k-th best), and
compares its forecasts with the window's own answers; the answers served
again must equal the window's bit for bit.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import judge, program
from benchmark.harness import trace as tracing
from benchmark.harness.traffic import POOL_STREAM, windows
from benchmark.harness.weights import make_weights
from benchmark.reference.model import dtype_mode

_MASK = (1 << 64) - 1


class Cell:
    kind = "serve"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.batch = cfg["shapes"]["batch"]

    def _rng(self, stream: int):
        return np.random.default_rng([self.seed & _MASK, stream])

    def setup(self, fault=None):
        """``fault``: a function (session) that breaks the served path
        underneath (tests only)."""
        cfg, t = self.cfg, self.traffic
        m = cfg["model"]
        marks = self.marks = [("start", time.perf_counter())]
        self.weights = make_weights(m, self.seed, 0, self.device)
        marks.append(("weights", time.perf_counter()))
        self.net = program.model(cfg, self.device)
        self.session = program.session(self.net, self.weights, self.batch,
                                       self.device)
        if fault is not None:
            fault(self.session)
        enc, dec, _ = windows(t["pool_windows"], cfg["shapes"],
                              m["pred_len"], t["series"], self.seed,
                              POOL_STREAM, self.device)
        self.pool = (enc, dec)
        self.host = (enc.cpu().numpy(), dec.cpu().numpy())
        self.requests = self._rng(1)
        marks.append(("program_and_data", time.perf_counter()))
        warm = self._rng(0)
        for _ in range(t["warmup_requests"]):
            self._serve(self._draw(warm))
        marks.append(("warmup", time.perf_counter()))

    def _draw(self, rng):
        return rng.choice(self.traffic["pool_windows"], self.batch,
                          replace=False)

    def _serve(self, idx):
        """(forecasts (b, pred_len), seconds) of one request."""
        enc, dec = self.host[0][idx], self.host[1][idx]
        t = time.perf_counter()
        out = self.session.predict(enc, dec)
        return out[..., 0], time.perf_counter() - t

    def window(self, seconds: float, trace: bool) -> dict:
        """Requests until ``seconds`` have passed.  With ``trace``, the
        ``profile_requests`` requests that start past half the window run
        under the profiler (past the window if none did), and the requests
        before them give the traced run's unprofiled rate."""
        t = self.traffic
        self.answers, latency, failed, profile = [], [], 0, None
        before = None  # (requests, seconds) ahead of the profiled slice
        t0 = time.perf_counter()
        while (time.perf_counter() - t0 < seconds
               or (trace and profile is None)):
            now = time.perf_counter()
            if (trace and profile is None and self.answers
                    and now - t0 >= seconds / 2):
                before = (len(self.answers), now - t0)
                idxs = [self._draw(self.requests)
                        for _ in range(t["profile_requests"])]
                outs, profile = tracing.profiled(
                    lambda: [self._serve(i) for i in idxs])
                served = list(zip(idxs, outs))
            else:
                idx = self._draw(self.requests)
                served = [(idx, self._serve(idx))]
            for idx, (out, sec) in served:
                self.answers.append((idx, out))
                latency.append(sec)
                failed += int(not np.all(np.isfinite(out)))
        elapsed = time.perf_counter() - t0
        n = len(self.answers)
        out = {"steps": n, "failed": failed, "elapsed": elapsed,
               "latency_s": latency,
               "metrics": {
                   "serve_windows_per_s": n * self.batch / elapsed,
                   "serve_batch_ms_p95": 1e3 * float(
                       np.percentile(latency, 95))}}
        if profile is not None:
            out.update(trace=tracing.read(profile),
                       slice_requests=t["profile_requests"],
                       unprofiled_requests=before[0],
                       unprofiled_s=before[1])
        return out

    def release(self):
        """The session stays for the check, which serves the sampled
        requests again; nothing else of the program is held."""
        self.session_for_check = self.session
        del self.session, self.net
        torch.cuda.empty_cache()

    # -- correct ------------------------------------------------------ #
    def sample(self) -> list:
        """The requests compared: ``check_requests`` of those the window
        finished, drawn from the seed."""
        n = len(self.answers)
        pick = self._rng(2).choice(n, min(n, self.traffic["check_requests"]),
                                   replace=False)
        return [self.answers[i] for i in sorted(pick)]

    def replay(self, session, answers: list) -> list:
        """Each of ``answers``'s requests served again by ``session`` under
        the recorder: [(window indices, forecasts, the lags of each
        AutoCorrelation call)]."""
        out = []
        for idx, _ in answers:
            with program.DelayRecorder() as rec:
                pred = session.predict(self.host[0][idx], self.host[1][idx])
            out.append((idx, pred[..., 0], rec.delays))
        return out

    def check(self, served=None) -> dict:
        """The numbers compared, of the sampled requests (or ``served``,
        another side's replay of them)."""
        if served is None:
            answers = self.sample()
            served = self.replay(self.session_for_check, answers)
            rerun = max(float(np.abs(a[1] - b[1]).max())
                        for a, b in zip(answers, served))
        else:
            rerun = 0.0
        self.session_for_check = None  # the program's last state, freed
        torch.cuda.empty_cache()
        numbers = judge.replayed_forecasts(
            self.cfg, dtype_mode(self.cfg["model"]), self.weights, self.pool,
            served)
        return dict(numbers, rerun_gap=rerun)

    def control(self) -> list:
        """The sampled requests through the int8 session, the program's
        own path one precision below bfloat16, under the recorder."""
        session = program.session(program.model(self.cfg, self.device),
                                  self.weights, self.batch, self.device,
                                  "int8")
        return self.replay(session, self.sample())


def altered(session):
    """A fault: the first forecast of every request moved by 1 where it is
    produced."""
    forward = session._forward

    def wrong(enc, dec):
        out = forward(enc, dec)
        out[0] += 1.0
        return out

    session._forward = wrong


FAULTS = {"altered": altered}
