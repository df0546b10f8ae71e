"""Windows of seeded synthetic series, made on the device.

One generator serves every traffic mix: a mix's file gives the series'
parameters (``series``: the periods, each feature's amplitude range, the
noise) and how many windows to make.  A window is a stretch of enc_len +
dec_len + 1 steps of F features, each feature a sum of sines of the given
periods (hourly data: a day, a week) with its own amplitudes and phases,
plus Gaussian noise, starting at its own offset; the target is feature 0
one step ahead over the last pred_len decoder steps.  The same seed gives
the same windows; every seed gives windows of the same sizes.
"""

from __future__ import annotations

import math

import torch

from benchmark.harness.weights import generator

#: streams of a seed: weights take 0.. (one a model), data the ones here
TRAIN_STREAM, POOL_STREAM = 100, 101


_CHUNK = 4096  # windows made at once, so that no large temporary is held


def windows(n: int, shapes: dict, pred_len: int, series: dict, seed: int,
            stream: int, device):
    """(enc (n, enc_len, F), dec (n, dec_len, F), y (n, pred_len, 1)),
    float32 on ``device``."""
    g = generator(seed, stream, device)
    parts = [_chunk(min(_CHUNK, n - at), shapes, pred_len, series, g,
                    device) for at in range(0, n, _CHUNK)]
    return tuple(torch.cat(p) for p in zip(*parts))


def _chunk(n, shapes, pred_len, series, g, device):
    le, ld, f = shapes["enc_len"], shapes["dec_len"], shapes["features"]
    periods = torch.tensor(series["periods"], dtype=torch.float32,
                           device=device)
    lo, hi = series["amplitude"]
    t0 = torch.randint(0, series["offsets"], (n, 1, 1, 1), generator=g,
                       device=device).float()
    amp = lo + (hi - lo) * torch.rand((n, 1, f, periods.numel()),
                                      generator=g, device=device)
    phase = 2 * math.pi * torch.rand((n, 1, f, periods.numel()),
                                     generator=g, device=device)
    t = t0 + torch.arange(le + ld + 1, device=device,
                          dtype=torch.float32)[None, :, None, None]
    x = (amp * torch.sin(2 * math.pi * t / periods + phase)).sum(-1)
    x = x + series["noise"] * torch.randn(x.shape, generator=g,
                                          device=device)
    enc = x[:, :le].contiguous()
    dec = x[:, le:le + ld].contiguous()
    y = x[:, le + ld - pred_len + 1:, :1].contiguous()
    return enc, dec, y
