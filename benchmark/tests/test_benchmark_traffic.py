"""The seeded traffic and weights."""

import numpy as np
import pytest
import torch

from benchmark.harness import traffic, weights
from benchmark.tests import _tiny

SHAPES = {"enc_len": 24, "dec_len": 12, "features": 4}
SERIES = {"periods": [24, 168], "amplitude": [0.5, 1.5], "noise": 0.3,
          "offsets": 100000}


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11, 2 ** 40 + 3])
def test_same_seed_same_windows(seed):
    a = traffic.windows(10, SHAPES, 8, SERIES, seed, traffic.TRAIN_STREAM,
                        "cpu")
    b = traffic.windows(10, SHAPES, 8, SERIES, seed, traffic.TRAIN_STREAM,
                        "cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    enc, dec, y = a
    assert enc.shape == (10, 24, 4) and dec.shape == (10, 12, 4)
    assert y.shape == (10, 8, 1) and torch.isfinite(enc).all()
    # the target is feature 0 one step ahead of the decoder's last steps
    assert torch.equal(y[:, :-1, 0], dec[:, -7:, 0])


def test_seeds_and_streams_differ_in_values_not_sizes():
    a = traffic.windows(6, SHAPES, 8, SERIES, 1, traffic.TRAIN_STREAM, "cpu")
    b = traffic.windows(6, SHAPES, 8, SERIES, 2, traffic.TRAIN_STREAM, "cpu")
    c = traffic.windows(6, SHAPES, 8, SERIES, 1, traffic.POOL_STREAM, "cpu")
    assert a[0].shape == b[0].shape == c[0].shape
    assert not torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])


def test_chunks_match_one_draw_in_size(monkeypatch):
    monkeypatch.setattr(traffic, "_CHUNK", 4)
    enc, dec, y = traffic.windows(10, SHAPES, 8, SERIES, 3, 0, "cpu")
    assert enc.shape[0] == dec.shape[0] == y.shape[0] == 10


def test_weights_from_seed():
    cfg = _tiny.config("autodg_wide_bf16")["model"]
    a = weights.make_weights(cfg, 5, 0, "cpu")
    b = weights.make_weights(cfg, 5, 0, "cpu")
    c = weights.make_weights(cfg, 5, 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["lam"], c["lam"])
    lam = float(a["lam"][0])
    assert 0 < lam < cfg["lam_clip_max"]
    ls = torch.nn.functional.softplus(
        a["deep_gp.output_layer.raw_lengthscale"])
    assert np.isclose(float(ls.mean()), cfg["d_model"] ** 0.5, rtol=0.1)


def test_serve_requests_from_seed():
    from benchmark.harness import serve

    cfg, t = _tiny.config("autodg_wide_bf16"), _tiny.traffic("serve")
    a, b = serve.Cell(cfg, t, 9, "cpu"), serve.Cell(cfg, t, 9, "cpu")
    ra, rb = a._rng(1), b._rng(1)
    for _ in range(3):
        ia, ib = a._draw(ra), b._draw(rb)
        assert np.array_equal(ia, ib) and len(set(ia.tolist())) == 4
