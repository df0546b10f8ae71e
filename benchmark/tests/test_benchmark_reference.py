"""The port's plain path against the reference, at tiny sizes on the CPU,
and AutoCorrelation's lags recorded in the program and replayed in the
reference."""

import pytest
import torch

from benchmark.harness import judge, program
from benchmark.harness.weights import make_weights
from benchmark.reference.model import Reference
from benchmark.reference.selection import Choices
from benchmark.tests import _tiny


def _inputs(seed=0, b=6):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, 24, 4, generator=g),
            torch.randn(b, 12, 4, generator=g),
            torch.randn(b, 8, 1, generator=g))


@pytest.mark.parametrize("name,mode", [("autodg", "fp32"),
                                       ("autodg_wide_bf16", "bf16")])
def test_port_matches_reference(name, mode):
    cfg = _tiny.config(name)
    cfg["model"].update(src_input_size=4, tgt_input_size=4)
    w = make_weights(cfg["model"], 3, 0, "cpu")
    net = program.model(cfg, "cpu")
    net.load_state_dict(w)
    ref = Reference(cfg["model"], mode)
    enc, dec, y = _inputs()
    with torch.no_grad():
        got = net(enc, dec, training=False).predictions
        want = ref.forward(w, enc, dec).predictions
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    out = net(enc, dec, y, training=True)
    out.loss.backward()
    leaves = {k: v.clone().requires_grad_() for k, v in w.items()}
    r = ref.forward(leaves, enc, dec, y, training=True)
    r.loss.backward()
    assert abs(float(out.loss) - float(r.loss)) <= 1e-6 * abs(float(r.loss))
    for k, p in net.named_parameters():
        assert (p.grad - leaves[k].grad).norm() <= 1e-5 * max(
            float(leaves[k].grad.norm()), 1e-12), k


def test_choices_read_a_replayed_shortfall():
    """A replayed set's weakest lag below the k-th best, over the row's
    largest score; a replayed top-k reads 0 and no flip."""
    scores = torch.tensor([[4.0, 2.0, 1.9, 0.0], [1.0, 3.0, 2.0, 0.5]])
    ch = Choices({0: torch.tensor([[0, 3], [2, 1]]), 1: torch.tensor(
        [[1, 0], [1, 2]])})
    assert ch(scores, 2).tolist() == [[0, 3], [2, 1]]
    assert ch.lag_gap == pytest.approx(0.5) and ch.flips == 1
    ch(scores, 2)
    assert ch.lag_gap == pytest.approx(0.5) and ch.flips == 1
    own = ch(scores, 2)  # a call past the replayed ones takes its own
    assert own.tolist() == [[0, 1], [1, 2]] and len(ch.chosen) == 3


def test_recorder_keeps_each_vmapped_rows_lags():
    """Lags taken inside ``torch.func.vmap`` (the seeds of
    ``MultiSeedTrainer``) come out with that axis first."""
    kept = []

    def one(x):
        kept.append(program._unbatched(torch.topk(x, 2).indices))
        return x.sum()

    torch.func.vmap(one)(torch.tensor([[1.0, 3.0, 2.0], [5.0, 4.0, 6.0]]))
    assert kept[0].tolist() == [[1, 2], [2, 0]]


def test_training_reference_replays_lags():
    """The reference's own lags replayed read its own steps again, with
    no shortfall; another run's lags are judged by their shortfall."""
    cfg = _tiny.config("autodg")
    w = make_weights(cfg["model"], 4, 0, "cpu")
    batches = [_inputs(s, 4) for s in range(2)]
    own = judge.reference_steps(cfg, "fp32", w, batches)
    again = judge.reference_steps(cfg, "fp32", w, batches, own["lags"])
    n = judge.train_numbers(own, again)
    assert max(n.values()) <= 1e-6 and again["flips"] == 0
    shifted = [[(lag + 1) % cfg["shapes"]["enc_len"] if i == 0 else lag
                for i, lag in enumerate(step)] for step in own["lags"]]
    other = judge.reference_steps(cfg, "fp32", w, batches, shifted)
    assert other["flips"] >= 1 and other["lag_gap"] > 0
