"""The card smoke's gates, on the CPU: ``chip_smoke._gp_grad_within``, the
fused-GP gradient gate of both backward checks (affine and not).

dos, a sum over every row and inducing point that nearly cancels, is
judged on the two versions' distances from float64 summed over
``F64_DRAWS`` draws when it misses the tolerance; every other gradient only
by the tolerance."""

import pytest

import chip_smoke

TOL = chip_smoke.TOL_FUSED_GP_BWD


@pytest.mark.parametrize("name,rel,kernel,plain,passes", [
    # small |dos|: 5e-2 off plain, 50x the tolerance, but the kernel's
    # summed distance from float64 0.7x plain's
    ("dos", 5e-2, 0.7, 1.0, True),
    # the kernel's summed distance 2.1x plain's
    ("dos", 5e-2, 2.1, 1.0, False),
    ("dos", 2e-1, 2.0, 1.0, True),  # the bound itself
    ("dos", 0.5 * TOL, 9.0, 1.0, True),  # within the tolerance
    ("dos", 5e-2, 1.0, 0.0, False),  # plain exact: nothing to share
    # the other gradients: the tolerance alone
    ("dW", 0.9 * TOL, 9.0, 1.0, True),
    ("dW", 1.1 * TOL, 0.1, 1.0, False),
    ("dx", 5e-2, 0.7, 1.0, False),
])
def test_gp_grad_gate(name, rel, kernel, plain, passes):
    assert chip_smoke._gp_grad_within(name, rel, TOL, kernel, plain) is \
        passes


def test_smoke_refuses_to_run_without_a_card(monkeypatch, capsys):
    """No result without a card: a non-zero exit and no output line."""
    monkeypatch.setattr(chip_smoke.torch.cuda, "is_available",
                        lambda: False)
    assert chip_smoke.main() != 0
    assert capsys.readouterr().out == ""


def test_jax_checkpoint_round_trip_on_cpu(tmp_path):
    """The smoke's ``jax_checkpoint`` phase at a test's size on the CPU:
    the flagship state through the JAX layout and back serves and resumes
    bit-equal to the state before it."""
    import dataclasses

    import numpy as np
    import torch

    flagship = {c.name: c for c in chip_smoke.CONFIGS}["autoformer"]
    cfg = dataclasses.replace(flagship, batch=2, enc_len=12, dec_len=8,
                              pred=8, d_model=16)
    rng = np.random.default_rng(0)
    n = 2 * chip_smoke.JAX_CKPT_STEPS
    enc = rng.normal(size=(n, 2, 12, cfg.features)).astype(np.float32)
    dec = rng.normal(size=(n, 2, 8, cfg.features)).astype(np.float32)
    data = tuple(torch.from_numpy(a) for a in (
        enc, dec, (0.5 * dec[..., -8:, :1]).astype(np.float32)))
    r = chip_smoke.jax_checkpoint_round_trip(cfg, "cpu", data, enc[0], dec[0],
                                             str(tmp_path))
    assert r["served"].shape == (2, 8, 1)
    np.testing.assert_array_equal(r["served"], r["want"])
    assert r["moments_apart"] == []
    assert len(r["losses"]) == chip_smoke.JAX_CKPT_STEPS
    assert r["losses"] == r["uninterrupted"]
    assert (tmp_path / chip_smoke.JAX_CKPT_NAME).exists()


def test_scale_max_replay_shares_an_exact_tie():
    """ATA's top-1 replayed from a run with an exact tie between two scales
    (``amax`` shares its gradient evenly) on a run where the tie is broken
    by a rounding: the same gradient as the tied run's, where the own top-1
    would put it all on one scale."""
    import torch

    tied = torch.tensor([[[[0.5, 0.25, 0.5, -1.0]]]], requires_grad=True)
    with chip_smoke._ScaleMaxRecorder() as card:
        card.module.relu_scale_max(tied).sum().backward()
    broken = torch.tensor([[[[0.5, 0.25, 0.5 - 2 ** -24, -1.0]]]],
                          requires_grad=True)
    with chip_smoke._ScaleMaxRecorder(replay=card.choices) as cpu:
        cpu.module.relu_scale_max(broken).sum().backward()
    assert tied.grad.tolist() == [[[[0.5, 0.0, 0.5, 0.0]]]]
    assert broken.grad.tolist() == tied.grad.tolist()
    assert cpu.flips == 0
