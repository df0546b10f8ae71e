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
