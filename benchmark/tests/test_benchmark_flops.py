"""The counted operations against PyTorch's own counter of products."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import flops
from benchmark.harness.weights import make_weights
from benchmark.reference.model import Reference
from benchmark.tests import _tiny


@pytest.mark.parametrize("name", ["autodg", "autodg_wide_bf16"])
def test_products_match_flop_counter(name):
    """The forward's matrix products as the reference runs them, in fp32.
    FlopCounterMode counts matrix-matrix products only: the GP's
    matrix-vector ones (x . mean_w, K u: 2 R d + 2 R M; u = L^-T m: 2 M^2)
    are left out of its count."""
    cfg = _tiny.config(name)
    m, b = cfg["model"], 3
    le, ld = cfg["shapes"]["enc_len"], cfg["shapes"]["dec_len"]
    w = make_weights(m, 1, 0, "cpu")
    enc = torch.randn(b, le, m["src_input_size"])
    dec = torch.randn(b, ld, m["tgt_input_size"])
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        Reference(m, "fp32").forward(w, enc, dec)
    rows, mm, d = b * (le + ld), m["num_inducing"], m["d_model"]
    vectors = 2 * rows * d + 2 * rows * mm + 2 * mm * mm
    assert counter.get_total_flops() == flops.matmul_products(
        m, b, le, ld) - vectors


def test_training_step_counts_the_backward():
    cfg = _tiny.config("autodg")
    m = cfg["model"]
    fwd = flops.step(m, 4, 24, 12, train=False)
    step = flops.step(m, 4, 24, 12, train=True)
    assert 2.5 * fwd < step < 3.5 * fwd


def test_fused_gp_least_time_lies_under_the_ports_own_design():
    """No design passes 100 %: at the kernel table's d 512 shape (40,960
    rows, M 512, float32) the least time lies under the time of the port's
    own design, its float32 products as six bfloat16 part products
    (PERF.md's kernel table, rows 1-2: 0.2492 / 0.5864 ms)."""
    m = {"d_model": 512, "num_inducing": 512}
    work = flops.fused_gp_work(m, 40960, bf16=False)
    assert flops.least_seconds(work["fwd"]) * 1e3 < 0.2492
    assert flops.least_seconds(work["bwd"]) * 1e3 < 0.5864


def test_least_time_spreads_float32_over_both_units():
    """Float32 operations over the CUDA cores and the tensor cores' split
    products together; bfloat16 ones take their share of the latter."""
    from benchmark.harness.peaks import PEAK_BF16, PEAK_FP32, PEAK_FP32_SPLIT

    both = PEAK_FP32 + PEAK_FP32_SPLIT
    none = {"fp32": 0.0, "bf16": 0.0, "exp": 0.0, "bytes": 0.0}
    assert flops.least_seconds(dict(none, fp32=both)) == pytest.approx(1.0)
    assert flops.least_seconds(dict(none, bf16=PEAK_BF16)) == pytest.approx(
        1.0)
    mixed = dict(none, fp32=PEAK_FP32, bf16=PEAK_BF16 / 2)
    assert flops.least_seconds(mixed) == pytest.approx(
        (PEAK_FP32 + PEAK_FP32_SPLIT / 2) / both)
