"""A whole run on the CPU at a tiny size, the look for a card skipped:
sound, it comes out correct; with the timed path broken underneath, or
with the control in the program's place, it does not."""

import time

import pytest

from benchmark.harness import cell, manifest, serve, train
from benchmark.tests import _tiny

SEED = 2 ** 31 + 101


def _cell(name):
    m = manifest.load()
    wl = manifest.workload(m, name)
    cfg, t = _tiny.config(wl["config"]), _tiny.traffic(wl["traffic"])
    driver = {"train": train, "serve": serve}[t["kind"]]
    return m, wl, driver.Cell(cfg, t, SEED, "cpu")


def _run(name, fault=None, trace=False):
    m, wl, c = _cell(name)
    rc, line = cell.run(m, wl, c, 0.5, trace, manifest.limits(name),
                        time.perf_counter(), fault=fault)
    assert rc == 0
    return line


CELLS = [w["name"] for w in manifest.load()["workloads"]]
TRAIN = [c for c in CELLS if c.endswith(("train", "train_3seed"))]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    line = _run(name)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert "setup_s" in line["metrics"]


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_per_layer_metrics(name):
    """A traced run reports the per-layer metrics its readers find (the
    CPU has no kernels, so no roofline), the slice's times and the
    breakdown, and no end-to-end metric."""
    line = _run(name, trace=True)
    assert line["correct"], line["checks"]
    kind = "train" if name in TRAIN else "serve"
    launches = ("launches_per_step.train" if kind == "train"
                else "launches_per_batch.serve")
    assert {launches, f"mfu.{kind}", f"idle_share.{kind}"} <= set(
        line["metrics"])
    assert "setup_s" not in line["metrics"]
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", ["frozen", "half_batch"])
def test_training_fault_is_caught(name, fault):
    line = _run(name, train.FAULTS[fault])
    assert not line["correct"], line["checks"]


def test_altered_answer_is_caught():
    line = _run("autodg_wide_bf16.serve", serve.FAULTS["altered"])
    assert not line["correct"], line["checks"]


def test_int8_session_reads_far_from_the_program():
    """At the CPU's size the int8 session's readings lie far above the
    program's own (its failing of the cell's limits is the card test
    below, at the cell's size)."""
    m, wl, c = _cell("autodg_wide_bf16.serve")
    c.setup()
    c.window(0.5, False)
    c.release()
    own = c.check()
    control = c.check(c.control())
    assert control["forecast_gap"] >= 3 * own["forecast_gap"]
    assert control["lag_gap"] >= 3 * own["lag_gap"]


@pytest.mark.gpu
def test_int8_session_fails_the_serving_check(card):
    """The control at the cell's own size on the card."""
    m = manifest.load()
    wl, c = cell.build(m, "autodg_wide_bf16.serve", SEED, card)
    c.setup()
    c.window(3.0, False)
    c.release()
    ok, checks = cell.verdict(c.check(c.control()),
                              manifest.limits(wl["name"]))
    assert not ok, checks


def test_fp8_reference_fails_the_bf16_training_check():
    m, wl, c = _cell("autodg_wide_bf16.train")
    c.setup()
    c.release()
    ok, checks = cell.verdict(c.check(c.control_readings()),
                              manifest.limits(wl["name"]))
    assert not ok, checks


@pytest.mark.gpu
def test_tf32_reference_fails_the_fp32_training_check(card):
    """TF32 exists on the card only; a batch of 64, the cell's widths."""
    m = manifest.load()
    wl = manifest.workload(m, "autodg.train_3seed")
    cfg = manifest.config(m, wl["config"])
    cfg["shapes"]["batch"] = 64
    t = dict(manifest.traffic(wl["traffic"]), epoch_windows=320)
    c = train.Cell(cfg, t, SEED, card)
    c.setup()
    c.release()
    ok, checks = cell.verdict(c.check(c.control_readings()),
                              manifest.limits(wl["name"]))
    assert not ok, checks
