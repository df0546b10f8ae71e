"""The manifest and the pieces it names, found by name."""

import json
import re
import shutil

import pytest

from benchmark.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_manifest_keys_and_names():
    m = manifest.load()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= m["run_seconds"] <= 51
    names = [e["name"] for g in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in m[g]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(e["unit"]) for g in ("end_to_end", "per_layer")
               for e in m[g])
    e2e = {e["name"] for e in m["end_to_end"]}
    assert "setup_s" in e2e
    for e in m["end_to_end"]:
        assert 0 < e["bound"] <= 0.25 and e["source"] in ("host_clock",
                                                          "device_trace")
    for e in m["per_layer"]:
        assert e["moves"] in e2e
    layers = {e["layer"] for e in m["per_layer"]}
    assert layers == {"trainer", "session", "model step", "kernels",
                      "device"}


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  manifest.load()["workloads"]])
def test_cell_found_by_name(cell):
    """Each cell's configuration, mix, limits and metrics are files found
    by their names, and every cell reports setup_s, another end-to-end
    metric and a per-layer one."""
    m = manifest.load()
    wl = manifest.workload(m, cell)
    cfg = manifest.config(m, wl["config"])
    assert cfg["name"] == wl["config"] and cfg["reduced"] == []
    traffic = manifest.traffic(wl["traffic"])
    assert (manifest.BENCH / "harness" / f"{traffic['kind']}.py").exists()
    assert set(manifest.limits(cell))
    e2e = [e["name"] for e in manifest.metrics_of(m, "end_to_end", cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per = manifest.metrics_of(m, "per_layer", cell)
    assert per
    for e in per:
        assert callable(manifest.reader(e["name"]))
        assert e["moves"] in e2e


def test_new_entries_need_no_edit(tmp_path):
    """A new configuration, mix and metric are new files and new entries:
    the harness finds them, and no existing file changes."""
    root = tmp_path / "checkout"
    shutil.copytree(manifest.BENCH, root / "benchmark")
    shutil.copy(manifest.ROOT / "BENCHMARK.json", root)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "autodg.json").read_text())
    cfg["name"] = "autodg_s3"
    cfg["model"]["stack_size"] = 3
    (bench / "configs" / "autodg_s3.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "train.json").read_text())
    mix["epoch_windows"] = 6400
    (bench / "traffic" / "train_short.json").write_text(json.dumps(mix))
    (bench / "metrics" / "steps_in_slice.train.py").write_text(
        "def read(ctx):\n    return ctx.result['slice_steps']\n")
    (bench / "limits" / "autodg_s3.train_short.json").write_text(
        json.dumps({"loss_gap": 1.0}))
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "autodg_s3", "source": "x",
                         "file": "benchmark/configs/autodg_s3.json",
                         "reduced": ["stack_size"], "why": "x"})
    m["workloads"].append({"name": "autodg_s3.train_short",
                           "config": "autodg_s3", "traffic": "train_short",
                           "chips": 1, "why": "x"})
    m["per_layer"].append({"name": "steps_in_slice.train", "unit": "steps",
                           "better": "higher", "source": "program_counter",
                           "layer": "trainer",
                           "moves": "train_windows_per_s",
                           "workloads": ["autodg_s3.train_short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    m = manifest.load(root)
    wl = manifest.workload(m, "autodg_s3.train_short")
    assert manifest.config(m, wl["config"], root)["model"]["stack_size"] == 3
    assert manifest.traffic(wl["traffic"], bench)["epoch_windows"] == 6400
    assert manifest.limits(wl["name"], bench) == {"loss_gap": 1.0}
    per = [e["name"] for e in manifest.metrics_of(m, "per_layer",
                                                  wl["name"])]
    assert per == ["steps_in_slice.train"]
    read = manifest.reader("steps_in_slice.train", bench)
    assert read(type("C", (), {"result": {"slice_steps": 25}})) == 25
    after = {p: p.read_bytes() for p in before}
    assert after == before


@pytest.mark.parametrize("cell", [w["name"] for w in manifest.load()
                                  ["workloads"]])
def test_limits_follow_their_readings(cell):
    """Each cell's limits are what ``calibrate.py --summarize`` sets from
    the readings kept beside them, to the three digits stored."""
    from benchmark import calibrate

    path = manifest.BENCH / "limits" / f"{cell}.readings.jsonl"
    derived = calibrate.summarize([path], cell)
    stored = manifest.limits(cell)
    assert set(stored) == set(derived)
    for k, v in stored.items():
        assert v == pytest.approx(derived[k]["limit"], rel=5e-3, abs=0), k
