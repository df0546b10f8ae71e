"""Tiny versions of the benchmark's configurations and mixes, for the
CPU: every width cut, every path kept."""

import json

from benchmark.harness import manifest


def config(name: str) -> dict:
    cfg = manifest.config(manifest.load(), name)
    cfg["model"].update(d_model=32, d_k=4, d_ff=128, num_inducing=16,
                        pred_len=8, stack_size=min(
                            cfg["model"]["stack_size"], 2))
    cfg["shapes"].update(batch=4, enc_len=24, dec_len=12)
    return cfg


def traffic(name: str) -> dict:
    t = json.loads((manifest.BENCH / "traffic" / f"{name}.json").read_text())
    if t["kind"] == "train":
        t.update(epoch_windows=16, call_batches=2)
    else:
        t.update(pool_windows=40, check_requests=4, profile_requests=2,
                 warmup_requests=1)
    return t
