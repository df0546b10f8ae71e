"""One rank of ``tests/test_torch_parallel.py``'s process group (gloo, on
the CPU).  Imports torch and the port only, never JAX: each spawned rank
imports this module, not the test file.

The parent writes ``inputs.pt`` (each attention type's parameters, from
JAX's ``init`` through ``params.from_flax``) into the work directory; every
rank takes every case on both meshes, the other options on the 2 x 2 mesh
from the port's own initial weights, then the two CLI runs, and writes
``rank{r}.pt``.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

# the JAX package's tests/test_parallel.py widths
CFG = dict(src_input_size=4, tgt_input_size=4, d_model=16, n_heads=4, d_k=4,
           stack_size=1, pred_len=8, gp=True, denoise=True, num_inducing=8)
BATCH, ENC_LEN, DEC_LEN = 16, 24, 8
MESHES = {"2x2": (2, 2), "4x1": (4, 1)}
ATTNS = ("basic", "autoformer", "conv_attn")
CASES = [(m, a, f) for m in MESHES for a in ATTNS for f in (False, True)]
# the model's other options, each against the single-device port: the
# rest of the attention zoo (fedformer's Fourier modes need a decoder of
# 14 steps or more) and the LSTM backbone
OPTIONS = {"ATA": {}, "ACAT": {}, "informer": {},
           "fedformer": {"dec_len": 16}, "lstm": {"backbone": "lstm"}}
OPTION_CASES = [(o, False) for o in OPTIONS] + [("lstm", True)]
WORLD = 4
CLI_ARGS = ["--exp_name", "solar", "--synthetic", "--attn_type", "basic",
            "--model_name", "mesh_smoke", "--num_epochs", "1", "--n_trials",
            "1", "--n_seeds", "1", "--pred_len", "8", "--num_inducing", "8",
            "--d_model_choices", "16", "--stack_choices", "1",
            "--max_train_samples", "64", "--max_valid_samples", "64"]
CLI_RUNS = {"dp_tp": ["--dp", "2", "--tp", "2"],
            "fsdp": ["--dp", "2", "--tp", "2", "--fsdp", "True"]}


def case_key(mesh: str, attn: str, fsdp: bool) -> str:
    return f"{mesh}-{attn}-{'fsdp' if fsdp else 'replicated'}"


def batches(n_batches: int = 2, dec_len: int = DEC_LEN):
    rng = np.random.default_rng(0)
    pred = CFG["pred_len"]
    enc = rng.normal(size=(n_batches, BATCH, ENC_LEN, 4)).astype(np.float32)
    dec = rng.normal(size=(n_batches, BATCH, dec_len, 4)).astype(np.float32)
    y = (0.5 * dec[..., -pred:, :1] + 0.1 * rng.normal(
        size=(n_batches, BATCH, pred, 1))).astype(np.float32)
    return enc, dec, y


def option_model(option: str):
    """The option's model (or an attention type's), from the port's own
    seed-0 initial weights, on the CPU."""
    from fine_grained_gaussian_process_forcasting_torch.models.forecast_denoising import (  # noqa: E501
        ForecastDenoising,
    )

    kw = {k: v for k, v in OPTIONS.get(option, {}).items()
          if k != "dec_len"}
    attn = "basic" if "backbone" in kw else option
    return ForecastDenoising(**CFG, attn_type=attn, device="cpu", **kw)


def option_key(option: str, fsdp: bool) -> str:
    return f"{option}-{'fsdp' if fsdp else 'replicated'}"


def digest(state) -> str:
    h = hashlib.sha256()
    for name in sorted(state):
        h.update(name.encode())
        h.update(state[name].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def make_model(attn: str):
    from fine_grained_gaussian_process_forcasting_torch.models.forecast_denoising import (  # noqa: E501
        ForecastDenoising,
    )

    return ForecastDenoising(**CFG, attn_type=attn, device="cpu")


def make_trainer(attn, params, mesh=None, fsdp=False):
    """``attn``: an attention type (its model takes ``params``) or, with
    ``params`` None, one of OPTIONS."""
    from fine_grained_gaussian_process_forcasting_torch.train.trainer import (
        Trainer,
    )

    model = make_model(attn) if params is not None else option_model(attn)
    trainer = Trainer(model, d_model=CFG["d_model"],
                      warmup_steps=10, clip_grad_norm=1.0,
                      nonfinite_guard="skip", device="cpu", mesh=mesh,
                      fsdp=fsdp)
    return trainer, trainer.init_state(params, seed=0)


def step_and_epoch(attn, params, batches, mesh=None, fsdp=False):
    """One step's loss and gradients (no update), the delays autoformer
    took in it, then an epoch over ``batches``: its loss sum and the whole
    parameters after it."""
    from fine_grained_gaussian_process_forcasting_torch.data.window import (
        BatchedSplit,
    )
    from fine_grained_gaussian_process_forcasting_torch.models import (
        transformer,
    )
    from fine_grained_gaussian_process_forcasting_torch.ops.autocorrelation import (  # noqa: E501
        DelayTape,
    )

    trainer, state = make_trainer(attn, params, mesh, fsdp)
    data = trainer.device_put_split(BatchedSplit(*batches))
    tape, plain = DelayTape(), transformer.auto_correlation
    transformer.auto_correlation = tape
    try:
        loss, grads = trainer.gradients(state, tuple(t[0] for t in data))
    finally:
        transformer.auto_correlation = plain
    state, loss_sum, _ = trainer.train_epoch(state, data)
    out = {"loss": float(loss), "grads": {k: v.cpu() for k, v in
                                          grads.items()},
           "delays": [d.tolist() for d in tape.delays],
           "epoch_loss": loss_sum, "full": trainer.full_params(state)}
    return trainer, state, out


def _storage(trainer, state) -> dict:
    """Per FSDP leaf: (elements this rank stores, whole elements), for the
    parameter and its Adam moments."""
    names = [n for n, _ in trainer.model.named_parameters()]
    sharded = trainer.sharded
    out = {}
    for i, name in enumerate(names):
        if name not in sharded.shards:
            continue
        whole = int(np.prod(sharded.full(name, state.params[name]).shape))
        moments = state.opt_state["state"][i]
        out[name] = (state.params[name].numel(),
                     moments["exp_avg"].numel(),
                     moments["exp_avg_sq"].numel(), whole)
    return out


def _round_trip(trainer, state, path: str) -> dict:
    """``save_state`` (rank 0 writes one whole checkpoint) then
    ``restore_state``: whether this rank's parameters and Adam moments
    come back bit-equal, and the file's shapes against the single-device
    model's."""
    os.makedirs(path, exist_ok=True)
    trainer.save_state(path, "ckpt", state)
    back = trainer.restore_state(path, "ckpt", state)
    params = all(torch.equal(back.params[k], v)
                 for k, v in state.params.items())
    moments = all(
        torch.equal(back.opt_state["state"][i][k], v)
        for i, s in state.opt_state["state"].items() for k, v in s.items())
    saved = torch.load(os.path.join(path, "ckpt"), weights_only=True)
    whole = {k: tuple(v.shape) for k, v in saved["params"].items()}
    return {"params": params, "moments": moments, "whole": whole}


def run(rank: int, port: int, workdir: str) -> None:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    from fine_grained_gaussian_process_forcasting_torch.parallel import (
        make_mesh,
        mesh as pm,
    )
    from fine_grained_gaussian_process_forcasting_torch.train import cli

    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    meshes = {k: make_mesh(*shape, device="cpu")
              for k, shape in MESHES.items()}
    out = {"cases": {}, "cli": {}}
    try:
        make_mesh(4, 2, device="cpu")
    except ValueError as e:
        out["short_world"] = str(e)
    for mesh_name, attn, fsdp in CASES:
        mesh = meshes[mesh_name]
        trainer, state, res = step_and_epoch(
            attn, inputs["params"][attn], batches(), mesh, fsdp)
        world = trainer.sharded.world
        res["full_digest"] = digest(res["full"])
        # each leaf that the placement replicates is bit-equal on the
        # ranks that hold it (every rank's copy after the same update)
        res["replicated_ok"] = all([  # a collective a leaf, on every rank
            pm.replicated(state.params[n], world)
            for n, _ in trainer.model.named_parameters()
            if trainer.sharded.copies(n) == WORLD])
        if fsdp:
            res["storage"] = _storage(trainer, state)
            res["round_trip"] = _round_trip(trainer, state, os.path.join(
                workdir, case_key(mesh_name, attn, fsdp)))
        if rank:
            res.pop("grads"), res.pop("full")
        out["cases"][case_key(mesh_name, attn, fsdp)] = res
    for option, fsdp in OPTION_CASES:
        _, _, res = step_and_epoch(
            option, None, batches(dec_len=OPTIONS[option].get(
                "dec_len", DEC_LEN)), meshes["2x2"], fsdp)
        res["full_digest"] = digest(res["full"])
        if rank:
            res.pop("grads"), res.pop("full")
        out["cases"][option_key(option, fsdp)] = res
    for name, flags in CLI_RUNS.items():
        path = os.path.join(workdir, f"cli_{name}")
        results = cli.main(CLI_ARGS + flags + ["--out_dir", path],
                           device="cpu")
        out["cli"][name] = [r["mse"] for r in results]
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def card_rank(rank: int, world: int, port: int, workdir: str) -> None:
    """One of ``world`` ranks on the one card (gloo, cuda:0), an n_data
    ``world`` mesh: ``basic`` at these widths, one step's loss and gathered
    gradients, the kernels this rank launched; to ``card{r}.pt``."""
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    from fine_grained_gaussian_process_forcasting_torch.data.window import (
        BatchedSplit,
    )
    from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (
        fused_gp,
        head_folded_attention,
    )
    from fine_grained_gaussian_process_forcasting_torch.parallel import (
        make_mesh,
    )
    from fine_grained_gaussian_process_forcasting_torch.train.trainer import (
        Trainer,
    )

    mesh = make_mesh(world, 1, device="cuda")
    trainer = Trainer(option_model("basic").cuda(), d_model=CFG["d_model"],
                      warmup_steps=10, device="cuda", mesh=mesh)
    state = trainer.init_state(seed=0)
    data = trainer.device_put_split(BatchedSplit(*batches()))
    counters = (fused_gp, head_folded_attention)
    for module in counters:
        module.launches = module.bwd_launches = 0
    loss, grads = trainer.gradients(state, tuple(t[0] for t in data))
    torch.save({"loss": float(loss),
                "grads": {k: v.cpu() for k, v in grads.items()},
                "backend": torch.distributed.get_backend(),
                "launches": {m.__name__.rsplit(".", 1)[1]:
                             (m.launches, m.bwd_launches) for m in counters}},
               os.path.join(workdir, f"card{rank}.pt"))
    torch.distributed.destroy_process_group()
