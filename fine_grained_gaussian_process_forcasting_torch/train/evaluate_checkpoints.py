"""Checkpoint scoring and comparison figures (counterpart of the JAX
package's ``train/evaluate_checkpoints.py``).

Reloads the harness's ``torch.save``d checkpoints over a {attn_type} x
{d_model} x {stack_size} sweep per seed, scores each on the test windows
(per-step MSE and MAE) and draws the per-step bar charts and forecast
overlays.  A missing checkpoint, or one whose shapes are not the model's,
is skipped with a message, as the reference's swallowed errors were.  The
data layer is the port's (``data/table.py``): the card's machine has no
pandas.  The figures need matplotlib, imported only when one is drawn.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence

import numpy as np

from fine_grained_gaussian_process_forcasting_torch.data import table
from fine_grained_gaussian_process_forcasting_torch.data.experiment import (
    ExperimentConfig,
)
from fine_grained_gaussian_process_forcasting_torch.data.window import (
    batch_sampled_data,
)
from fine_grained_gaussian_process_forcasting_torch.device import resolve_device
from fine_grained_gaussian_process_forcasting_torch.models.forecast_denoising import (
    ForecastDenoising,
)
from fine_grained_gaussian_process_forcasting_torch.train.checkpoint import (
    load_checkpoint,
)
from fine_grained_gaussian_process_forcasting_torch.train.trainer import (
    Trainer,
)


@dataclasses.dataclass
class EvalArgs:
    """The JAX ``EvalArgs``, field for field."""

    exp_name: str = "solar"
    pred_len: int = 96
    seeds: Sequence[int] = (8220,)
    attn_types: Sequence[str] = ("basic", "ATA")
    d_models: Sequence[int] = (16, 32)
    stack_sizes: Sequence[int] = (1, 2, 3)
    denoising: bool = True
    gp: bool = True
    no_noise: bool = False
    iso: bool = False
    residual: bool = False
    input_corrupt: bool = False
    out_dir: str = "."
    num_inducing: int = 512  # must match the trained checkpoint
    gp_hidden_dims: Sequence[int] = ()
    max_samples: Optional[int] = None  # override the test sample count
    batch_size: Optional[int] = None
    # checkpoint-name prefix when the training run was labelled apart from
    # the attention type (run.sh labels variants e.g. "ATA_gp")
    model_prefix: Optional[str] = None


def _model_name(args: EvalArgs, attn: str, seed: int) -> str:
    """The harness's checkpoint name of one configuration and seed."""
    return "{}_{}_{}_{}{}{}{}{}{}{}".format(
        args.model_prefix or attn, args.exp_name, args.pred_len, seed,
        "_denoise" if args.denoising else "",
        "_gp" if args.gp else "",
        "_predictions" if args.no_noise else "",
        "_iso" if args.iso else "",
        "_residual" if args.residual else "",
        "_input_corrupt" if args.input_corrupt else "",
    )


def _load_params(model, model_path: str, name: str) -> dict:
    """The checkpoint's parameters, checked against the model's shapes."""
    params = load_checkpoint(model_path, name)["params"]
    for key, value in model.state_dict().items():
        got = params.get(key)
        if got is None or tuple(got.shape) != tuple(value.shape):
            shape = None if got is None else tuple(got.shape)
            raise ValueError(f"param {key} has shape {shape}, expected "
                             f"{tuple(value.shape)}")
    return params


def evaluate_checkpoints(raw_data: table.Frame, args: EvalArgs, *,
                         device="cuda") -> Dict:
    """Each checkpoint found, keyed ``{name}_d{d_model}_s{stack}``: its
    per-step MSE and MAE (pred_len,), their means, its predictions and the
    test targets (n_batches, batch, pred_len)."""
    device = resolve_device(device)
    config = ExperimentConfig(args.pred_len, args.exp_name,
                              root_folder=os.path.join(args.out_dir,
                                                       "outputs"))
    formatter = config.make_data_formatter()
    params_exp = formatter.get_experiment_params()
    model_params = formatter.get_default_model_params()
    data = formatter.transform_data(raw_data)
    train_max, valid_max = formatter.get_num_samples_for_calibration()
    if args.max_samples is not None:
        train_max = valid_max = args.max_samples
    batch_size = args.batch_size or model_params["minibatch_size"][0]
    _, _, test = batch_sampled_data(
        data, 0.8 if args.exp_name != "exchange" else 0.4,
        (train_max, valid_max), params_exp["total_time_steps"],
        params_exp["num_encoder_steps"], args.pred_len,
        params_exp["column_definition"], batch_size)

    model_path = os.path.join(args.out_dir,
                              f"models_{args.exp_name}_{args.pred_len}")
    n_heads = model_params["num_heads"]
    y = test.y[..., 0]
    results: Dict[str, Dict] = {}
    for seed in args.seeds:
        for attn in args.attn_types:
            name = _model_name(args, attn, seed)
            for d_model in args.d_models:
                for stack in args.stack_sizes:
                    model = ForecastDenoising(
                        src_input_size=test.enc.shape[-1],
                        tgt_input_size=test.dec.shape[-1],
                        d_model=d_model, n_heads=n_heads,
                        d_k=d_model // n_heads, stack_size=stack,
                        pred_len=args.pred_len, attn_type=attn,
                        gp=args.gp, denoise=args.denoising,
                        no_noise=args.no_noise, residual=args.residual,
                        input_corrupt=args.input_corrupt,
                        num_inducing=args.num_inducing,
                        gp_hidden_dims=tuple(args.gp_hidden_dims),
                        device=device)
                    try:
                        params = _load_params(model, model_path, name)
                    except (OSError, RuntimeError, ValueError) as e:
                        print(f"skip {name} d{d_model} s{stack}: {e}")
                        continue
                    trainer = Trainer(model, d_model=d_model, device=device)
                    state = trainer.init_state(params, seed=0)
                    _, _, preds = trainer.eval_epoch(
                        state, trainer.device_put_split(test))
                    preds = preds.cpu().numpy()[..., 0]
                    key = f"{name}_d{d_model}_s{stack}"
                    results[key] = {
                        "per_step_mse": ((preds - y) ** 2).mean(axis=(0, 1)),
                        "per_step_mae": np.abs(preds - y).mean(axis=(0, 1)),
                        "mse": float(((preds - y) ** 2).mean()),
                        "mae": float(np.abs(preds - y).mean()),
                        "predictions": preds,
                        "test_y": y,
                    }
                    print(key, "MSE %.4f MAE %.4f" % (results[key]["mse"],
                                                      results[key]["mae"]))
    return results


def _pyplot():
    """matplotlib's pyplot on the Agg backend; a clear ImportError where
    matplotlib is not installed (the card's machine)."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the checkpoint figures need matplotlib, which is "
                          "not installed here; the scores need nothing "
                          "more") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_per_step_errors(results: Dict, exp_name: str, out_dir: str = ".",
                         metric: str = "per_step_mse") -> Optional[str]:
    """Per-step error bars of every result; the figure's path."""
    if not results:
        return None
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(9, 4))
    width = 0.8 / max(len(results), 1)
    for i, (name, r) in enumerate(results.items()):
        steps = np.arange(len(r[metric]))
        ax.bar(steps + i * width, r[metric], width=width, label=name)
    ax.set_xlabel("forecast step")
    ax.set_ylabel(metric)
    ax.legend(fontsize=6)
    path = os.path.join(out_dir, f"{exp_name}_{metric}_comparison.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_forecasts(results: Dict, exp_name: str, out_dir: str = ".",
                   window: int = 0, batch: int = 0) -> Optional[str]:
    """Every result's forecast of one window over the ground truth; the
    figure's path."""
    if not results:
        return None
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(9, 4))
    first = next(iter(results.values()))
    ax.plot(first["test_y"][batch, window], "k-", label="ground truth", lw=2)
    for name, r in results.items():
        ax.plot(r["predictions"][batch, window], "--", label=name)
    ax.legend(fontsize=6)
    ax.set_xlabel("forecast step")
    path = os.path.join(out_dir, f"{exp_name}_forecasts.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path
