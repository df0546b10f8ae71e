"""Baseline-model harness: DeepAR / N-BEATS / DLinear / CMGP on univariate
windows (counterpart of the JAX package's ``train/baselines_harness.py``).

The same study as JAX's: the HPO space ``d_model in {32, 64}``, ``stack in
{1, 2}`` (N-BEATS pinned to stack 1, CMGP to d_model 32) on the TPE sampler
seeded with ``seed``; Noam-Adam; the per-model losses (DeepAR's Gaussian NLL
teacher-forced over ``[history ++ target][:, :-1]``, CMGP's marginal
likelihood, MSE for the others); best-validation checkpointing
(``train/checkpoint.py``); and the ``Previous_set_up_Final_errors_{exp}.csv``
report, written as JAX's pandas writes it (``table.append_errors_csv``).

The data is windowed on the host (numpy, ``data/univariate.py``) and copied
to the device once per trial; the models run on ``device`` (``cuda`` unless
the caller asks for the CPU).  A model's weights are drawn from a CPU
generator seeded with ``seed``, so every device starts from the same ones.
DeepAR's test batch i samples with the normal draws of a CPU generator
seeded i (``deepar_eps``), where JAX uses ``PRNGKey(i)``: the same draws on
every device, not JAX's.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from fine_grained_gaussian_process_forcasting_torch.data import table
from fine_grained_gaussian_process_forcasting_torch.data.experiment import (
    ExperimentConfig,
)
from fine_grained_gaussian_process_forcasting_torch.data.univariate import (
    TARGET_COLUMNS,
    UnivariateBatches,
    UnivariateLoader,
)
from fine_grained_gaussian_process_forcasting_torch.device import resolve_device
from fine_grained_gaussian_process_forcasting_torch.models.cmgp import CMGP
from fine_grained_gaussian_process_forcasting_torch.models.deepar import (
    DeepAR,
    deepar_nll,
)
from fine_grained_gaussian_process_forcasting_torch.models.dlinear import (
    DLinear,
)
from fine_grained_gaussian_process_forcasting_torch.models.nbeats import NBeats
from fine_grained_gaussian_process_forcasting_torch.train import hpo
from fine_grained_gaussian_process_forcasting_torch.train.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from fine_grained_gaussian_process_forcasting_torch.train.schedule import (
    noam_adam,
)

MODELS = ("DeepAR", "NBeats", "DLinear", "CMGP")


@dataclasses.dataclass
class BaselineArgs:
    """The JAX ``BaselineArgs``, field for field."""

    exp_name: str = "solar"
    model_name: str = "DLinear"  # DeepAR | NBeats | DLinear | CMGP
    pred_len: int = 96
    seed: int = 1234
    n_trials: int = 5
    num_epochs: int = 50
    out_dir: str = "."
    max_encoder_length: int = 8 * 24


def _full_x(batches: UnivariateBatches) -> np.ndarray:
    return np.concatenate([batches.x_enc, batches.x_dec], axis=2)


class BaselinesHarness:
    def __init__(self, raw_data: table.Frame, args: BaselineArgs,
                 formatter=None, *, device="cuda"):
        if args.model_name not in MODELS:
            raise ValueError(f"model_name={args.model_name!r}, not one of "
                             f"{MODELS}")
        self.args = args
        self.device = resolve_device(device)
        self.model_id = args.model_name
        self.pred_len = args.pred_len
        self.seed = args.seed

        if formatter is None:
            config = ExperimentConfig(
                args.pred_len, args.exp_name,
                root_folder=os.path.join(args.out_dir, "outputs"))
            formatter = config.make_data_formatter()
        data = formatter.transform_data(raw_data)

        self.loader = UnivariateLoader(
            data,
            target_col=TARGET_COLUMNS[args.exp_name],
            pred_len=args.pred_len,
            max_encoder_length=args.max_encoder_length,
        )
        self.model_path = os.path.join(
            args.out_dir, f"models_{args.exp_name}_{args.pred_len}")
        os.makedirs(self.model_path, exist_ok=True)
        self.model_name = (f"{args.model_name}_{args.exp_name}_{args.seed}_"
                           f"{args.pred_len}")
        self.best_val = 1e10
        self.best_params: Optional[Dict[str, torch.Tensor]] = None
        self.best_model: Optional[nn.Module] = None
        self.best_config: Optional[tuple] = None  # (d_model, stack_size)
        # (trial, epoch, train loss summed over batches, valid loss summed)
        self.epoch_losses = []

    # ------------------------------------------------------------------ #

    def _make_model(self, d_model: int, stack_size: int) -> nn.Module:
        """The study's model at (d_model, stack_size), on the device, its
        weights from a CPU generator seeded ``seed``."""
        L = self.args.max_encoder_length
        kw = dict(device=self.device)
        gen = torch.Generator().manual_seed(self.seed)
        if self.model_id == "DeepAR":
            return DeepAR(embedding_dim=d_model, hidden_dim=d_model,
                          n_layers=stack_size, generator=gen, **kw)
        if self.model_id == "NBeats":
            return NBeats(backcast_length=L, forecast_length=self.pred_len,
                          hidden_layer_units=d_model, generator=gen, **kw)
        if self.model_id == "CMGP":
            # stack_size -> number of convolved latent processes
            return CMGP(pred_len=self.pred_len, n_latent=stack_size, **kw)
        return DLinear(seq_len=L, pred_len=self.pred_len, **kw)

    def loss(self, model: nn.Module, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
        """x: full history (b, L, 1); y: (b, pred_len, 1)."""
        if self.model_id == "DeepAR":
            # teacher forcing over [history ++ target]: z_t from z_{<t}
            full = torch.cat([x, y], dim=1)
            mu, sigma = model(full[:, :-1])
            tgt = full[:, 1:, 0]
            n = y.shape[1]
            return deepar_nll(mu[:, -n:], sigma[:, -n:], tgt[:, -n:])
        if self.model_id == "NBeats":
            _, forecast = model(x)
            return torch.mean((y[..., 0] - forecast) ** 2)
        if self.model_id == "CMGP":
            # GP hyperparameters train by exact marginal likelihood
            return model.nll(x, y)
        return torch.mean((y - model(x)) ** 2)

    def deepar_eps(self, batch: int, b: int) -> torch.Tensor:
        """DeepAR's normal draws (1, pred_len, b) for test batch ``batch``:
        a CPU generator seeded ``batch``, the same on every device."""
        gen = torch.Generator().manual_seed(batch)
        return torch.randn((1, self.pred_len, b), generator=gen).to(
            self.device)

    def predict(self, model: nn.Module, x: torch.Tensor,
                batch: int) -> torch.Tensor:
        """x: (b, L, 1) -> (b, pred_len, 1); ``batch`` picks DeepAR's
        draws."""
        if self.model_id == "DeepAR":
            samples = model.sample(x, self.pred_len, 1,
                                   eps=self.deepar_eps(batch, x.shape[0]))
            return torch.quantile(samples, 0.5, dim=0)[..., None]
        if self.model_id == "NBeats":
            _, forecast = model(x)
            return forecast[..., None]
        return model(x)

    def train_step(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                   x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """One update on one batch; returns its loss (no host read)."""
        optimizer.zero_grad(set_to_none=True)
        loss = self.loss(model, x, y)
        loss.backward()
        optimizer.step()
        return loss.detach()

    # ------------------------------------------------------------------ #

    def objective(self, trial: hpo.Trial) -> float:
        # CMGP ignores d_model (only n_latent <- stack_size matters): pinned
        # so the study covers distinct configurations; DLinear has neither
        # axis, so its space is one point either way
        d_model = (trial.suggest_categorical("d_model", [32])
                   if self.model_id == "CMGP"
                   else trial.suggest_categorical("d_model", [32, 64]))
        w_steps = trial.suggest_categorical("w_steps", [4000])
        stack_size = trial.suggest_categorical(
            "stack_size", [1, 2] if self.model_id != "NBeats" else [1])

        model = self._make_model(d_model, stack_size)
        optimizer = noam_adam(model.parameters(), d_model, w_steps)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        tl, vl = self.loader.train_loader, self.loader.valid_loader
        train_x, train_y = put(_full_x(tl)), put(tl.y)
        valid_x, valid_y = put(_full_x(vl)), put(vl.y)

        val_loss = 1e10
        for epoch in range(self.args.num_epochs):
            model.train()
            total_loss = torch.stack([
                self.train_step(model, optimizer, train_x[i], train_y[i])
                for i in range(train_x.shape[0])]).sum()
            model.eval()
            with torch.no_grad():
                v = float(torch.stack([
                    self.loss(model, valid_x[i], valid_y[i])
                    for i in range(valid_x.shape[0])]).sum())
            self.epoch_losses.append((trial.number, epoch, float(total_loss),
                                      v))
            if epoch % 5 == 0:
                print(f"Train epoch: {epoch}, loss: {float(total_loss):.4f}")
                print(f"val loss: {v:.4f}")
            if v < val_loss:
                val_loss = v
                if val_loss < self.best_val:
                    self.best_val = val_loss
                    self.best_params = {k: t.detach().clone() for k, t in
                                        model.state_dict().items()}
                    self.best_model = model
                    self.best_config = (d_model, stack_size)
                    save_checkpoint(self.model_path, self.model_name,
                                    self.best_params)
        return val_loss

    def run_study(self) -> hpo.Study:
        study = hpo.create_study(study_name=self.model_id, sampler="tpe",
                                 seed=self.seed)
        study.optimize(self.objective, n_trials=self.args.n_trials)
        return study

    def load_best(self, d_model: int, stack_size: int) -> None:
        """The best parameters from this harness's checkpoint
        (``model_name`` in ``model_path``, e.g. one converted from the JAX
        package's by ``scripts/convert_jax_checkpoints.py``), in the model
        of the study's (d_model, stack_size), for ``evaluate``; a
        checkpoint of another model raises, naming its leaves."""
        model = self._make_model(d_model, stack_size)
        params = load_checkpoint(self.model_path, self.model_name,
                                 map_location="cpu")["params"]
        model.load_state_dict(params)
        self.best_params = {k: t.detach().clone()
                            for k, t in model.state_dict().items()}
        self.best_model = model
        self.best_config = (d_model, stack_size)

    def evaluate(self) -> dict:
        """Test MSE and MAE of the best parameters, a row appended to
        ``Previous_set_up_Final_errors_{exp}.csv``; returns them and the
        predictions (n_batches, batch, pred_len, 1)."""
        if self.best_params is None:
            raise RuntimeError("run_study first")
        model = self.best_model
        model.load_state_dict(self.best_params)
        model.eval()
        tl = self.loader.test_loader
        x = torch.from_numpy(_full_x(tl)).to(self.device)
        y = tl.y

        with torch.no_grad():
            preds = np.stack([self.predict(model, x[i], i).cpu().numpy()
                              for i in range(x.shape[0])])

        mse = float(np.mean((preds - y) ** 2))
        mae = float(np.mean(np.abs(preds - y)))
        errors = {self.model_name: {"MSE": f"{mse:.3f}",
                                    "MAE": f"{mae: .3f}"}}
        print(errors)
        table.append_errors_csv(
            os.path.join(self.args.out_dir,
                         f"Previous_set_up_Final_errors_"
                         f"{self.args.exp_name}.csv"),
            self.model_name, errors[self.model_name])
        return {"mse": mse, "mae": mae, "predictions": preds}
