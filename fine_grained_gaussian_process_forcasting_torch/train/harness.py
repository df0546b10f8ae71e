"""Experiment harness: split -> HPO study -> epoch loop -> checkpoint ->
evaluation (counterpart of the JAX package's ``train/harness.py``).

The same behaviour as the JAX harness (and the reference's ``Train``):

- ``model_name`` encodes the whole ablation configuration;
- the HPO space ``d_model x stack x w_steps`` on the grid sampler, duplicate
  configurations pruned, trial ``n`` initialised from ``seed + n``;
- the best validation loss across *all* trials is checkpointed
  (``torch.save``, ``train/checkpoint.py``);
- per epoch the metrics JSONL, per trial the loss-curve ``.npy`` files;
- the study state (completed trials, best value and configuration) is a JSON
  beside the curves, so a restarted study skips finished trials and
  rebuilds the best parameters from their checkpoint;
- ``evaluate``: test MSE / MAE with their std, the predictions ``.npz``, and
  a row appended to ``reported_errors_{exp}.csv``;
- ``MultiSeedExperimentHarness``: the seeds of one study trained together
  (``train/multiseed.py``), with a best checkpoint, loss curves and an
  evaluation per seed.

The data is windowed on the host (numpy), copied to the device once per
trial, and the model runs on ``device`` (``cuda`` unless the caller asks for
the CPU).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

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
from fine_grained_gaussian_process_forcasting_torch.train import hpo
from fine_grained_gaussian_process_forcasting_torch.train.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from fine_grained_gaussian_process_forcasting_torch.train.multiseed import (
    MultiSeedTrainer,
)
from fine_grained_gaussian_process_forcasting_torch.train.observability import (
    MetricsLogger,
    StepTimer,
)
from fine_grained_gaussian_process_forcasting_torch.train.trainer import Trainer


@dataclasses.dataclass
class HarnessArgs:
    """The JAX ``HarnessArgs``, field for field."""

    exp_name: str = "solar"
    model_name: str = "ATA"
    attn_type: str = "ATA"
    pred_len: int = 96
    seed: int = 1234
    n_trials: int = 5
    num_epochs: int = 50
    denoising: bool = True
    gp: bool = True
    residual: bool = False
    no_noise: bool = False
    iso: bool = False
    input_corrupt_training: bool = False
    backbone: str = "transformer"
    out_dir: str = "."
    use_pallas_gp: bool = False
    use_pallas_attention: Optional[bool] = None
    use_fused_gp: bool = True
    num_inducing: int = 512
    gp_hidden_dims: tuple = ()
    gp_kind: str = "variational"
    gp_ls_init: float = 0.0
    exact_noise_init: float = 0.0
    lam_clip_max: float = 0.005
    gp_inject: str = "joint"
    d_model_choices: Tuple[int, ...] = (32, 16)
    stack_choices: Tuple[int, ...] = (1, 3)
    w_steps_choices: Tuple[int, ...] = (4000,)
    max_train_samples: Optional[int] = None
    max_valid_samples: Optional[int] = None
    clip_grad_norm: float = 0.0
    nonfinite_guard: str = "off"


class ExperimentHarness:
    def __init__(self, raw_data: table.Frame, args: HarnessArgs, *,
                 device="cuda"):
        self.args = args
        self.device = resolve_device(device)
        self.input_corrupt = args.input_corrupt_training
        self.denoising = args.denoising if not self.input_corrupt else False
        self.gp = args.gp

        config = ExperimentConfig(
            args.pred_len, args.exp_name,
            root_folder=os.path.join(args.out_dir, "outputs"))
        self.formatter = config.make_data_formatter()
        self.params = self.formatter.get_experiment_params()
        self.model_params = self.formatter.get_default_model_params()
        self.batch_size = self.model_params["minibatch_size"][0]
        self.pred_len = args.pred_len
        self.seed = args.seed

        self.model_path = os.path.join(
            args.out_dir, f"models_{args.exp_name}_{args.pred_len}")
        os.makedirs(self.model_path, exist_ok=True)
        self.model_name = "{}_{}_{}_{}{}{}{}{}{}{}".format(
            args.model_name, args.exp_name, args.pred_len, args.seed,
            "_denoise" if self.denoising else "",
            "_gp" if self.gp else "",
            "_predictions" if args.no_noise else "",
            "_iso" if args.iso else "",
            "_residual" if args.residual else "",
            "_input_corrupt" if self.input_corrupt else "",
        )

        self.best_val = 1e10
        self.best_params = None
        self.best_config = None
        self.raw_data = raw_data
        self.train_data, self.valid_data, self.test_data = self._split_data()

        # crash-safe study resume: completed trials and the best-so-far
        # persist to a JSON beside the loss curves
        self._study_state_path = os.path.join(
            args.out_dir, "losses_lists", f"{self.model_name}_study.json")
        self._completed_trials = {}
        self._load_study_state()

    # ------------------------------------------------------------------ #

    def _load_study_state(self) -> None:
        if not os.path.exists(self._study_state_path):
            return
        with open(self._study_state_path) as f:
            st = json.load(f)
        self._completed_trials = st.get("trials", {})
        self._apply_study_state(st)

    def _apply_study_state(self, st: dict) -> None:
        if st.get("best_config") is not None:
            self.best_val = st["best_val"]
            self.best_config = tuple(st["best_config"])

    def _study_state_payload(self) -> dict:
        return {"trials": self._completed_trials, "best_val": self.best_val,
                "best_config": (list(self.best_config)
                                if self.best_config else None)}

    def _save_study_state(self) -> None:
        os.makedirs(os.path.dirname(self._study_state_path), exist_ok=True)
        tmp = self._study_state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._study_state_payload(), f)
        os.replace(tmp, self._study_state_path)

    def _load_best_params(self, model_name: str, d_model: int,
                          stack_size: int):
        """The checkpointed best parameters after a restart, checked against
        the shapes of the model the study state names."""
        want = self._make_model(d_model, stack_size).state_dict()
        params = load_checkpoint(self.model_path, model_name)["params"]
        for name, value in want.items():
            got = params.get(name)
            if got is None or tuple(got.shape) != tuple(value.shape):
                shape = None if got is None else tuple(got.shape)
                raise ValueError(
                    f"checkpoint {model_name!r} has param {name} of shape "
                    f"{shape} but the study state expects "
                    f"{tuple(value.shape)}: the on-disk study JSON "
                    f"({self._study_state_path}) is stale relative to the "
                    "checkpoint; delete it (or the checkpoint) and re-run.")
        return params

    # ------------------------------------------------------------------ #

    def _split_data(self):
        data = self.formatter.transform_data(self.raw_data)
        train_max, valid_max = self.formatter.get_num_samples_for_calibration()
        if self.args.max_train_samples is not None:
            train_max = self.args.max_train_samples
        if self.args.max_valid_samples is not None:
            valid_max = self.args.max_valid_samples
        train_frac = 0.4 if self.args.exp_name == "exchange" else 0.8
        # drop-last batching would give no batch for a split whose sample
        # cap is below the batch size
        cap = min(train_max, valid_max)
        if cap < self.batch_size:
            self.batch_size = max(1, cap)
        return batch_sampled_data(
            data, train_frac, (train_max, valid_max),
            self.params["total_time_steps"], self.params["num_encoder_steps"],
            self.pred_len, self.params["column_definition"], self.batch_size)

    def _make_model(self, d_model: int, stack_size: int,
                    seed: int = 0) -> ForecastDenoising:
        n_heads = self.model_params["num_heads"]
        d_k = d_model // n_heads
        assert d_model % d_k == 0
        a = self.args
        return ForecastDenoising(
            src_input_size=self.train_data.enc.shape[-1],
            tgt_input_size=self.train_data.dec.shape[-1],
            d_model=d_model, n_heads=n_heads, d_k=d_k, stack_size=stack_size,
            pred_len=self.pred_len, attn_type=a.attn_type,
            backbone=a.backbone, gp=self.gp, denoise=self.denoising,
            no_noise=a.no_noise, residual=a.residual,
            input_corrupt=self.input_corrupt, num_inducing=a.num_inducing,
            gp_hidden_dims=tuple(a.gp_hidden_dims), gp_kind=a.gp_kind,
            gp_ls_init=a.gp_ls_init, exact_noise_init=a.exact_noise_init,
            lam_clip_max=a.lam_clip_max, gp_inject=a.gp_inject,
            use_pallas_gp=a.use_pallas_gp,
            use_pallas_attention=a.use_pallas_attention,
            use_fused_gp=a.use_fused_gp, device=self.device,
            generator=torch.Generator().manual_seed(seed))

    # ------------------------------------------------------------------ #

    def objective(self, trial: hpo.Trial) -> float:
        args = self.args
        d_model = trial.suggest_categorical("d_model",
                                            list(args.d_model_choices))
        w_steps = trial.suggest_categorical("w_steps",
                                            list(args.w_steps_choices))
        stack_size = trial.suggest_categorical("stack_size",
                                               list(args.stack_choices))

        trial_key = f"d{d_model}_w{w_steps}_s{stack_size}"
        if trial_key in self._completed_trials:
            val = self._completed_trials[trial_key]
            print(f"trial {trial_key}: resumed from study state "
                  f"(val {val:.4f})")
            return val

        seed = self.seed + trial.number
        model = self._make_model(d_model, stack_size, seed)
        trainer = Trainer(model, d_model=d_model, warmup_steps=w_steps,
                          clip_grad_norm=args.clip_grad_norm,
                          nonfinite_guard=args.nonfinite_guard,
                          device=self.device)
        train_dev = trainer.device_put_split(self.train_data)
        valid_dev = trainer.device_put_split(self.valid_data)
        state = trainer.init_state(seed=seed)

        losses_dir = os.path.join(args.out_dir, "losses_lists")
        metrics = MetricsLogger(os.path.join(
            losses_dir, f"{self.model_name}_metrics.jsonl"))
        timer = StepTimer()
        val_loss = 1e10
        curves_train, curves_valid = [], []
        for epoch in range(args.num_epochs):
            state, total_loss, total_mse = trainer.train_epoch(state,
                                                               train_dev)
            v_loss, v_mse, _ = trainer.eval_epoch(state, valid_dev)
            epoch_s = timer.tick()
            curves_train.append(total_mse)
            curves_valid.append(v_mse)
            metrics.log(epoch, train_loss=total_loss, train_mse=total_mse,
                        valid_loss=v_loss, valid_mse=v_mse,
                        epoch_seconds=epoch_s)
            if epoch % 5 == 0:
                print(f"Train epoch: {epoch}, loss: {total_loss:.4f}")
                print(f"val loss: {v_loss:.4f}")
            if v_loss < val_loss:
                val_loss = v_loss
                if val_loss < self.best_val:
                    self.best_val = val_loss
                    # the live state advances in place: keep a copy
                    self.best_params = {k: v.detach().clone()
                                        for k, v in state.params.items()}
                    self.best_config = (d_model, stack_size)
                    save_checkpoint(self.model_path, self.model_name,
                                    self.best_params)

        os.makedirs(losses_dir, exist_ok=True)
        np.save(os.path.join(
            losses_dir, f"{self.model_name}_mse_losses_train.npy"),
            np.asarray(curves_train))
        np.save(os.path.join(
            losses_dir, f"{self.model_name}_mse_losses_valid.npy"),
            np.asarray(curves_valid))
        self._completed_trials[trial_key] = val_loss
        self._save_study_state()
        return val_loss

    def run_study(self) -> hpo.Study:
        study = hpo.create_study(study_name=self.args.model_name,
                                 sampler="grid", seed=self.seed)
        study.optimize(self.objective, n_trials=self.args.n_trials)
        best = study.best_trial
        print("Best trial:")
        print("  Value: ", best.value)
        print("  Params: ")
        for key, value in best.params.items():
            print(f"    {key}: {value}")
        return study

    # ------------------------------------------------------------------ #

    def evaluate(self) -> dict:
        if self.best_params is None and self.best_config is not None:
            # a restarted process: the best parameters are in the checkpoint
            self.best_params = self._load_best_params(self.model_name,
                                                      *self.best_config)
        assert self.best_params is not None, "run_study first"
        d_model, stack_size = self.best_config
        model = self._make_model(d_model, stack_size)
        trainer = Trainer(model, d_model=d_model, device=self.device)
        test_dev = trainer.device_put_split(self.test_data)
        state = trainer.init_state(self.best_params, seed=0)
        _, _, preds = trainer.eval_epoch(state, test_dev)
        preds = preds.cpu().numpy()[..., 0]  # (nb, bs, pred_len)
        test_y = self.test_data.y[..., 0]

        mse_all = (preds - test_y) ** 2
        mae_all = np.abs(preds - test_y)
        errors = {
            "MSE": f"{mse_all.mean():.3f} {mse_all.std():.4f}",
            "MAE": f"{mae_all.mean(): .3f} {mae_all.std():.4f}",
        }
        print({self.model_name: errors})

        tensor_dir = os.path.join(self.args.out_dir, self.args.exp_name)
        os.makedirs(tensor_dir, exist_ok=True)
        np.savez(os.path.join(tensor_dir, f"{self.model_name}.npz"),
                 predictions=preds, test_y=test_y)
        table.append_errors_csv(
            os.path.join(self.args.out_dir,
                         f"reported_errors_{self.args.exp_name}.csv"),
            self.model_name, errors)
        return {"mse": float(mse_all.mean()), "mae": float(mae_all.mean()),
                "errors": errors}


class MultiSeedExperimentHarness(ExperimentHarness):
    """The reference's N-seed protocol as one study whose trials train every
    seed together (``train/multiseed.py``), as N sequential
    ``ExperimentHarness`` studies would: seed s's trial n starts from
    ``s + n``, and each seed keeps its own best validation loss, checkpoint
    (``_name_for_seed``), loss curves and evaluation.  A trial's value is
    the mean over seeds of their best validation losses."""

    def __init__(self, raw_data: table.Frame, args: HarnessArgs, seeds, *,
                 device="cuda"):
        self.seeds = tuple(int(s) for s in seeds)
        n = len(self.seeds)
        # before super().__init__: _load_study_state restores into these
        self.best_val_seed = [1e10] * n
        self.best_params_seed = [None] * n
        self.best_config_seed = [None] * n
        super().__init__(raw_data, args, device=device)

    def _apply_study_state(self, st: dict) -> None:
        super()._apply_study_state(st)
        vals = st.get("best_val_seed") or []
        cfgs = st.get("best_config_seed") or []
        for i, (v, c) in enumerate(zip(vals, cfgs)):
            if i < len(self.seeds) and c is not None:
                self.best_val_seed[i] = v
                self.best_config_seed[i] = tuple(c)

    def _study_state_payload(self) -> dict:
        payload = super()._study_state_payload()
        payload["best_val_seed"] = self.best_val_seed
        payload["best_config_seed"] = [
            list(c) if c is not None else None for c in self.best_config_seed]
        return payload

    def _name_for_seed(self, seed: int) -> str:
        a = self.args
        return "{}_{}_{}_{}{}{}{}{}{}{}".format(
            a.model_name, a.exp_name, a.pred_len, seed,
            "_denoise" if self.denoising else "",
            "_gp" if self.gp else "",
            "_predictions" if a.no_noise else "",
            "_iso" if a.iso else "",
            "_residual" if a.residual else "",
            "_input_corrupt" if self.input_corrupt else "",
        )

    def objective(self, trial: hpo.Trial) -> float:
        args = self.args
        d_model = trial.suggest_categorical("d_model",
                                            list(args.d_model_choices))
        w_steps = trial.suggest_categorical("w_steps",
                                            list(args.w_steps_choices))
        stack_size = trial.suggest_categorical("stack_size",
                                               list(args.stack_choices))

        trial_key = f"d{d_model}_w{w_steps}_s{stack_size}"
        if trial_key in self._completed_trials:
            val = self._completed_trials[trial_key]
            print(f"trial {trial_key}: resumed from study state "
                  f"(val {val:.4f})")
            return val

        trial_seeds = [s + trial.number for s in self.seeds]
        trainer = MultiSeedTrainer(
            self._make_model(d_model, stack_size), d_model=d_model,
            n_seeds=len(self.seeds), warmup_steps=w_steps,
            clip_grad_norm=args.clip_grad_norm,
            nonfinite_guard=args.nonfinite_guard, device=self.device)
        train_dev = trainer.device_put_split(self.train_data)
        valid_dev = trainer.device_put_split(self.valid_data)
        state = trainer.init_state(
            trial_seeds,
            lambda s: self._make_model(d_model, stack_size, s).state_dict())

        val_best = np.full(len(self.seeds), 1e10)
        curves_train, curves_valid = [], []
        for epoch in range(args.num_epochs):
            state, loss, mse = trainer.train_epoch(state, train_dev)
            v_loss, v_mse, _ = trainer.eval_epoch(state, valid_dev)
            curves_train.append(mse)
            curves_valid.append(v_mse)
            if epoch % 5 == 0:
                print(f"Train epoch: {epoch}, loss: "
                      + " ".join(f"{x:.4f}" for x in loss))
                print("val loss: " + " ".join(f"{x:.4f}" for x in v_loss))
            improved = v_loss < val_best
            val_best = np.minimum(val_best, v_loss)
            for i in np.flatnonzero(improved):
                if v_loss[i] < self.best_val_seed[i]:
                    self.best_val_seed[i] = float(v_loss[i])
                    self.best_params_seed[i] = trainer.seed_params(state,
                                                                   int(i))
                    self.best_config_seed[i] = (d_model, stack_size)
                    save_checkpoint(self.model_path,
                                    self._name_for_seed(self.seeds[i]),
                                    self.best_params_seed[i])

        losses_dir = os.path.join(args.out_dir, "losses_lists")
        os.makedirs(losses_dir, exist_ok=True)
        for i, seed in enumerate(self.seeds):
            name = self._name_for_seed(seed)
            np.save(os.path.join(losses_dir, f"{name}_mse_losses_train.npy"),
                    np.asarray(curves_train)[:, i])
            np.save(os.path.join(losses_dir, f"{name}_mse_losses_valid.npy"),
                    np.asarray(curves_valid)[:, i])
        value = float(val_best.mean())
        self._completed_trials[trial_key] = value
        self._save_study_state()
        return value

    def evaluate(self) -> list:
        """One result per seed, through the single-seed machinery."""
        results = []
        for i, seed in enumerate(self.seeds):
            if (self.best_params_seed[i] is None
                    and self.best_config_seed[i] is not None):
                self.best_params_seed[i] = self._load_best_params(
                    self._name_for_seed(seed), *self.best_config_seed[i])
            assert self.best_params_seed[i] is not None, "run_study first"
            self.best_params = self.best_params_seed[i]
            self.best_config = self.best_config_seed[i]
            self.model_name = self._name_for_seed(seed)
            results.append(super().evaluate())
        return results
