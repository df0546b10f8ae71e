"""Inference session: state dict -> fixed-size batch predictor ->
unscaled predictions.

Counterpart of the JAX package's ``train/predict.py`` ``InferenceSession``:
numpy windows in, numpy forecasts out, in fixed-size batches whose ragged
tail is padded by repeating the last row; int8 serving
(``train/quantize.py``); checkpoints of ``train/checkpoint.py``; an
exported serving artifact (``torch.export``, in place of JAX's StableHLO);
and ``predict_dataframe``, the production path: formatter scaling ->
window extraction -> batched device inference -> per-entity inverse target
scaling.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from fine_grained_gaussian_process_forcasting_torch import serving
from fine_grained_gaussian_process_forcasting_torch.data import table
from fine_grained_gaussian_process_forcasting_torch.data.base import (
    InputTypes,
    get_single_col_by_input_type,
)
from fine_grained_gaussian_process_forcasting_torch.data.window import (
    SAMPLING_SEED,
    sample_windows,
)
from fine_grained_gaussian_process_forcasting_torch.device import resolve_device
from fine_grained_gaussian_process_forcasting_torch.draws import DrawTape
from fine_grained_gaussian_process_forcasting_torch.models.forecast_denoising import (
    ForecastDenoising,
)
from fine_grained_gaussian_process_forcasting_torch.train.checkpoint import (
    load_checkpoint,
)
from fine_grained_gaussian_process_forcasting_torch.train.quantize import (
    quantize_model,
)


class _ServedForward(nn.Module):
    """The session's forward at one batch shape, with the draws it takes
    held as buffers and replayed: what ``export_serving`` exports."""

    def __init__(self, model: nn.Module, draws):
        super().__init__()
        self.model = model
        self.n_draws = len(draws)
        for i, t in enumerate(draws):
            self.register_buffer(f"draw{i}", t)

    def forward(self, enc, dec):
        tape = DrawTape(draws=[getattr(self, f"draw{i}")
                               for i in range(self.n_draws)])
        return self.model(enc, dec, training=False,
                          generator=tape).predictions


class InferenceSession:
    def __init__(self, model: ForecastDenoising,
                 state_dict: Mapping[str, torch.Tensor],
                 batch_size: int = 256, device="cuda",
                 quantize: Optional[str] = None):
        """Loads ``state_dict`` (e.g. ``params.from_flax(...)`` or a
        ``torch.save``d ``model.state_dict()``) into ``model`` on
        ``device``.  ``quantize="int8"`` serves every dense projection
        through the int8 product (``train/quantize.py``), on a copy of the
        model whose weights are quantized here, once; the GP, the
        normalizations and the attention math stay as they are."""
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize={quantize!r} (None or 'int8')")
        self.device = resolve_device(device)
        model = model.to(self.device).eval()
        model.load_state_dict(state_dict)
        self.model = quantize_model(model) if quantize == "int8" else model
        self.batch_size = batch_size
        self.quantize = quantize

    @classmethod
    def from_checkpoint(cls, model: ForecastDenoising, model_path: str,
                        model_name: str, template_params=None,
                        batch_size: int = 256,
                        quantize: Optional[str] = None,
                        device="cuda") -> "InferenceSession":
        """A session on the parameters of a ``train/checkpoint.py``
        checkpoint (``torch.save``, not orbax).  ``template_params``, where
        given, is the key set the checkpoint must hold (a state dict or its
        keys); ``load_state_dict`` then checks the shapes."""
        params = load_checkpoint(model_path, model_name,
                                 map_location="cpu")["params"]
        if template_params is not None and set(params) != set(
                template_params):
            missing = sorted(set(template_params) - set(params))
            extra = sorted(set(params) - set(template_params))
            raise ValueError(f"checkpoint {model_name!r} does not match the "
                             f"template: missing {missing}, unexpected "
                             f"{extra}")
        return cls(model, params, batch_size, device=device,
                   quantize=quantize)

    def _generator(self) -> torch.Generator:
        # the draws a served batch takes (the isotropic noise, the hidden
        # GP layers' eps, informer's key samples): one fixed stream per
        # batch, as the JAX session passes fixed keys
        return torch.Generator(device=self.device).manual_seed(0)

    def _forward(self, enc: np.ndarray, dec: np.ndarray) -> np.ndarray:
        e = torch.from_numpy(np.ascontiguousarray(enc, np.float32)).to(
            self.device)
        d = torch.from_numpy(np.ascontiguousarray(dec, np.float32)).to(
            self.device)
        with torch.inference_mode():
            out = self.model(e, d, training=False,
                             generator=self._generator())
        return out.predictions.cpu().numpy()

    def predict(self, enc: np.ndarray, dec: np.ndarray) -> np.ndarray:
        """(N, enc_len, F), (N, dec_len, F) -> (N, pred_len, 1); pads the
        tail batch so every batch has one shape."""
        n = enc.shape[0]
        bs = self.batch_size
        outs = []
        for i in range(0, n, bs):
            e, d = enc[i: i + bs], dec[i: i + bs]
            pad = bs - e.shape[0]
            if pad:
                e = np.concatenate([e, np.repeat(e[-1:], pad, 0)], 0)
                d = np.concatenate([d, np.repeat(d[-1:], pad, 0)], 0)
            p = self._forward(e, d)
            outs.append(p[: bs - pad] if pad else p)
        return np.concatenate(outs, 0)

    def export_serving(self, path: str, enc_len: int, dec_len: int,
                       n_features: int, platforms=None) -> str:
        """Serialize the served forward (``torch.export``, saved with
        ``torch.export.save``) to ``path``: the weights (the int8 ones of
        an int8 session) and the draws a served batch takes are held in
        the artifact, and each hand kernel is a call of its registered op.
        ``load_exported`` serves it in any process with this package's
        ops registered, without the model code or parameters.

        Shapes are fixed at (batch_size, enc_len/dec_len, n_features), the
        one shape ``predict`` serves through.  ``platforms``: the torch
        device types the artifact may serve on (``"cpu"``, ``"cuda"``;
        JAX's names the backends it lowers for), recorded in the artifact;
        ``load_exported(path, device=)`` moves the program to one of them.
        None: it serves on the session's device.  Returns ``path``.
        """
        platforms = serving.check_platforms(platforms)
        b = self.batch_size
        enc = torch.zeros((b, enc_len, n_features), device=self.device)
        dec = torch.zeros((b, dec_len, n_features), device=self.device)
        tape = DrawTape(self._generator())
        with torch.no_grad():
            # the draws depend on the shapes alone: record them once
            self.model(enc, dec, training=False, generator=tape)
            program = torch.export.export(
                _ServedForward(self.model, tape.draws), (enc, dec),
                strict=False)
        serving.save_exported(program, path, platforms)
        return path

    @staticmethod
    def load_exported(path: str, device=None):
        """Load an ``export_serving`` artifact -> callable (enc, dec) ->
        predictions, on ``device``, one of its platforms
        (``serving.load_exported``)."""
        return serving.load_exported(path, device)

    def predict_dataframe(self, raw_df: table.Frame, formatter,
                          pred_len: int,
                          max_windows: Optional[int] = 1024) -> table.Frame:
        """Raw frame -> per-window forecasts in the ORIGINAL scale: a frame
        with columns t+1 .. t+pred_len and identifier, grouped by
        identifier (``format_predictions``).  The windows are drawn as
        JAX's are: numpy's global generator seeded 2436 (restored
        afterwards), real windows only (``pad_incomplete=False``)."""
        params_exp = formatter.get_experiment_params()
        columns = params_exp["column_definition"]
        data = formatter.transform_data(raw_df)
        time_col = get_single_col_by_input_type(InputTypes.TIME, columns)
        id_col = get_single_col_by_input_type(InputTypes.ID, columns)
        data = table.sort_by(data, [id_col, time_col])

        rng_state = np.random.get_state()
        np.random.seed(SAMPLING_SEED)
        try:
            split = sample_windows(
                data, max_windows or 0, params_exp["total_time_steps"],
                params_exp["num_encoder_steps"], pred_len, columns,
                pad_incomplete=False)
        finally:
            np.random.set_state(rng_state)

        preds = self.predict(split.enc_inputs, split.dec_inputs)[..., 0]
        frame = {f"t+{i + 1}": preds[:, i] for i in range(pred_len)}
        frame["identifier"] = np.asarray(
            split.identifiers[: len(preds)].tolist())
        return formatter.format_predictions(frame)
