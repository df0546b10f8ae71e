"""Inference session: state dict -> fixed-size batch predictor.

Counterpart of the JAX package's ``train/predict.py`` ``InferenceSession``:
numpy windows in, numpy forecasts out, in fixed-size batches whose ragged
tail is padded by repeating the last row.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from fine_grained_gaussian_process_forcasting_torch.device import resolve_device
from fine_grained_gaussian_process_forcasting_torch.models.forecast_denoising import (
    ForecastDenoising,
)

_NOT_PORTED = ("is not ported yet (ROADMAP.md modules to port, item 12: "
               "serving and runtime)")


class InferenceSession:
    def __init__(self, model: ForecastDenoising,
                 state_dict: Mapping[str, torch.Tensor],
                 batch_size: int = 256, device="cuda",
                 quantize: Optional[str] = None):
        """Loads ``state_dict`` (e.g. ``params.from_flax(...)`` or a
        ``torch.save``d ``model.state_dict()``) into ``model`` on
        ``device``."""
        if quantize is not None:
            raise NotImplementedError(f"quantize={quantize!r} {_NOT_PORTED}")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.model.load_state_dict(state_dict)
        self.batch_size = batch_size

    @classmethod
    def from_checkpoint(cls, *args, **kwargs):
        raise NotImplementedError(
            "orbax checkpoints need JAX; load a torch.save'd state dict and "
            "pass it to InferenceSession instead")

    def _forward(self, enc: np.ndarray, dec: np.ndarray) -> np.ndarray:
        e = torch.from_numpy(np.ascontiguousarray(enc, np.float32)).to(
            self.device)
        d = torch.from_numpy(np.ascontiguousarray(dec, np.float32)).to(
            self.device)
        # the isotropic mode's noise: one fixed stream per batch, as the JAX
        # session passes one fixed key
        generator = torch.Generator(device=self.device).manual_seed(0)
        with torch.inference_mode():
            out = self.model(e, d, training=False, generator=generator)
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

    def export_serving(self, *args, **kwargs):
        raise NotImplementedError(f"export_serving {_NOT_PORTED}")

    def predict_dataframe(self, *args, **kwargs):
        raise NotImplementedError(f"predict_dataframe {_NOT_PORTED}")
