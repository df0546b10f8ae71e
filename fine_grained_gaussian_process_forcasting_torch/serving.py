"""Load and serve an artifact of ``InferenceSession.export_serving``.

The artifact is a ``torch.export`` program: the served forward's graph with
the weights (the int8 ones of an int8 session), the random draws the session
takes, and each hand kernel as a call of its registered op
(``fgp_torch::*``, ``ops/cuda/``).  Loading it needs ``torch`` and the
registration of those ops, which importing this module does; it needs no
model code and no parameters, and this module imports neither.  (JAX's
StableHLO artifact needs only ``jax``: the kernels of this port are not
part of ``torch``, so their ops must be registered first.)

The program serves on the device it was exported on, at the shapes it was
exported at: ``(batch_size, enc_len, n_features)`` and ``(batch_size,
dec_len, n_features)``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

# registers the kernels' ops (each module defines its own)
from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (  # noqa: F401
    cholesky,
    flash_attention,
    fused_gp,
    head_folded_attention,
    rbf,
    small_head_attention,
)


def _program_device(program: torch.export.ExportedProgram) -> torch.device:
    """The device of the program's weights, where it serves."""
    for t in list(program.state_dict.values()) + list(
            program.constants.values()):
        if isinstance(t, torch.Tensor):
            return t.device
    raise ValueError("the program holds no weights")


def load_exported(path: str) -> Callable[[np.ndarray, np.ndarray],
                                         np.ndarray]:
    """Load an ``export_serving`` artifact -> callable (enc, dec) ->
    predictions, numpy in and out, on the device it was exported on."""
    program = torch.export.load(path)
    device = _program_device(program)
    forward = program.module()

    def serve(enc, dec) -> np.ndarray:
        e = torch.as_tensor(np.ascontiguousarray(enc, np.float32),
                            device=device)
        d = torch.as_tensor(np.ascontiguousarray(dec, np.float32),
                            device=device)
        with torch.no_grad():
            return forward(e, d).cpu().numpy()

    return serve
