"""Load and serve an artifact of ``InferenceSession.export_serving``.

The artifact is a ``torch.export`` program: the served forward's graph with
the weights (the int8 ones of an int8 session), the random draws the session
takes, and each hand kernel as a call of its registered op
(``fgp_torch::*``, ``ops/cuda/``).  Loading it needs ``torch`` and the
registration of those ops, which importing this module does; it needs no
model code and no parameters, and this module imports neither.  (JAX's
StableHLO artifact needs only ``jax``: the kernels of this port are not
part of ``torch``, so their ops must be registered first.)

The program serves at the shapes it was exported at: ``(batch_size,
enc_len, n_features)`` and ``(batch_size, dec_len, n_features)``.  It serves
on the device it was exported on, or, where it was exported with
``platforms=`` (torch device types, recorded in the artifact), on any of
those: ``load_exported(path, device=)`` moves the program there
(``torch.export.passes.move_to_device_pass``).  Every kernel's op has a CPU
body, its plain version, so a program exported on the card serves on the
CPU.
"""

from __future__ import annotations

import json
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.export.passes import move_to_device_pass

from fine_grained_gaussian_process_forcasting_torch.device import resolve_device

# registers the kernels' ops (each module defines its own)
from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (  # noqa: F401
    cholesky,
    flash_attention,
    fused_gp,
    head_folded_attention,
    rbf,
    small_head_attention,
)


#: the device types an artifact may name in ``platforms=``
PLATFORMS = ("cpu", "cuda")
_PLATFORMS_FILE = "platforms"  # the artifact's extra file that holds them


def check_platforms(platforms: Optional[Sequence[str]]
                    ) -> Optional[Tuple[str, ...]]:
    """``platforms=`` as a tuple of torch device types (None stays None);
    raises ValueError for an empty one or a name that is not in
    ``PLATFORMS`` (JAX's "tpu" among them)."""
    if platforms is None:
        return None
    platforms = tuple(platforms)
    if not platforms or any(p not in PLATFORMS for p in platforms):
        raise ValueError(f"platforms={platforms!r}: name one or more torch "
                         f"device types of {PLATFORMS}")
    return platforms


def save_exported(program: torch.export.ExportedProgram, path: str,
                  platforms: Optional[Sequence[str]] = None) -> None:
    """Write ``program`` to ``path`` (``torch.export.save``) with the
    platforms it may serve on (None: the device it was exported on)."""
    torch.export.save(program, path, extra_files={
        _PLATFORMS_FILE: json.dumps(check_platforms(platforms))})


def _program_device(program: torch.export.ExportedProgram) -> torch.device:
    """The device of the program's weights, where it serves."""
    for t in list(program.state_dict.values()) + list(
            program.constants.values()):
        if isinstance(t, torch.Tensor):
            return t.device
    raise ValueError("the program holds no weights")


def load_exported(path: str, device=None
                  ) -> Callable[[np.ndarray, np.ndarray], np.ndarray]:
    """Load an ``export_serving`` artifact -> callable (enc, dec) ->
    predictions, numpy in and out.  ``device``: one of the artifact's
    platforms (None: the device it was exported on, or its first platform
    where that is not one of them); an artifact exported without
    ``platforms=`` serves on the device type it was exported on alone."""
    extra = {_PLATFORMS_FILE: ""}
    program = torch.export.load(path, extra_files=extra)
    home = _program_device(program)
    platforms = (check_platforms(json.loads(extra[_PLATFORMS_FILE]))
                 if extra[_PLATFORMS_FILE] else None) or (home.type,)
    if device is None:
        device = home if home.type in platforms else platforms[0]
    device = torch.device(device)
    if device.type not in platforms:
        raise ValueError(f"{path} serves on {platforms}, not on {device}")
    device = resolve_device(device)
    if device.type != home.type or (device.index is not None
                                    and device != home):
        program = move_to_device_pass(program, device)
    forward = program.module()

    def serve(enc, dec) -> np.ndarray:
        e = torch.as_tensor(np.ascontiguousarray(enc, np.float32),
                            device=device)
        d = torch.as_tensor(np.ascontiguousarray(dec, np.float32),
                            device=device)
        with torch.no_grad():
            return forward(e, d).cpu().numpy()

    return serve
