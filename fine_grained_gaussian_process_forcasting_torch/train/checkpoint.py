"""Checkpoints keyed by model name (counterpart of the JAX package's
``train/checkpoint.py``, with ``torch.save`` in place of orbax).

A checkpoint is one file holding the model's state dict and, for a true
mid-run resume, the optimizer's.  It is written atomically: to a ``.tmp``
sibling first, then the old copy is renamed away and the new one renamed
into place, so a crash mid-save never loses the previous best.
"""

from __future__ import annotations

import os
from typing import Any, Mapping, Optional

import torch


def save_checkpoint(model_path: str, model_name: str,
                    params: Mapping[str, torch.Tensor],
                    opt_state: Optional[Mapping[str, Any]] = None) -> str:
    """Write ``{"params": params, "opt_state": opt_state}`` (tensors moved
    to the CPU) to ``model_path/model_name``; returns the path."""
    path = os.path.abspath(os.path.join(model_path, model_name))
    tmp, old = path + ".tmp", path + ".old"
    payload = {"params": _to_cpu(params)}
    if opt_state is not None:
        payload["opt_state"] = _to_cpu(opt_state)
    torch.save(payload, tmp)
    if os.path.exists(old):
        os.remove(old)
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(tmp, path)
    if os.path.exists(old):
        os.remove(old)
    return path


def load_checkpoint(model_path: str, model_name: str,
                    map_location=None) -> dict:
    """The payload ``save_checkpoint`` wrote: ``{"params": ..., and
    "opt_state": ... if it was saved}``."""
    path = os.path.abspath(os.path.join(model_path, model_name))
    return torch.load(path, map_location=map_location, weights_only=True)


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, Mapping):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree
