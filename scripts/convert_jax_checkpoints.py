#!/usr/bin/env python3
"""Converts the JAX package's orbax checkpoints into the PyTorch port's.

Run from the root of a checkout, where JAX and orbax are installed (the
port's machine needs only the output):

    python3 scripts/convert_jax_checkpoints.py MODEL_PATH OUT_PATH \\
        [--names NAME ...] [--model '{"src_input_size": 5, ...}'] \\
        [--clip_grad_norm C] [--nonfinite_guard off|raise|skip]

MODEL_PATH is a directory of the JAX package's checkpoints: the harness's
``models_{exp_name}_{pred_len}`` (the best parameters of each model name,
or of each seed of a multi-seed run), the baselines harness's, or one that
``Trainer.save_state`` wrote into.  Every checkpoint in it, or those that
``--names`` lists, is restored with the JAX package's ``load_checkpoint``
and written into OUT_PATH with the port's ``save_checkpoint`` under the
same name, where the port's harness, ``evaluate_checkpoints``,
``InferenceSession.from_checkpoint`` and ``Trainer.restore_state`` look for
it.  OUT_PATH must be another directory: orbax writes a directory where
the port writes a file of the same name.

The restore takes a template.  The parameters' shapes and dtypes come from
the checkpoint's own metadata: a harness's width and depth are its study's
picks, which the name does not encode.  An optimizer state's template is
the JAX ``noam_adam(clip_grad_norm=, nonfinite_guard=).init`` of them, the
chain the JAX ``Trainer`` built with those settings, so optax's states come
back as its NamedTuples; a checkpoint of another chain fails to restore.
An optimizer state needs ``--model``, the ``ForecastDenoising`` keyword
arguments as JSON (dtypes by name, e.g. ``"compute_dtype": "bfloat16"``):
the port builds that model on the CPU for the order of its parameters, and
every checkpoint's leaves are checked against it.

Not carried: the JAX ``TrainState.rng`` (the port cannot reproduce
``jax.random``'s draws; a resumed run draws from the port's own generator).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Mapping, Optional, Sequence

import jax
import numpy as np
import orbax.checkpoint as ocp
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from fine_grained_gaussian_process_forcasting_torch.models.forecast_denoising import (  # noqa: E402,E501
    ForecastDenoising,
)
from fine_grained_gaussian_process_forcasting_torch.train.checkpoint import (  # noqa: E402,E501
    payload_from_jax,
    save_checkpoint,
)
from fine_grained_gaussian_process_forcasting_tpu.train.checkpoint import (  # noqa: E402,E501
    load_checkpoint,
)
from fine_grained_gaussian_process_forcasting_tpu.train.schedule import (  # noqa: E402,E501
    noam_adam,
)


def checkpoint_names(model_path: str) -> list:
    """The orbax checkpoints in ``model_path`` (not an interrupted save's
    ``.tmp`` or ``.old``), sorted."""
    return sorted(
        name for name in os.listdir(model_path)
        if not name.endswith((".tmp", ".old")) and os.path.isfile(
            os.path.join(model_path, name, "_CHECKPOINT_METADATA")))


def restore(model_path: str, name: str, clip_grad_norm: float = 0.0,
            nonfinite_guard: str = "off") -> dict:
    """The checkpoint ``name`` as a tree of numpy arrays, restored with a
    template (the parameters from its metadata; the optimizer state
    ``noam_adam``'s of them)."""
    meta = ocp.StandardCheckpointer().metadata(
        os.path.abspath(os.path.join(model_path, name))).item_metadata
    meta = getattr(meta, "tree", meta)
    template = {"params": jax.tree.map(
        lambda m: jax.ShapeDtypeStruct(m.shape, m.dtype), meta["params"])}
    if "opt_state" in meta:
        tx = noam_adam(1, clip_grad_norm=clip_grad_norm,
                       nonfinite_guard=nonfinite_guard)
        template["opt_state"] = jax.eval_shape(tx.init, template["params"])
    return jax.tree.map(np.asarray,
                        load_checkpoint(model_path, name, template=template))


def port_model(kwargs: Mapping) -> torch.nn.Module:
    """The port's ``ForecastDenoising`` of these keyword arguments, on the
    CPU."""
    kw = {k: (getattr(torch, v) if k.endswith("dtype") and v else v)
          for k, v in kwargs.items()}
    if "gp_hidden_dims" in kw:
        kw["gp_hidden_dims"] = tuple(kw["gp_hidden_dims"])
    return ForecastDenoising(**kw, device="cpu")


def convert(model_path: str, out_path: str,
            names: Optional[Sequence[str]] = None, *,
            model: Optional[torch.nn.Module] = None,
            clip_grad_norm: float = 0.0,
            nonfinite_guard: str = "off") -> list:
    """Converts the checkpoints ``names`` (default: all) of
    ``model_path`` into ``out_path``; returns the paths written.  ``model``
    (the port's) checks the leaves and orders an optimizer state."""
    if os.path.abspath(model_path) == os.path.abspath(out_path):
        raise ValueError("OUT_PATH must differ from MODEL_PATH")
    names = list(names) if names else checkpoint_names(model_path)
    if not names:
        raise ValueError(f"no orbax checkpoint in {model_path}")
    os.makedirs(out_path, exist_ok=True)
    written = []
    for name in names:
        tree = restore(model_path, name, clip_grad_norm, nonfinite_guard)
        try:
            payload = payload_from_jax(
                tree, model, clip=clip_grad_norm > 0,
                guard=nonfinite_guard == "skip")
        except ValueError as e:
            raise ValueError(f"checkpoint {name!r}: {e}") from e
        written.append(save_checkpoint(out_path, name, payload["params"],
                                       payload.get("opt_state")))
    return written


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("model_path")
    ap.add_argument("out_path")
    ap.add_argument("--names", nargs="+", default=None)
    ap.add_argument("--model", type=json.loads, default=None,
                    help="ForecastDenoising's keyword arguments as JSON")
    ap.add_argument("--clip_grad_norm", type=float, default=0.0)
    ap.add_argument("--nonfinite_guard", default="off",
                    choices=["off", "raise", "skip"])
    args = ap.parse_args(argv)
    model = port_model(args.model) if args.model else None
    for path in convert(args.model_path, args.out_path, args.names,
                        model=model, clip_grad_norm=args.clip_grad_norm,
                        nonfinite_guard=args.nonfinite_guard):
        print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
