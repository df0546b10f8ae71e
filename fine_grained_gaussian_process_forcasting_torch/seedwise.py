"""Ops that run once per seed under ``torch.func.vmap``.

Multi-seed training (``train/multiseed.py``) vmaps the model over weights
stacked by seed.  Most ops batch under vmap as JAX's do.  ``seedwise(fn,
*args)`` is for the few that must not: under a functorch transform it runs
``fn`` once per index of the vmapped axis on that index's inputs and
stacks the outputs, each call recorded by autograd, so that each seed's
result is its single-seed call's, bit for bit; with no transform it is
``fn(*args)``.  Two callers:

- ``models/lstm.py``: ``torch.func.vmap`` has no batching rule for
  ``aten::lstm`` (one cuDNN recurrence a seed);
- ``gp/deep_gp.py``: a layer's Cholesky factor of Kzz, its explicit
  inverse and the whitened q(u) products.  cuSOLVER's and cuBLAS's batched
  routines round otherwise than their single calls, and at the output
  layer's conditioning (W reaches ~1e4) that moved the q(u) gradient of a
  vmapped step 2.8 times farther from float64 than the single-seed step's
  (``scripts/multiseed_output_layer_bisect.py``).

Multi-seed training differentiates outside the vmapped call, so no other
transform's rule is given: the Function's ``backward`` raises.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree


class _Seedwise(torch.autograd.Function):
    """``fn(*args)``, for its ``vmap`` rule: one call of ``fn`` per index
    of the vmapped axis, the outputs stacked on a leading axis."""

    @staticmethod
    def forward(fn, *args):
        return fn(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, fn, *args):
        outs = [fn(*(a.select(dim, s) if dim is not None else a
                     for a, dim in zip(args, in_dims[1:])))
                for s in range(info.batch_size)]
        stacked = pytree.tree_map(lambda *ts: torch.stack(ts), *outs)
        return stacked, pytree.tree_map(lambda _: 0, stacked)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "seedwise ops are differentiated only through their vmap rule "
            "(torch.func.vmap, then .backward())")


def seedwise(fn, *args):
    """``fn(*args)``; under ``torch.func.vmap``, one call a seed (module
    docstring).  ``args`` are tensors."""
    if torch._C._are_functorch_transforms_active():
        return _Seedwise.apply(fn, *args)
    return fn(*args)
