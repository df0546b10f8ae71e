"""Where each parameter lives on the (data, model) mesh.

Counterpart of the JAX package's ``parallel/sharding.py``.  The spec
functions are pure functions over the port's state-dict names and shapes
and give JAX's placement: a spec is a tuple with one entry a dim (None,
'model' or 'data'), trailing Nones dropped, as a ``PartitionSpec``.  JAX's
rules match the Flax path of a leaf; a port name is read as that path (a
2-D or 3-D ``weight`` is the Dense or Conv ``kernel``) and the axes are
turned where ``params.from_flax`` turns the kernel ((in, out) ->
``Linear.weight`` (out, in); (f, in, out) -> conv1d's (out, in, f)):

- the attention projections ``wq|wk|wv|wqkv`` and the FFN's ``w1`` (and
  its bias) are column-parallel: their output features split over 'model';
- the attention output ``fc`` and the FFN's ``w2`` are row-parallel: their
  input features split over 'model';
- everything else (embeddings, the GP, ``lam``) is replicated;
- FSDP shards the largest free dim (in JAX's orientation) of each leaf of at
  least 2 n_data elements that n_data divides, over 'data'; a 'model' axis
  of width 1 is replication.

``ShardedParams`` puts a model's parameters there and back.  Over 'model'
a rank's module holds its slice of each split leaf; the fused ``wqkv`` is
``[q | k | v]``, and a rank holds its heads of each block (JAX keeps one
contiguous slice of the fused matrix and lets GSPMD move the blocks; the
spec is the same).  Over 'data' (FSDP) a rank stores 1/n_data of each leaf
the spec shards, as a parameter of its own that the optimizer steps; the
module's tensor is gathered before a step and freed after it, and the
gradient is reduce-scattered onto the shard.  The gradients of every other
leaf are averaged over 'data' (each rank's loss is the mean over its equal
share of the batch).
"""

from __future__ import annotations

import math
import re
from typing import Mapping, Optional

import torch
from torch import nn

from fine_grained_gaussian_process_forcasting_torch.parallel import mesh as pm

Spec = tuple

# JAX's rule table over 'path/to/leaf', in JAX's orientation; first match
# wins
_RULES = [
    (r".*(wq|wk|wv|wqkv)/kernel$", (None, "model")),
    (r".*/fc/kernel$", ("model", None)),
    (r".*ffn/w1/kernel$", (None, "model")),
    (r".*ffn/w1/bias$", ("model",)),
    (r".*ffn/w2/kernel$", ("model", None)),
]


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", leaf))


def _flax_path(name: str, ndim: int):
    """(the Flax path of a port leaf, whether from_flax turns its axes)."""
    *modules, leaf = name.split(".")
    if leaf == "weight" and ndim in (2, 3):
        return "/".join(modules + ["kernel"]), True
    return "/".join(modules + [leaf]), False


def _canon(axes) -> Spec:
    axes = list(axes)
    while axes and axes[-1] is None:
        axes.pop()
    return tuple(axes)


def _turn(spec: Spec, ndim: int) -> Spec:
    """A spec over JAX's axes as one over the port's, and back (from_flax
    reverses a kernel's axes)."""
    full = tuple(spec) + (None,) * (ndim - len(spec))
    return _canon(full[::-1])


def param_specs(params: Mapping) -> dict:
    """{name: spec} for a state dict (or {name: shape}) by JAX's rules."""
    out = {}
    for name, leaf in params.items():
        shape = _shape(leaf)
        path, turned = _flax_path(name, len(shape))
        spec = ()
        for pattern, rule in _RULES:
            if re.match(pattern, path):
                spec = _canon(rule)
                break
        out[name] = _turn(spec, len(shape)) if turned else spec
    return out


def _fsdp_assign(shape: tuple, spec: Spec, n_data: int, n_model: int) -> Spec:
    """JAX ``fsdp_specs``' ``assign`` on one leaf, in JAX's orientation."""
    axes = list(spec) + [None] * (len(shape) - len(spec))
    if n_model <= 1:
        axes = [None if a == "model" else a for a in axes]
    if math.prod(shape) < 2 * n_data:
        return _canon(axes)
    cands = [i for i, s in enumerate(shape)
             if axes[i] is None and s % n_data == 0 and s > 0]
    if not cands:
        return _canon(axes)
    axes[max(cands, key=lambda i: shape[i])] = "data"
    return _canon(axes)


def fsdp_specs(params: Mapping, n_data: int, base: Optional[dict] = None,
               n_model: int = 1) -> dict:
    """ZeRO-3 / FSDP specs: from the tensor-parallel ``base`` (default
    ``param_specs``), each leaf shards its largest still-replicated
    n_data-divisible dim over 'data', chosen in JAX's orientation so that
    a tie picks JAX's dim; leaves under 2 n_data elements stay as they
    are."""
    if base is None:
        base = param_specs(params)
    if n_data <= 1:
        return dict(base)
    out = {}
    for name, leaf in params.items():
        shape = _shape(leaf)
        _, turned = _flax_path(name, len(shape))
        if turned:
            jspec = _fsdp_assign(shape[::-1], _turn(base[name], len(shape)),
                                 n_data, n_model)
            out[name] = _turn(jspec, len(shape))
        else:
            out[name] = _fsdp_assign(shape, base[name], n_data, n_model)
    return out


def param_shardings(mesh, params: Mapping, fsdp: bool = False) -> dict:
    """The specs on ``mesh`` (a ``DeviceMesh`` or {'data': n, 'model':
    m}): ``param_specs``, with ``fsdp`` composed by ``fsdp_specs``."""
    specs = param_specs(params)
    if fsdp:
        sizes = pm.axis_sizes(mesh)
        specs = fsdp_specs(params, sizes["data"], base=specs,
                           n_model=sizes["model"])
    return specs


def opt_state_shardings(mesh, opt_state: Mapping, params: Mapping,
                        fsdp: bool = False) -> dict:
    """Specs for an Adam ``state_dict()`` over ``params`` (the named
    parameters, in the optimizer's order): each moment takes its parameter's
    spec, so an update never moves data (with ``fsdp`` the moments shard as
    the parameters: ZeRO's optimizer-state partition); the step counts and
    the param groups are replicated.  Every index of the param groups gets
    an entry, before the first step too."""
    specs = param_shardings(mesh, params, fsdp)
    names = list(params)
    state = {}
    for group in opt_state["param_groups"]:
        for i in group["params"]:
            spec = specs[names[i]]
            state[i] = {"step": (), "exp_avg": spec, "exp_avg_sq": spec}
    return {"state": state,
            "param_groups": [() for _ in opt_state["param_groups"]]}


# -- putting a model's parameters on the mesh ------------------------- #

def _check_divisible(model: nn.Module, n_model: int) -> None:
    from fine_grained_gaussian_process_forcasting_torch.models.transformer import (  # noqa: E501
        FeedForward,
        MultiHeadAttention,
    )

    for name, module in model.named_modules():
        if isinstance(module, MultiHeadAttention) and (
                module.n_heads % n_model):
            raise ValueError(f"{name}: {module.n_heads} heads do not split "
                             f"over a model axis of {n_model}")
        if isinstance(module, FeedForward) and (
                module.w1.out_features % n_model):
            raise ValueError(f"{name}: d_ff {module.w1.out_features} does "
                             f"not split over a model axis of {n_model}")


def attach(model: nn.Module, model_axis: Optional[pm.Axis],
           data_axis: Optional[pm.Axis]) -> None:
    """Tell the modules whose forward spans the mesh where they run: the
    attention layers and feed-forward blocks (their heads and hidden units
    over ``model_axis``; AutoCorrelation's batch mean over ``data_axis``)
    and the conv family's batch norms (statistics over ``data_axis``).
    None for an axis of width 1."""
    from fine_grained_gaussian_process_forcasting_torch.models.transformer import (  # noqa: E501
        FeedForward,
        MultiHeadAttention,
    )
    from fine_grained_gaussian_process_forcasting_torch.ops.conv_attention import (  # noqa: E501
        BatchStatsNorm,
    )

    if model_axis is not None:
        _check_divisible(model, model_axis.size)
    for module in model.modules():
        if isinstance(module, (MultiHeadAttention, FeedForward)):
            module.model_axis = model_axis
        if isinstance(module, (MultiHeadAttention, BatchStatsNorm)):
            module.data_axis = data_axis


def _dim(spec: Spec, axis_name: str) -> Optional[int]:
    return spec.index(axis_name) if axis_name in spec else None


class ShardedParams:
    """A model's parameters and their gradients on a (data, model) mesh.

    ``install(full)`` puts a full state dict (or one of the model's own
    tensors) in place: each split leaf's model-local slice into the module,
    each FSDP leaf's data shard into ``shards``.  Before a step
    ``materialize`` gathers the FSDP leaves into the module; after the
    backward ``reduce_grads`` reduce-scatters their gradients onto the
    shards (frees the gathered tensors) and averages every other gradient
    over 'data'.  ``opt_params`` is what the optimizer steps, in the
    module's parameter order.  ``full(name, local)`` gathers a leaf (or a
    moment placed like it) back to its whole, unsharded value.
    """

    def __init__(self, model: nn.Module, mesh, fsdp: bool):
        self.model = model
        self.data = pm.axis(mesh, "data")
        self.model_ax = pm.axis(mesh, "model")
        self.world = pm.world_axis()
        params = dict(model.named_parameters())
        specs = param_shardings(mesh, params, fsdp)
        if self.model_ax.size <= 1:  # a model axis of width 1: replication
            specs = {k: tuple(None if a == "model" else a for a in s)
                     for k, s in specs.items()}
        self.specs = specs
        attach(model, self.model_ax if self.model_ax.size > 1 else None,
               self.data if self.data.size > 1 else None)
        self.shards = {
            name: nn.Parameter(torch.empty(0, device=p.device))
            for name, p in params.items()
            if _dim(specs[name], "data") is not None}
        self.install({k: v.detach() for k, v in params.items()})

    # ------------------------------------------------------------------ #

    def opt_params(self):
        return [self.shards.get(name, p)
                for name, p in self.model.named_parameters()]

    def copies(self, name: str) -> int:
        """How many ranks hold the same elements of a leaf."""
        spec = self.specs[name]
        n = 1
        if "model" not in spec:
            n *= self.model_ax.size
        if "data" not in spec:
            n *= self.data.size
        return n

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's storage of a leaf (or a moment placed like it) from
        its whole value: a tensor of its own."""
        spec = self.specs[name]
        m = _dim(spec, "model")
        if m is not None:
            if name.endswith("wqkv.weight"):  # the rank's heads of q, k, v
                full = torch.cat([pm._chunk(b, self.model_ax, 0)
                                  for b in full.chunk(3, dim=0)])
            else:
                full = pm._chunk(full, self.model_ax, m)
        d = _dim(spec, "data")
        if d is not None:
            full = pm._chunk(full, self.data, d)
        return full.clone(memory_format=torch.contiguous_format)

    def full(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The whole value of a leaf from every rank's storage (a
        collective: every rank calls it)."""
        spec = self.specs[name]
        d = _dim(spec, "data")
        if d is not None:
            local = pm.all_gather(local, self.data, d)
        m = _dim(spec, "model")
        if m is not None:
            if name.endswith("wqkv.weight"):
                parts = pm.all_gather(local[None], self.model_ax, 0)
                blocks = [p.chunk(3, dim=0) for p in parts]
                local = torch.cat([blocks[r][j] for j in range(3)
                                   for r in range(len(blocks))])
            else:
                local = pm.all_gather(local, self.model_ax, m)
        return local

    def install(self, full: Mapping[str, torch.Tensor]) -> None:
        """Every parameter from its whole value (and the buffers ``full``
        holds); the FSDP leaves' module tensors are left empty until
        ``materialize``."""
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                value = self.local(name, full[name].to(p.device, p.dtype))
                if name in self.shards:
                    self.shards[name].data = value
                    p.data = value.new_empty(0)
                else:
                    p.data = value
            self._copy_buffers(full)

    def _copy_buffers(self, state: Mapping[str, torch.Tensor]) -> None:
        buffers = dict(self.model.named_buffers())
        for name, value in state.items():
            if name in buffers:
                buffers[name].copy_(value)

    def local_state(self) -> dict:
        """This rank's storage, keyed as the module's state dict: a shard
        for each FSDP leaf, the module's own tensor otherwise."""
        state = self.model.state_dict()
        for name, shard in self.shards.items():
            state[name] = shard.data
        return state

    def load_local_state(self, state: Mapping[str, torch.Tensor]) -> None:
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                target = self.shards[name] if name in self.shards else p
                target.data = state[name].to(p.device).clone()
                if name in self.shards:
                    p.data = p.data.new_empty(0)
            self._copy_buffers(state)

    # ------------------------------------------------------------------ #

    def materialize(self) -> None:
        """Gather the FSDP leaves into the module, in one all-gather."""
        if not self.shards:
            return
        names = list(self.shards)
        flat = torch.cat([self.shards[n].data.reshape(-1) for n in names])
        parts = pm.all_gather(flat[None], self.data, 0)
        params = dict(self.model.named_parameters())
        with torch.no_grad():
            start = 0
            for name in names:
                shard = self.shards[name].data
                n = shard.numel()
                pieces = [parts[r, start:start + n].view(shard.shape)
                          for r in range(self.data.size)]
                params[name].data = torch.cat(
                    pieces, dim=_dim(self.specs[name], "data"))
                start += n

    def release(self) -> None:
        """Free the gathered FSDP leaves."""
        params = dict(self.model.named_parameters())
        for name in self.shards:
            params[name].data = params[name].data.new_empty(0)
            params[name].grad = None

    def reduce_grads(self) -> None:
        """The step's gradient of the global mean loss on every rank's
        storage: each FSDP leaf's reduce-scattered onto its shard, every
        other leaf's all-reduced, both over 'data' and divided by its width;
        one collective each.  A leaf the loss does not reach gets zeros."""
        n_data = self.data.size
        sharded, whole = [], []
        for name, p in self.model.named_parameters():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            (sharded if name in self.shards else whole).append((name, p, g))
        if whole:
            flat = pm.all_reduce(torch.cat([g.reshape(-1)
                                            for _, _, g in whole]),
                                 self.data) / n_data
            start = 0
            for _, p, g in whole:
                p.grad = flat[start:start + g.numel()].view_as(g)
                start += g.numel()
        if sharded:
            # row r: every leaf's r-th chunk, flattened; one reduce-scatter
            rows = [torch.cat([c.reshape(-1) for c in (
                g.chunk(n_data, dim=_dim(self.specs[name], "data"))[r]
                for name, _, g in sharded)]) for r in range(n_data)]
            mine = pm.reduce_scatter(torch.cat(rows), self.data) / n_data
            start = 0
            for name, _, _ in sharded:
                shard = self.shards[name]
                n = shard.numel()
                shard.grad = mine[start:start + n].view_as(shard)
                start += n
            self.release()

    def full_state(self, local: Optional[Mapping] = None) -> dict:
        """The whole, unsharded state dict (on the host) from this rank's
        storage (``local_state()`` by default); a collective."""
        local = self.local_state() if local is None else local
        params = dict(self.model.named_parameters())
        return {name: (self.full(name, value) if name in params else value
                       ).detach().cpu().clone()
                for name, value in local.items()}

    def full_opt_state(self, opt_state: Mapping) -> dict:
        """An Adam ``state_dict()`` over ``opt_params`` with every moment
        gathered whole: a single device's optimizer state; a collective."""
        names = [n for n, _ in self.model.named_parameters()]
        state = {i: {k: (self.full(names[i], v).cpu() if k != "step"
                         else v.clone()) for k, v in s.items()}
                 for i, s in opt_state["state"].items()}
        return {"state": state, "param_groups": [
            dict(g) for g in opt_state["param_groups"]]}

    def local_opt_state(self, opt_state: Mapping) -> dict:
        """This rank's share of a single device's Adam ``state_dict()``."""
        names = [n for n, _ in self.model.named_parameters()]
        state = {i: {k: (self.local(names[i], v) if k != "step"
                         else v.clone()) for k, v in s.items()}
                 for i, s in opt_state["state"].items()}
        return {"state": state, "param_groups": [
            dict(g) for g in opt_state["param_groups"]]}
