#!/usr/bin/env python3
"""Where the multi-layer flagship's vmapped step loses accuracy in its
output layer: a bisection on an NVIDIA GPU.

Run from the root of a checkout, on a machine with a card and nvcc:

    python3 scripts/multiseed_output_layer_bisect.py [--out DIR]

``chip_smoke.py``'s ``train_multiseed_multilayer`` holds one step of the
3 vmapped seeds against 3 single-seed steps on the card.  This script
trains the same 3 seeds through the same 8 steps, takes the same 256-window
batch, and then:

``model``: each seed's gradients of the output layer's leaves from the
vmapped step, from the single-seed card step, from the fp32 CPU step and
from a float64 CPU step, all on the seed's own draws: each one's largest
distance from float64, and the vmapped step's from the single-seed step
over the leaf's largest magnitude (the smoke's measure).

``layer``: the output layer alone, its input and the cotangents of its
mean, variance and KL taken from the single-seed card step, so that
nothing upstream differs.  Its forward is written out here op by op, and
each op is run either as the single-seed call or as under vmap
(``torch.func.vmap`` over 3 copies of the op's inputs, the first copy's
result kept): ``kzz`` (the Gram matrix of the inducing points), ``chol``
(its Cholesky factor), ``solve`` (the explicit inverse factor), ``mm``
(u and W, the two products with it), ``gp`` (the fused-GP marginals, on
the seeded kernel), ``all`` of them, ``vmap3`` (the whole layer vmapped
over 3 copies of the seed), ``vmap`` (the whole layer vmapped over the 3
seeds), and the same forward on the CPU in fp32 and float64.  Each
gradient's distance from float64 says which op moves the vmapped step.

Writes ``bisect.json`` into ``--out`` (default ``build/probe``) and prints
the card's name and power limit.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import torch
from torch.utils import _pytree as pytree

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from fine_grained_gaussian_process_forcasting_torch.gp import deep_gp  # noqa: E402,E501
from fine_grained_gaussian_process_forcasting_torch.gp.kernels import (  # noqa: E402,E501
    rbf_ard,
    softplus,
)
from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (  # noqa: E402,E501
    fused_gp,
)
from fine_grained_gaussian_process_forcasting_torch.train.multiseed import (  # noqa: E402,E501
    MultiSeedTrainer,
)

LAYER = "deep_gp.output_layer."
OPS = ("kzz", "chol", "solve", "mm", "gp")


def under_vmap(fn, *args):
    """``fn`` as vmap runs it: over 3 copies of every input, the first
    copy's result."""
    outs = torch.func.vmap(fn)(*(a.expand(3, *a.shape).contiguous()
                                 for a in args))
    return pytree.tree_map(lambda t: t[0], outs)


def output_layer(p, x, batched=()):
    """The fused route of ``deep_gp._VariationalLayer.forward`` for the
    scalar output layer, each op in ``batched`` run as under vmap."""
    def op(name, fn, *args):
        return under_vmap(fn, *args) if name in batched else fn(*args)

    m = p["inducing_points"].shape[0]
    ls = softplus(p["raw_lengthscale"])
    os_ = softplus(p["raw_outputscale"])
    z = p["inducing_points"]
    kzz = op("kzz", lambda z_, l_, o_: rbf_ard(z_, z_, l_, o_), z, ls, os_)
    eye = torch.eye(m, dtype=kzz.dtype, device=kzz.device)
    chol = op("chol", torch.linalg.cholesky, kzz + deep_gp._JITTER * eye)
    inv = op("solve", lambda c: torch.linalg.solve_triangular(
        c, eye, upper=False), chol)
    log_std, var_mean = p["variational_log_stddev"], p["variational_mean"]
    s2 = torch.exp(2.0 * log_std)
    kl = 0.5 * torch.sum(s2 + var_mean * var_mean - 1.0 - 2.0 * log_std)
    u, w = op("mm", lambda i_, vm, s2_: (i_.T @ vm,
                                         i_.T @ (i_ * (1.0 - s2_)[:, None])),
              inv, var_mean, s2)
    args = (x.contiguous(), (z / ls).contiguous(), u.contiguous(),
            w.contiguous(), os_, (1.0 / ls).contiguous(), p["mean_weight"],
            p["mean_bias"])
    mean, var = op("gp", fused_gp.whitened_marginals_affine, *args)
    return mean, torch.clamp(var, min=1e-8), kl


def layer_grads(p, x, cots, batched=(), dtype=None, device=None):
    """The output layer's parameter gradients of <outputs, cots>."""
    conv = (lambda t: t.detach().to(device, dtype)) if dtype else (
        lambda t: t.detach())
    leaves = {k: conv(v).requires_grad_() for k, v in p.items()}
    outs = output_layer(leaves, conv(x), batched)
    torch.autograd.backward(outs, [conv(c) for c in cots])
    return {k: v.grad for k, v in leaves.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/probe")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _, _, smi = cs.phase_device()
    by = {c.name: c for c in cs.CONFIGS}
    cfg = dataclasses.replace(by["multilayer"], epochs=1, steps=4)
    n_steps = cs.N_WARMUP + cfg.epochs * cfg.steps + 1  # the smoke's steps
    trainer = MultiSeedTrainer(cfg.model("cuda"), cfg.d_model, cs.N_SEEDS,
                               warmup_steps=cs.WARMUP_STEPS,
                               lr_mul=cs.LR_MUL, device="cuda")
    seeds = [cs.SEED + i for i in range(cs.N_SEEDS)]
    state = trainer.init_state(
        seeds, lambda s: cfg.model("cuda", seed=s).state_dict())
    data = cfg.training_data(n_steps + 1, cs.SEED + 1)
    state, _, _ = trainer.train_epoch(state, tuple(t[:n_steps]
                                                   for t in data))
    batch = tuple(t[n_steps] for t in data)
    _, vgrads = trainer.gradients(state, batch)
    names = [n[len(LAYER):] for n in vgrads if n.startswith(LAYER)]
    judged = [n[len(LAYER):] for n in cfg.f64_leaves]
    res = {"card": smi, "windows": cfg.batch, "steps_before": n_steps,
           "model": {}, "layer": {}}
    caught = {}

    def hook(module, inputs, outputs):
        caught["x"] = inputs[0].detach()
        caught["cots"] = [None] * 3
        for j, t in enumerate(outputs):
            t.register_hook(lambda g, j=j: caught["cots"].__setitem__(j, g))

    layer_in = []
    for i in range(cs.N_SEEDS):
        params = trainer.seed_params(state, i)
        gen = torch.Generator("cuda")
        gen.set_state(state.rngs[i])
        model = cfg.model("cuda")
        model.load_state_dict(params)
        drawn = model.noise_draws(cfg.batch, cfg.enc_len, cfg.dec_len, True,
                                  gen, "cuda")
        handle = model.deep_gp.output_layer.register_forward_hook(hook)
        model(*batch, training=True, **drawn).loss.backward()
        handle.remove()
        got = {"vmapped": {n: vgrads[LAYER + n][i] for n in names},
               "single_seed": {n: model.get_parameter(LAYER + n).grad
                               for n in names}}
        for key, dtype in (("cpu_fp32", torch.float32),
                           ("float64", torch.float64)):
            cpu = cfg.model("cpu").to(dtype)
            cpu.load_state_dict(params)
            cpu(*(t.cpu().to(dtype) for t in batch), training=True,
                **pytree.tree_map(lambda t: t.cpu().to(dtype)
                                  if t.is_floating_point() else t.cpu(),
                                  drawn)).loss.backward()
            got[key] = {n: cpu.get_parameter(LAYER + n).grad for n in names}
            del cpu
        for n in judged:
            exact = got["float64"][n]
            d = {k: (v[n].cpu().double() - exact).abs().max().item()
                 for k, v in got.items() if k != "float64"}
            single = got["single_seed"][n]
            d["vmapped_vs_single_rel"] = ((got["vmapped"][n] - single).abs()
                                          .max() / single.abs().max()).item()
            res["model"][f"seed {i} {n}"] = d
            cs.log(f"model seed {i} {n}: " + ", ".join(
                f"{k} {v:.3e}" for k, v in d.items()))

        lp = {n: params[LAYER + n].to("cuda") for n in names}
        layer_in.append((lp, caught["x"], caught["cots"]))
        variants = {"single": ()}
        variants.update({o: (o,) for o in OPS})
        variants["all"] = OPS
        g = {k: layer_grads(lp, caught["x"], caught["cots"], b)
             for k, b in variants.items()}
        g["cpu_fp32"] = layer_grads(lp, caught["x"], caught["cots"],
                                    dtype=torch.float32, device="cpu")
        g["float64"] = layer_grads(lp, caught["x"], caught["cots"],
                                   dtype=torch.float64, device="cpu")
        stacked = [{k: v.expand(3, *v.shape) for k, v in t.items()}
                   if isinstance(t, dict) else t.expand(3, *t.shape)
                   for t in (lp, caught["x"])]
        cots3 = [c.expand(3, *c.shape) for c in caught["cots"]]
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in stacked[0].items()}
        outs = torch.func.vmap(output_layer)(leaves, stacked[1].contiguous())
        torch.autograd.backward(outs, cots3)
        g["vmap3"] = {k: v.grad[0] for k, v in leaves.items()}
        g["_layer_vs_model_single"] = got["single_seed"]
        res["layer"][f"seed {i}"] = g

    # the layer vmapped over the 3 seeds' own parameters, inputs and
    # cotangents
    stacked = {n: torch.stack([li[0][n] for li in layer_in]).detach()
               .clone().requires_grad_() for n in names}
    x3 = torch.stack([li[1] for li in layer_in])
    outs = torch.func.vmap(output_layer)(stacked, x3)
    torch.autograd.backward(outs, [torch.stack([li[2][j] for li in layer_in])
                                   for j in range(3)])
    out = {"model": res["model"], "layer": {}}
    for i in range(cs.N_SEEDS):
        g = res["layer"][f"seed {i}"]
        g["vmap"] = {n: stacked[n].grad[i] for n in names}
        for n in judged:
            exact = g["float64"][n]
            single = g["single"][n]
            row = {}
            for k, v in g.items():
                if k in ("float64", "_layer_vs_model_single"):
                    continue
                row[k] = {"from_float64": (v[n].cpu().double() - exact).abs()
                          .max().item(),
                          "vs_single_rel": ((v[n].cpu() - single.cpu()).abs()
                                            .max() / single.abs().max()
                                            .cpu()).item()}
            row["layer_single_equals_model_single"] = bool(torch.equal(
                g["single"][n], g["_layer_vs_model_single"][n]))
            out["layer"][f"seed {i} {n}"] = row
            cs.log(f"layer seed {i} {n}: " + ", ".join(
                f"{k} {v['from_float64']:.3e} ({v['vs_single_rel']:.2e})"
                for k, v in row.items() if isinstance(v, dict))
                + f"; replica == model: "
                f"{row['layer_single_equals_model_single']}")
    out.update(card=smi, windows=cfg.batch, steps_before=n_steps,
               seconds=time.perf_counter() - t0)
    with open(os.path.join(args.out, "bisect.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
