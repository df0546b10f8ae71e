"""Weights made from the seed, on the device, in one draw.

Both sides get these same tensors: the program through its own
``load_state_dict`` (a copy), the reference as they are.  Each leaf's law
is a trained model's, not only an initialiser's: the GP's lengthscale of
order sqrt(d) keeps the kernel live on LayerNorm'd hidden states (at the
initial 0.69 every K underflows to 0 and the GP computes nothing), q(u)
away from the prior so that K W is no product of zeros, and lambda inside
its clip so the ELBO reaches the loss.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.model import leaf_specs

_MASK = (1 << 63) - 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for stream ``stream`` of ``seed`` (any
    whole number; the streams of one seed do not overlap)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream * 7_919 + 17) & _MASK)
    return g


def _inverse_softplus(x):
    return x + torch.log(-torch.expm1(-x))


def make_weights(model: dict, seed: int, stream: int, device) -> dict:
    """{leaf: float32 tensor} of the configuration, drawn as one N(0, 1)
    block from ``generator(seed, stream)`` and shaped leaf by leaf."""
    specs = leaf_specs(model)
    sizes = [math.prod(s) for s in specs.values()]
    flat = torch.randn(sum(sizes), generator=generator(seed, stream, device),
                       device=device)
    d = model["d_model"]
    out, at = {}, 0
    for (name, shape), n in zip(specs.items(), sizes):
        z = flat[at:at + n].view(shape)
        at += n
        leaf = name.rsplit(".", 1)[-1]
        if name == "lam":  # inside (0, lam_clip_max): the ELBO counts
            w = model["lam_clip_max"] * (0.2 + 0.6 * torch.sigmoid(z))
        elif leaf == "raw_lengthscale":
            w = _inverse_softplus(math.sqrt(d) * (1.0 + 0.05 * z))
        elif leaf == "raw_outputscale":
            w = _inverse_softplus(1.0 + 0.05 * z)
        elif leaf == "variational_log_stddev":
            w = -0.5 + 0.1 * z
        elif leaf == "variational_mean":
            w = 0.5 * z
        elif leaf == "inducing_points":
            w = z
        elif leaf == "mean_weight":
            w = z / math.sqrt(d)
        elif leaf in ("bias", "mean_bias", "raw_noise"):
            w = 0.02 * z if leaf != "raw_noise" else 0.1 * z
        else:  # a dense layer's (out, in) weight: lecun normal
            w = z / math.sqrt(shape[1])
        out[name] = w.contiguous()
    return out
