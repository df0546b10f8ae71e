"""PyTorch port vs the JAX package: the conv-attention family (ATA, ACAT,
conv_attn), alone and inside the transformer and the composite model, from
the same Flax parameters (``params.from_flax``) and numpy-seeded inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fine_grained_gaussian_process_forcasting_tpu.models import (
    forecast_denoising as jfd,
)
from fine_grained_gaussian_process_forcasting_tpu.models import (
    transformer as jtr,
)
from fine_grained_gaussian_process_forcasting_tpu.ops import (
    conv_attention as jca,
)
from fine_grained_gaussian_process_forcasting_torch.models import (
    forecast_denoising as tfd,
)
from fine_grained_gaussian_process_forcasting_torch.models import (
    transformer as ttr,
)
from fine_grained_gaussian_process_forcasting_torch.ops import (
    conv_attention as tca,
)
from fine_grained_gaussian_process_forcasting_torch.params import (
    from_flax,
    to_flax,
)

# fp32 convolutions, batch norms and softmaxes, each summed in another order
# by each framework: outputs 1e-5, gradients and composite outputs 1e-4
TOL_OP = 1e-5
TOL = 1e-4
B, H, D_K = 3, 4, 4


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _init(module, seed, *args):
    """Flax parameters, initialised under jit (an eager init compiles each
    op on its own and is several times slower)."""
    return jax.jit(lambda: module.init(jax.random.PRNGKey(seed), *args))()[
        "params"]


def _qkv(lq, lk, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, H, n, D_K)).astype(np.float32)
                 for n in (lq, lk, lk))


OPS = {
    "ATA": (lambda flag: jca.ATAAttention(
                d_k=D_K, n_heads=H, use_pallas_attention=flag),
            lambda flag: tca.ATAAttention(
                D_K, H, use_kernel=flag, device="cpu",
                generator=torch.Generator().manual_seed(0))),
    "ACAT": (lambda flag: jca.ACATAttention(d_k=D_K, n_heads=H),
             lambda flag: tca.ACATAttention(
                 D_K, H, device="cpu",
                 generator=torch.Generator().manual_seed(0))),
    "conv_attn": (lambda flag: jca.ConvAttnAttention(
                      d_k=D_K, n_heads=H, use_pallas_attention=flag),
                  lambda flag: tca.ConvAttnAttention(
                      D_K, H, use_kernel=flag, device="cpu",
                      generator=torch.Generator().manual_seed(0))),
}


@pytest.mark.parametrize("lengths", [(20, 20), (12, 20)],
                         ids=["self", "cross"])
@pytest.mark.parametrize("op", list(OPS))
def test_conv_op_matches_jax(op, lengths):
    """Forward and the VJP of a loss through the op, params and inputs."""
    q, k, v = _qkv(*lengths, seed=1)
    jmod_fn, tmod_fn = OPS[op]
    jmod = jmod_fn(False)
    params = _init(jmod, 3, q, k, v)
    # move the norms off their (1, 0) init so their gradients are generic
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: x + 0.1 * jnp.cos(jnp.arange(x.size, dtype=x.dtype)
                                       ).reshape(x.shape)
        if p[-1].key in ("scale", "bias") else x, params)

    def jloss(params, q, k, v):
        ctx, _ = jmod.apply({"params": params}, q, k, v)
        return jnp.sum(jnp.sin(ctx)), ctx

    vjp = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)
    # JAX's own ATA gradient is NaN under jax.jit on the CPU (ROADMAP.md
    # section 3), so ATA's reference runs eagerly
    (_, want), jgrads = (vjp if op == "ATA" else jax.jit(vjp))(params, q, k,
                                                              v)
    tmod = tmod_fn(False)
    tmod.load_state_dict(from_flax(_np_tree(params)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    got = tmod(tq, tk, tv)
    torch.sin(got).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL_OP, atol=TOL_OP)
    tgrads = to_flax({n: p.grad for n, p in tmod.named_parameters()})
    flat_w = jax.tree_util.tree_leaves_with_path(jgrads[0])
    assert len(flat_w) == len(list(tmod.parameters()))
    for path, w in flat_w:
        node = tgrads
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node, np.asarray(w), rtol=TOL, atol=TOL,
                                   err_msg=jax.tree_util.keystr(path))
    for t, w in zip((tq, tk, tv), jgrads[1:]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("op", ["ATA", "conv_attn"])
def test_flagged_op_matches_jax_head_folded(op):
    """JAX with the flag runs its head-folded Pallas kernel (interpret mode
    on the CPU); the port with the flag runs the kernel's plain version on
    the CPU.  Same function."""
    q, k, v = _qkv(16, 16, seed=2)
    jmod_fn, tmod_fn = OPS[op]
    jmod = jmod_fn(True)
    params = _init(jmod, 4, q, k, v)
    want, _ = jmod.apply({"params": params}, q, k, v)
    tmod = tmod_fn(True)
    tmod.load_state_dict(from_flax(_np_tree(params)))
    with torch.no_grad():
        got = tmod(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_OP,
                               atol=TOL_OP)


@pytest.mark.parametrize("d_k", [72, 128])
@pytest.mark.parametrize("op", ["ATA", "conv_attn"])
def test_flagged_op_above_the_head_folded_kernel_matches_jax(op, d_k):
    """The flag at head dims past 64 (d_k 64 is held above): the port's
    flash route (its plain version on the CPU) against JAX's head-folded
    kernel (interpret mode)."""
    assert tca.conv_attention_route(d_k, True) == "flash"
    got, want = _flagged_op_at(op, d_k, seed=d_k)
    np.testing.assert_allclose(got, want, rtol=TOL_OP, atol=TOL_OP)


def test_batch_stats_norm_is_biased_batch_normalisation():
    x = np.random.default_rng(5).normal(size=(3, 7, 6)).astype(np.float32)
    norm = tca.BatchStatsNorm(6, device="cpu")
    with torch.no_grad():
        norm.scale.copy_(torch.linspace(0.5, 1.5, 6))
        norm.bias.copy_(torch.linspace(-1.0, 1.0, 6))
    jnorm = jca.BatchStatsNorm()
    want = jnorm.apply({"params": {"scale": norm.scale.detach().numpy(),
                                   "bias": norm.bias.detach().numpy()}}, x)
    with torch.no_grad():
        got = norm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL_OP,
                               atol=TOL_OP)


_TRANSFORMER_PARAMS = {}


@pytest.mark.parametrize("attn_type,flag", [
    ("ATA", None), ("ATA", True), ("ACAT", None), ("conv_attn", None),
    ("conv_attn", True)])
def test_transformer_matches_jax(attn_type, flag):
    """JAX with the flag takes its head-folded Pallas kernel (interpret
    mode); the port on the CPU the kernel's plain version."""
    rng = np.random.default_rng(6)
    enc = rng.normal(size=(B, 20, 16)).astype(np.float32)
    dec = rng.normal(size=(B, 10, 16)).astype(np.float32)
    kw = dict(d_model=16, d_ff=64, d_k=4, d_v=4, n_heads=4, n_layers=1,
              attn_type=attn_type, use_pallas_attention=flag)
    jmod = jtr.Transformer(**kw)
    # the flag changes no parameter: one init per attention type
    if attn_type not in _TRANSFORMER_PARAMS:
        _TRANSFORMER_PARAMS[attn_type] = _init(jmod, 7, enc, dec)
    params = _TRANSFORMER_PARAMS[attn_type]
    want = jmod.apply({"params": params}, enc, dec)
    tmod = ttr.Transformer(**kw, device="cpu")
    tmod.load_state_dict(from_flax(_np_tree(params)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(enc), torch.from_numpy(dec))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


SMALL = dict(src_input_size=5, tgt_input_size=5, d_model=16, n_heads=4,
             d_k=4, stack_size=1, pred_len=8, num_inducing=16)


@pytest.mark.parametrize("attn_type", ["ACAT", "conv_attn"])
def test_forecast_denoising_step_matches_jax(attn_type):
    """The composite (GP + denoise) in training: loss and every gradient.
    JAX's ATA gradient under jax.jit is NaN on the CPU (ROADMAP.md section
    3) and its eager run of the whole model is slow, so ATA is held at the
    op (forward and gradients, ``test_conv_op_matches_jax``) and in the
    transformer (``test_transformer_matches_jax``)."""
    rng = np.random.default_rng(8)
    enc = rng.normal(size=(4, 24, 5)).astype(np.float32)
    dec = rng.normal(size=(4, 8, 5)).astype(np.float32)
    y = rng.normal(size=(4, 8, 1)).astype(np.float32)
    jmod = jfd.ForecastDenoising(**SMALL, attn_type=attn_type,
                                 gp_ls_init=-1.0)
    params = _init(jmod, 9, enc, dec)

    def jloss(params):
        out = jmod.apply({"params": params}, enc, dec, y, training=True)
        return out.loss

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    tmod = tfd.ForecastDenoising(**SMALL, attn_type=attn_type,
                                 gp_ls_init=-1.0, device="cpu")
    tmod.load_state_dict(from_flax(_np_tree(params)))
    out = tmod(*(torch.from_numpy(a) for a in (enc, dec, y)), training=True)
    out.loss.backward()
    np.testing.assert_allclose(out.loss.item(), float(want), rtol=TOL)
    tgrads = to_flax({n: p.grad for n, p in tmod.named_parameters()})
    leaves = jax.tree_util.tree_leaves_with_path(jgrads)
    # a gradient that is 0 in exact arithmetic (a convolution's bias ahead
    # of a batch norm, which the mean cancels) is rounding residue on both
    # sides: held to 1e-6 of the largest gradient
    floor = 1e-6 * max(np.abs(np.asarray(w)).max() for _, w in leaves)
    for path, w in leaves:
        node = tgrads
        for key in path:
            node = node[key.key]
        w = np.asarray(w)
        scale = max(np.abs(w).max(), floor)
        assert np.abs(node - w).max() <= TOL * scale, \
            jax.tree_util.keystr(path)


def _flagged_op_at(op, d_k, seed):
    """(port, JAX) outputs of the op with the flag at head dim d_k, from
    the same parameters and inputs."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(2, 2, 12, d_k)).astype(np.float32)
               for _ in range(3))
    make_j = (jca.ATAAttention if op == "ATA" else jca.ConvAttnAttention)
    make_t = (tca.ATAAttention if op == "ATA" else tca.ConvAttnAttention)
    jmod = make_j(d_k=d_k, n_heads=2, use_pallas_attention=True)
    params = _init(jmod, seed, q, k, v)
    want, _ = jmod.apply({"params": params}, q, k, v)
    tmod = make_t(d_k, 2, use_kernel=True, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    tmod.load_state_dict(from_flax(_np_tree(params)))
    with torch.no_grad():
        got = tmod(*(torch.from_numpy(a) for a in (q, k, v)))
    return got.numpy(), np.asarray(want)


def test_flag_beyond_the_kernels_head_dim_raises():
    """The flag at d_k 64, past the head-folded kernel's d_k <= 63: the port
    takes the flash kernel there (its plain version on the CPU), JAX its
    head-folded kernel (interpret mode), the same function; nothing
    raises."""
    for op in ("ATA", "conv_attn"):
        got, want = _flagged_op_at(op, 64, seed=8)
        np.testing.assert_allclose(got, want, rtol=TOL_OP, atol=TOL_OP,
                                   err_msg=op)
    ttr.Transformer(d_model=512, d_ff=64, d_k=64, d_v=64, n_heads=8,
                    n_layers=1, attn_type="ATA", use_pallas_attention=True,
                    device="cpu")
