"""PyTorch port vs the JAX package: the FEDformer stack on the CPU
(``ops/decomposition.py``, ``ops/full_attention.py``,
``models/embedding.py``, ``ops/wavelet_filters.py``, ``ops/wavelet.py``,
``models/fedformer.py``).

Inputs come from numpy seeds, parameters from the JAX module's Flax
``init`` (each leaf moved by 0.1 of its mean magnitude times N(0, 1), so no
bias is zero and no scale one) through ``params.from_flax`` with
``strict=True``.  AutoCorrelation's delays are JAX's, replayed
(``DelayTape``).  Tolerances, each the largest |port - JAX| over the largest
|JAX| of the array:
- forward outputs (fp32): ``TOL`` 1e-5;
- gradients (fp32): ``TOL_GRAD`` 1e-4, each leaf's error taken over the
  larger of its own largest magnitude and ``GRAD_FLOOR`` 1e-2 of the
  module's largest gradient.  The floor is for leaves whose gradient is
  zero in exact arithmetic (a bias that the seasonal layernorm cancels or
  that moves only modes no block keeps; a projection whose output is never
  read, where JAX gives zeros and torch no gradient) or nearly so: they hold
  rounding noise of up to ~5e-8 of the largest gradient on both sides;
- the whole FEDformer's gradients: ``TOL_GRAD_MODEL`` 5e-4 (through two
  encoder layers, the decoder and its trend the leaves lie 3e-5 to 1.6e-4
  from JAX's, rounding carried along the chain), the same floor;
- the filter banks: bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fine_grained_gaussian_process_forcasting_tpu.models import (
    embedding as jemb,
    fedformer as jfed,
)
from fine_grained_gaussian_process_forcasting_tpu.ops import (
    decomposition as jdec,
    wavelet as jwav,
    wavelet_filters as jfilt,
)
from fine_grained_gaussian_process_forcasting_tpu.ops.full_attention import (
    full_attention as jfull_attention,
)
from fine_grained_gaussian_process_forcasting_torch.models import (
    embedding as temb,
    fedformer as tfed,
)
from fine_grained_gaussian_process_forcasting_torch.ops import (
    decomposition as tdec,
    wavelet as twav,
    wavelet_filters as tfilt,
)
from fine_grained_gaussian_process_forcasting_torch.ops.full_attention import (
    full_attention as tfull_attention,
)
from fine_grained_gaussian_process_forcasting_torch.ops.autocorrelation import (
    DelayTape,
)
from fine_grained_gaussian_process_forcasting_torch.params import (
    from_flax,
    to_flax,
)

TOL = 1e-5
TOL_GRAD = 1e-4
GRAD_FLOOR = 1e-2
TOL_GRAD_MODEL = 5e-4


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all() and np.isfinite(want).all(), what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: {err:.3e} over {tol:.0e}"


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _moved(params, seed):
    """Each leaf moved by 0.1 of its mean magnitude (1 where it is 0)
    times N(0, 1)."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    out = []
    for v in leaves:
        v = np.asarray(v, np.float32)
        scale = float(np.abs(v).mean()) or 1.0
        out.append(v + (0.1 * scale * rng.normal(size=v.shape)).astype(
            np.float32))
    return jax.tree_util.tree_unflatten(tree, out)


def _init(jmod, tmod, *args, seed=1):
    """JAX's init, moved, loaded into the port's module (strict)."""
    params = jax.jit(jmod.init)(jax.random.PRNGKey(seed), *args)["params"]
    params = _moved(params, seed)
    tmod.load_state_dict(from_flax(params), strict=True)
    return params


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _t(*arrays, grad=False):
    return [torch.from_numpy(np.array(a)).requires_grad_(grad)
            for a in arrays]


def _port_grads(tmod):
    """The port's parameter gradients, Flax-shaped; a parameter the loss
    never reached has none in torch and zeros in JAX."""
    return _flat(to_flax({k: torch.zeros_like(p) if p.grad is None
                          else p.grad for k, p in tmod.named_parameters()}))


def _grads_close(got, want, tol=TOL_GRAD):
    """Each leaf within ``tol`` of the larger of its own largest magnitude
    and ``GRAD_FLOOR`` of the largest gradient."""
    assert set(got) == set(want)
    floor = GRAD_FLOOR * max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        g = np.asarray(got[k], np.float64)
        assert g.shape == w.shape, k
        assert np.isfinite(g).all() and np.isfinite(w).all(), k
        err = np.abs(g - w).max() / max(np.abs(w).max(), floor)
        assert err <= tol, f"{k}: {err:.3e} over {tol:.0e}"


def _grads_match(jloss, tloss, params, tmod):
    """Loss and every parameter gradient: JAX's ``jax.grad`` against the
    port's backward."""
    want_loss, want = jax.jit(jax.value_and_grad(jloss))(params)
    tmod.zero_grad()
    got_loss = tloss()
    got_loss.backward()
    _close(got_loss.item(), float(want_loss), TOL, "loss")
    _grads_close(_port_grads(tmod), _flat(want))


# ------------------------------------------------------------ decomposition


@pytest.mark.parametrize("kernel", [25, 24, 9, 2], ids=lambda k: f"k{k}")
def test_series_decomp_matches_jax(kernel):
    """Odd and even kernels (the even ones pad one more row in front)."""
    (x,) = _normal(0, (2, 48, 4))
    want_res, want_trend = jdec.series_decomp(jnp.asarray(x), kernel)
    (xt,) = _t(x)
    res, trend = tdec.series_decomp(xt, kernel)
    _close(trend.numpy(), want_trend, TOL, "trend")
    _close(res.numpy(), want_res, TOL, "residual")
    assert trend.shape == xt.shape


def test_series_decomp_multi_matches_jax():
    """The kernels' trends mixed by a softmax of ``mix``, and its
    gradients."""
    (x,) = _normal(1, (2, 48, 4))
    jmod = jdec.SeriesDecompMulti((13, 17, 24))
    tmod = tdec.SeriesDecompMulti((13, 17, 24), device="cpu",
                                  generator=torch.Generator())
    params = _init(jmod, tmod, x)
    want = jmod.apply({"params": params}, x)
    got = tmod(*_t(x))
    for g, w, name in zip(got, want, ("residual", "trend")):
        _close(g.detach().numpy(), w, TOL, name)
    (g_out,) = _normal(2, (2, 48, 4))
    _grads_match(
        lambda p: jnp.sum(jmod.apply({"params": p}, x)[1] * g_out),
        lambda: (tmod(*_t(x))[1] * torch.from_numpy(g_out)).sum(),
        params, tmod)


def test_my_layernorm_matches_jax():
    (x,) = _normal(3, (2, 20, 8))
    jmod = jdec.MyLayerNorm(8)
    tmod = tdec.MyLayerNorm(8, device="cpu")
    params = _init(jmod, tmod, x)
    assert set(from_flax(params)) == {"LayerNorm_0.scale", "LayerNorm_0.bias"}
    _close(tmod(*_t(x)).detach().numpy(),
           jmod.apply({"params": params}, x), TOL)


# ----------------------------------------------------------- full attention


@pytest.mark.parametrize("mask_flag,lq,lk", [(False, 12, 16), (True, 12, 12)],
                         ids=["cross", "causal"])
def test_full_attention_matches_jax(mask_flag, lq, lk):
    q, k, v, g = _normal(4, (2, lq, 3, 8), (2, lk, 3, 8), (2, lk, 3, 8),
                         (2, lq, 3, 8))

    def jloss(*qkv):
        out, attn = jfull_attention(*qkv, mask_flag=mask_flag)
        return jnp.sum(out * g), (out, attn)

    (_, (want, want_attn)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    ts = _t(q, k, v, grad=True)
    out, attn = tfull_attention(*ts, mask_flag=mask_flag)
    (out * torch.from_numpy(g)).sum().backward()
    _close(out.detach().numpy(), want, TOL, "out")
    _close(attn.detach().numpy(), want_attn, TOL, "attn")
    if mask_flag:
        assert (attn[0, 0].triu(1) == 0).all()
    for name, t, w in zip("qkv", ts, jgrads):
        _close(t.grad.numpy(), w, TOL_GRAD, name)


# --------------------------------------------------------------- embeddings


def _marks(seed, b, l, freq):
    """Integer calendar columns [month, day, weekday, hour(, minute)]."""
    rng = np.random.default_rng(seed)
    highs = (13, 32, 7, 24) + ((4,) if freq == "t" else ())
    return np.stack([rng.integers(0, h, size=(b, l)) for h in highs],
                    -1).astype(np.float32)


@pytest.mark.parametrize("embed_type,freq,use_pos", [
    ("fixed", "h", True), ("learned", "h", True), ("learned", "t", False),
    ("timeF", "h", True), ("timeF", "t", False)],
    ids=["fixed", "learned", "learned_t_wopos", "timeF", "timeF_t_wopos"])
def test_data_embedding_matches_jax(embed_type, freq, use_pos):
    """Token conv (circular k 3), the calendar embeddings (fixed tables or
    ``nn.Embed``'s ``embedding`` leaf) or the timeF linear, and the
    positional table; output and the parameters' gradients."""
    b, l, c, d = 2, 10, 3, 16
    (x,) = _normal(5, (b, l, c))
    x_mark = (_normal(6, (b, l, temb.FREQ_FEATURES[freq]))[0]
              if embed_type == "timeF" else _marks(6, b, l, freq))
    jcls = jemb.DataEmbedding if use_pos else jemb.DataEmbeddingWoPos
    tcls = temb.DataEmbedding if use_pos else temb.DataEmbeddingWoPos
    jmod = jcls(d, embed_type, freq)
    tmod = tcls(c, d, embed_type, freq, device="cpu",
                generator=torch.Generator())
    params = _init(jmod, tmod, x, x_mark)
    want = jmod.apply({"params": params}, x, x_mark)
    _close(tmod(*_t(x, x_mark)).detach().numpy(), want, TOL)
    (g,) = _normal(7, (b, l, d))
    _grads_match(
        lambda p: jnp.sum(jmod.apply({"params": p}, x, x_mark) * g),
        lambda: (tmod(*_t(x, x_mark)) * torch.from_numpy(g)).sum(),
        params, tmod)


# ---------------------------------------------------------------- wavelets


@pytest.mark.parametrize("base,k", [("legendre", 2), ("legendre", 4),
                                    ("legendre", 8), ("chebyshev", 4)],
                         ids=lambda v: str(v))
def test_filter_bank_bit_equal_to_jax(base, k):
    for got, want in zip(tfilt.filter_bank(base, k),
                         jfilt.filter_bank(base, k)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(twav._build_filters(base, k),
                         jwav._build_filters(base, k)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [24, 16, 20])
def test_pad_pow2_and_levels(n):
    """The pad to 2^ceil(log2 n) by repeating the head, and floor(log2 n)
    levels, as JAX computes them."""
    (x,) = _normal(8, (1, n, 2, 2))
    want, want_ns = jwav._pad_pow2(jnp.asarray(x), n)
    got, ns = twav._pad_pow2(torch.from_numpy(x), n)
    assert ns == want_ns
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _wavelet_case(jmod, tmod, inputs, seed, output=lambda o: o):
    """Output and every parameter gradient of sum(out * g)."""
    params = _init(jmod, tmod, *inputs, seed=seed)
    want = output(jax.jit(jmod.apply)({"params": params}, *inputs))
    got = output(tmod(*_t(*inputs)))
    _close(got.detach().numpy(), want, TOL, "out")
    (g,) = _normal(seed + 1, want.shape)
    _grads_match(
        lambda p: jnp.sum(output(jmod.apply({"params": p}, *inputs)) * g),
        lambda: (output(tmod(*_t(*inputs))) * torch.from_numpy(g)).sum(),
        params, tmod)


@pytest.mark.parametrize("n,L", [(24, 0), (16, 1)], ids=["n24", "n16_L1"])
def test_mwtcz_matches_jax(n, L):
    (x,) = _normal(9, (2, n, 3, 4))
    _wavelet_case(jwav.MWTCZ(k=4, alpha=5, L=L, c=3),
                  twav.MWTCZ(4, 5, L, 3, device="cpu",
                             generator=torch.Generator()), (x,), seed=10)


@pytest.mark.parametrize("n,s", [(24, 16), (16, 24)],
                         ids=["n24_s16", "n16_s24"])
def test_multiwavelet_transform_matches_jax(n, s):
    q, v = _normal(11, (2, n, 4, 4), (2, s, 4, 4))
    _wavelet_case(jwav.MultiWaveletTransform(ich=16, k=2, alpha=4, c=3),
                  twav.MultiWaveletTransform(16, 2, 4, 3, device="cpu",
                                             generator=torch.Generator()),
                  (q, v, v), seed=12, output=lambda o: o[0])


@pytest.mark.parametrize("n,s,activation", [(24, 16, "tanh"),
                                            (16, 24, "softmax")],
                         ids=["n24_s16_tanh", "n16_s24_softmax"])
def test_multiwavelet_cross_matches_jax(n, s, activation):
    q, kv = _normal(13, (2, n, 4, 4), (2, s, 4, 4))
    kw = dict(modes=3, ich=16, k=2, c=3, activation=activation)
    _wavelet_case(jwav.MultiWaveletCross(16, 16, **kw),
                  twav.MultiWaveletCross(16, 16, **kw, device="cpu",
                                         generator=torch.Generator()),
                  (q, kv, kv), seed=14, output=lambda o: o[0])


# ---------------------------------------------------------------- FEDformer

FED_SMALL = dict(enc_in=3, dec_in=3, c_out=3, seq_len=32, label_len=16,
                 pred_len=8, d_model=16, n_heads=4, d_ff=16, e_layers=2,
                 d_layers=1, moving_avg=(9,), modes=4, wavelet_k=2, L=1)
FED_CASES = {
    "Fourier": dict(version="Fourier"),
    # one encoder layer and three levels: the multiwavelet pyramids
    # unroll into a large program for JAX's gradient
    "Wavelets": dict(version="Wavelets", e_layers=1, L=2),
    "Autoformer": dict(version="Autoformer", moving_avg=(9, 12)),
    # label_len != seq_len // 2: the decoder's blocks are sized for
    # seq_len // 2 + pred_len = 24 rows, its input has 16
    "Fourier_dec_q_len": dict(version="Fourier", label_len=8),
}


def _recording_top_k(chosen):
    """``jax.lax.top_k`` that also hands each call's indices to ``chosen``,
    in program order (an ordered callback, under jit too)."""
    top_k = jax.lax.top_k

    def recording(x, n):
        out = top_k(x, n)
        jax.debug.callback(lambda i: chosen.append(np.array(i)), out[1],
                           ordered=True)
        return out

    return recording


@pytest.fixture(scope="module", params=list(FED_CASES))
def fed_case(request):
    """JAX's FEDformer of one case: moved init, its output (AutoCorrelation's
    delays recorded), and the MSE and its gradients, jitted, once."""
    cfg_kw = dict(FED_SMALL, **FED_CASES[request.param])
    cfg = jfed.FEDformerConfig(**cfg_kw)
    b, dec_len = 3, cfg.label_len + cfg.pred_len
    inputs = _normal(15, (b, cfg.seq_len, 3), (b, cfg.seq_len, 4),
                     (b, dec_len, 3), (b, dec_len, 4))
    (y,) = _normal(16, (b, cfg.pred_len, 3))
    jmod = jfed.FEDformer(cfg)
    params = _moved(jax.jit(jmod.init)(jax.random.PRNGKey(2),
                                       *inputs)["params"], 2)
    chosen = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "top_k", _recording_top_k(chosen))
        want = np.asarray(jax.jit(jmod.apply)({"params": params}, *inputs))
        jax.effects_barrier()

    def jloss(p):
        return jnp.mean((jmod.apply({"params": p}, *inputs) - y) ** 2)

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(params)
    return dict(name=request.param, cfg_kw=cfg_kw, inputs=inputs, y=y,
                params=params, want=want, delays=chosen,
                want_loss=float(want_loss), want_grads=_flat(want_grads))


def test_fedformer_matches_jax(fed_case):
    """Output, MSE and every parameter gradient, JAX's delays replayed; the
    Autoformer case (two decomposition kernels) also takes the multi-kernel
    mix, the dec_q_len case the decoder's clamped Fourier modes."""
    c = fed_case
    model = tfed.FEDformer(tfed.FEDformerConfig(**c["cfg_kw"]), device="cpu")
    model.load_state_dict(from_flax(c["params"]), strict=True)
    if c["name"] == "Autoformer":
        # e_layers + 2 decoder calls, each batch-shared (top_k,)
        assert len(c["delays"]) == 4
    else:
        assert not c["delays"]

    def tape():
        return (DelayTape([torch.from_numpy(d).long() for d in c["delays"]])
                if c["delays"] else None)

    inputs = _t(*c["inputs"])
    out = model(*inputs, delays=tape())
    assert out.shape == c["want"].shape
    _close(out.detach().numpy(), c["want"], TOL, "out")
    loss = ((model(*inputs, delays=tape()) - torch.from_numpy(c["y"])) ** 2
            ).mean()
    loss.backward()
    _close(loss.item(), c["want_loss"], TOL, "loss")
    _grads_close(_port_grads(model), c["want_grads"], TOL_GRAD_MODEL)


def test_fedformer_delays_record_and_replay():
    """A ``DelayTape`` made empty records each AutoCorrelation call's
    delays; replayed, the same output."""
    cfg = tfed.FEDformerConfig(**dict(FED_SMALL, version="Autoformer"))
    model = tfed.FEDformer(cfg, device="cpu")
    inputs = _t(*_normal(17, (2, 32, 3), (2, 32, 4), (2, 24, 3), (2, 24, 4)))
    tape = DelayTape()
    out = model(*inputs, delays=tape)
    assert len(tape.delays) == 4
    torch.testing.assert_close(
        model(*inputs, delays=DelayTape(tape.delays)), out, rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="holds 3 delays"):
        model(*inputs, delays=DelayTape(tape.delays[:3]))

