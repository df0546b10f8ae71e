"""PyTorch port vs the JAX package: the rest of the baselines on the CPU
(``models/informer_stack.py``, ``models/losses.py``,
``models/denoise_vae.py``, ``models/arima.py``).

Inputs come from numpy seeds, parameters from the JAX module's Flax
``init`` (each leaf moved by 0.1 of its mean magnitude times N(0, 1))
through ``params.from_flax`` with ``strict=True``.  The random draws are
JAX's, injected: ProbSparse's key samples as a ``draws.DrawTape`` in call
order (recorded from JAX's ``jax.random.randint``), the VAE's two normal
draws likewise.  Tolerances, each the largest |port - JAX| over the largest
|JAX| of the array:
- forward outputs (fp32): ``TOL`` 1e-5;
- parameter gradients (fp32): ``TOL_GRAD`` 1e-4, each leaf's error taken
  over the larger of its own largest magnitude and ``GRAD_FLOOR`` 1e-2 of
  the module's largest gradient (for a leaf whose gradient is zero in exact
  arithmetic, the distilling conv's bias, which the batch-statistics norm
  cancels: rounding noise of ~1.5e-7 of the largest on both sides);
- the scalar ARIMA fit and forecast (numpy, scipy): bit-equal;
- the batched ARIMA forecast (fp32 Adam): 1e-5 after 100 steps; 2e-2
  after 300, where the fit has become sensitive to rounding (there the
  port's own fp32 and float64 runs lie 1.0e-2 apart, JAX's 7.1e-4 from the
  port's fp32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fine_grained_gaussian_process_forcasting_tpu.models import (
    arima as jarima,
    denoise_vae as jvae,
    informer_stack as jinf,
    losses as jlosses,
)
from fine_grained_gaussian_process_forcasting_torch import draws
from fine_grained_gaussian_process_forcasting_torch.models import (
    arima as tarima,
    denoise_vae as tvae,
    informer_stack as tinf,
    losses as tlosses,
)
from fine_grained_gaussian_process_forcasting_torch.params import (
    from_flax,
    to_flax,
)

TOL = 1e-5
TOL_GRAD = 1e-4
GRAD_FLOOR = 1e-2


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
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    out = []
    for v in leaves:
        v = np.asarray(v, np.float32)
        scale = float(np.abs(v).mean()) or 1.0
        out.append(v + (0.1 * scale * rng.normal(size=v.shape)).astype(
            np.float32))
    return jax.tree_util.tree_unflatten(tree, out)


def _init(jmod, tmod, *args, seed=1, **kw):
    params = jax.jit(lambda key, *a: jmod.init(key, *a, **kw))(
        jax.random.PRNGKey(seed), *args)["params"]
    params = _moved(params, seed)
    tmod.load_state_dict(from_flax(params), strict=True)
    return params


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _grads_match(jloss, tloss, params, tmod):
    """Loss and every parameter gradient, JAX's ``jax.grad`` against the
    port's backward."""
    want_loss, want = jax.jit(jax.value_and_grad(jloss))(params)
    tmod.zero_grad()
    got_loss = tloss()
    got_loss.backward()
    _close(got_loss.item(), float(want_loss), TOL, "loss")
    got = _flat(to_flax({k: torch.zeros_like(p) if p.grad is None
                         else p.grad for k, p in tmod.named_parameters()}))
    _grads_close(got, _flat(want))


def _grads_close(got, want, tol=TOL_GRAD):
    """Each leaf within ``tol`` of the larger of its own largest magnitude
    and ``GRAD_FLOOR`` of the largest gradient."""
    assert set(got) == set(want)
    floor = GRAD_FLOOR * max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        g = np.asarray(got[k], np.float64)
        assert np.isfinite(g).all() and np.isfinite(w).all(), k
        err = np.abs(g - w).max() / max(np.abs(w).max(), floor)
        assert err <= tol, f"{k}: {err:.3e} over {tol:.0e}"


# ---------------------------------------------------------- Informer stack


def _recorded_samples(fn):
    """Run ``fn`` (a jitted JAX call) with ``jax.random.randint`` recording
    each draw in program order; returns (fn's result, the draws as int64
    tensors)."""
    samples, randint = [], jax.random.randint

    def recording(*args, **kw):
        out = randint(*args, **kw)
        jax.debug.callback(lambda s: samples.append(np.array(s)), out,
                           ordered=True)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "randint", recording)
        result = fn()
        jax.effects_barrier()
    return result, [torch.from_numpy(s).long() for s in samples]


D_INF, H_INF = 16, 4


@pytest.fixture(scope="module")
def informer_case():
    """JAX's encoder (2 layers, ProbSparse, distilled) on (2, 24, 16) and
    decoder layer on (2, 8, 16) against its output, each layer's key sample
    from a ``sampling`` rng; outputs, samples, and the gradients of
    sum(out * g)."""
    x, dec_in = _normal(20, (2, 24, D_INF), (2, 8, D_INF))
    rngs = {"sampling": jax.random.PRNGKey(7)}
    jenc = jinf.InformerEncoder(d_model=D_INF, n_layers=2, n_heads=H_INF,
                                distil=True)
    jdec = jinf.InformerDecoderLayer(d_model=D_INF, n_heads=H_INF)
    enc_p = _moved(jax.jit(lambda k: jenc.init({"params": k, **rngs}, x))(
        jax.random.PRNGKey(1))["params"], 1)
    enc_out, enc_samples = _recorded_samples(lambda: np.asarray(jax.jit(
        lambda p: jenc.apply({"params": p}, x, rngs=rngs))(enc_p)))
    dec_p = _moved(jax.jit(lambda k: jdec.init(
        {"params": k, **rngs}, dec_in, enc_out))(jax.random.PRNGKey(2))[
        "params"], 2)
    dec_out, dec_samples = _recorded_samples(lambda: np.asarray(jax.jit(
        lambda p: jdec.apply({"params": p}, dec_in, enc_out, rngs=rngs))(
        dec_p)))
    return dict(x=x, dec_in=dec_in, rngs=rngs, jenc=jenc, jdec=jdec,
                enc_p=enc_p, dec_p=dec_p, enc_out=enc_out, dec_out=dec_out,
                enc_samples=enc_samples, dec_samples=dec_samples)


def test_informer_encoder_matches_jax(informer_case):
    """Two ProbSparse layers (factor 5) with the distilling ConvLayer
    between them (24 rows -> 13), JAX's key samples replayed; output and
    every gradient."""
    c = informer_case
    assert [tuple(s.shape) for s in c["enc_samples"]] == [(24, 20), (13, 13)]
    model = tinf.InformerEncoder(D_INF, 2, H_INF, device="cpu")
    model.load_state_dict(from_flax(c["enc_p"]), strict=True)
    (x,) = _t(c["x"])

    def tape():
        return draws.DrawTape(draws=c["enc_samples"])

    out = model(x, generator=tape())
    assert out.shape == (2, 13, D_INF)
    _close(out.detach().numpy(), c["enc_out"], TOL)
    (g,) = _normal(21, (2, 13, D_INF))
    jenc, rngs = c["jenc"], c["rngs"]
    _grads_match(
        lambda p: jnp.sum(jenc.apply({"params": p}, c["x"], rngs=rngs) * g),
        lambda: (model(x, generator=tape()) * torch.from_numpy(g)).sum(),
        c["enc_p"], model)


def test_informer_decoder_layer_matches_jax(informer_case):
    """Causal ProbSparse self-attention (JAX's sample replayed), full cross
    attention on the encoder's output, the feed-forward; output and every
    gradient."""
    c = informer_case
    model = tinf.InformerDecoderLayer(D_INF, H_INF, device="cpu")
    model.load_state_dict(from_flax(c["dec_p"]), strict=True)
    dec_in, cross = _t(c["dec_in"], c["enc_out"])

    def tape():
        return draws.DrawTape(draws=c["dec_samples"])

    _close(model(dec_in, cross, generator=tape()).detach().numpy(),
           c["dec_out"], TOL)
    (g,) = _normal(22, c["dec_out"].shape)
    jdec, rngs = c["jdec"], c["rngs"]
    _grads_match(
        lambda p: jnp.sum(jdec.apply({"params": p}, c["dec_in"], c["enc_out"],
                                     rngs=rngs) * g),
        lambda: (model(dec_in, cross, generator=tape())
                 * torch.from_numpy(g)).sum(),
        c["dec_p"], model)


@pytest.mark.parametrize("inner", ["full", "prob"])
def test_informer_draws_fall_back_to_seed_zero(inner):
    """Without a generator each ProbSparse layer draws from a fixed seed-0
    generator (two calls, the same output); full attention draws
    nothing."""
    model = tinf.InformerEncoder(D_INF, 2, H_INF, inner=inner, device="cpu")
    (x,) = _t(*_normal(23, (2, 24, D_INF)))
    torch.testing.assert_close(model(x), model(x), rtol=0, atol=0)
    tape = draws.DrawTape(torch.Generator().manual_seed(3))
    model(x, generator=tape)
    assert len(tape.draws) == (2 if inner == "prob" else 0)


@pytest.mark.parametrize("length", [24, 25, 7])
def test_conv_layer_matches_jax(length):
    """The distilling layer: l rows -> ceil((l + 2) / 2) (circular pad 2,
    k 3, max-pool 3 / 2 / 1), its output and gradients."""
    (x,) = _normal(24, (2, length, 8))
    jmod = jinf.ConvLayer(8)
    tmod = tinf.ConvLayer(8, device="cpu", generator=torch.Generator())
    params = _init(jmod, tmod, x)
    want = np.asarray(jmod.apply({"params": params}, x))
    got = tmod(*_t(x))
    assert got.shape[1] == -(-(length + 2) // 2) == want.shape[1]
    _close(got.detach().numpy(), want, TOL)
    (g,) = _normal(25, want.shape)
    _grads_match(lambda p: jnp.sum(jmod.apply({"params": p}, x) * g),
                 lambda: (tmod(*_t(x)) * torch.from_numpy(g)).sum(),
                 params, tmod)


# ------------------------------------------------------------------- losses


def test_normal_kl_matches_jax():
    a, b, c, d = _normal(26, *[(3, 5)] * 4)
    _close(tlosses.normal_kl(*_t(a, b, c, d)).numpy(),
           jlosses.normal_kl(a, b, c, d), TOL)


# -------------------------------------------------------------- DenoiseVAE

VAE_CASES = {
    "gp_target": dict(gp=True),
    "plain_target": dict(),
    "residual_no_target": dict(residual=True, target=False),
    "n_noise_target": dict(n_noise=True),
}


@pytest.mark.parametrize("case", list(VAE_CASES))
def test_denoise_vae_matches_jax(case):
    """Output, KL and every gradient of MSE + KL, JAX's two normal draws
    (``PRNGKey(0)`` split, as JAX draws without a ``noise`` rng) replayed
    through a ``DrawTape``."""
    kw = dict(VAE_CASES[case])
    with_target = kw.pop("target", True)
    b, l, d, s = 3, 20, 8, 6
    x, residual, target, y = _normal(27, (b, l, d), (b, l, d), (b, s, 1),
                                     (b, l, d))
    jmod = jvae.DenoiseVAE(d, **kw)
    tmod = tvae.DenoiseVAE(d, **kw, target_prior=with_target, device="cpu")
    jkw = dict(target=target if with_target else None, residual=residual)
    params = _init(jmod, tmod, x, **jkw)
    r1, r2 = jax.random.split(jax.random.PRNGKey(0))
    eps = np.asarray(jax.random.normal(r1, x.shape, jnp.float32))
    z_noise = np.asarray(jax.random.normal(r2, (b, l, d)))
    want, want_kl = jmod.apply({"params": params}, x, **jkw)
    tkw = dict(target=_t(target)[0] if with_target else None,
               residual=_t(residual)[0])

    def tape():
        return draws.DrawTape(draws=_t(eps, z_noise))

    (xt,) = _t(x)
    got, got_kl = tmod(xt, **tkw, generator=tape())
    _close(got.detach().numpy(), want, TOL, "output")
    if with_target:
        _close(got_kl.item(), float(want_kl), TOL, "kl")
    else:
        assert got_kl.item() == 0.0 == float(want_kl)

    def jloss(p):
        out, kl = jmod.apply({"params": p}, x, **jkw)
        return jnp.mean((out - y) ** 2) + kl

    def tloss():
        out, kl = tmod(xt, **tkw, generator=tape())
        return ((out - torch.from_numpy(y)) ** 2).mean() + kl

    _grads_match(jloss, tloss, params, tmod)


def test_denoise_vae_draws_in_order():
    """The input noise first, then the latent's; without a generator both
    from a fixed seed-0 generator."""
    model = tvae.DenoiseVAE(4, device="cpu")
    (x,) = _t(*_normal(28, (2, 10, 4)))
    tape = draws.DrawTape(torch.Generator().manual_seed(1))
    model(x, generator=tape)
    assert [tuple(t.shape) for t in tape.draws] == [(2, 10, 4), (2, 10, 4)]
    torch.testing.assert_close(model(x)[0], model(x)[0], rtol=0, atol=0)


# ------------------------------------------------------------------- ARIMA


def _arima_series(seed, n, length):
    """Integrated ARMA(1,1) series with a drift, (n, length)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n, length))
    for i in range(n):
        phi, theta = rng.uniform(-0.8, 0.8, 2)
        e = rng.normal(size=length)
        w = np.zeros(length)
        for t in range(1, length):
            w[t] = 0.05 + phi * w[t - 1] + theta * e[t - 1] + e[t]
        out[i] = 10.0 + np.cumsum(w)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scalar_arima_bit_equal_to_jax(seed):
    (y,) = _arima_series(seed, 1, 90)
    assert tarima.fit_arima_111(y) == jarima.fit_arima_111(y)
    np.testing.assert_array_equal(tarima.forecast_arima_111(y, 12),
                                  jarima.forecast_arima_111(y, 12))


@pytest.mark.parametrize("iters,tol", [(100, 1e-5), (300, 2e-2)],
                         ids=["100_steps", "300_steps"])
def test_fit_forecast_batch_matches_jax(iters, tol):
    """(4, 120) windows, 24 ahead: the port's fp32 Adam
    (``torch.optim.Adam``) against optax's, each forecast within ``tol``
    of the largest."""
    x = _arima_series(3, 4, 120).astype(np.float32)
    want = jarima.fit_forecast_batch(x, 24, iters=iters)
    got = tarima.fit_forecast_batch(x, 24, iters=iters, device="cpu")
    assert got.shape == (4, 24) and got.dtype == np.float32
    _close(got, want, tol)


def test_css_residuals_batch_equals_scalar_recursion():
    """The batched residuals, in float64, equal the scalar loop's."""
    x = _arima_series(4, 3, 40)
    params = np.array([[0.1, 0.5, -0.3], [0.0, -0.2, 0.7], [0.3, 0.9, 0.1]])
    w = np.diff(x, axis=1)
    got = tarima.css_residuals_batch(torch.from_numpy(params),
                                     torch.from_numpy(w)).numpy()
    for i in range(3):
        np.testing.assert_allclose(
            got[i], tarima._css_residuals(params[i], w[i]), rtol=1e-12,
            atol=1e-12)
