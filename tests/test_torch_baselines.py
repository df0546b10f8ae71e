"""PyTorch port vs the JAX package: the baselines' loader and models
(``data/univariate.py``, ``models/dlinear.py``, ``models/nbeats.py``,
``models/deepar.py``, ``models/cmgp.py``) on the CPU.

Inputs come from numpy seeds, parameters from the JAX model's Flax
``init`` (moved off zero where a leaf starts there) through
``params.from_flax``.  Tolerances, each the largest |port - JAX| over the
largest |JAX| of the array:
- fp32 forward and gradients: ``TOL`` 1e-5;
- CMGP (a Cholesky of a smooth mixture kernel): ``TOL_CMGP`` 1e-4;
- the loader: bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from fine_grained_gaussian_process_forcasting_tpu.data import (
    synthetic as jsyn,
)
from fine_grained_gaussian_process_forcasting_tpu.data import (
    univariate as juni,
)
from fine_grained_gaussian_process_forcasting_tpu.gp.kernels import (
    softplus as jsoftplus,
)
from fine_grained_gaussian_process_forcasting_tpu.models import (
    cmgp as jcmgp,
    deepar as jdeepar,
    dlinear as jdlinear,
    nbeats as jnbeats,
)
from fine_grained_gaussian_process_forcasting_torch.data import (
    synthetic as tsyn,
)
from fine_grained_gaussian_process_forcasting_torch.data import table
from fine_grained_gaussian_process_forcasting_torch.data import (
    univariate as tuni,
)
from fine_grained_gaussian_process_forcasting_torch.models import (
    cmgp as tcmgp,
    deepar as tdeepar,
    dlinear as tdlinear,
    nbeats as tnbeats,
)
from fine_grained_gaussian_process_forcasting_torch.params import (
    from_flax,
    to_flax,
)
from fine_grained_gaussian_process_forcasting_torch.train import (
    baselines_harness as tharness,
)

TOL = 1e-5
TOL_CMGP = 1e-4


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all() and np.isfinite(want).all(), what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: {err:.3e} over {tol:.0e}"


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _pair(jmod, tmod, x, seed=1):
    """JAX's init (each leaf moved by 0.1 N(0, 1), so no bias or constant
    is zero) loaded into the port's module."""
    params = jax.jit(jmod.init)(jax.random.PRNGKey(seed),
                                jnp.asarray(x))["params"]
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_unflatten(tree, [
        np.asarray(v) + 0.1 * rng.normal(size=v.shape).astype(np.float32)
        for v in leaves])
    tmod.load_state_dict(from_flax(params))
    return params


def _grads_match(jloss, tloss, params, tmod, tol):
    """Loss and every gradient, JAX's jax.grad against the port's
    backward."""
    want_loss, want = jax.jit(jax.value_and_grad(jloss))(params)
    tmod.zero_grad()
    got_loss = tloss()
    got_loss.backward()
    got = to_flax({k: p.grad for k, p in tmod.named_parameters()})
    _close(got_loss.item(), float(want_loss), tol, "loss")
    want, got = _flat(want), _flat(got)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], tol, k)


# ------------------------------------------------------------------ loader


@pytest.mark.parametrize("sizes", [(512, 128, 64), (4096, 1024, 32)],
                         ids=["drawn", "with_replacement"])
def test_univariate_loader_bit_equal_to_jax(sizes):
    """Entity ids out of sorted order (2, 0, 3, 1): JAX visits them in
    order of first appearance, and the windows ``rng.choice`` picks depend
    on it; at the second size there are fewer starts than samples."""
    n_train, n_test, bs = sizes
    steps, order = 700, (2, 0, 3, 1)
    kw = dict(num_entities=4, steps_per_entity=steps, seed=11)
    runs = [slice(i * steps, (i + 1) * steps) for i in order]
    jframe = jsyn.make_synthetic_frame("electricity", **kw)
    jframe = pd.concat([jframe.iloc[r] for r in runs], ignore_index=True)
    tframe = tsyn.make_synthetic_frame("electricity", **kw)
    tframe = table.concat([table.take(tframe, r) for r in runs])
    np.testing.assert_array_equal(tframe["id"], jframe["id"].to_numpy())
    args = dict(target_col="power_usage", pred_len=24,
                max_encoder_length=96, max_train_sample=n_train,
                max_test_sample=n_test, batch_size=bs)
    want = juni.UnivariateLoader(jframe, **args)
    got = tuni.UnivariateLoader(tframe, **args)
    for split in ("train_loader", "valid_loader", "test_loader"):
        for part in ("x_enc", "x_dec", "y"):
            w = getattr(getattr(want, split), part)
            g = getattr(getattr(got, split), part)
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w, err_msg=f"{split}.{part}")
    assert got.train_loader.n_batches == n_train // bs
    assert tuni.TARGET_COLUMNS == juni.TARGET_COLUMNS


# ----------------------------------------------------------------- DLinear


@pytest.mark.parametrize("kernel_size", [25, 5])
def test_moving_avg_and_series_decomp_match_jax(kernel_size):
    x = np.random.default_rng(0).normal(size=(3, 60, 2)).astype(np.float32)
    _close(tdlinear.moving_avg(torch.from_numpy(x), kernel_size),
           jdlinear.moving_avg(jnp.asarray(x), kernel_size), TOL,
           "moving_avg")
    for got, want in zip(tdlinear.series_decomp(torch.from_numpy(x),
                                                kernel_size),
                         jdlinear.series_decomp(jnp.asarray(x),
                                                kernel_size)):
        _close(got, want, TOL, "series_decomp")


def _window(seed, b=6, length=48, c=1):
    return (np.random.default_rng(seed).normal(size=(b, length, c))
            + 2.0).astype(np.float32)


def test_dlinear_matches_jax():
    L, H = 48, 12
    x, y = _window(1, c=2), _window(2, length=H, c=2)
    jmod = jdlinear.DLinear(seq_len=L, pred_len=H)
    tmod = tdlinear.DLinear(L, H, device="cpu")
    # the port's own init is JAX's: 1/seq_len kernels, zero biases
    init = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    got_init = _flat(to_flax(tmod.state_dict()))
    for k, v in _flat(init).items():
        np.testing.assert_array_equal(got_init[k], v, err_msg=k)
    params = _pair(jmod, tmod, x)
    _close(tmod(torch.from_numpy(x)).detach(),
           jax.jit(jmod.apply)({"params": params}, x), TOL, "forward")
    _grads_match(
        lambda p: jnp.mean((jmod.apply({"params": p}, x) - y) ** 2),
        lambda: torch.mean((tmod(torch.from_numpy(x))
                            - torch.from_numpy(y)) ** 2),
        params, tmod, TOL)


# ------------------------------------------------------------------ N-BEATS


@pytest.mark.parametrize("stacks", [("trend", "seasonality"),
                                    ("generic", "trend")])
def test_nbeats_matches_jax(stacks):
    L, H = 48, 12
    x, y = _window(3), _window(4, length=H)
    kw = dict(stack_types=stacks, hidden_layer_units=16)
    jmod = jnbeats.NBeats(L, H, **kw)
    tmod = tnbeats.NBeats(L, H, **kw, device="cpu")
    params = _pair(jmod, tmod, x)
    assert set(tmod.state_dict()) == set(from_flax(params))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    want = jax.jit(jmod.apply)({"params": params}, x)
    for g, w, what in zip(got, want, ("backcast", "forecast")):
        _close(g, w, TOL, what)

    def jloss(p):
        back, fore = jmod.apply({"params": p}, x)
        return jnp.mean((fore - y[..., 0]) ** 2) + jnp.mean(back ** 2)

    def tloss():
        back, fore = tmod(torch.from_numpy(x))
        return (torch.mean((fore - torch.from_numpy(y)[..., 0]) ** 2)
                + torch.mean(back ** 2))

    _grads_match(jloss, tloss, params, tmod, TOL)


def test_nbeats_bases_are_buffers():
    tmod = tnbeats.NBeats(48, 12, hidden_layer_units=8, device="cpu")
    names = {n for n, _ in tmod.named_parameters()}
    assert not any("basis" in n for n in names)
    assert not any("basis" in k for k in tmod.state_dict())
    block = tmod.stack1_block0  # seasonality: forecast_length thetas
    assert block.theta.weight.shape == (12, 8)
    np.testing.assert_array_equal(
        block.basis_f.numpy(),
        jnbeats.seasonality_basis(12, np.arange(12) / 12))


# ------------------------------------------------------------------- DeepAR


@pytest.mark.parametrize("n_layers", [2, 1])
def test_deepar_matches_jax(n_layers):
    """(mu, sigma), deepar_nll and every gradient; the heads read every
    layer's hidden sequence."""
    x = _window(5, length=20)
    jmod = jdeepar.DeepAR(embedding_dim=8, hidden_dim=6, n_layers=n_layers)
    tmod = tdeepar.DeepAR(8, 6, n_layers, device="cpu")
    params = _pair(jmod, tmod, x)
    with torch.no_grad():
        mu, sigma = tmod(torch.from_numpy(x))
    jmu, jsigma = jax.jit(jmod.apply)({"params": params}, x)
    _close(mu, jmu, TOL, "mu")
    _close(sigma, jsigma, TOL, "sigma")
    labels = x[..., 0] + 0.1
    _close(tdeepar.deepar_nll(mu, sigma, torch.from_numpy(labels)),
           jdeepar.deepar_nll(jmu, jsigma, labels), TOL, "deepar_nll")
    _grads_match(
        lambda p: jdeepar.deepar_nll(*jmod.apply({"params": p}, x), labels),
        lambda: tdeepar.deepar_nll(*tmod(torch.from_numpy(x)),
                                   torch.from_numpy(labels)),
        params, tmod, TOL)


def test_deepar_sample_matches_jax_with_its_draws():
    """Ancestral sampling with JAX's own normal draws injected: rebuilt
    with ``jax.random.split`` and ``jax.random.normal`` as
    ``DeepAR.sample`` draws them."""
    b, n_samples, pred_len = 4, 3, 6
    x = _window(6, b=b, length=20)
    jmod = jdeepar.DeepAR(embedding_dim=8, hidden_dim=8, n_layers=2)
    tmod = tdeepar.DeepAR(8, 8, 2, device="cpu")
    params = _pair(jmod, tmod, x)
    rng = jax.random.PRNGKey(1)
    want = jax.jit(lambda p, x, r: jmod.apply(
        {"params": p}, x, pred_len, r, n_samples, method="sample"))(
            params, x, rng)
    eps = np.stack([
        np.stack([np.asarray(jax.random.normal(k, (b,)))
                  for k in jax.random.split(key, pred_len)])
        for key in jax.random.split(rng, n_samples)])
    with torch.no_grad():
        got = tmod.sample(torch.from_numpy(x), pred_len, n_samples,
                          eps=torch.from_numpy(eps))
    assert got.shape == (n_samples, b, pred_len)
    _close(got, want, TOL, "samples")
    # without draws: from the caller's generator, reproducibly
    with torch.no_grad():
        a, c = (tmod.sample(torch.from_numpy(x), pred_len, n_samples,
                            generator=torch.Generator().manual_seed(3))
                for _ in range(2))
    assert torch.equal(a, c) and torch.isfinite(a).all()
    with pytest.raises(ValueError, match="eps"):
        tmod.sample(torch.from_numpy(x), pred_len, n_samples,
                    eps=torch.zeros(n_samples, pred_len, b + 1))


def test_deepar_accuracy_metrics_match_jax():
    rng = np.random.default_rng(7)
    mu = rng.normal(size=(5, 9)).astype(np.float32)
    labels = rng.normal(size=(5, 9)).astype(np.float32)
    labels[::2, ::3] = 0.0  # the metrics skip zero labels
    for tfn, jfn in ((tdeepar.accuracy_nd, jdeepar.accuracy_nd),
                     (tdeepar.accuracy_rmse, jdeepar.accuracy_rmse)):
        got = tfn(torch.from_numpy(mu), torch.from_numpy(labels))
        for g, w in zip(got, jfn(mu, labels)):
            _close(g, w, TOL, tfn.__name__)


def test_from_flax_round_trips_deepar_cells():
    """DeepAR's ``rnn{i}/cell`` maps onto ``rnn{i}.cell`` and back; the
    LSTM backbone's ``lstm{i}`` cells still map as before."""
    x = _window(8, length=10)
    jmod = jdeepar.DeepAR(embedding_dim=4, hidden_dim=5, n_layers=2)
    params = jax.device_get(jax.jit(jmod.init)(jax.random.PRNGKey(2),
                                               jnp.asarray(x))["params"])
    state = from_flax(params)
    assert state["rnn1.cell.weight_ih_l0"].shape == (20, 5)
    assert state["rnn0.cell.weight_ih_l0"].shape == (20, 4)
    assert not state["rnn0.cell.bias_ih_l0"].any()
    tmod = tdeepar.DeepAR(4, 5, 2, device="cpu")
    assert set(state) == set(tmod.state_dict())
    back = _flat(to_flax(state))
    want = _flat(params)
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    cell = params["rnn0"]["cell"]
    lstm_tree = {"model": {"lstm0": cell, "dense": {"kernel": np.ones(
        (2, 3), np.float32)}}}
    assert set(from_flax(lstm_tree)) == {
        "model.dense.weight", *(f"model.lstm.{n}_l0" for n in (
            "weight_ih", "weight_hh", "bias_hh", "bias_ih"))}


# --------------------------------------------------------------------- CMGP


def _cmgp_setup(L=48, H=12, b=6, seed=9, q=2):
    """JAX's own CMGP fixture (tests/test_baselines.py)."""
    rng = np.random.default_rng(seed)
    t = np.arange(L + H) / 24.0
    y = (np.sin(2 * np.pi * t / 2.5)[None]
         + 0.3 * rng.normal(size=(b, 1))) + 0.02 * rng.normal(size=(b, L + H))
    y = y.astype(np.float32)
    jmod = jcmgp.CMGP(pred_len=H, n_latent=q)
    x_hist, y_fut = y[:, :L, None], y[:, L:, None]
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0),
                                jnp.asarray(x_hist))["params"]
    tmod = tcmgp.CMGP(H, q, device="cpu")
    tmod.load_state_dict(from_flax(jax.device_get(params)))
    return jmod, params, tmod, x_hist, y_fut


@pytest.mark.parametrize("shape", [(48, 12, 2), (192, 96, 2), (192, 96, 1)],
                         ids=["jax_fixture", "harness_width", "one_latent"])
def test_cmgp_matches_jax(shape):
    """The posterior mean, the NLL and its gradients, at JAX's fixture and
    at the harness's history 192 and horizon 96."""
    L, H, q = shape
    jmod, params, tmod, x, y = _cmgp_setup(L, H, q=q)
    # the port's own init is JAX's
    got_init = _flat(to_flax(tcmgp.CMGP(H, q, device="cpu").state_dict()))
    for k, v in _flat(jax.device_get(params)).items():
        np.testing.assert_array_equal(got_init[k], v, err_msg=k)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    _close(got, jax.jit(jmod.apply)({"params": params}, x), TOL_CMGP,
           "forward")
    _grads_match(
        lambda p: jmod.apply({"params": p}, x, y, method="nll"),
        lambda: tmod.nll(torch.from_numpy(x), torch.from_numpy(y)),
        params, tmod, TOL_CMGP)


def test_cmgp_nll_matches_naive_mvn():
    """JAX's property on the port: the NLL equals a dense multivariate
    normal logpdf in float64 numpy within JAX's 1e-2 (the fp32 limit of a
    Cholesky of this smooth kernel)."""
    jmod, params, tmod, x, y = _cmgp_setup()
    with torch.no_grad():
        got = tmod.nll(torch.from_numpy(x), torch.from_numpy(y)).item()
    w = np.asarray(jsoftplus(jnp.asarray(params["raw_width"])), np.float64)
    s = np.asarray(jsoftplus(jnp.asarray(params["raw_scale"])), np.float64)
    noise = float(jsoftplus(jnp.asarray(params["raw_noise"])))
    mean = float(params["mean_const"])
    z = np.concatenate([x, y], axis=1)[..., 0].astype(np.float64)
    T = z.shape[1]
    tg = np.arange(T) / 24.0
    d2 = (tg[:, None] - tg[None, :]) ** 2
    K = sum(s[q] * np.exp(-d2 / (4.0 * w[q] ** 2)) for q in range(len(w)))
    K += (noise + tmod.jitter) * np.eye(T)
    _, logdet = np.linalg.slogdet(K)
    quad = np.mean(np.einsum("bi,ij,bj->b", z - mean, np.linalg.inv(K),
                             z - mean))
    ref = 0.5 * (quad + logdet + T * np.log(2 * np.pi)) / T
    np.testing.assert_allclose(got, ref, rtol=1e-2)


def test_cmgp_posterior_interpolates_smooth_series():
    """JAX's property on the port: the first forecast steps of a nearly
    noiseless smooth series beat the history's mean."""
    _, _, tmod, x, y = _cmgp_setup(seed=3)
    with torch.no_grad():
        pred = tmod(torch.from_numpy(x)).numpy()
    assert pred.shape == y.shape
    assert np.isfinite(pred).all()
    err_gp = np.mean((pred[:, :4, 0] - y[:, :4, 0]) ** 2)
    err_mean = np.mean((x.mean(axis=1, keepdims=True)[..., 0]
                        - y[:, :4, 0]) ** 2)
    assert err_gp < 0.5 * err_mean


def test_cmgp_nll_training_step_reduces_loss():
    """JAX's property on the port: 30 Adam steps (lr 1e-2) lower the NLL."""
    _, _, tmod, x, y = _cmgp_setup()
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    opt = torch.optim.Adam(tmod.parameters(), lr=1e-2)
    with torch.no_grad():
        l0 = tmod.nll(x, y).item()
    for _ in range(30):
        opt.zero_grad()
        loss = tmod.nll(x, y)
        loss.backward()
        opt.step()
    assert np.isfinite(loss.item()) and loss.item() < l0


# ------------------------------------------------------------- entry points


def test_entry_points_take_the_card_unless_asked_for_the_cpu():
    """Without a card the default device raises, and nothing falls back to
    the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    for build in (lambda: tdlinear.DLinear(48, 12),
                  lambda: tnbeats.NBeats(48, 12),
                  lambda: tdeepar.DeepAR(),
                  lambda: tcmgp.CMGP(12),
                  lambda: tharness.BaselinesHarness(
                      tsyn.make_synthetic_frame("electricity"),
                      tharness.BaselineArgs(exp_name="electricity"))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
