"""The port's multi-seed trainer on the options that train under vmap since
the kernels' seed rules: the exact GP (the library's factorization and the
Cholesky kernel's route), hidden GP layers (``rbf_ard`` and the rbf
kernel's route), the LSTM backbone and informer.  Each against sequential
port ``Trainer`` runs at the JAX package's multi-seed tolerances, the exact
GP and the LSTM also against JAX's ``MultiSeedTrainer``; the exact GP's
jitter picked per seed; the rbf plain version's seed axis and the vmap
rules of rbf, the Cholesky and small-head attention on the CPU; informer's
key samples; ``seedwise``'s one call a seed.

At ``tests/test_torch_multiseed.py``'s size: d_model 8, 2 heads, 8 inducing
points, 3 batches of 4 windows, one intra-op thread.  The port runs on the
CPU, the hand kernels through their plain versions.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fine_grained_gaussian_process_forcasting_tpu.models import (
    forecast_denoising as jfd,
)
from fine_grained_gaussian_process_forcasting_tpu.train.multiseed import (
    MultiSeedTrainer as JMultiSeedTrainer,
)
from fine_grained_gaussian_process_forcasting_torch.gp import deep_gp
from fine_grained_gaussian_process_forcasting_torch.gp.exact import (
    psd_safe_cholesky,
)
from fine_grained_gaussian_process_forcasting_torch.models import (
    forecast_denoising as tfd,
)
from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (
    cholesky,
    rbf,
    small_head_attention,
)
from fine_grained_gaussian_process_forcasting_torch.params import from_flax
from fine_grained_gaussian_process_forcasting_torch.seedwise import seedwise
from fine_grained_gaussian_process_forcasting_torch.train import Trainer
from fine_grained_gaussian_process_forcasting_torch.train.multiseed import (
    MultiSeedTrainer,
)

# the JAX package's own tolerances for N vmapped replicas against N
# sequential trainers (tests/test_multiseed.py)
RTOL_LOSS = ATOL_LOSS = 1e-5
RTOL_PARAM, ATOL_PARAM = 2e-4, 2e-5
TOL_LOSS = 1e-4  # the port against the JAX package, one epoch
SEEDS = (11, 23)
NB, BS, ENC_LEN, DEC_LEN, FEAT, PRED, DM = 3, 4, 12, 4, 3, 4, 8
TINY = dict(src_input_size=FEAT, tgt_input_size=FEAT, d_model=DM, n_heads=2,
            d_k=DM // 2, stack_size=1, pred_len=PRED, num_inducing=8)
EXACT = dict(gp_kind="exact", exact_noise_init=0.1)
# (attention, model options, the exact blur's use_pallas): the exact blur
# takes its Cholesky kernel by its own flag, as the export of the exact
# model sets it (use_pallas_gp reaches only the variational GP, in both
# packages)
OPTIONS = {
    "exact": ("basic", EXACT, False),
    "exact_pallas": ("basic", EXACT, True),
    "hidden_layers": ("basic", dict(gp_hidden_dims=(3,)), False),
    "hidden_layers_pallas": ("basic", dict(gp_hidden_dims=(3,),
                                           use_pallas_gp=True), False),
    "lstm": ("basic", dict(backbone="lstm"), False),
    "informer": ("informer", {}, False),
}


@pytest.fixture(autouse=True)
def one_thread():
    """A few thousand parameters: one intra-op thread runs them as fast as
    many and keeps them from contending with the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    enc = rng.normal(size=(NB, BS, ENC_LEN, FEAT)).astype(np.float32)
    dec = rng.normal(size=(NB, BS, DEC_LEN, FEAT)).astype(np.float32)
    y = rng.normal(size=(NB, BS, PRED, 1)).astype(np.float32)
    return enc, dec, y


def _torch(data):
    return tuple(torch.from_numpy(a) for a in data)


def _model(option, seed=0):
    attn, kw, blur_pallas = OPTIONS[option]
    model = tfd.ForecastDenoising(
        **TINY, attn_type=attn, device="cpu",
        generator=torch.Generator().manual_seed(seed), **kw)
    if blur_pallas:
        model.deep_gp.use_pallas = True
    return model


def _sequential(option, data):
    """Each seed trained alone by the port's ``Trainer``: (losses, mses,
    eval losses, predictions, params) per seed."""
    runs = []
    for s in SEEDS:
        trainer = Trainer(_model(option, s), DM, warmup_steps=100,
                          device="cpu")
        state = trainer.init_state(seed=s)
        state, loss, mse = trainer.train_epoch(state, data)
        e_loss, _, preds = trainer.eval_epoch(state, data)
        runs.append((loss, mse, e_loss, preds,
                     {k: v.detach().clone() for k, v in state.params.items()}))
    return runs


@pytest.mark.parametrize("option", list(OPTIONS))
def test_multiseed_option_matches_sequential_trainers(option):
    """Two seeds trained together == two sequential ``Trainer`` runs of the
    same seeds: same initial weights, the same draws (eps, key samples)
    from each seed's generator, the same updates; and vmap runs no op as a
    per-seed loop of its own (the LSTM's loop is its Function's rule)."""
    data = _torch(_data())
    trainer = MultiSeedTrainer(_model(option), DM, len(SEEDS),
                               warmup_steps=100, device="cpu")
    state = trainer.init_state(SEEDS,
                               lambda s: _model(option, s).state_dict())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state, loss, mse = trainer.train_epoch(state, data)
        e_loss, _, preds = trainer.eval_epoch(state, data)
    slow = [str(w.message) for w in caught
            if "performance drop" in str(w.message)]
    assert not slow, slow
    assert np.isfinite(loss).all()
    assert preds.shape == (len(SEEDS), NB, BS, PRED, 1)
    for i, (s_loss, s_mse, s_eloss, s_preds, s_params) in enumerate(
            _sequential(option, data)):
        np.testing.assert_allclose(loss[i], s_loss, rtol=RTOL_LOSS,
                                   atol=ATOL_LOSS)
        np.testing.assert_allclose(mse[i], s_mse, rtol=RTOL_LOSS,
                                   atol=ATOL_LOSS)
        np.testing.assert_allclose(e_loss[i], s_eloss, rtol=RTOL_LOSS,
                                   atol=ATOL_LOSS)
        np.testing.assert_allclose(preds[i].numpy(), s_preds.numpy(),
                                   rtol=RTOL_PARAM, atol=ATOL_PARAM)
        got = trainer.seed_params(state, i)
        assert list(got) == list(s_params)
        for name, want in s_params.items():
            np.testing.assert_allclose(
                got[name].numpy(), want.numpy(), rtol=RTOL_PARAM,
                atol=ATOL_PARAM, err_msg=f"seed {i} {name}")


@pytest.mark.parametrize("option", ["exact", "lstm"])
def test_multiseed_option_matches_jax_multiseed(option):
    """The port's trainer against the JAX package's ``MultiSeedTrainer`` on
    the two options whose training forward draws nothing (no hidden GP
    layer, no key sample): each seed's parameters from JAX's through
    ``params.from_flax``, the ELBO weight (and the variational GP's q(u))
    moved off its init, one epoch; each seed's summed losses and MSEs at
    the JAX parity tolerance."""
    enc, dec, y = _data()
    attn, kw, _ = OPTIONS[option]
    flags = dict(TINY, attn_type=attn, gp=True, denoise=True, **kw)
    jtrainer = JMultiSeedTrainer(jfd.ForecastDenoising(**flags), d_model=DM,
                                 n_seeds=len(SEEDS), warmup_steps=100)
    jstate = jtrainer.init_state(SEEDS, enc[0], dec[0], y[0])
    per_seed = []
    rng = np.random.default_rng(5)
    for i in range(len(SEEDS)):
        params = jax.tree_util.tree_map(np.asarray,
                                        jtrainer.seed_params(jstate, i))
        params["lam"] = np.array([0.003], np.float32)
        layer = params["deep_gp"].get("output_layer")
        for name, scale in (("variational_mean", 0.5),
                            ("variational_log_stddev", 0.3)):
            if layer is not None:
                layer[name] = (scale * rng.normal(size=layer[name].shape)
                               ).astype(np.float32)
        per_seed.append(params)
    stacked = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *per_seed)
    jstate.params = stacked
    jstate.opt_state = jax.vmap(jtrainer.optimizer.init)(stacked)
    jstate, jloss, jmse = jtrainer.train_epoch(
        jstate, tuple(jnp.asarray(a) for a in (enc, dec, y)))

    trainer = MultiSeedTrainer(tfd.ForecastDenoising(**flags, device="cpu"),
                               DM, len(SEEDS), warmup_steps=100,
                               device="cpu")
    state = trainer.init_state(SEEDS, [from_flax(p) for p in per_seed])
    state, loss, mse = trainer.train_epoch(state, _torch((enc, dec, y)))
    assert np.isfinite(loss).all() and np.isfinite(jloss).all()
    np.testing.assert_allclose(loss, jloss, rtol=TOL_LOSS)
    np.testing.assert_allclose(mse, jmse, rtol=TOL_LOSS)


def _indefinite(n, lowest, seed):
    """A symmetric (2, n, n) batch with eigenvalues 1 and, once, ``lowest``:
    its psd-safe jitter is the first 1e-4 * s0 * 10^i that lifts it."""
    g = torch.Generator().manual_seed(seed)
    q, _ = torch.linalg.qr(torch.randn(2, n, n, generator=g,
                                       dtype=torch.float64))
    eig = torch.ones(2, n, dtype=torch.float64)
    eig[:, -1] = lowest
    return (q * eig[:, None, :] @ q.transpose(-1, -2)).float()


@pytest.mark.parametrize("factor", ["library", "kernel_fold"])
def test_exact_jitter_is_each_seeds_own(factor):
    """``psd_safe_cholesky`` under vmap picks each seed's jitter from that
    seed's probes: seed 0 factors at the first jitter, seed 1 (an
    eigenvalue of -5e-4) needs the second; each equals its own call, and a
    jitter shared across the seeds would have given seed 0 another factor.
    ``kernel_fold``: the probes through the Cholesky Function, whose vmap
    rule folds the seeds into the batch before the pick."""
    fn = (cholesky.batched_cholesky_plain if factor == "library"
          else cholesky._BatchedCholesky.apply)
    n = 6
    a = torch.stack([_indefinite(n, 1.0, 0), _indefinite(n, -5e-4, 1)])
    got = torch.func.vmap(lambda m: psd_safe_cholesky(m, factor=fn))(a)
    assert torch.isfinite(got).all()
    eye = torch.eye(n)
    for i, jitter in enumerate((1e-4, 1e-3)):
        single = psd_safe_cholesky(a[i], factor=fn)
        torch.testing.assert_close(got[i], single, rtol=0, atol=0)
        s0 = torch.diagonal(a[i], dim1=-2, dim2=-1).mean()
        at = cholesky.batched_cholesky_plain(a[i] + jitter * s0 * eye)
        torch.testing.assert_close(got[i], at)
    shared = cholesky.batched_cholesky_plain(
        a[0] + 1e-3 * torch.diagonal(a[0], dim1=-2, dim2=-1).mean() * eye)
    assert not torch.allclose(got[0], shared, rtol=0, atol=1e-7)


def _rbf_args(gps, seeds=3, seed=0):
    """rbf inputs with a seed axis: x (S, 2, 5, 3) and one GP's (gps None)
    or ``gps`` GPs' parameters."""
    g = torch.Generator().manual_seed(seed)
    lead = (seeds, gps) if gps else (seeds,)
    return (torch.randn(seeds, 2, 5, 3, generator=g),
            torch.randn(*lead, 6, 3, generator=g),
            0.5 + torch.rand(*lead, 3, generator=g),
            0.5 + torch.rand(*lead, generator=g))


def test_rbf_plain_versions_take_the_seed_axis():
    """The plain forward and VJP on seed-stacked inputs (x (S, ..., N, d),
    z (S, h, M, d)) equal a call per seed; x's gradient sums each seed's
    own GPs."""
    x, z, ls, os_ = _rbf_args(4)
    k = rbf.rbf_cross_kernel_plain(x, z, ls, os_)
    assert k.shape == (3, 4, 2, 5, 6)
    g = torch.randn(k.shape, generator=torch.Generator().manual_seed(1))
    grads = rbf.rbf_cross_kernel_bwd_plain(x, z, ls, os_, k, g)
    for i in range(3):
        one = (x[i], z[i], ls[i], os_[i])
        k1 = rbf.rbf_cross_kernel_plain(*one)
        torch.testing.assert_close(k[i], k1)
        for got, want in zip(grads, rbf.rbf_cross_kernel_bwd_plain(
                *one, k1, g[i])):
            torch.testing.assert_close(got[i], want)


@pytest.mark.parametrize("gps, x_batched", [(None, True), (4, True),
                                            (4, False)],
                         ids=["one_gp", "h_gps", "shared_x"])
def test_rbf_vmap_rule_on_the_cpu(gps, x_batched):
    """Under ``torch.func.vmap`` the rbf op's rule makes one seeded call:
    each seed's K and the gradients of every input equal that seed's own
    call, for one GP, for h GPs, and with an x the vmap does not batch
    (stacked by the rule)."""
    args = _rbf_args(gps)
    if not x_batched:
        args = (args[0][0],) + args[1:]
    leaves = [a.clone().requires_grad_() for a in args]
    in_dims = (0 if x_batched else None, 0, 0, 0)
    k = torch.func.vmap(rbf.rbf_cross_kernel, in_dims=in_dims)(*leaves)
    cot = torch.randn(k.shape, generator=torch.Generator().manual_seed(2))
    k.backward(cot)
    x_grad = torch.zeros_like(args[0])
    for i in range(3):
        one = [(a if d is None else a[i]).clone().requires_grad_()
               for a, d in zip(args, in_dims)]
        k1 = rbf.rbf_cross_kernel(*one)
        k1.backward(cot[i])
        torch.testing.assert_close(k[i], k1)
        for leaf, single, d in zip(leaves, one, in_dims):
            if d is None:
                x_grad += single.grad
            else:
                torch.testing.assert_close(leaf.grad[i], single.grad)
    if not x_batched:
        torch.testing.assert_close(leaves[0].grad, x_grad)


def test_cholesky_fold_rule_on_the_cpu():
    """The Cholesky Function's vmap rule folds the seeds into the batch:
    each seed's factor and gradient equal its own call's (the CPU route:
    the library's factor, the plain pullback), a matrix that is not
    positive definite NaN in its seed alone; without a gradient too."""
    g = torch.Generator().manual_seed(3)
    a = torch.randn(3, 2, 5, 5, generator=g)
    a = (a @ a.transpose(-1, -2) + 5.0 * torch.eye(5)).requires_grad_()
    cot = torch.randn(3, 2, 5, 5, generator=g)
    chol = torch.func.vmap(cholesky._BatchedCholesky.apply)(a)
    chol.backward(cot)
    for i in range(3):
        one = a[i].detach().requires_grad_()
        single = cholesky._BatchedCholesky.apply(one)
        single.backward(cot[i])
        torch.testing.assert_close(chol[i], single)
        torch.testing.assert_close(a.grad[i], one.grad)
    bad = a.detach().clone()
    bad[1, 0] = -torch.eye(5)
    with torch.no_grad():
        got = torch.func.vmap(cholesky._BatchedCholesky.apply)(bad)
    assert torch.isnan(got[1, 0]).all() and torch.isfinite(got[1, 1]).all()
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[2]).all()


def test_small_head_fold_rule_on_the_cpu():
    """Small-head attention's vmap rule folds the seeds into b: each seed's
    context and gradients equal its own call's; q's dtype comes back."""
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(3, 2, 2, 7, 4, generator=g).requires_grad_()
               for _ in range(3))
    do = torch.randn(3, 2, 2, 7, 4, generator=g)
    out = torch.func.vmap(small_head_attention.small_head_attention)(q, k, v)
    out.backward(do)
    for i in range(3):
        one = [t[i].detach().requires_grad_() for t in (q, k, v)]
        o = small_head_attention.small_head_attention(*one)
        o.backward(do[i])
        torch.testing.assert_close(out[i], o)
        for t, s in zip((q, k, v), one):
            torch.testing.assert_close(t.grad[i], s.grad)
    with torch.no_grad():
        half = torch.func.vmap(small_head_attention.small_head_attention)(
            q.double(), k.double(), v.double())
    assert half.dtype == torch.float64 and half.shape == q.shape


def test_informer_forward_draws_through_noise_draws():
    """The single-seed forward takes informer's key samples through
    ``noise_draws``, one per ProbSparse call in forward order (the
    forecaster's five here: residual off, 1 encoder and 1 decoder layer
    twice over), so a forward handed the draws of a generator seeded alike
    computes the same loss."""
    enc, dec, y = (t[0] for t in _torch(_data()))
    model = _model("informer", 5)
    gen = torch.Generator().manual_seed(9)
    drawn = model.noise_draws(BS, ENC_LEN, DEC_LEN, True, gen, "cpu")
    assert list(drawn) == ["index_samples"]
    assert [tuple(t.shape) for t in drawn["index_samples"]] == [
        (12, 3), (4, 2), (4, 3)] * 2
    want = model(enc, dec, y, training=True,
                 generator=torch.Generator().manual_seed(9)).loss
    got = model(enc, dec, y, training=True, **drawn).loss
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_seedwise_is_one_call_a_seed():
    """Under vmap, ``seedwise`` runs the deep GP's factorization and
    products once a seed: each seed's outputs and gradients (an unbatched
    input's too) equal its own call's bit for bit; with no transform it is
    the call itself, and its Function has no rule but vmap's."""
    gen = torch.Generator().manual_seed(4)
    a = torch.randn(3, 6, 6, generator=gen)
    kzz = (a @ a.transpose(-1, -2) + 6.0 * torch.eye(6)).requires_grad_()
    s2 = torch.rand(6, generator=gen).requires_grad_()

    def chain(k, s2_):
        inv = deep_gp._inverse_factor(k)
        return deep_gp._whitened_products(inv, torch.ones(6), s2_)

    u, w = torch.func.vmap(lambda k: seedwise(chain, k, s2))(kzz)
    (u.square().sum() + w.square().sum()).backward()
    ds2 = torch.zeros(6)
    for i in range(3):
        k = kzz.detach()[i].requires_grad_()
        s2_i = s2.detach().clone().requires_grad_()
        ui, wi = chain(k, s2_i)
        assert torch.equal(seedwise(chain, k, s2_i)[1], wi)
        (ui.square().sum() + wi.square().sum()).backward()
        assert torch.equal(u[i], ui) and torch.equal(w[i], wi)
        assert torch.equal(kzz.grad[i], k.grad)
        ds2 += s2_i.grad
    torch.testing.assert_close(s2.grad, ds2, rtol=1e-6, atol=0)
    with pytest.raises(NotImplementedError, match="vmap"):
        torch.func.grad(lambda k: seedwise(chain, k, s2)[1].sum())(
            kzz.detach()[0])
