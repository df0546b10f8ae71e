"""The port's multi-seed trainer: against sequential port ``Trainer`` runs,
against the JAX package's ``MultiSeedTrainer``, its guards and clipping
seed by seed, and the fused GP's and flash attention's vmap rules on the
CPU.  The exact GP, hidden GP layers, the LSTM backbone and informer are
``tests/test_torch_multiseed_options.py``'s.

All at a test's size: d_model 8, 2 heads, 8 inducing points, 3 batches of
4 windows.  The port runs on the CPU, the hand kernels through their plain
versions; the JAX package runs its fused-GP Pallas kernels in interpret
mode under its own vmap, as its tests do.
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
from fine_grained_gaussian_process_forcasting_torch.models import (
    forecast_denoising as tfd,
)
from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (
    flash_attention,
    fused_gp,
)
from fine_grained_gaussian_process_forcasting_torch.params import from_flax
from fine_grained_gaussian_process_forcasting_torch.train import Trainer
from fine_grained_gaussian_process_forcasting_torch.train.multiseed import (
    MultiSeedTrainer,
)
from fine_grained_gaussian_process_forcasting_torch.train.trainer import (
    NonFiniteLossError,
)

# the JAX package's own tolerances for N vmapped replicas against N
# sequential trainers (tests/test_multiseed.py)
RTOL_LOSS = ATOL_LOSS = 1e-5
RTOL_PARAM, ATOL_PARAM = 2e-4, 2e-5
# the port against the JAX package, one epoch from the same parameters
# (tests/test_torch_train.py)
TOL_LOSS = 1e-4
SEEDS = (11, 23)
NB, BS, ENC_LEN, DEC_LEN, FEAT, PRED, DM = 3, 4, 12, 4, 3, 4, 8
TINY = dict(src_input_size=FEAT, tgt_input_size=FEAT, d_model=DM, n_heads=2,
            d_k=DM // 2, stack_size=1, pred_len=PRED, num_inducing=8)
BF16 = dict(compute_dtype=torch.bfloat16, gp_compute_dtype=torch.bfloat16)
# the configurations that train under vmap: (attention, model options)
CONFIGS = {
    "basic": ("basic", {}),
    "autoformer": ("autoformer", {}),
    "ata_flag": ("ATA", dict(use_pallas_attention=True)),
    "ata": ("ATA", {}),
    "conv_attn_flag": ("conv_attn", dict(use_pallas_attention=True)),
    "conv_attn": ("conv_attn", {}),
    "iso": ("basic", dict(gp=False)),
    "no_noise": ("basic", dict(gp=False, no_noise=True)),
    "no_denoise": ("autoformer", dict(denoise=False)),
    "autoformer_bf16": ("autoformer", BF16),
    "basic_bf16": ("basic", BF16),
    "conv_attn_bf16": ("conv_attn", BF16),
}


@pytest.fixture(autouse=True)
def one_thread():
    """These models are a few thousand parameters: one intra-op thread runs
    them as fast as many, and keeps them from contending with the suite's
    other workers for the cores."""
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


def _model(attn, seed=0, **kw):
    return tfd.ForecastDenoising(
        **TINY, attn_type=attn, device="cpu",
        generator=torch.Generator().manual_seed(seed), **kw)


def _compared(name):
    """Parameters the comparison of trained weights holds: all but ATA's
    convolution biases, whose gradients are 0 in exact arithmetic (the
    batch norm after each removes them with the mean): their rounding
    residue, which Adam scales up to full steps, has no value to agree
    on."""
    return not (".ata." in name and "_conv" in name
                and name.endswith("bias"))


def _sequential(attn, kw, data, **trainer_kw):
    """Each seed trained alone by the port's ``Trainer``: (losses, mses,
    eval losses, predictions, params) per seed."""
    runs = []
    for s in SEEDS:
        trainer = Trainer(_model(attn, s, **kw), DM, warmup_steps=100,
                          device="cpu", **trainer_kw)
        state = trainer.init_state(seed=s)
        state, loss, mse = trainer.train_epoch(state, data)
        e_loss, _, preds = trainer.eval_epoch(state, data)
        runs.append((loss, mse, e_loss, preds,
                     {k: v.detach().clone() for k, v in state.params.items()}))
    return runs


def _multiseed(attn, kw, data, **trainer_kw):
    trainer = MultiSeedTrainer(_model(attn, **kw), DM, len(SEEDS),
                               warmup_steps=100, device="cpu", **trainer_kw)
    state = trainer.init_state(SEEDS,
                               lambda s: _model(attn, s, **kw).state_dict())
    return trainer, state


@pytest.mark.parametrize("config", list(CONFIGS))
def test_multiseed_matches_sequential_trainers(config):
    """Two seeds trained together == two sequential ``Trainer`` runs of the
    same seeds: same initial weights, same noise streams, same updates; and
    torch.func.vmap runs no op of these models as a per-seed loop."""
    attn, kw = CONFIGS[config]
    data = _torch(_data())
    trainer, state = _multiseed(attn, kw, data)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state, loss, mse = trainer.train_epoch(state, data)
        e_loss, _, preds = trainer.eval_epoch(state, data)
    slow = [str(w.message) for w in caught
            if "performance drop" in str(w.message)]
    assert not slow, slow
    assert loss.shape == mse.shape == (len(SEEDS),)
    assert preds.shape == (len(SEEDS), NB, BS, PRED, 1)
    for i, (s_loss, s_mse, s_eloss, s_preds, s_params) in enumerate(
            _sequential(attn, kw, data)):
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
            if _compared(name):
                np.testing.assert_allclose(
                    got[name].numpy(), want.numpy(), rtol=RTOL_PARAM,
                    atol=ATOL_PARAM, err_msg=f"seed {i} {name}")


@pytest.mark.parametrize("attn", ["autoformer"])
def test_multiseed_matches_jax_multiseed(attn):
    """The port's trainer against the JAX package's ``MultiSeedTrainer``:
    each seed's parameters from JAX's ``seed_params`` through
    ``params.from_flax`` (with the ELBO weight and q(u) moved off their
    inits, as ``tests/test_torch_train.py`` does), one epoch; each seed's
    summed losses and MSEs at the JAX parity tolerance."""
    enc, dec, y = _data()
    flags = dict(TINY, attn_type=attn, gp=True, denoise=True,
                 use_fused_gp=True)
    jtrainer = JMultiSeedTrainer(jfd.ForecastDenoising(**flags), d_model=DM,
                                 n_seeds=len(SEEDS), warmup_steps=100)
    jstate = jtrainer.init_state(SEEDS, enc[0], dec[0], y[0])
    per_seed = []
    rng = np.random.default_rng(5)
    for i in range(len(SEEDS)):
        params = jax.tree_util.tree_map(np.asarray,
                                        jtrainer.seed_params(jstate, i))
        params["lam"] = np.array([0.003], np.float32)
        layer = params["deep_gp"]["output_layer"]
        for name, scale in (("variational_mean", 0.5),
                            ("variational_log_stddev", 0.3)):
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


def test_multiseed_eval_and_divergence():
    """Seeds started from different weights diverge, and evaluation returns
    each seed's metrics (``tests/test_multiseed.py``)."""
    data = _torch(_data())
    seeds = (1, 2, 3)
    trainer = MultiSeedTrainer(_model("basic", gp=False, denoise=False), DM,
                               3, device="cpu")
    state = trainer.init_state(
        seeds, lambda s: _model("basic", s, gp=False,
                                denoise=False).state_dict())
    state, loss, _ = trainer.train_epoch(state, data)
    assert loss.shape == (3,)
    assert len({round(float(x), 6) for x in loss}) == 3
    e_loss, e_mse, preds = trainer.eval_epoch(state, data)
    assert e_loss.shape == e_mse.shape == (3,)
    assert preds.shape == (3, NB, BS, PRED, 1)
    assert state.step == NB


def _poisoned(trainer, state, seed_index):
    """The state with one seed's output projection made infinite, so that
    its loss and gradients are not finite from the first step."""
    with torch.no_grad():
        state.params["final_projection.weight"][seed_index] = float("inf")
    return state


def test_skip_guard_drops_a_seeds_updates_alone():
    """'skip' drops the bad seed's updates and counts its bad steps, and
    leaves the other seed's training as a ``Trainer`` of its own runs it."""
    data = _torch(_data())
    trainer, state = _multiseed("basic", {}, data, nonfinite_guard="skip")
    state = _poisoned(trainer, state, 1)
    before = {k: v[1].detach().clone() for k, v in state.params.items()}
    state, loss, _ = trainer.train_epoch(state, data)
    assert np.isfinite(loss[0]) and not np.isfinite(loss[1])
    assert state.opt_state["notfinite_count"] == [0, NB]
    assert state.opt_state["count"] == [NB, 0]
    for k, v in before.items():
        torch.testing.assert_close(state.params[k][1], v, rtol=0, atol=0,
                                   equal_nan=True)
    want = _sequential("basic", {}, data, nonfinite_guard="skip")[0]
    np.testing.assert_allclose(loss[0], want[0], rtol=RTOL_LOSS,
                               atol=ATOL_LOSS)
    got = trainer.seed_params(state, 0)
    for name, value in want[4].items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(),
                                   rtol=RTOL_PARAM, atol=ATOL_PARAM)


def test_raise_guard_names_the_seed_indices():
    """'raise' checks once at the epoch's end, names the bad seed's index,
    and leaves the state as it was before the epoch.  (Without the GP: a
    non-finite update would reach the GP's Cholesky, which raises on its
    own before the epoch ends.)"""
    data = _torch(_data())
    trainer, state = _multiseed("basic", dict(gp=False, no_noise=True), data,
                                nonfinite_guard="raise")
    state = _poisoned(trainer, state, 1)
    before = {k: v.detach().clone() for k, v in state.params.items()}
    with pytest.raises(NonFiniteLossError, match=r"seed indices \[1\]"):
        trainer.train_epoch(state, data)
    for k, v in before.items():
        torch.testing.assert_close(state.params[k], v, rtol=0, atol=0,
                                   equal_nan=True)
    assert state.opt_state["count"] == [0, 0]


def test_clipping_uses_each_seeds_norm():
    """``clip_grad_norm`` clips each seed by its own global norm: the seeds
    match ``Trainer``s that clip alone, and a seed whose gradients are
    scaled up by 1e3 does not clip the other."""
    data = _torch(_data())
    trainer, state = _multiseed("basic", {}, data, clip_grad_norm=0.05)
    state, loss, _ = trainer.train_epoch(state, data)
    for i, run in enumerate(_sequential("basic", {}, data,
                                        clip_grad_norm=0.05)):
        np.testing.assert_allclose(loss[i], run[0], rtol=RTOL_LOSS,
                                   atol=ATOL_LOSS)
        got = trainer.seed_params(state, i)
        for name, value in run[4].items():
            np.testing.assert_allclose(got[name].numpy(), value.numpy(),
                                       rtol=RTOL_PARAM, atol=ATOL_PARAM)
    grads = [torch.ones(2, 3), torch.ones(2, 4)]
    grads[0][1] *= 1e3
    trainer._clip(grads)
    np.testing.assert_allclose(torch.cat([g[0] for g in grads]).norm(),
                               0.05, rtol=1e-6)
    np.testing.assert_allclose(torch.cat([g[1] for g in grads]).norm(),
                               0.05, rtol=1e-6)
    small = [torch.full((2, 3), 1e-3)]
    trainer._clip(small)
    assert torch.equal(small[0], torch.full((2, 3), 1e-3))


def _gp_args(seeds, seed=0, affine=True):
    """Fused-GP inputs of ``seeds`` seeds, each stacked on a leading axis."""
    g = torch.Generator().manual_seed(seed)
    b, n, d, m = 2, 6, 4, 8
    x = torch.randn(seeds, b, n, d, generator=g)
    zs = torch.randn(seeds, m, d, generator=g)
    u = torch.randn(seeds, m, generator=g)
    a = torch.randn(seeds, m, m, generator=g) / m
    w = a @ a.transpose(1, 2)
    os_ = 0.5 + torch.rand(seeds, generator=g)
    if not affine:
        return x, zs, u, w, os_
    return (x, zs, u, w, os_, 0.5 + torch.rand(seeds, d, generator=g),
            torch.randn(seeds, d, generator=g) / d,
            torch.randn(seeds, generator=g))


@pytest.mark.parametrize("fn", ["whitened_marginals_affine",
                                "whitened_marginals_affine_bf16",
                                "whitened_marginals",
                                "whitened_marginals_bf16"])
def test_fused_gp_vmap_rule_on_the_cpu(fn):
    """Under ``torch.func.vmap`` each fused-GP entry (the plain fp32 route
    and the bf16 Function, affine or not) gives each seed what a call on
    that seed's inputs gives, forward and gradients of every input; the
    rule's seeded call takes the plain versions' seed axis."""
    marginals = getattr(fused_gp, fn)
    args = _gp_args(3, affine="affine" in fn)
    cot = [torch.randn(3, 2, 6, generator=torch.Generator().manual_seed(1))
           for _ in range(2)]
    leaves = [a.clone().requires_grad_() for a in args]
    mean, var = torch.func.vmap(marginals)(*leaves)
    torch.autograd.backward((mean, var), cot)
    for i in range(3):
        one = [a[i].clone().requires_grad_() for a in args]
        m1, v1 = marginals(*one)
        torch.autograd.backward((m1, v1), [c[i] for c in cot])
        torch.testing.assert_close(mean[i], m1, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(var[i], v1, rtol=1e-5, atol=1e-6)
        for leaf, single in zip(leaves, one):
            torch.testing.assert_close(leaf.grad[i], single.grad, rtol=1e-5,
                                       atol=1e-6)


def test_fused_gp_plain_versions_take_the_seed_axis():
    """The plain forward and VJP on seed-stacked inputs equal a call per
    seed."""
    args = _gp_args(3)
    cot = (torch.randn(3, 2, 6), torch.randn(3, 2, 6))
    for bf16 in (False, True):
        fwd = fused_gp.whitened_marginals_affine_plain(*args, bf16=bf16)
        bwd = fused_gp.whitened_marginals_affine_bwd_plain(*args, *cot,
                                                           bf16=bf16)
        for i in range(3):
            one = [a[i] for a in args]
            for got, want in zip(fwd, fused_gp.whitened_marginals_affine_plain(
                    *one, bf16=bf16)):
                torch.testing.assert_close(got[i], want)
            for got, want in zip(bwd,
                                 fused_gp.whitened_marginals_affine_bwd_plain(
                                     *one, cot[0][i], cot[1][i], bf16=bf16)):
                torch.testing.assert_close(got[i], want)


def test_flash_fold_rule_on_the_cpu():
    """Flash attention's vmap rule folds the seeds into the batch: each
    seed's context and gradients equal its own call's (the Function's CPU
    route: the plain forward and the plain VJP)."""
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(3, 2, 2, 5, 4, generator=g).requires_grad_()
               for _ in range(3))
    do = torch.randn(3, 2, 2, 5, 4, generator=g)
    out = torch.func.vmap(flash_attention.fused_attention)(q, k, v)
    out.backward(do)
    for i in range(3):
        one = [t[i].detach().requires_grad_() for t in (q, k, v)]
        o = flash_attention.fused_attention(*one)
        o.backward(do[i])
        torch.testing.assert_close(out[i], o)
        for t, s in zip((q, k, v), one):
            torch.testing.assert_close(t.grad[i], s.grad)
