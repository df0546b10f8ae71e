"""PyTorch port vs the JAX package: the trainer, its schedule, clipping,
non-finite guard and checkpoints.

Both trainers start from the same parameters (``params.from_flax``) and
take the same numpy batches.  The port runs on the CPU (its kernels' plain
versions, differentiated by torch's autograd); the JAX package runs its
fused-GP Pallas forward and backward in interpret mode, as its own tests do.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fine_grained_gaussian_process_forcasting_tpu.models import (
    forecast_denoising as jfd,
)
from fine_grained_gaussian_process_forcasting_tpu.train import (
    schedule as jschedule,
)
from fine_grained_gaussian_process_forcasting_tpu.train.trainer import (
    Trainer as JTrainer,
    TrainState as JTrainState,
)
from fine_grained_gaussian_process_forcasting_torch.models import (
    forecast_denoising as tfd,
)
from fine_grained_gaussian_process_forcasting_torch.params import (
    from_flax,
    to_flax,
)
from fine_grained_gaussian_process_forcasting_torch.train import (
    load_checkpoint,
    noam_adam,
    save_checkpoint,
    Trainer,
)
from fine_grained_gaussian_process_forcasting_torch.train import (
    schedule as tschedule,
)
from fine_grained_gaussian_process_forcasting_torch.train.trainer import (
    NonFiniteLossError,
)

# per-step loss and MSE: fp32 through the forward, the backward and five
# Adam updates, summed in another order by each framework: 1e-4 relative.
# Step 1's gradients: the JAX package's fused-GP gradient tolerances
# (tests/test_fused_gp.py).  A resumed run repeats the same arithmetic on
# the same device: 1e-5.
TOL_LOSS = 1e-4
RTOL_GRAD, ATOL_GRAD = 3e-4, 3e-5
TOL_RESUME = 1e-5

SRC, TGT, DM, NH, PRED = 4, 4, 16, 4, 8
ENC_LEN, DEC_LEN, BS, STEPS = 24, 8, 8, 5
SMALL = dict(src_input_size=SRC, tgt_input_size=TGT, d_model=DM,
             n_heads=NH, d_k=DM // NH, stack_size=1, pred_len=PRED,
             num_inducing=16, gp_ls_init=-1.0)
# the exact-GP blur: its MLL replaces the ELBO, and it draws nothing at
# random, so the two trainers see the same function step by step
EXACT = dict(SMALL, gp_kind="exact", exact_noise_init=0.1)
CONFIGS = {"autoformer_gp_denoise": ("autoformer", SMALL),
           "basic_gp_denoise": ("basic", SMALL),
           "basic_exact": ("basic", EXACT)}
# the production-width model cut to a test's size (d_k 64, two layers), in
# fp32 (held to the fp32 tolerances above: JAX goes through its flash kernel
# in interpret mode, the port through the plain route) and in bf16
WIDE = dict(SMALL, d_model=128, n_heads=2, d_k=64, stack_size=2)
WIDE_CONFIGS = {"wide_basic_fp32": {},
                "wide_basic_bf16": dict(compute_dtype="bfloat16",
                                        gp_compute_dtype="bfloat16")}
# bf16: the frameworks round at different places.  A step's loss within 2^-5
# relative over five updates; each gradient of step 1 within 2^-3 of its
# largest magnitude: either framework's own bf16 gradient lies up to a
# quarter of that magnitude from the fp32 gradient (the GP's scalar
# parameters, whose gradients are sums over all rows that nearly cancel)
TOL_LOSS_BF16 = 2.0 ** -5
TOL_GRAD_BF16 = 2.0 ** -3


def _batches(n_batches, seed=0):
    rng = np.random.default_rng(seed)
    enc = rng.normal(size=(n_batches, BS, ENC_LEN, SRC)).astype(np.float32)
    dec = rng.normal(size=(n_batches, BS, DEC_LEN, TGT)).astype(np.float32)
    y = (0.5 * dec[..., -PRED:, :1]
         + 0.1 * rng.normal(size=(n_batches, BS, PRED, 1))).astype(np.float32)
    return enc, dec, y


def _pair(attn_type, base=SMALL, dtypes=None, **kw):
    """JAX trainer + state and the port's trainer + state, same params.
    ``dtypes``: the compute dtypes by name, e.g. "bfloat16"."""
    flags = dict(base, attn_type=attn_type, gp=True, denoise=True,
                 use_fused_gp=True)
    dtypes = dtypes or {}
    enc, dec, y = _batches(1, seed=9)
    dm = flags["d_model"]
    jtrainer = JTrainer(
        jfd.ForecastDenoising(**flags, **{k: getattr(jnp, v)
                                          for k, v in dtypes.items()}),
        d_model=dm, warmup_steps=100, **kw)
    jstate = jtrainer.init_state(jax.random.PRNGKey(0), enc[0], dec[0], y[0])
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    params["lam"] = np.array([0.003], np.float32)  # the ELBO counts
    # q(u) away from the prior, else the marginals ignore Z, W and 1/ls
    rng = np.random.default_rng(5)
    layer = params["deep_gp"].get("output_layer", {})  # none in the exact
    for name, scale in (("variational_mean", 0.5),
                        ("variational_log_stddev", 0.3)):
        if name in layer:
            layer[name] = (scale * rng.normal(
                size=layer[name].shape)).astype(np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = JTrainState(params=jparams,
                         opt_state=jtrainer.optimizer.init(jparams),
                         rng=jstate.rng)
    trainer = Trainer(
        tfd.ForecastDenoising(**flags, **{k: getattr(torch, v)
                                          for k, v in dtypes.items()},
                              device="cpu"),
        d_model=dm, warmup_steps=100, device="cpu", **kw)
    state = trainer.init_state(from_flax(params))
    return jtrainer, jstate, trainer, state, params


@pytest.mark.parametrize("config", list(CONFIGS) + list(WIDE_CONFIGS))
def test_trainer_matches_jax_per_step(config):
    if config in CONFIGS:
        jtrainer, jstate, trainer, state, _ = _pair(*CONFIGS[config])
        tol = TOL_LOSS
    else:
        dtypes = WIDE_CONFIGS[config]
        jtrainer, jstate, trainer, state, _ = _pair("basic", WIDE, dtypes)
        tol = TOL_LOSS_BF16 if dtypes else TOL_LOSS
    enc, dec, y = _batches(STEPS)
    for i in range(STEPS):  # single-batch epochs: one loss per step
        batch = tuple(a[i: i + 1] for a in (enc, dec, y))
        jstate, jloss, jmse = jtrainer.train_epoch(
            jstate, tuple(jnp.asarray(a) for a in batch))
        state, loss, mse = trainer.train_epoch(
            state, tuple(torch.from_numpy(a) for a in batch))
        assert np.isfinite(loss) and np.isfinite(mse)
        np.testing.assert_allclose(loss, jloss, rtol=tol,
                                   err_msg=f"loss, step {i + 1}")
        np.testing.assert_allclose(mse, jmse, rtol=tol,
                                   err_msg=f"mse, step {i + 1}")
    assert state.step == STEPS
    for p in trainer.model.parameters():  # weights stay fp32 in bf16 too
        assert p.dtype == torch.float32


@pytest.mark.parametrize("config", list(CONFIGS) + list(WIDE_CONFIGS))
def test_first_step_gradients_match_jax(config):
    if config in CONFIGS:
        jtrainer, _, trainer, _, params = _pair(*CONFIGS[config])
        bf16 = False
    else:
        dtypes = WIDE_CONFIGS[config]
        jtrainer, _, trainer, _, params = _pair("basic", WIDE, dtypes)
        bf16 = bool(dtypes)
    enc, dec, y = (a[0] for a in _batches(1))

    def loss_fn(p):
        return jtrainer.model.apply(
            {"params": p}, jnp.asarray(enc), jnp.asarray(dec),
            jnp.asarray(y), training=True,
            rngs={"noise": jax.random.PRNGKey(1),
                  "sampling": jax.random.PRNGKey(2)}).loss

    want = jax.grad(loss_fn)(jax.tree_util.tree_map(jnp.asarray, params))
    model = trainer.model
    out = model(torch.from_numpy(enc), torch.from_numpy(dec),
                torch.from_numpy(y), training=True)
    out.loss.backward()
    got = to_flax({name: p.grad for name, p in model.named_parameters()})
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert set(flat_got) == set(flat_want)
    for path, g in flat_got.items():
        w = np.asarray(flat_want[path])
        assert g.dtype == np.float32 and w.dtype == np.float32
        if bf16:
            err, scale = np.abs(g - w).max(), np.abs(w).max()
            assert err <= TOL_GRAD_BF16 * scale, (
                jax.tree_util.keystr(path), err, scale)
        else:
            np.testing.assert_allclose(
                g, w, rtol=RTOL_GRAD, atol=ATOL_GRAD,
                err_msg=jax.tree_util.keystr(path))
    # the GP's own parameters receive gradient (through the fused kernel,
    # or the exact blur's factorization)
    gp = got["deep_gp"].get("output_layer", got["deep_gp"])
    names = (("raw_lengthscale", "raw_outputscale", "raw_noise",
              "mean_weight", "mean_bias") if "raw_noise" in gp else
             ("inducing_points", "variational_mean", "raw_lengthscale",
              "raw_outputscale", "mean_weight", "mean_bias"))
    for name in names:
        assert np.abs(gp[name]).sum() > 0, name


def test_noam_schedule_matches_jax():
    want = jschedule.noam_schedule(32, 4000, 2.0)
    got = tschedule.noam_schedule(32, 4000, 2.0)
    for count in list(range(11)) + [3999, 4000, 4001]:
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=1e-6, err_msg=str(count))


class _Toy(torch.nn.Module):
    """loss = w . enc: the gradient of a step is its batch, by hand."""

    def __init__(self, w0):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(w0))

    def forward(self, enc, dec, y, training=False, generator=None):
        loss = (self.w * enc).sum()
        return types.SimpleNamespace(loss=loss, mse=loss, predictions=enc)


W0 = [0.5, -1.0, 2.0]


def _optax_run(grads, **kw):
    tx = jschedule.noam_adam(16, 100, 2.0, **kw)
    params = {"w": jnp.asarray(W0)}
    opt_state = tx.init(params)
    for g in grads:
        updates, opt_state = tx.update({"w": jnp.asarray(g)}, opt_state,
                                       params)
        params = optax.apply_updates(params, updates)
    return np.asarray(params["w"])


def _toy_run(grads, **kw):
    trainer = Trainer(_Toy(W0), d_model=16, warmup_steps=100, device="cpu",
                      **kw)
    state = trainer.init_state()
    enc = torch.tensor(np.asarray(grads, np.float32))
    dummy = torch.zeros(len(grads), 1)
    state, _, _ = trainer.train_epoch(state, (enc, dummy, dummy))
    return state.params["w"].numpy(), state


def test_noam_adam_steps_match_optax():
    grads = np.random.default_rng(0).normal(size=(6, 3)).astype(np.float32)
    got, state = _toy_run(grads)
    np.testing.assert_allclose(got, _optax_run(grads), rtol=1e-6, atol=1e-7)
    assert state.opt_state["param_groups"][0]["count"] == 6
    model = _Toy(W0)
    assert isinstance(noam_adam(model.parameters(), 16), torch.optim.Adam)


def test_clip_by_global_norm_matches_optax():
    rng = np.random.default_rng(1)
    tree = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,))]
    norm = float(np.sqrt(sum((t ** 2).sum() for t in tree)))
    for max_norm in (0.5 * norm, 2.0 * norm):
        want, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(t) for t in tree], None)
        got = [torch.from_numpy(t.copy()) for t in tree]
        tschedule.clip_by_global_norm(got, max_norm)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    grads = (rng.normal(size=(5, 3)) * 10).astype(np.float32)
    got, _ = _toy_run(grads, clip_grad_norm=1.0)
    np.testing.assert_allclose(got, _optax_run(grads, clip_grad_norm=1.0),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("bad_steps", [[1], [0, 2, 3], list(range(1, 13))],
                         ids=["one", "scattered", "eleven_in_a_row"])
def test_skip_guard_matches_optax_apply_if_finite(bad_steps):
    n = max(bad_steps) + 3
    grads = np.random.default_rng(2).normal(size=(n, 3)).astype(np.float32)
    for i in bad_steps:
        grads[i, i % 3] = np.inf if i % 2 else np.nan
    want = _optax_run(grads, nonfinite_guard="skip")
    got, _ = _toy_run(grads, nonfinite_guard="skip")
    # more than 10 bad steps in a row let the NaN through, in both
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-6,
                               atol=1e-7)
    assert np.all(np.isfinite(got)) == (len(bad_steps) <= 10)


def test_raise_guard_reports_first_bad_step():
    model = tfd.ForecastDenoising(**{**SMALL, "attn_type": "basic"},
                                  gp=False, denoise=False, device="cpu")
    trainer = Trainer(model, d_model=DM, warmup_steps=100,
                      nonfinite_guard="raise", device="cpu")
    enc, dec, y = _batches(4, seed=3)
    y[2, 0, 0, 0] = np.nan
    data = tuple(torch.from_numpy(a) for a in (enc, dec, y))
    state = trainer.init_state()
    with pytest.raises(NonFiniteLossError, match="batch 2") as err:
        trainer.train_epoch(state, data)
    assert err.value.step == 2
    # the state before the epoch survives the raising call
    assert all(torch.isfinite(v).all() for v in state.params.values())
    trainer.eval_epoch(state, data)
    clean = tuple(torch.from_numpy(a) for a in _batches(4, seed=3))
    _, loss, _ = trainer.train_epoch(state, clean)
    assert np.isfinite(loss)


def test_checkpoint_resume_continues_identically(tmp_path):
    model = tfd.ForecastDenoising(**{**SMALL, "attn_type": "autoformer"},
                                  device="cpu")
    trainer = Trainer(model, d_model=DM, warmup_steps=100, device="cpu")
    data = tuple(torch.from_numpy(a) for a in _batches(2, seed=4))
    state = trainer.init_state()
    state, _, _ = trainer.train_epoch(state, data)
    trainer.save_state(str(tmp_path), "ckpt", state)
    path = trainer.save_state(str(tmp_path), "ckpt", state)  # overwrite
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt"]
    assert set(load_checkpoint(str(tmp_path), "ckpt")) == {"params",
                                                           "opt_state"}
    restored = trainer.restore_state(str(tmp_path), "ckpt", state)
    s1, l1, m1 = trainer.train_epoch(state, data)
    s2, l2, m2 = trainer.train_epoch(restored, data)
    np.testing.assert_allclose(l2, l1, rtol=TOL_RESUME)
    np.testing.assert_allclose(m2, m1, rtol=TOL_RESUME)
    for k, v in s1.params.items():
        np.testing.assert_allclose(s2.params[k].numpy(), v.numpy(),
                                   rtol=TOL_RESUME, atol=1e-7, err_msg=k)
    assert path.endswith("ckpt")
    save_checkpoint(str(tmp_path), "params_only", state.params)
    assert set(load_checkpoint(str(tmp_path), "params_only")) == {"params"}


def test_live_state_is_not_copied_and_survives_a_switch():
    model = tfd.ForecastDenoising(**{**SMALL, "attn_type": "basic"},
                                  gp=False, denoise=False, device="cpu")
    trainer = Trainer(model, d_model=DM, warmup_steps=100, device="cpu")
    data = tuple(torch.from_numpy(a) for a in _batches(2, seed=6))
    other = trainer.init_state()
    other.params = {k: v.clone() for k, v in other.params.items()}
    state, _, _ = trainer.train_epoch(trainer.init_state(), data)
    # the epoch's state is the model's own tensors, not a copy
    for name, p in model.named_parameters():
        assert state.params[name].data_ptr() == p.data_ptr(), name
    values = {k: v.clone() for k, v in state.params.items()}
    moments = {k: v["exp_avg"].clone()
               for k, v in state.opt_state["state"].items()}
    trainer.train_epoch(other, data)  # overwrites the model's tensors
    for k, v in values.items():
        torch.testing.assert_close(state.params[k], v, rtol=0, atol=0)
    for k, v in moments.items():
        torch.testing.assert_close(state.opt_state["state"][k]["exp_avg"],
                                   v, rtol=0, atol=0)
    _, again, _ = trainer.train_epoch(state, data)
    _, want, _ = Trainer(
        tfd.ForecastDenoising(**{**SMALL, "attn_type": "basic"}, gp=False,
                              denoise=False, device="cpu"),
        d_model=DM, warmup_steps=100, device="cpu").train_epoch(state, data)
    np.testing.assert_allclose(again, want, rtol=TOL_RESUME)


@pytest.mark.parametrize("kwargs", [{"mesh": object()}, {"fsdp": True}])
def test_trainer_parallel_options_raise(kwargs):
    """mesh= takes a DeviceMesh (parallel.make_mesh; the sharded steps are
    tests/test_torch_parallel.py's) and fsdp= needs one."""
    model = tfd.ForecastDenoising(**{**SMALL, "attn_type": "basic"},
                                  device="cpu")
    error, match = ((TypeError, "DeviceMesh") if "mesh" in kwargs
                    else (ValueError, "needs a mesh"))
    with pytest.raises(error, match=match):
        Trainer(model, d_model=DM, device="cpu", **kwargs)
