"""PyTorch port vs the JAX package: the model's last options (informer,
fedformer, the LSTM backbone) through the ``Trainer``, the weights' map
(``params.from_flax``/``to_flax``), the LSTM's initialisation, and the CLI
(``_torch_zoo_cases`` has the configurations)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_zoo_cases import (  # noqa: F401 (pinned_samples: a fixture)
    ATOL_GRAD,
    RTOL_GRAD,
    SMALL,
    TOL,
    _pair,
    _windows,
    pinned_samples,
)
from fine_grained_gaussian_process_forcasting_tpu.train.trainer import (
    Trainer as JTrainer,
    TrainState as JTrainState,
)
from fine_grained_gaussian_process_forcasting_torch.models import (
    forecast_denoising as tfd,
)
from fine_grained_gaussian_process_forcasting_torch.models.lstm import (
    LSTMBackbone,
)
from fine_grained_gaussian_process_forcasting_torch.params import (
    from_flax,
    to_flax,
)
from fine_grained_gaussian_process_forcasting_torch.train import Trainer
from fine_grained_gaussian_process_forcasting_torch.train import cli as tcli


def _trainer_pair(case):
    """The JAX trainer and state and the port's, from the same
    parameters."""
    jmod, params, tmod, (enc, dec, y) = _pair(case)
    jtrainer = JTrainer(jmod, d_model=16, warmup_steps=100)
    jstate = jtrainer.init_state(jax.random.PRNGKey(0), enc, dec, y)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = JTrainState(params=jparams,
                         opt_state=jtrainer.optimizer.init(jparams),
                         rng=jstate.rng)
    trainer = Trainer(tmod, d_model=16, warmup_steps=100, device="cpu")
    return jtrainer, jstate, trainer, trainer.init_state(from_flax(params)), \
        params


STEP_CASES = ("informer", "fedformer", "lstm")


@pytest.mark.parametrize("case", STEP_CASES)
def test_first_step_gradients_match_jax(case, pinned_samples):
    """Every parameter's gradient of one training step, the port's
    ``Trainer`` model against ``jax.grad`` of the JAX trainer's model, and
    nothing more: the LSTM's zero ``b_ih`` is no parameter."""
    jtrainer, _, trainer, _, params = _trainer_pair(case)
    enc, dec, y = _windows(9)

    def loss_fn(p):
        return jtrainer.model.apply(
            {"params": p}, enc, dec, y, training=True,
            rngs={"noise": jax.random.PRNGKey(1),
                  "sampling": jax.random.PRNGKey(2)}).loss

    want = jax.jit(jax.grad(loss_fn))(
        jax.tree_util.tree_map(jnp.asarray, params))
    model = trainer.model
    out = model(*(torch.from_numpy(a) for a in (enc, dec, y)),
                training=True, generator=trainer.generator)
    out.loss.backward()
    got = to_flax({n: p.grad for n, p in model.named_parameters()})
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert set(flat_got) == set(flat_want)
    for path, g in flat_got.items():
        np.testing.assert_allclose(g, np.asarray(flat_want[path]),
                                   rtol=RTOL_GRAD, atol=ATOL_GRAD,
                                   err_msg=jax.tree_util.keystr(path))
    # every weight of the backbone moves the loss; fedformer's encoder none:
    # its cross-attention reads only the decoder's stream, and the GP's
    # marginals of the decoder's points do not depend on the encoder's
    backbone = got["forecasting_model"]
    if case == "fedformer":
        assert not any(np.abs(g).sum() for g in jax.tree_util.tree_leaves(
            backbone.pop("encoder")))
    for path, g in jax.tree_util.tree_flatten_with_path(backbone)[0]:
        assert np.abs(g).sum() > 0, jax.tree_util.keystr(path)


@pytest.mark.parametrize("case", STEP_CASES)
def test_trainer_matches_jax_per_step(case, pinned_samples):
    """Five single-batch epochs of each ``Trainer`` (the JAX one jitted):
    the same loss and MSE each step."""
    jtrainer, jstate, trainer, state, _ = _trainer_pair(case)
    for i in range(5):
        batch = tuple(a[None] for a in _windows(20 + i))
        jstate, jloss, jmse = jtrainer.train_epoch(
            jstate, tuple(jnp.asarray(a) for a in batch))
        state, loss, mse = trainer.train_epoch(
            state, tuple(torch.from_numpy(a) for a in batch))
        np.testing.assert_allclose(loss, jloss, rtol=TOL,
                                   err_msg=f"loss, step {i + 1}")
        np.testing.assert_allclose(mse, jmse, rtol=TOL,
                                   err_msg=f"mse, step {i + 1}")


def test_informer_draws_from_the_trainers_generator():
    """Without a pinned sample, informer's key samples come from the
    generator the model is called with: two trainers seeded alike take the
    same steps, another seed other steps."""
    losses = []
    for seed in (3, 3, 4):
        model = tfd.ForecastDenoising(**SMALL, attn_type="informer",
                                      device="cpu")
        trainer = Trainer(model, d_model=16, warmup_steps=100, device="cpu")
        state = trainer.init_state(seed=seed)
        batch = tuple(torch.from_numpy(a[None]) for a in _windows(30))
        _, loss, _ = trainer.train_epoch(state, batch)
        losses.append(loss)
    assert np.isfinite(losses).all()
    assert losses[0] == losses[1] != losses[2]


@pytest.mark.parametrize("case", ["informer", "fedformer", "lstm"])
def test_from_flax_covers_the_new_leaves(case):
    """Every leaf of the Flax tree lands on the port's state dict with its
    shape (the LSTM's gates stacked, plus its zero ``b_ih`` buffers), and
    ``to_flax`` gives the tree back, bit for bit."""
    _, params, tmod, _ = _pair(case)
    state = from_flax(params)
    want = {k: tuple(v.shape) for k, v in tmod.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in state.items()} == want
    back = to_flax(tmod.state_dict())
    flat = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(flat_back) == set(flat)
    for path, v in flat.items():
        np.testing.assert_array_equal(flat_back[path], np.asarray(v),
                                      err_msg=jax.tree_util.keystr(path))
    n_flax = sum(np.asarray(v).size for v in flat.values())
    assert sum(p.numel() for p in tmod.parameters()) == n_flax
    if case == "lstm":
        lstm = params["forecasting_model"]["lstm1"]
        np.testing.assert_array_equal(
            state["forecasting_model.lstm.weight_hh_l1"][32:48],
            np.asarray(lstm["hg"]["kernel"]).T)
        np.testing.assert_array_equal(
            state["forecasting_model.lstm.bias_hh_l1"][48:],
            np.asarray(lstm["ho"]["bias"]))
        assert not state["forecasting_model.lstm.bias_ih_l1"].any()
        names = {n for n, _ in tmod.named_parameters()}
        assert "forecasting_model.lstm.bias_ih_l0" not in names
    if case == "fedformer":
        layer = params["forecasting_model"]["decoder"]["layer0"][
            "cross_attn"]
        assert layer["fourier_block"]["w_real"].shape == (4, 4, 4, 8)
        assert "fed_q" in layer and "wq" not in layer


def test_lstm_initialises_like_flax():
    """lecun-normal input kernels, orthogonal recurrent kernels (each
    gate's own), zero biases, and ``b_ih`` a zero buffer that training
    leaves at zero."""
    h = 64
    lstm = LSTMBackbone(h, 2, device="cpu",
                        generator=torch.Generator().manual_seed(0)).lstm
    for i in range(2):
        w_hh = getattr(lstm, f"weight_hh_l{i}").detach()
        for g in range(4):
            block = w_hh[g * h:(g + 1) * h]
            torch.testing.assert_close(block @ block.T, torch.eye(h),
                                       rtol=0, atol=1e-5)
        w_ih = getattr(lstm, f"weight_ih_l{i}").detach()
        assert abs(w_ih.std().item() * h ** 0.5 - 1.0) < 0.05
        assert w_ih.abs().max().item() <= 2.0 / (0.8796 * h ** 0.5)
        assert not getattr(lstm, f"bias_hh_l{i}").any()
        assert f"bias_ih_l{i}" in dict(lstm.named_buffers())
    model = tfd.ForecastDenoising(**SMALL, backbone="lstm", device="cpu")
    trainer = Trainer(model, d_model=16, warmup_steps=100, device="cpu")
    batch = tuple(torch.from_numpy(a[None]) for a in _windows(31))
    state, loss, _ = trainer.train_epoch(trainer.init_state(), batch)
    assert np.isfinite(loss)
    assert not state.params["forecasting_model.lstm.bias_ih_l0"].any()
    assert state.params["forecasting_model.lstm.bias_hh_l0"].any()


CLI_ARGS = ["--exp_name", "solar", "--denoising", "True", "--gp", "True",
            "--synthetic", "--pred_len", "8", "--d_model_choices", "16",
            "--stack_choices", "1", "--n_trials", "1", "--n_seeds", "1",
            "--num_epochs", "1", "--num_inducing", "16",
            "--max_train_samples", "32", "--max_valid_samples", "16"]


@pytest.mark.parametrize("flags,name", [
    (["--attn_type", "informer", "--model_name", "informer"],
     "informer_solar_8_8220_denoise_gp"),
    (["--backbone", "lstm", "--model_name", "lstm"],
     "lstm_solar_8_8220_denoise_gp")], ids=["informer", "lstm"])
def test_cli_runs_the_new_options(flags, name, tmp_path):
    """``train.cli.main`` trains, checkpoints and evaluates a study of each
    on the CPU."""
    results = tcli.main(CLI_ARGS + flags + ["--out_dir", str(tmp_path)],
                        device="cpu")
    assert len(results) == 1 and np.isfinite(results[0]["mse"])
    assert (tmp_path / "solar" / f"{name}.npz").exists()
    assert (tmp_path / "models_solar_8" / name).exists()
    lines = (tmp_path / "reported_errors_solar.csv").read_text().splitlines()
    assert lines[1].startswith(name + ",")
