"""PyTorch port vs the JAX package: Transformer and ForecastDenoising, plus
the port's contracts (weights carried across, devices, unknown options,
no JAX imports)."""

import ast
from pathlib import Path

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
from fine_grained_gaussian_process_forcasting_torch.gp.deep_gp import DeepGP
from fine_grained_gaussian_process_forcasting_torch.models import (
    forecast_denoising as tfd,
)
from fine_grained_gaussian_process_forcasting_torch.models import (
    transformer as ttr,
)
from fine_grained_gaussian_process_forcasting_torch.params import (
    from_flax,
    to_flax,
)
from fine_grained_gaussian_process_forcasting_torch.train.predict import (
    InferenceSession,
)

# fp32 through two transformer passes, a GP and LayerNorms, summed in
# another order by each framework: 1e-4
TOL = 1e-4
B, ENC, DEC, F = 4, 24, 12, 4
SMALL = dict(src_input_size=F, tgt_input_size=F, d_model=16, n_heads=4,
             d_k=4, stack_size=1, pred_len=DEC, num_inducing=32,
             gp_ls_init=-1.0)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("attn_type", ["basic", "autoformer"])
def test_transformer_matches_jax(attn_type):
    rng = np.random.default_rng(1)
    enc = rng.normal(size=(B, ENC, 16)).astype(np.float32)
    dec = rng.normal(size=(B, DEC, 16)).astype(np.float32)
    kw = dict(d_model=16, d_ff=64, d_k=4, d_v=4, n_heads=4, n_layers=2,
              attn_type=attn_type)
    jmod = jtr.Transformer(**kw)
    params = jmod.init(jax.random.PRNGKey(2), enc, dec)["params"]
    want = jmod.apply({"params": params}, enc, dec)
    tmod = ttr.Transformer(**kw, device="cpu")
    tmod.load_state_dict(from_flax(_np_tree(params)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(enc), torch.from_numpy(dec))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


CASES = {
    "autoformer_gp": dict(attn_type="autoformer"),
    "basic_gp": dict(attn_type="basic"),
    "basic_no_noise": dict(attn_type="basic", gp=False, no_noise=True),
    "basic_isotropic": dict(attn_type="basic", gp=False),
    "autoformer_residual_enc": dict(attn_type="autoformer", residual=True,
                                    gp_inject="enc"),
    "basic_no_denoise": dict(attn_type="basic", denoise=False),
    "basic_gp_training": dict(attn_type="basic", training=True),
    "autoformer_gp_training": dict(attn_type="autoformer", training=True),
    # the multi-layer deep GP (3 hidden GPs) at eps = 0: JAX without a
    # 'noise' rng, the port without draws or a generator
    "basic_multilayer": dict(attn_type="basic", gp_hidden_dims=(3,)),
    "autoformer_multilayer_pallas_training": dict(
        attn_type="autoformer", gp_hidden_dims=(3,), use_pallas_gp=True,
        training=True),
    # the exact-GP blur, its MLL in the loss when training
    "basic_exact": dict(attn_type="basic", gp_kind="exact",
                        exact_noise_init=0.1),
    "autoformer_exact_training": dict(attn_type="autoformer",
                                      gp_kind="exact", exact_noise_init=0.1,
                                      training=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_forecast_denoising_matches_jax(case):
    kw = dict(CASES[case])
    training = kw.pop("training", False)
    rng = np.random.default_rng(3)
    enc = rng.normal(size=(B, ENC, F)).astype(np.float32)
    dec = rng.normal(size=(B, DEC, F)).astype(np.float32)
    y = rng.normal(size=(B, DEC, 1)).astype(np.float32)

    jmod = jfd.ForecastDenoising(**SMALL, **kw)
    params = _np_tree(jmod.init({"params": jax.random.PRNGKey(4)}, enc,
                                dec)["params"])
    params["lam"] = np.array([0.003], np.float32)  # ELBO weight in the loss
    # isotropic mode without a 'noise' stream draws from PRNGKey(0): hand
    # the port the same draws
    r1, r2 = jax.random.split(jax.random.PRNGKey(0))
    noise = tuple(torch.from_numpy(np.array(jax.random.normal(r, shape)))
                  for r, shape in ((r1, (B, ENC, 16)), (r2, (B, DEC, 16))))
    want = jmod.apply({"params": params}, enc, dec, y, training=training)

    tmod = tfd.ForecastDenoising(**SMALL, **kw, device="cpu")
    tmod.load_state_dict(from_flax(params))
    with torch.no_grad():
        got = tmod(torch.from_numpy(enc), torch.from_numpy(dec),
                   torch.from_numpy(y), training=training, noise=noise)
    assert got.predictions.shape == (B, DEC, 1)
    for field in ("predictions", "mse", "loss"):
        np.testing.assert_allclose(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)),
            rtol=TOL, atol=TOL, err_msg=field)


# the production-width model cut to a test's size: d_k 64 (the width at
# which ``basic`` self-attention leaves the head-folded route), two layers
WIDE = dict(src_input_size=F, tgt_input_size=F, d_model=128, n_heads=2,
            d_k=64, stack_size=2, pred_len=DEC, num_inducing=16,
            gp_ls_init=-1.0, attn_type="basic")
BF16 = dict(compute_dtype="bfloat16", gp_compute_dtype="bfloat16")
# bf16 model against bf16 model: the two frameworks round at different
# places (Flax rounds a dense layer's product and then its bias sum, torch
# once; XLA and torch sum in other orders), and four transformer passes of
# LayerNorms amplify a one-step difference: 2^-6 of the largest magnitude
TOL_BF16_MODEL = 2.0 ** -6


def _dtypes(kw, module):
    return {k: getattr(module, v) if k.endswith("dtype") else v
            for k, v in kw.items()}


def _wide_pair(kw, seed=4):
    rng = np.random.default_rng(seed)
    enc = rng.normal(size=(B, ENC, F)).astype(np.float32)
    dec = rng.normal(size=(B, DEC, F)).astype(np.float32)
    y = rng.normal(size=(B, DEC, 1)).astype(np.float32)
    jmod = jfd.ForecastDenoising(**WIDE, **_dtypes(kw, jnp))
    params = _np_tree(jmod.init({"params": jax.random.PRNGKey(seed)}, enc,
                                dec)["params"])
    params["lam"] = np.array([0.003], np.float32)
    layer = params["deep_gp"]["output_layer"]  # q(u) away from the prior
    for name, scale in (("variational_mean", 0.5),
                        ("variational_log_stddev", 0.3)):
        layer[name] = (scale * rng.normal(size=16)).astype(np.float32)
    tmod = tfd.ForecastDenoising(**WIDE, **_dtypes(kw, torch), device="cpu")
    tmod.load_state_dict(from_flax(params))
    return jmod, params, tmod, (enc, dec, y)


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_wide_fp32_model_matches_jax(training):
    """fp32 at d_k 64: JAX goes through its flash kernel (interpret mode),
    the port through the plain route; the exact check of both."""
    jmod, params, tmod, (enc, dec, y) = _wide_pair({})
    want = jmod.apply({"params": params}, enc, dec, y, training=training)
    with torch.no_grad():
        got = tmod(*(torch.from_numpy(a) for a in (enc, dec, y)),
                   training=training)
    for field in ("predictions", "mse", "loss"):
        np.testing.assert_allclose(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)),
            rtol=TOL, atol=TOL, err_msg=field)


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_wide_bf16_model_matches_jax(training):
    jmod, params, tmod, (enc, dec, y) = _wide_pair(BF16)
    want = jmod.apply({"params": params}, enc, dec, y, training=training)
    with torch.no_grad():
        got = tmod(*(torch.from_numpy(a) for a in (enc, dec, y)),
                   training=training)
    assert got.predictions.dtype == torch.float32
    wp = np.asarray(want.predictions)
    assert (np.abs(got.predictions.numpy() - wp).max()
            <= TOL_BF16_MODEL * np.abs(wp).max())
    for field in ("mse", "loss"):
        np.testing.assert_allclose(float(getattr(got, field)),
                                   float(getattr(want, field)),
                                   rtol=TOL_BF16_MODEL, err_msg=field)
    # and bf16 is another function than fp32
    fp32 = tfd.ForecastDenoising(**WIDE, device="cpu")
    fp32.load_state_dict(from_flax(params))
    with torch.no_grad():
        exact = fp32(*(torch.from_numpy(a) for a in (enc, dec, y)),
                     training=training)
    assert (exact.predictions - got.predictions).abs().max() > 1e-4


def test_wide_bf16_session_matches_jax():
    jmod, params, tmod, (enc, dec, _) = _wide_pair(BF16, seed=6)
    rng = np.random.default_rng(8)
    enc = np.concatenate([enc, rng.normal(size=(3, ENC, F)).astype(
        np.float32)])
    dec = np.concatenate([dec, rng.normal(size=(3, DEC, F)).astype(
        np.float32)])
    want = np.asarray(jmod.apply({"params": params}, enc, dec).predictions)
    session = InferenceSession(tmod, from_flax(params), batch_size=4,
                               device="cpu")
    got = session.predict(enc, dec)  # 7 windows: a batch and a ragged 3
    assert got.shape == (7, DEC, 1) and got.dtype == np.float32
    assert np.abs(got - want).max() <= TOL_BF16_MODEL * np.abs(want).max()


def test_transformer_bf16_matches_jax():
    """The backbone alone: bf16 inside, both streams back in the input's
    dtype."""
    rng = np.random.default_rng(1)
    enc = rng.normal(size=(B, ENC, 128)).astype(np.float32)
    dec = rng.normal(size=(B, DEC, 128)).astype(np.float32)
    kw = dict(d_model=128, d_ff=512, d_k=64, d_v=64, n_heads=2, n_layers=1,
              attn_type="basic")
    jmod = jtr.Transformer(**kw, dtype=jnp.bfloat16)
    params = jmod.init(jax.random.PRNGKey(2), enc, dec)["params"]
    want = jmod.apply({"params": params}, enc, dec)
    tmod = ttr.Transformer(**kw, compute_dtype=torch.bfloat16, device="cpu")
    tmod.load_state_dict(from_flax(_np_tree(params)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(enc), torch.from_numpy(dec))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= TOL_BF16_MODEL * np.abs(w).max()
    for p in tmod.parameters():
        assert p.dtype == torch.float32


def test_from_flax_covers_every_parameter():
    """Every parameter of the Flax tree lands on the port's state dict with
    its shape, for basic attention and the three conv-family types (Conv
    kernels (f, in, out) become conv1d weights (out, in, f))."""
    rng = np.random.default_rng(0)
    enc = rng.normal(size=(2, ENC, F)).astype(np.float32)
    dec = rng.normal(size=(2, DEC, F)).astype(np.float32)
    for attn_type in ("basic", "ATA", "ACAT", "conv_attn"):
        params = jfd.ForecastDenoising(**SMALL, attn_type=attn_type).init(
            jax.random.PRNGKey(0), enc, dec)
        state = from_flax(_np_tree(params))  # the {"params": ...} wrapper too
        model = tfd.ForecastDenoising(**SMALL, attn_type=attn_type,
                                      device="cpu")
        want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        assert {k: tuple(v.shape) for k, v in state.items()} == want, \
            attn_type
        layer = params["params"]["forecasting_model"]["encoder"]["layer0"][
            "self_attn"]
        w = layer["wqkv"]["kernel"]
        np.testing.assert_array_equal(
            state["forecasting_model.encoder.layer0.self_attn.wqkv.weight"],
            np.asarray(w).T)
        if attn_type == "ATA":
            w = layer["ata"]["k_conv7"]["kernel"]
            np.testing.assert_array_equal(
                state["forecasting_model.encoder.layer0.self_attn.ata."
                      "k_conv7.weight"], np.asarray(w).transpose(2, 1, 0))
        back = to_flax(state)
        for path, leaf in jax.tree_util.tree_leaves_with_path(
                params["params"]):
            node = back
            for key in path:
                node = node[key.key]
            np.testing.assert_array_equal(node, np.asarray(leaf))


def test_isotropic_mode_needs_generator_or_noise():
    model = tfd.ForecastDenoising(**SMALL, gp=False, device="cpu")
    enc = torch.zeros(2, ENC, F)
    dec = torch.zeros(2, DEC, F)
    with torch.no_grad():
        with pytest.raises(ValueError, match="generator"):
            model(enc, dec)
        a = model(enc, dec, generator=torch.Generator().manual_seed(5))
        b = model(enc, dec, generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(a.predictions, b.predictions)


def test_entry_points_need_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda **kw: tfd.ForecastDenoising(**SMALL, **kw),
                  lambda **kw: ttr.Transformer(16, 64, 4, 4, 4, 1, **kw),
                  lambda **kw: DeepGP(16, 8, **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
        build(device="cpu")
    model = tfd.ForecastDenoising(**SMALL, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceSession(model, model.state_dict(), batch_size=4)
    InferenceSession(model, model.state_dict(), batch_size=4, device="cpu")


@pytest.mark.parametrize("kwargs,error", [
    (dict(attn_type="nope"), ValueError),
    (dict(backbone="nope"), ValueError),
])
def test_unported_options_raise(kwargs, error):
    with pytest.raises(error):
        tfd.ForecastDenoising(**{**SMALL, **kwargs}, device="cpu")


def test_exact_blur_takes_only_the_joint_injection():
    with pytest.raises(ValueError, match="gp_inject"):
        tfd.ForecastDenoising(**SMALL, gp_kind="exact", gp_inject="enc",
                              device="cpu")
    with pytest.raises(ValueError, match="gp_kind"):
        tfd.ForecastDenoising(**SMALL, gp_kind="nope", device="cpu")


# at the size the JAX package's own multi-layer and exact composite tests
# would need to stay fast (its Pallas rbf runs in interpret mode)
GP_SMALL = dict(SMALL, d_model=8, n_heads=2, pred_len=8, num_inducing=16)
GP_ENC, GP_DEC = 16, 8
GP_CONFIGS = {
    "multilayer_pallas": dict(attn_type="basic", gp_hidden_dims=(3,),
                              use_pallas_gp=True),
    "exact": dict(attn_type="basic", gp_kind="exact", exact_noise_init=0.1),
}


def _gp_config_pair(config, seed=5):
    kw = GP_CONFIGS[config]
    rng = np.random.default_rng(seed)
    enc = rng.normal(size=(B, GP_ENC, F)).astype(np.float32)
    dec = rng.normal(size=(B, GP_DEC, F)).astype(np.float32)
    y = rng.normal(size=(B, GP_DEC, 1)).astype(np.float32)
    jmod = jfd.ForecastDenoising(**GP_SMALL, **kw)
    params = _np_tree(jmod.init({"params": jax.random.PRNGKey(seed)}, enc,
                                dec)["params"])
    params["lam"] = np.array([0.003], np.float32)
    for layer in ("hidden_layer0", "output_layer"):  # q(u) off the prior
        for name, scale in (("variational_mean", 0.5),
                            ("variational_log_stddev", 0.3)):
            p = params["deep_gp"].get(layer)
            if p is not None:
                p[name] = (scale * rng.normal(size=p[name].shape)).astype(
                    np.float32)
    tmod = tfd.ForecastDenoising(**GP_SMALL, **kw, device="cpu")
    tmod.load_state_dict(from_flax(params))
    return jmod, params, tmod, (enc, dec, y)


@pytest.mark.parametrize("config", list(GP_CONFIGS))
def test_gp_config_first_step_gradients_match_jax(config):
    """The training loss and every parameter's gradient of the multi-layer
    (rbf route, eps = 0) and the exact-blur composites."""
    jmod, params, tmod, (enc, dec, y) = _gp_config_pair(config)

    def loss_fn(p):
        return jmod.apply({"params": p}, enc, dec, y, training=True).loss

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree_util.tree_map(jnp.asarray, params))
    out = tmod(*(torch.from_numpy(a) for a in (enc, dec, y)), training=True)
    out.loss.backward()
    np.testing.assert_allclose(float(out.loss.detach()), float(want_loss),
                               rtol=TOL, atol=TOL)
    got = to_flax({n: p.grad for n, p in tmod.named_parameters()})
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert set(flat_got) == set(flat_want)
    for path, g in flat_got.items():
        np.testing.assert_allclose(g, np.asarray(flat_want[path]), rtol=TOL,
                                   atol=TOL,
                                   err_msg=jax.tree_util.keystr(path))
    gp = got["deep_gp"]  # the GP's own parameters receive gradient
    layers = ([gp["hidden_layer0"], gp["output_layer"]] if "output_layer" in gp
              else [gp])
    for layer in layers:
        for name, g in layer.items():
            assert np.abs(g).sum() > 0, name


def test_multilayer_injected_gp_eps_matches_jax_noise_draws(monkeypatch):
    """The multi-layer composite with the hidden layer's draws injected
    (``gp_eps``): JAX draws eps from its 'noise' rng, the port is handed
    those draws; the training loss, the predictions and every parameter's
    gradient agree."""
    jmod, params, tmod, (enc, dec, y) = _gp_config_pair("multilayer_pallas")
    rngs = {"noise": jax.random.PRNGKey(7)}
    draws, normal = [], jax.random.normal

    def recording(key, shape=(), dtype=float):
        out = normal(key, shape, dtype)
        draws.append(np.array(out))
        return out

    monkeypatch.setattr(jax.random, "normal", recording)
    want_out = jmod.apply({"params": params}, enc, dec, y, training=True,
                          rngs=rngs)
    monkeypatch.undo()
    assert [d.shape for d in draws] == [(B, GP_ENC + GP_DEC, 3)]

    def loss_fn(p):
        return jmod.apply({"params": p}, enc, dec, y, training=True,
                          rngs=rngs).loss

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree_util.tree_map(jnp.asarray, params))
    gp_eps = [torch.from_numpy(d) for d in draws]
    out = tmod(*(torch.from_numpy(a) for a in (enc, dec, y)), training=True,
               gp_eps=gp_eps)
    out.loss.backward()
    np.testing.assert_allclose(float(out.loss.detach()), float(want_loss),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out.predictions.detach().numpy(),
                               np.asarray(want_out.predictions), rtol=TOL,
                               atol=TOL)
    got = to_flax({n: p.grad for n, p in tmod.named_parameters()})
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    for path, g in jax.tree_util.tree_flatten_with_path(got)[0]:
        np.testing.assert_allclose(g, np.asarray(flat_want[path]), rtol=TOL,
                                   atol=TOL,
                                   err_msg=jax.tree_util.keystr(path))
    # the draws matter: at eps = 0 the loss is another
    with torch.no_grad():
        at_zero = tmod(*(torch.from_numpy(a) for a in (enc, dec, y)),
                       training=True).loss
    assert abs(float(at_zero) - float(want_loss)) > 10 * TOL


@pytest.mark.parametrize("config", list(GP_CONFIGS))
def test_gp_config_params_round_trip(config):
    """from_flax -> the port's state dict (every key and shape, the hidden
    layer's (h,)-shaped former scalars too) -> to_flax gives the tree back."""
    _, params, tmod, _ = _gp_config_pair(config)
    back = to_flax(tmod.state_dict())
    flat = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(flat_back) == set(flat)
    for path, v in flat.items():
        np.testing.assert_array_equal(flat_back[path], np.asarray(v),
                                      err_msg=jax.tree_util.keystr(path))
    if config == "multilayer_pallas":
        hidden = back["deep_gp"]["hidden_layer0"]
        assert hidden["raw_outputscale"].shape == (3,)
        assert hidden["mean_bias"].shape == (3,)
        assert hidden["inducing_points"].shape == (3, 16, 8)
        assert back["deep_gp"]["output_layer"]["mean_weight"].shape == (3,)


def test_unported_session_surfaces_raise():
    """Every session surface is ported; what has no counterpart raises: a
    quantization mode other than int8, and JAX's ``platforms=`` (the
    artifact serves on the session's device)."""
    model = tfd.ForecastDenoising(**SMALL, device="cpu")
    with pytest.raises(ValueError, match="fp4"):
        InferenceSession(model, model.state_dict(), device="cpu",
                         quantize="fp4")
    session = InferenceSession(model, model.state_dict(), device="cpu",
                               quantize="int8")
    with pytest.raises(ValueError, match="platforms"):
        session.export_serving("unused.pt2", 24, 12, 4, platforms=("tpu",))


_FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax",
              "fine_grained_gaussian_process_forcasting_tpu", "_torch_gp_ref",
              "tests", "pandas", "sklearn"}


def test_port_imports_nothing_of_jax():
    """An AST scan: the environment preloads jax, so sys.modules cannot
    show what the port imports.  Nor pandas or scikit-learn: the machine
    with the card has neither."""
    root = Path(__file__).resolve().parents[1]
    files = sorted((root / "fine_grained_gaussian_process_forcasting_torch")
                   .rglob("*.py")) + [root / "chip_smoke.py"]
    assert len(files) > 10
    port = root / "fine_grained_gaussian_process_forcasting_torch"
    for module in ("train/trainer.py", "train/schedule.py",
                   "train/checkpoint.py", "data/window.py", "params.py",
                   "ops/cuda/fused_gp.py", "ops/cuda/head_folded_attention.py",
                   "ops/cuda/flash_attention.py", "ops/cuda/rbf.py",
                   "ops/cuda/cholesky.py", "gp/exact.py", "gp/exact_blur.py",
                   "ops/cuda/small_head_attention.py", "ops/conv_attention.py",
                   "data/table.py", "data/synthetic.py",
                   "data/formatters/scaling.py", "train/hpo.py",
                   "train/harness.py", "train/cli.py", "ops/probsparse.py",
                   "ops/fourier.py", "models/lstm.py", "train/multiseed.py",
                   "train/evaluate_checkpoints.py", "train/quantize.py",
                   "train/predict.py", "serving.py", "draws.py",
                   "utils/config.py", "utils/normalizers.py",
                   "data/univariate.py", "models/dlinear.py",
                   "models/nbeats.py", "models/deepar.py", "models/cmgp.py",
                   "train/baselines_harness.py", "parallel/__init__.py",
                   "parallel/mesh.py", "parallel/sharding.py"):
        assert port / module in files, module
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in _FORBIDDEN, (
                    f"{path.relative_to(root)} imports {name}")
