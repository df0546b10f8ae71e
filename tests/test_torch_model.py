"""PyTorch port vs the JAX package: Transformer and ForecastDenoising, plus
the port's contracts (weights carried across, devices, unported options,
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
from fine_grained_gaussian_process_forcasting_torch.params import from_flax
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


def test_from_flax_covers_every_parameter():
    rng = np.random.default_rng(0)
    enc = rng.normal(size=(2, ENC, F)).astype(np.float32)
    dec = rng.normal(size=(2, DEC, F)).astype(np.float32)
    params = jfd.ForecastDenoising(**SMALL).init(
        jax.random.PRNGKey(0), enc, dec)
    state = from_flax(_np_tree(params))  # the {"params": ...} wrapper too
    model = tfd.ForecastDenoising(**SMALL, device="cpu")
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in state.items()} == want
    w = params["params"]["forecasting_model"]["encoder"]["layer0"][
        "self_attn"]["wqkv"]["kernel"]
    np.testing.assert_array_equal(
        state["forecasting_model.encoder.layer0.self_attn.wqkv.weight"],
        np.asarray(w).T)


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
    (dict(attn_type="informer"), NotImplementedError),
    (dict(attn_type="ATA"), NotImplementedError),
    (dict(attn_type="nope"), ValueError),
    (dict(backbone="lstm"), NotImplementedError),
    (dict(gp_kind="exact"), NotImplementedError),
    (dict(use_pallas_gp=True), NotImplementedError),
    (dict(gp_hidden_dims=(4,)), NotImplementedError),
    (dict(compute_dtype=torch.bfloat16), NotImplementedError),
    (dict(gp_compute_dtype=torch.bfloat16), NotImplementedError),
])
def test_unported_options_raise(kwargs, error):
    with pytest.raises(error):
        tfd.ForecastDenoising(**{**SMALL, **kwargs}, device="cpu")


def test_unported_session_surfaces_raise():
    model = tfd.ForecastDenoising(**SMALL, device="cpu")
    with pytest.raises(NotImplementedError):
        InferenceSession(model, model.state_dict(), device="cpu",
                         quantize="int8")
    session = InferenceSession(model, model.state_dict(), device="cpu")
    for call in (InferenceSession.from_checkpoint, session.export_serving,
                 session.predict_dataframe):
        with pytest.raises(NotImplementedError):
            call()


_FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax",
              "fine_grained_gaussian_process_forcasting_tpu", "_torch_gp_ref",
              "tests"}


def test_port_imports_nothing_of_jax():
    """An AST scan: the environment preloads jax, so sys.modules cannot
    show what the port imports."""
    root = Path(__file__).resolve().parents[1]
    files = sorted((root / "fine_grained_gaussian_process_forcasting_torch")
                   .rglob("*.py")) + [root / "chip_smoke.py"]
    assert len(files) > 10
    port = root / "fine_grained_gaussian_process_forcasting_torch"
    for module in ("train/trainer.py", "train/schedule.py",
                   "train/checkpoint.py", "data/window.py", "params.py",
                   "ops/cuda/fused_gp.py", "ops/cuda/head_folded_attention.py"):
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
