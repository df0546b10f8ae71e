"""The port's serving artifact: ``InferenceSession.export_serving`` ->
``load_exported`` (``torch.export``), fp32 and int8, across the model's
configurations, in a fresh process, and the kernels' registered ops.

The exported program must reproduce ``session.predict`` at the JAX
package's tolerances for its own artifact (tests/test_predict.py): rtol
1e-6 / atol 1e-7 fp32, 1e-5 / 1e-6 int8.  On the CPU every hand kernel's
op runs its plain version (the card's tests run the kernels:
tests/test_torch_gpu.py).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_zoo_cases import CASES, SMALL, _dtypes
from fine_grained_gaussian_process_forcasting_torch.gp.exact_blur import (
    ExactGPBlur,
)
from fine_grained_gaussian_process_forcasting_torch.models.forecast_denoising import (
    ForecastDenoising,
)
from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (
    cholesky,
    flash_attention,
    fused_gp,
    head_folded_attention,
    rbf,
    small_head_attention,
)
from fine_grained_gaussian_process_forcasting_torch.train.predict import (
    InferenceSession,
)

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-6, 1e-7
RTOL_INT8, ATOL_INT8 = 1e-5, 1e-6
# tests/test_predict.py's model and shapes
PREDICT_KW = dict(src_input_size=4, tgt_input_size=4, d_model=16, n_heads=4,
                  d_k=4, stack_size=1, pred_len=8, attn_type="basic",
                  gp=True, denoise=True, num_inducing=8)
B, ENC, DEC, F = 4, 48, 8, 4


def _windows(seed, enc_len=ENC, dec_len=DEC):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, enc_len, F)).astype(np.float32),
            rng.normal(size=(B, dec_len, F)).astype(np.float32))


def _ops_in(path):
    program = torch.export.load(str(path))
    return {str(n.target).split(".")[1] for n in program.graph.nodes
            if str(n.target).startswith("fgp_torch.")}


@pytest.mark.parametrize("quantize", [None, "int8"], ids=["fp32", "int8"])
def test_export_serving_round_trip(tmp_path, quantize):
    """export_serving -> load_exported reproduces session.predict, the
    weights (int8 ones too) held in the artifact."""
    model = ForecastDenoising(**PREDICT_KW, device="cpu")
    session = InferenceSession(model, model.state_dict(), batch_size=B,
                               device="cpu", quantize=quantize)
    path = session.export_serving(str(tmp_path / "serving.pt2"),
                                  enc_len=ENC, dec_len=DEC, n_features=F)
    enc, dec = _windows(7 if quantize else 2)
    want = session.predict(enc, dec)
    got = InferenceSession.load_exported(path)(enc, dec)
    rtol, atol = (RTOL_INT8, ATOL_INT8) if quantize else (RTOL, ATOL)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    assert (tmp_path / "serving.pt2").stat().st_size > 1000
    assert _ops_in(path) == {"fused_gp_fwd"}
    program = torch.export.load(path)
    dtypes = {t.dtype for t in program.state_dict.values()}
    assert (torch.int8 in dtypes) == (quantize == "int8")


# the model's configurations: the zoo's (informer's key samples replayed
# from the artifact), the exact GP, the isotropic noise (its draws too),
# hidden GP layers on the rbf kernel, and which kernel ops each holds
CONFIGS = {**{name: (_dtypes(kw, torch), {"fused_gp_fwd"} | (
              {"head_folded_attention_fwd"} if "use_pallas_attention" in kw
              else set())) for name, kw in CASES.items()},
           "exact": (dict(gp_kind="exact", exact_noise_init=0.1), set()),
           "isotropic": (dict(gp=False), set()),
           "multilayer": (dict(gp_hidden_dims=(3,), use_pallas_gp=True),
                          {"fused_gp_fwd", "rbf_cross_fwd"})}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_export_round_trip_configurations(tmp_path, config):
    kw, ops = CONFIGS[config]
    enc_len, dec_len = 24, 16  # the zoo's: fedformer's modes need 14
    model = ForecastDenoising(**{**SMALL, **kw}, device="cpu")
    session = InferenceSession(model, model.state_dict(), batch_size=B,
                               device="cpu")
    path = session.export_serving(str(tmp_path / f"{config}.pt2"), enc_len,
                                  dec_len, F)
    enc, dec = _windows(3, enc_len, dec_len)
    want = session.predict(enc, dec)
    got = InferenceSession.load_exported(path)(enc, dec)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert _ops_in(path) == ops


def test_exact_blur_on_the_cholesky_op_exports():
    """The exact blur through the Cholesky kernel's op: the jitter is
    picked on the device, so the blur exports and equals eager."""
    blur = ExactGPBlur(8, use_pallas=True, noise_init=0.1, device="cpu")
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(3, 12, 8)).astype(np.float32))

    class Smooth(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.blur = blur

        def forward(self, x):
            return self.blur.smooth(x)

    with torch.no_grad():
        program = torch.export.export(Smooth(), (x,), strict=False)
        want = blur.smooth(x)
    ops = [str(n.target) for n in program.graph.nodes
           if str(n.target).startswith("fgp_torch.")]
    # the probes (one batched call) and the differentiable factorization
    assert ops == ["fgp_torch.batched_cholesky_fwd.default"] * 2
    np.testing.assert_allclose(program.module()(x).detach().numpy(),
                               want.numpy(), rtol=RTOL, atol=ATOL)


def test_export_rejects_platforms(tmp_path):
    """platforms= names torch device types: a ("cpu",) artifact records
    them and serves equal to session.predict; a name that is not a torch
    device type (JAX's "tpu") or a device the artifact does not name is
    refused."""
    model = ForecastDenoising(**PREDICT_KW, device="cpu")
    session = InferenceSession(model, model.state_dict(), batch_size=B,
                               device="cpu")
    for bad in (("tpu",), ("cpu", "tpu"), ()):
        with pytest.raises(ValueError, match="platforms"):
            session.export_serving(str(tmp_path / "s.pt2"), ENC, DEC, F,
                                   platforms=bad)
    path = session.export_serving(str(tmp_path / "cpu.pt2"), ENC, DEC, F,
                                  platforms=("cpu",))
    enc, dec = _windows(4)
    want = session.predict(enc, dec)
    for device in (None, "cpu"):
        got = InferenceSession.load_exported(path, device=device)(enc, dec)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    extra = {"platforms": ""}
    torch.export.load(path, extra_files=extra)
    assert extra["platforms"] == '["cpu"]'
    # an artifact exported without platforms= serves on its own device
    # type alone, as before; one that names only the card is refused here
    plain = session.export_serving(str(tmp_path / "plain.pt2"), ENC, DEC, F)
    for artifact, device in ((plain, "cuda"), (session.export_serving(
            str(tmp_path / "cuda.pt2"), ENC, DEC, F, platforms=("cuda",)),
            "cpu")):
        with pytest.raises(ValueError, match="serves on"):
            InferenceSession.load_exported(artifact, device=device)


_LOADER = """
import sys
import numpy as np
from fine_grained_gaussian_process_forcasting_torch.serving import (
    load_exported,
)
serve = load_exported(sys.argv[1])
np.save(sys.argv[4], serve(np.load(sys.argv[2]), np.load(sys.argv[3])))
print(sorted(m for m in sys.modules
             if m.startswith("fine_grained_gaussian_process_forcasting_torch")))
"""


def test_artifact_loads_without_model_code(tmp_path):
    """A fresh process loads and serves the int8 artifact importing only
    ``serving`` and the kernels' ops: no model code, no parameters."""
    model = ForecastDenoising(**PREDICT_KW, device="cpu")
    session = InferenceSession(model, model.state_dict(), batch_size=B,
                               device="cpu", quantize="int8")
    path = session.export_serving(str(tmp_path / "s.pt2"), ENC, DEC, F)
    enc, dec = _windows(8)
    np.save(tmp_path / "enc.npy", enc)
    np.save(tmp_path / "dec.npy", dec)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    run = subprocess.run(
        [sys.executable, "-c", _LOADER, path, str(tmp_path / "enc.npy"),
         str(tmp_path / "dec.npy"), str(tmp_path / "out.npy")],
        capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert run.returncode == 0, run.stderr[-3000:]
    loaded = eval(run.stdout.strip().splitlines()[-1])
    port = "fine_grained_gaussian_process_forcasting_torch"
    assert f"{port}.serving" in loaded
    assert not [m for m in loaded if m.startswith(
        (f"{port}.models", f"{port}.params", f"{port}.train", f"{port}.gp"))]
    np.testing.assert_allclose(np.load(tmp_path / "out.npy"),
                               session.predict(enc, dec), rtol=RTOL_INT8,
                               atol=ATOL_INT8)


def _t(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


def _op_cases():
    rng = np.random.default_rng(0)
    q, k, v = _t(rng, 2, 2, 5, 4), _t(rng, 2, 2, 6, 4), _t(rng, 2, 2, 6, 4)
    a = _t(rng, 3, 5, 5)
    spd = a @ a.transpose(-1, -2) + 5 * torch.eye(5)
    m, d = 6, 3
    lw = 0.1 * _t(rng, m, m)
    gp = (_t(rng, 2, 5, d), _t(rng, m, d), _t(rng, m), lw @ lw.T,
          torch.tensor(0.9), torch.full((d,), 0.5), _t(rng, d),
          torch.tensor(0.2))
    return {
        "fused_gp": (fused_gp.fused_gp_fwd, (*gp, False)),
        "fused_gp_bf16": (fused_gp.fused_gp_fwd, (*gp, True)),
        "head_folded": (head_folded_attention.head_folded_attention_fwd,
                        (q, k, v)),
        "flash": (flash_attention.flash_attention_fwd, (q, k, v, False)),
        "flash_bf16": (flash_attention.flash_attention_fwd,
                       (q.bfloat16(), k.bfloat16(), v.bfloat16(), False)),
        "small_head": (small_head_attention.small_head_attention_fwd,
                       (q, k, v)),
        "rbf": (rbf.rbf_cross_fwd, (_t(rng, 2, 5, d), _t(rng, m, d),
                                    torch.full((d,), 0.7),
                                    torch.tensor(1.3))),
        "rbf_hidden": (rbf.rbf_cross_fwd, (_t(rng, 2, 5, d),
                                           _t(rng, 4, m, d),
                                           torch.full((4, d), 0.7),
                                           torch.full((4,), 1.3))),
        "cholesky": (cholesky.batched_cholesky_fwd, (spd,)),
    }


@pytest.mark.parametrize("case", list(_op_cases()))
def test_registered_op_passes_opcheck(case):
    """Each kernel's op on CPU tensors (its plain version): schema, fake
    (shapes, dtypes, strides) and dispatch checks of ``opcheck``."""
    op, args = _op_cases()[case]
    torch.library.opcheck(op, args)
