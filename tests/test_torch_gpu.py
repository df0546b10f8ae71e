"""The PyTorch port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one (decided in the
``cuda`` fixture, never at import).  The file imports no JAX, so it runs on
a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from fine_grained_gaussian_process_forcasting_torch.models.forecast_denoising import (
    ForecastDenoising,
)
from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (
    fused_gp,
    head_folded_attention as hfa,
)
from fine_grained_gaussian_process_forcasting_torch.train.predict import (
    InferenceSession,
)

# kernel vs plain, both fp32 on the card, summed in another order: the JAX
# package's own tolerances (tests/test_fused_gp.py for the GP,
# tests/test_pallas_kernels.py for attention); the whole model 1e-4
TOL_GP = 2e-5
TOL_ATTENTION = 1e-5
TOL_MODEL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _fused_inputs(b, n, d, m, seed, device):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, d)).astype(np.float32)
    z = rng.normal(size=(m, d)).astype(np.float32)
    ls = np.full(d, np.sqrt(2.0 * d), np.float32)  # K far from 0
    lw = (0.1 * rng.normal(size=(m, m))).astype(np.float32)
    s2 = rng.uniform(0.0, 1.0, size=m).astype(np.float32)
    w = lw.T @ (lw * (1.0 - s2)[:, None])
    arrays = (x, z / ls, rng.normal(size=m), 0.5 * (w + w.T), np.float32(0.9),
              1.0 / ls, rng.normal(size=d) / d, np.float32(0.2))
    return [torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
            for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,d,m", [(4, 36, 16, 32), (3, 77, 32, 512),
                                     (2, 5, 7, 300)])
def test_fused_gp_kernel_matches_plain(cuda, b, n, d, m):
    args = _fused_inputs(b, n, d, m, seed=m, device=cuda)
    before = fused_gp.launches
    got = fused_gp.whitened_marginals_affine(*args)
    torch.cuda.synchronize()
    assert fused_gp.launches == before + 1
    want = fused_gp.whitened_marginals_affine_plain(*args)
    for g, w in zip(got, want):
        assert g.shape == (b, n)
        torch.testing.assert_close(g, w, rtol=TOL_GP, atol=TOL_GP)


@pytest.mark.gpu
def test_fused_gp_kernel_refuses_grad(cuda):
    args = _fused_inputs(2, 8, 4, 16, seed=0, device=cuda)
    args[0].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="backward"):
        fused_gp.whitened_marginals_affine(*args)


def _qkv(b, h, lq, lk, d, seed, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(b, h, n, d)).astype(
        np.float32)).to(device) for n in (lq, lk, lk)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,lq,lk,d", [
    (256, 8, 192, 192, 4), (256, 8, 96, 192, 4), (3, 4, 50, 37, 7),
    (2, 2, 130, 65, 33), (1, 1, 1, 1, 1)])
def test_head_folded_kernel_matches_plain(cuda, b, h, lq, lk, d):
    q, k, v = _qkv(b, h, lq, lk, d, seed=d, device=cuda)
    before = hfa.launches
    got = hfa.head_folded_attention(q, k, v)
    torch.cuda.synchronize()
    assert hfa.launches == before + 1
    torch.testing.assert_close(got, hfa.head_folded_attention_plain(q, k, v),
                               rtol=TOL_ATTENTION, atol=TOL_ATTENTION)


@pytest.mark.gpu
def test_head_folded_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(2, 2, 8, 8, 64, 0, cuda)
    with pytest.raises(ValueError, match="head dim"):
        hfa.head_folded_attention(q, k, v)
    q, k, v = _qkv(2, 2, 8, 8, 4, 0, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        hfa.head_folded_attention(q[:, :, ::2], k, v)
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="backward"):
        hfa.head_folded_attention(q, k, v)


N, BATCH, ENC, DEC, F = 37, 16, 24, 12, 4
SMALL = dict(src_input_size=F, tgt_input_size=F, d_model=16, n_heads=4,
             d_k=4, stack_size=1, pred_len=DEC, num_inducing=32,
             gp_ls_init=-1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("attn_type,expect", [
    ("basic", {"fused_gp": 3, "head_folded_attention": 18}),
    ("autoformer", {"fused_gp": 3, "head_folded_attention": 0})])
def test_session_on_card_runs_the_kernels_and_matches_cpu(cuda, attn_type,
                                                          expect):
    rng = np.random.default_rng(2)
    enc = rng.normal(size=(N, ENC, F)).astype(np.float32)
    dec = rng.normal(size=(N, DEC, F)).astype(np.float32)
    cpu_model = ForecastDenoising(**SMALL, attn_type=attn_type, device="cpu")
    state = cpu_model.state_dict()
    want = InferenceSession(cpu_model, state, batch_size=BATCH,
                            device="cpu").predict(enc, dec)
    session = InferenceSession(
        ForecastDenoising(**SMALL, attn_type=attn_type, device=cuda), state,
        batch_size=BATCH, device=cuda)
    fused_gp.launches = 0
    hfa.launches = 0
    got = session.predict(enc, dec)
    assert {"fused_gp": fused_gp.launches,
            "head_folded_attention": hfa.launches} == expect
    np.testing.assert_allclose(got, want, rtol=TOL_MODEL, atol=TOL_MODEL)
