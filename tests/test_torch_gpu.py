"""The PyTorch port's CUDA kernels against their plain versions, on the card:
forward and backward kernels, the autograd Functions, serving and training.

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
from fine_grained_gaussian_process_forcasting_torch.train import Trainer
from fine_grained_gaussian_process_forcasting_torch.train.predict import (
    InferenceSession,
)

# kernel vs plain, both fp32 on the card, summed in another order: the JAX
# package's own tolerances (tests/test_fused_gp.py for the GP,
# tests/test_pallas_kernels.py for attention); the whole model 1e-4
TOL_GP = 2e-5
TOL_ATTENTION = 1e-5
TOL_MODEL = 1e-4
# gradients: the JAX package's fused-GP gradient tolerances
# (tests/test_fused_gp.py) and its attention-gradient tolerances
# (tests/test_pallas_kernels.py)
TOL_GRAD, ATOL_GRAD = 3e-4, 3e-5
TOL_GRAD_ATT, ATOL_GRAD_ATT = 1e-4, 1e-5


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


def _assert_grads_close(got, want, names):
    """Per-row outputs (the first) elementwise; the row-summed ones within
    the tolerance relative to their largest magnitude."""
    for i, (g, w, name) in enumerate(zip(got, want, names)):
        assert g.shape == w.shape, name
        if i == 0:
            torch.testing.assert_close(g, w, rtol=TOL_GRAD, atol=ATOL_GRAD,
                                       msg=name)
        else:
            err = (g - w).abs().max().item()
            scale = max(1.0, w.abs().max().item())
            assert err <= TOL_GRAD * scale, (name, err, scale)


GP_GRADS = ("x", "zs", "u", "w", "outputscale", "inv_ls", "mean_w", "mean_b")


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,d,m", [(4, 36, 16, 32), (3, 77, 32, 512),
                                     (2, 5, 7, 300), (3, 13, 1, 16)])
def test_fused_gp_bwd_kernel_matches_plain(cuda, b, n, d, m):
    args = _fused_inputs(b, n, d, m, seed=m + 1, device=cuda)
    rng = np.random.default_rng(d)
    cot = [torch.from_numpy(rng.normal(size=(b, n)).astype(np.float32)).to(
        cuda) for _ in range(2)]
    before = fused_gp.bwd_launches
    got = fused_gp.backward_kernel(*args, *cot)
    torch.cuda.synchronize()
    assert fused_gp.bwd_launches == before + 1
    want = fused_gp.whitened_marginals_affine_bwd_plain(*args, *cot)
    _assert_grads_close(got, want, GP_GRADS)
    again = fused_gp.backward_kernel(*args, *cot)
    for g, a in zip(got, again):  # no atomics: equal bit for bit
        assert torch.equal(g, a)


@pytest.mark.gpu
def test_fused_gp_kernel_takes_grad(cuda):
    """On a CUDA tensor that requires grad the wrapper runs the autograd
    Function (forward and backward kernels), never the plain version; its
    gradients equal torch's autograd through the plain forward."""
    args = _fused_inputs(3, 29, 16, 64, seed=4, device=cuda)
    leaves = [a.clone().requires_grad_(True) for a in args]
    fwd, bwd = fused_gp.launches, fused_gp.bwd_launches
    mean, var = fused_gp.whitened_marginals_affine(*leaves)
    (torch.sin(mean) * 1.7 + var ** 2 * 0.3).sum().backward()
    assert (fused_gp.launches, fused_gp.bwd_launches) == (fwd + 1, bwd + 1)
    plain = [a.clone().requires_grad_(True) for a in args]
    mean, var = fused_gp.whitened_marginals_affine_plain(*plain)
    (torch.sin(mean) * 1.7 + var ** 2 * 0.3).sum().backward()
    _assert_grads_close([t.grad for t in leaves], [t.grad for t in plain],
                        GP_GRADS)


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


ATT_SHAPES = [(256, 8, 192, 192, 4), (256, 8, 96, 192, 4), (3, 4, 50, 37, 7),
              (2, 2, 130, 65, 33), (1, 1, 1, 1, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,lq,lk,d", ATT_SHAPES)
def test_head_folded_bwd_kernel_matches_plain(cuda, b, h, lq, lk, d):
    q, k, v = _qkv(b, h, lq, lk, d, seed=d + 1, device=cuda)
    do = torch.randn(b, h, lq, d, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(d))
    out, lse = hfa.forward_kernel(q, k, v, with_lse=True)
    want_lse = torch.logsumexp(
        torch.matmul(q, k.transpose(-1, -2)) / d ** 0.5, dim=-1)
    torch.testing.assert_close(lse, want_lse, rtol=TOL_ATTENTION,
                               atol=TOL_ATTENTION)
    before = hfa.bwd_launches
    got = hfa.backward_kernel(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    assert hfa.bwd_launches == before + 1
    want = hfa.head_folded_attention_bwd_plain(q, k, v, do)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        torch.testing.assert_close(g, w, rtol=TOL_GRAD_ATT,
                                   atol=ATOL_GRAD_ATT, msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("lq,lk", [(50, 50), (24, 61)])
def test_head_folded_kernel_takes_grad(cuda, lq, lk):
    """With inputs that require grad the wrapper runs the autograd Function
    (forward with lse, then the backward kernel); its gradients equal
    torch's autograd through the plain forward."""
    qkv = _qkv(3, 4, lq, lk, 4, seed=lk, device=cuda)
    leaves = [t.clone().requires_grad_(True) for t in qkv]
    fwd, bwd = hfa.launches, hfa.bwd_launches
    torch.sin(hfa.head_folded_attention(*leaves)).sum().backward()
    assert (hfa.launches, hfa.bwd_launches) == (fwd + 1, bwd + 1)
    plain = [t.clone().requires_grad_(True) for t in qkv]
    torch.sin(hfa.head_folded_attention_plain(*plain)).sum().backward()
    for a, p, name in zip(leaves, plain, "qkv"):
        torch.testing.assert_close(a.grad, p.grad, rtol=TOL_GRAD_ATT,
                                   atol=ATOL_GRAD_ATT, msg=name)


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


@pytest.mark.gpu
@pytest.mark.parametrize("attn_type,per_step", [
    ("basic", {"fused_gp": 1, "fused_gp_bwd": 1, "head_folded_attention": 6,
               "head_folded_attention_bwd": 6}),
    ("autoformer", {"fused_gp": 1, "fused_gp_bwd": 1,
                    "head_folded_attention": 0,
                    "head_folded_attention_bwd": 0})])
def test_training_step_on_card_matches_cpu(cuda, attn_type, per_step):
    """Two Trainer steps on the card and on the CPU from the same weights
    and batches: the same losses and parameters, through the kernels."""
    rng = np.random.default_rng(7)
    data = [rng.normal(size=(2, BATCH, n, f)).astype(np.float32)
            for n, f in ((ENC, F), (DEC, F), (DEC, 1))]
    cpu_model = ForecastDenoising(**SMALL, attn_type=attn_type, device="cpu")
    with torch.no_grad():  # q(u) away from the prior: every GP gradient
        layer = cpu_model.deep_gp.output_layer
        layer.variational_mean.copy_(torch.from_numpy(
            0.5 * rng.normal(size=32).astype(np.float32)))
        layer.variational_log_stddev.copy_(torch.from_numpy(
            0.3 * rng.normal(size=32).astype(np.float32)))
    state = {k: v.clone() for k, v in cpu_model.state_dict().items()}
    results = {}
    for device in ("cpu", cuda):
        model = (cpu_model if device == "cpu" else ForecastDenoising(
            **SMALL, attn_type=attn_type, device=cuda))
        trainer = Trainer(model, d_model=16, warmup_steps=100, device=device)
        s = trainer.init_state(state)
        fused_gp.launches = fused_gp.bwd_launches = 0
        hfa.launches = hfa.bwd_launches = 0
        s, loss, mse = trainer.train_epoch(
            s, tuple(torch.from_numpy(a).to(device) for a in data))
        counts = {"fused_gp": fused_gp.launches,
                  "fused_gp_bwd": fused_gp.bwd_launches,
                  "head_folded_attention": hfa.launches,
                  "head_folded_attention_bwd": hfa.bwd_launches}
        results[str(device)] = (loss, mse, s.params, counts)
    loss_c, mse_c, params_c, counts_c = results["cpu"]
    loss_g, mse_g, params_g, counts_g = results["cuda"]
    assert counts_c == dict.fromkeys(per_step, 0)
    assert counts_g == {k: 2 * v for k, v in per_step.items()}
    np.testing.assert_allclose(loss_g, loss_c, rtol=TOL_MODEL)
    np.testing.assert_allclose(mse_g, mse_c, rtol=TOL_MODEL)
    for name, p in params_c.items():
        torch.testing.assert_close(params_g[name].cpu(), p, rtol=TOL_MODEL,
                                   atol=TOL_MODEL, msg=name)
