"""The reference forward, loss and Noam-Adam step, in plain PyTorch.

The configuration (``benchmark/configs/<name>.json``, its ``model`` group)
gives the shapes and the precision.  Weights are a dict of tensors keyed as
``leaf_specs`` names them; the reference holds no state of its own.

Precisions (``mode``):

- ``fp32``: every product in float32, TF32 off;
- ``tf32``: the same with TF32 on (the control of a float32 configuration);
- ``bf16``: the configuration's 16-bit model: every dense layer's input,
  weight and bias rounded to bfloat16 and the product rounded once to it,
  the streams and the positional table in bfloat16, LayerNorm's statistics
  in float32 and its output in bfloat16; the embeddings, the output
  projection, AutoCorrelation's correlation and aggregation (operands
  widened), the GP, the ELBO and the loss in float32; the GP's K W and
  K^T (dvar o K) products on bfloat16-rounded operands summed in float32;
- ``fp8``: ``bf16`` with each of those products' operands rounded to
  float8 e4m3 (one scale a tensor, its largest magnitude to 448): the
  control of a bfloat16 configuration.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from benchmark.reference.selection import Choices

JITTER = 1e-4  # the inducing points' Gram matrix's jitter (gpytorch fp32)
NOISE_FLOOR = 1e-4  # the Gaussian likelihood's noise floor
BETAS, EPS = (0.9, 0.98), 1e-9  # the reference's Adam
_FP8_MAX = 448.0  # float8 e4m3's largest finite value


class Output(NamedTuple):
    predictions: torch.Tensor  # (b, pred_len, 1)
    loss: torch.Tensor
    mse: torch.Tensor


def leaf_specs(model: dict) -> Dict[str, tuple]:
    """{leaf name: shape} of the configuration's weights, named as the
    model's published (Flax) tree flattens."""
    d, h, dk = model["d_model"], model["n_heads"], model["d_k"]
    dff, m = model["d_ff"], model["num_inducing"]
    specs = {"lam": (1,)}
    for side in ("encoder", "decoder"):
        for i in range(model["stack_size"]):
            p = f"forecasting_model.{side}.layer{i}."
            specs[p + "self_attn.wqkv.weight"] = (3 * h * dk, d)
            specs[p + "self_attn.fc.weight"] = (d, h * dk)
            if side == "decoder":
                for w in ("wq", "wk", "wv"):
                    specs[p + f"cross_attn.{w}.weight"] = (h * dk, d)
                specs[p + "cross_attn.fc.weight"] = (d, h * dk)
            specs[p + "ffn.w1.weight"] = (dff, d)
            specs[p + "ffn.w1.bias"] = (dff,)
            specs[p + "ffn.w2.weight"] = (d, dff)
            specs[p + "ffn.w2.bias"] = (d,)
    for name, fan_in in (("enc_embedding", model["src_input_size"]),
                         ("dec_embedding", model["tgt_input_size"])):
        specs[name + ".weight"] = (d, fan_in)
        specs[name + ".bias"] = (d,)
    specs["final_projection.weight"] = (1, d)
    specs["final_projection.bias"] = (1,)
    g = "deep_gp.output_layer."
    specs.update({"deep_gp.raw_noise": (), g + "inducing_points": (m, d),
                  g + "variational_mean": (m,),
                  g + "variational_log_stddev": (m,),
                  g + "raw_lengthscale": (d,), g + "raw_outputscale": (),
                  g + "mean_weight": (d,), g + "mean_bias": (),
                  "proj_up.weight": (d, 1), "proj_up.bias": (d,)})
    return specs


@contextlib.contextmanager
def precision(mode: str):
    """TF32 on for ``tf32``, off for every other mode, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    on = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _fp8(t: torch.Tensor):
    """t at one scale (its largest magnitude to 448), rounded to float8
    e4m3, as float32; the rounding passes the gradient straight through,
    as float8 training differentiates.  Returns (the rounded, the scale)."""
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    scale = _FP8_MAX / amax
    s = t.float() * scale
    return s + (s.to(torch.float8_e4m3fn).float() - s).detach(), scale


def _product16(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a @ b of bfloat16 operands, exact products summed in float32 and
    rounded once to bfloat16; ``fp8`` rounds the operands to float8 first."""
    if mode == "fp8":
        (qa, sa), (qb, sb) = _fp8(a), _fp8(b)
        return (torch.matmul(qa, qb) / (sa * sb)).to(torch.bfloat16)
    if a.device.type == "cpu":  # the CPU's bf16 GEMM sums in another order
        return torch.matmul(a.float(), b.float()).to(torch.bfloat16)
    return torch.matmul(a, b)


def _round(t: torch.Tensor, mode: str) -> torch.Tensor:
    """The GP products' operand rounding: bfloat16 or float8 e4m3 (kept as
    float32), none in float32."""
    if mode == "fp8":
        q, s = _fp8(t)
        return q / s
    if mode == "bf16":
        return t.bfloat16().float()
    return t


class Reference:
    """The forward of one configuration in one precision."""

    def __init__(self, model: dict, mode: str):
        if model["attn_type"] != "autoformer":
            raise ValueError("the reference has the autoformer forecaster "
                             f"only, not {model['attn_type']!r}")
        if model["d_ff"] != 4 * model["d_model"]:
            raise ValueError("d_ff is 4 d_model in the published model")
        self.m = model
        self.mode = mode
        self.cd = None if mode in ("fp32", "tf32") else torch.bfloat16

    # -- layers ------------------------------------------------------- #
    def dense(self, x, w, b=None):
        if self.cd is None:
            return F.linear(x, w, b)
        out = _product16(x.to(self.cd), w.to(self.cd).T, self.mode)
        return out if b is None else out + b.to(self.cd)

    def layer_norm(self, x):
        return F.layer_norm(x.float(), x.shape[-1:], eps=1e-5).to(
            self.cd or x.dtype)

    @staticmethod
    def positional(length, d, device, dtype):
        pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
        div = torch.pow(10000.0, torch.arange(0, d, 2, dtype=torch.float32,
                                              device=device) / d)
        x = pos / div
        pe = torch.zeros((length, d), dtype=torch.float32, device=device)
        pe[:, 0::2] = torch.sin(x)
        pe[:, 1::2] = torch.cos(x[:, : d // 2])
        return pe[None].to(dtype)

    def auto_correlation(self, q, k, v, training, choose):
        """Autoformer's AutoCorrelation over (b, h, L, d): the period-based
        dependencies (the correlation's mean over heads and channels, by
        FFT), the top int(log L) lags (shared by the batch in training,
        each sample's own in evaluation, chosen by ``choose``), softmax over
        their correlations and the weighted sum of the values rolled by
        each lag."""
        dtype = v.dtype
        q, k, v = q.float(), k.float(), v.float()
        b, h, L, d = q.shape
        S = k.shape[2]
        if L > S:
            pad = torch.zeros((b, h, L - S, d), dtype=q.dtype,
                              device=q.device)
            k, v = torch.cat([k, pad], 2), torch.cat([v, pad], 2)
        else:
            k, v = k[:, :, :L], v[:, :, :L]
        qf = torch.fft.rfft(q.transpose(2, 3), dim=-1)
        kf = torch.fft.rfft(k.transpose(2, 3), dim=-1)
        corr = torch.fft.irfft((qf * torch.conj(kf)).mean(dim=(1, 2)), n=L,
                               dim=-1)  # (b, L)
        top_k = int(math.log(L))
        if training:
            lags = choose(corr.mean(0, keepdim=True), top_k)  # (1, k)
            lags = lags.expand(b, -1)
        else:
            lags = choose(corr, top_k)  # (b, k)
        weights = torch.softmax(torch.gather(corr, -1, lags), dim=-1)
        vt = v.transpose(2, 3)  # (b, h, d, L)
        t = torch.arange(L, device=v.device)
        index = (t[None, None, :] + lags[:, :, None]) % L  # (b, k, L)
        out = torch.zeros_like(vt)
        for i in range(top_k):
            idx = index[:, i][:, None, None, :].expand(b, h, d, L)
            out = out + weights[:, i, None, None, None] * torch.gather(
                vt, -1, idx)
        return out.transpose(2, 3).to(dtype)

    def attention(self, w, prefix, q_in, kv_in, training, choose):
        m = self.m
        h, dk = m["n_heads"], m["d_k"]
        b = q_in.shape[0]
        if kv_in is None:  # self-attention: one fused projection
            qkv = self.dense(q_in, w[prefix + "wqkv.weight"])
            q, k, v = (qkv[..., :dk * h], qkv[..., dk * h:2 * dk * h],
                       qkv[..., 2 * dk * h:])
        else:
            q = self.dense(q_in, w[prefix + "wq.weight"])
            k = self.dense(kv_in, w[prefix + "wk.weight"])
            v = self.dense(kv_in, w[prefix + "wv.weight"])
        q, k, v = (t.reshape(b, -1, h, dk).transpose(1, 2) for t in (q, k, v))
        ctx = self.auto_correlation(q, k, v, training, choose)
        ctx = ctx.transpose(1, 2).reshape(b, -1, h * dk)
        return self.dense(ctx, w[prefix + "fc.weight"])

    def ffn(self, w, p, x):
        hid = F.relu(self.dense(x, w[p + "w1.weight"], w[p + "w1.bias"]))
        return self.dense(hid, w[p + "w2.weight"], w[p + "w2.bias"])

    def transformer(self, w, enc, dec, training, choose):
        """Post-LN encoder-decoder over embedded streams; fp32 out."""
        m = self.m
        d, in_dtype = m["d_model"], enc.dtype
        x = enc.to(self.cd) if self.cd else enc
        x = x + self.positional(x.shape[1], d, x.device, x.dtype)
        for i in range(m["stack_size"]):
            p = f"forecasting_model.encoder.layer{i}."
            x = self.layer_norm(self.attention(w, p + "self_attn.", x, None,
                                               training, choose) + x)
            x = self.layer_norm(self.ffn(w, p + "ffn.", x) + x)
        enc_out = x
        x = dec.to(self.cd) if self.cd else dec
        x = x + self.positional(x.shape[1], d, x.device, x.dtype)
        for i in range(m["stack_size"]):
            p = f"forecasting_model.decoder.layer{i}."
            x = self.layer_norm(x + self.attention(w, p + "self_attn.", x,
                                                   None, training, choose))
            x = self.layer_norm(x + self.attention(w, p + "cross_attn.", x,
                                                   enc_out, training, choose))
            x = self.layer_norm(x + self.ffn(w, p + "ffn.", x))
        return enc_out.to(in_dtype), x.to(in_dtype)

    # -- the GP ------------------------------------------------------- #
    def gp(self, w, x):
        """The whitened variational GP's marginals at the (b, s, d) points:
        (mean, var, kl, noise)."""
        g = "deep_gp.output_layer."
        ls = F.softplus(w[g + "raw_lengthscale"])
        os_ = F.softplus(w[g + "raw_outputscale"])
        z = w[g + "inducing_points"]
        zs = z / ls
        z2 = (zs * zs).sum(-1)
        kzz = os_ * torch.exp(-0.5 * torch.clamp(
            z2[:, None] + z2[None, :] - 2.0 * zs @ zs.T, min=0.0))
        eye = torch.eye(kzz.shape[0], dtype=kzz.dtype, device=kzz.device)
        chol = torch.linalg.cholesky(kzz + JITTER * eye)
        linv = torch.linalg.solve_triangular(chol, eye, upper=False)
        mu, log_std = w[g + "variational_mean"], w[g + "variational_log_stddev"]
        s2 = torch.exp(2.0 * log_std)
        kl = 0.5 * torch.sum(s2 + mu * mu - 1.0 - 2.0 * log_std)
        u = linv.T @ mu
        wm = linv.T @ (linv * (1.0 - s2)[:, None])
        args = (x, zs, u, wm, os_, 1.0 / ls, w[g + "mean_weight"],
                w[g + "mean_bias"])
        if self.mode in ("fp32", "tf32"):
            mean, var = marginals(*args)
        else:
            mean, var = _Marginals16.apply(self.mode, *args)
        noise = F.softplus(w["deep_gp.raw_noise"]) + NOISE_FLOOR
        return mean, torch.clamp(var, min=1e-8), kl, noise

    # -- the model ---------------------------------------------------- #
    def forward(self, w, enc_in, dec_in, y=None, training=False,
                choose=None) -> Output:
        m = self.m
        if choose is None:
            choose = Choices()
        enc = F.linear(enc_in, w["enc_embedding.weight"],
                       w["enc_embedding.bias"])
        dec = F.linear(dec_in, w["dec_embedding.weight"],
                       w["dec_embedding.bias"])
        enc_out, dec_out = self.transformer(w, enc, dec, training, choose)
        s_enc, pred = enc_out.shape[1], m["pred_len"]
        mean, var, kl, noise = self.gp(
            w, torch.cat([enc_out, dec_out], dim=1))
        eps = F.linear(mean[..., None], w["proj_up.weight"], w["proj_up.bias"])
        _, dec_rec = self.transformer(w, enc_out + eps[:, :s_enc],
                                      dec_out + eps[:, s_enc:], training,
                                      choose)
        final = F.linear((dec_out + dec_rec)[:, -pred:],
                         w["final_projection.weight"],
                         w["final_projection.bias"])
        zero = torch.zeros((), device=enc_in.device)
        if y is None:
            return Output(final, zero, zero)
        mll_error = zero
        if training:
            target = y[..., 0]
            mu = mean[..., s_enc:][..., -pred:]
            vr = var[..., s_enc:][..., -pred:]
            ell = -0.5 * (((target - mu) ** 2 + vr) / noise
                          + torch.log(2.0 * math.pi * noise))
            elbo = (ell.mean(-1) - kl / m["d_model"]).mean()
            mll_error = -elbo
        mse = torch.mean((y - final) ** 2)
        lam = torch.clamp(w["lam"][0], 0.0, m["lam_clip_max"])
        return Output(final, mse + lam * mll_error, mse)


def marginals(x, zs, u, wm, os_, inv_ls, mean_w, mean_b):
    """mean = x . mean_w + mean_b + K u, var = os - sum((K W) o K), with
    K = os exp(-|x inv_ls - zs|^2 / 2) as |xs|^2 + |zs|^2 - 2 xs . zs."""
    xs = x * inv_ls
    d2 = ((xs * xs).sum(-1, keepdim=True) + (zs * zs).sum(-1)
          - 2.0 * torch.matmul(xs, zs.T))
    k = os_ * torch.exp(-0.5 * d2)
    mean = torch.matmul(x, mean_w) + mean_b + torch.matmul(k, u)
    var = os_ - (torch.matmul(k, wm) * k).sum(-1)
    return mean, var


class _Marginals16(torch.autograd.Function):
    """The 16-bit GP's marginals: K W from rounded K and W, and the
    published VJP of that function (E from the rounded K W, dW from the
    rounded K and dvar o K), W taken as symmetric."""

    @staticmethod
    def forward(ctx, mode, x, zs, u, wm, os_, inv_ls, mean_w, mean_b):
        ctx.mode = mode
        ctx.save_for_backward(x, zs, u, wm, os_, inv_ls, mean_w, mean_b)
        xs = x * inv_ls
        d2 = ((xs * xs).sum(-1, keepdim=True) + (zs * zs).sum(-1)
              - 2.0 * torch.matmul(xs, zs.T))
        k = os_ * torch.exp(-0.5 * d2)
        mean = torch.matmul(x, mean_w) + mean_b + torch.matmul(k, u)
        kw = torch.matmul(_round(k, mode), _round(wm, mode))
        return mean, os_ - (kw * k).sum(-1)

    @staticmethod
    def backward(ctx, dmean, dvar):
        x, zs, u, wm, os_, inv_ls, mean_w, mean_b = ctx.saved_tensors
        mode = ctx.mode
        b, n, d = x.shape
        xr = x.reshape(b * n, d)
        xs = xr * inv_ls
        d2 = ((xs * xs).sum(-1, keepdim=True) + (zs * zs).sum(-1)
              - 2.0 * torch.matmul(xs, zs.T))
        k = os_ * torch.exp(-0.5 * d2)
        g = torch.matmul(_round(k, mode), _round(wm, mode))
        dm, dv = dmean.reshape(-1, 1), dvar.reshape(-1, 1)
        e = (dm * u - 2.0 * dv * g) * k
        dxsc = torch.matmul(e, zs) - e.sum(-1, keepdim=True) * xs
        dx = dxsc * inv_ls + dm * mean_w
        dzs = torch.matmul(e.T, xs) - e.sum(0)[:, None] * zs
        du = (k * dm).sum(0)
        dw = -torch.matmul(_round(k.T, mode), _round(dv * k, mode))
        dos = e.sum() / os_ + dv.sum()
        return (None, dx.reshape(b, n, d), dzs, du, dw, dos,
                (dxsc * xr).sum(0), (dm * xr).sum(0), dm.sum())


def noam_lr(count: int, d_model: int, warmup: int, lr_mul: float) -> float:
    """The Noam rate of the update after ``count`` applied ones."""
    n = count + 1.0
    return lr_mul * d_model ** -0.5 * min(n ** -0.5, n * warmup ** -1.5)


@torch.no_grad()
def adam_step(params: dict, grads: dict, state: dict, lr: float) -> None:
    """One Adam update (betas 0.9, 0.98; eps 1e-9; bias-corrected) in
    place; ``state`` holds the moments and the step count."""
    t = state["t"] = state.get("t", 0) + 1
    b1, b2 = BETAS
    for name, p in params.items():
        g = grads[name]
        m = state.setdefault(("m", name), torch.zeros_like(p))
        v = state.setdefault(("v", name), torch.zeros_like(p))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        denom = (v.sqrt() / math.sqrt(1 - b2 ** t)).add_(EPS)
        p.addcdiv_(m, denom, value=-lr / (1 - b1 ** t))


def dtype_mode(model: dict) -> str:
    """The precision the configuration states: ``bf16`` or ``fp32``."""
    return "bf16" if model["compute_dtype"] == "bfloat16" else "fp32"


def control_mode(model: dict) -> str:
    """The precision just below the configuration's: float32 with TF32 off
    -> TF32; bfloat16 -> float8 e4m3."""
    return "fp8" if dtype_mode(model) == "bf16" else "tf32"
