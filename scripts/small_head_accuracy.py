"""Small-head attention's accuracy at the card tests' score cases.

On a card (the default): the forward and backward kernels
(``csrc/small_head_attention.cu``) against the plain fp32 version and
float64 at every case of ``tests/_torch_small_head_cases.SCORE_CASES`` --
the output and log-sum-exp as distances, each gradient in units of its
tolerance (2e-3 relative, 1e-4 absolute) -- and the kernels one call of
each C entry launches, as the library counts them.

With ``--replay CASE`` (the CPU, numpy): the forward's arithmetic replayed
in fp32 in the kernel's order (groups of 4 keys against a lazy offset, the
rescale past 2^8), then dQ as the backward takes it, from D = rowsum(dO o
O); once with each group's sum entering the row sum as it comes, once with
the sums of 16 groups gathered first (``FWD_FOLD``, the kernel's order).

    python3 scripts/small_head_accuracy.py
    python3 scripts/small_head_accuracy.py --replay jump_keep_192
"""

import argparse
import math
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import _torch_small_head_cases as cases  # noqa: E402

F32 = np.float32
G, LIMIT, KEEP, FOLD = 4, 256.0, 2.0 ** -26, 16


def _fma(a, b, x):
    """fp32 a * b + x, rounded once."""
    wide = [np.asarray(t, np.float64) for t in (a, b, x)]
    return (wide[0] * wide[1] + wide[2]).astype(F32)


def _dot(x, qs, kv):
    """x + qs . kv over the head dim, one fp32 FMA a term."""
    for c in range(qs.shape[1]):
        x = _fma(qs[:, c], kv[c], x)
    return x


def replay_forward(q, k, v, fold):
    """(o, lse) of one head in the kernel's fp32 order: rows vectorised."""
    rows, d = q.shape
    qs = (q * F32(math.log2(math.e) / math.sqrt(d))).astype(F32)
    m = _dot(np.zeros(rows, F32), qs, k[0])  # the offset: key 0's score
    acc = np.zeros((rows, d), F32)
    l, lb = np.zeros(rows, F32), np.zeros(rows, F32)
    for n, t0 in enumerate(range(0, len(k), G)):
        keys = range(t0, min(t0 + G, len(k)))
        ps = [np.exp2(_dot(-m, qs, k[j])).astype(F32) for j in keys]
        for p, j in zip(ps, keys):
            for c in range(d):
                acc[:, c] = _fma(p, v[j, c], acc[:, c])
        g = ps[0]
        for p in ps[1:]:
            g = (g + p).astype(F32)
        if fold:
            lb = (lb + g).astype(F32)
        else:
            l = (l + g).astype(F32)
        for r in np.nonzero(~(g <= LIMIT))[0]:
            l[r], lb[r] = F32(l[r] + lb[r]), 0
            gm = max(_dot(F32(0), qs[r:r + 1], k[j])[0] for j in keys)
            mn = max(m[r], gm)
            sc = F32(np.exp2(F32(m[r] - mn)))
            if F32((l[r] - g[r]) * sc) >= KEEP:
                l[r], acc[r] = F32(l[r] * sc), (acc[r] * sc).astype(F32)
            else:
                l[r], acc[r] = 0, 0
                for j in keys:
                    p = F32(np.exp2(_dot(-mn, qs[r:r + 1], k[j])[0]))
                    l[r] = F32(l[r] + p)
                    acc[r] = _fma(p, v[j], acc[r])
            m[r] = mn
        if fold and (n + 1) % FOLD == 0:
            l, lb = (l + lb).astype(F32), np.zeros(rows, F32)
    l = (l + lb).astype(F32)
    o = (acc * (F32(1) / l)[:, None]).astype(F32)
    lse = ((m + np.log2(l)) * F32(math.log(2))).astype(F32)
    return o, lse


def replay_dq(q, k, v, o, lse, do):
    """dQ of one head as the backward takes it: D = rowsum(dO o O), each
    probability from lse, the keys summed in order."""
    d = q.shape[1]
    qs = (q * F32(math.log2(math.e) / math.sqrt(d))).astype(F32)
    dd = np.zeros(len(q), F32)
    for c in range(d):
        dd = _fma(do[:, c], o[:, c], dd)
    l2 = (lse * F32(math.log2(math.e))).astype(F32)
    dq = np.zeros_like(q)
    for j in range(len(k)):
        p = np.exp2(_dot(-l2, qs, k[j])).astype(F32)
        ds = (p * _dot(-dd, do, v[j])).astype(F32)
        for c in range(d):
            dq[:, c] = _fma(ds, k[j, c], dq[:, c])
    return (dq * F32(1 / math.sqrt(d))).astype(F32)


def _exact(q, k, v, do):
    q, k, v, do = (a.astype(np.float64) for a in (q, k, v, do))
    s = q @ k.T / math.sqrt(q.shape[1])
    p = np.exp(s - s.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    dp = do @ v.T
    ds = p * (dp - (dp * p).sum(1, keepdims=True))
    return p @ v, ds @ k / math.sqrt(q.shape[1])


def _in_tol(got, want):
    """max |got - want| in units of the gradients' tolerance."""
    got, want = (np.asarray(t, np.float64) for t in (got, want))
    return float((np.abs(got - want) / (1e-4 + 2e-3 * np.abs(want))).max())


def replay(name):
    q, k, v, do = cases.score_case(name)
    for fold in (False, True):
        o_err = dq_err = 0.0
        for b in range(q.shape[0]):
            for h in range(q.shape[1]):
                args = q[b, h], k[b, h], v[b, h]
                o, lse = replay_forward(*args, fold)
                dq = replay_dq(*args, o, lse, do[b, h])
                o64, dq64 = _exact(*args, do[b, h])
                o_err = max(o_err, float(np.abs(o - o64).max()))
                dq_err = max(dq_err, _in_tol(dq, dq64))
        print(f"{name}, row sums {'gathered 16 groups' if fold else 'a group'}"
              f" at a time: output {o_err:.3e} from float64, dQ "
              f"{dq_err:.3f} of the tolerance from float64", flush=True)


def on_card():
    import subprocess

    import torch

    from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (
        small_head_attention as sha,
    )

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    q, k, v, do = (torch.randn(256, 8, 192, 4, device="cuda")
                   for _ in range(4))
    before = sha.kernels_launched()
    out, lse = sha.forward_kernel(q, k, v)
    middle = sha.kernels_launched()
    sha.backward_kernel(q, k, v, out, lse, do)
    print("kernels launched a call: forward", middle - before, "backward",
          sha.kernels_launched() - middle, flush=True)
    for name in cases.SCORE_CASES:
        q, k, v, do = (torch.from_numpy(a).cuda()
                       for a in cases.score_case(name))
        out, lse = sha.forward_kernel(q, k, v)
        grads = sha.backward_kernel(q, k, v, out, lse, do)
        plain = sha.small_head_attention_bwd_plain(q, k, v, do)
        wide = [t.double() for t in (q, k, v, do)]
        exact = sha.small_head_attention_bwd_plain(*wide)
        o64 = sha.small_head_attention_plain(*wide[:3])
        lse64 = torch.logsumexp(wide[0] @ wide[1].transpose(-1, -2)
                                / math.sqrt(q.shape[-1]), -1)
        o32 = sha.small_head_attention_plain(q, k, v)
        lse32 = torch.logsumexp(q @ k.transpose(-1, -2)
                                / math.sqrt(q.shape[-1]), -1)
        line = [f"{name}: output from float64 kernel "
                f"{(out.double() - o64).abs().max():.2e} plain "
                f"{(o32.double() - o64).abs().max():.2e}, lse kernel "
                f"{(lse.double() - lse64).abs().max():.2e} plain "
                f"{(lse32.double() - lse64).abs().max():.2e}"]
        for n, g, p, w in zip(("dq", "dk", "dv"), grads, plain, exact):
            g, p, w = (t.cpu().numpy() for t in (g, p, w))
            line.append(f"{n} in units of the tolerance: kernel - plain "
                        f"{_in_tol(g, p):.3f}, kernel - float64 "
                        f"{_in_tol(g, w):.3f}, plain - float64 "
                        f"{_in_tol(p, w):.3f}")
        print("; ".join(line), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--replay", metavar="CASE", choices=cases.SCORE_CASES,
                    help="replay the kernel's fp32 order on the CPU")
    args = ap.parse_args()
    if args.replay:
        replay(args.replay)
    else:
        on_card()


if __name__ == "__main__":
    main()
