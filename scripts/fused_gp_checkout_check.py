"""The fused GP of one checkout against another's, bit for bit, on a card.

Runs both variants (fp32, bf16) of the fused-GP forward and backward
(``ops/cuda/fused_gp.py`` ``forward_kernel`` / ``backward_kernel``, no seed
axis) of the checkout at ``--root`` on fixed inputs from a seed, at the
flagship shape (73,728 rows, d 32, M 512) and the production width's
(40,960 rows, d 512, M 512), and saves the outputs to ``--out``.  With
``--against`` (another checkout's file) it compares them bit for bit,
prints which agree and exits non-zero if any does not: a change that must
leave the kernels' arithmetic as it was (the seed axis at S = 1) is held
to its parent commit this way.

    git archive <parent> fine_grained_gaussian_process_forcasting_torch | tar -x -C parent
    python3 scripts/fused_gp_checkout_check.py --root parent --out parent.pt
    python3 scripts/fused_gp_checkout_check.py --root . --out change.pt --against parent.pt

Each checkout builds its own kernels (into its ``build/``).  Imports
nothing of JAX.
"""

import argparse
import math
import sys

SHAPES = {"flagship": (256, 288, 32, 512), "production": (64, 640, 512, 512)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", required=True,
                        help="the checkout whose fused GP runs")
    parser.add_argument("--out", required=True,
                        help="where its outputs are saved (torch.save)")
    parser.add_argument("--against", default=None,
                        help="another checkout's saved outputs to compare")
    args = parser.parse_args()
    sys.path.insert(0, args.root)
    import torch

    from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (
        fused_gp,
    )

    if not torch.cuda.is_available():
        print("fused_gp_checkout_check: no CUDA device", file=sys.stderr)
        return 1
    g = torch.Generator("cuda").manual_seed(5)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=g)

    out = {}
    for name, (b, n, d, m) in SHAPES.items():
        a = randn(m, m) / m
        inputs = (randn(b, n, d), (randn(m, d) / math.sqrt(2 * d)).contiguous(),
                  randn(m), (a @ a.T).contiguous(),
                  torch.tensor(0.7, device="cuda"),
                  torch.full((d,), 1 / math.sqrt(2 * d), device="cuda"),
                  randn(d) / d, torch.tensor(0.1, device="cuda"))
        cot = (randn(b, n), randn(b, n))
        for bf16 in (False, True):
            key = f"{name}_{'bf16' if bf16 else 'fp32'}"
            out[key + "_fwd"] = [t.cpu() for t in fused_gp.forward_kernel(
                *inputs, bf16=bf16)]
            out[key + "_bwd"] = [t.cpu() for t in fused_gp.backward_kernel(
                *inputs, *cot, bf16=bf16)]
    torch.save(out, args.out)
    if args.against is None:
        return 0
    ref = torch.load(args.against)
    same = {k: all(torch.equal(x, y) for x, y in zip(v, ref[k]))
            for k, v in out.items()}
    print(f"fused GP of {args.root} against {args.against}, bit-equal: "
          f"{same}")
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
