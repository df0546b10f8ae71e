"""Training CLI: the ``python train.py`` of the port (counterpart of the JAX
package's ``train/cli.py``, with the same flags, names and defaults).

Three seeds are drawn from ``random.seed(1234)`` as the reference draws
them; each seed runs an HPO study (``train/harness.py``) and its evaluation
per ``--pred_len``, or with ``--multiseed True`` all the seeds train as one
group per ``--pred_len`` (``MultiSeedExperimentHarness``, one step per batch
for every seed) and are evaluated one by one.  ``--synthetic`` trains on generated data of the
experiment's schema; otherwise ``--data_csv`` (``{exp_name}.csv`` by
default) is read, its ``date`` column kept as text.

    python -m fine_grained_gaussian_process_forcasting_torch.train.cli \\
        --exp_name solar --attn_type ATA --model_name ATA \\
        --denoising True --gp True --synthetic

Runs on the card; ``main(argv, device="cpu")`` runs the plain versions on
the CPU.  Every ``--attn_type``, ``--backbone`` and ``--gp_kind`` of the
JAX CLI runs, alone or with ``--multiseed True``.  Not ported yet, and
refused rather than ignored: ``--dp``,
``--tp`` and ``--fsdp`` (ROADMAP.md item 13).  The
JAX CLI first enables JAX's persistent compilation cache; PyTorch runs
eagerly and the CUDA kernels are built once per source hash
(``ops/cuda/_build.py``), so there is nothing to enable here.
"""

from __future__ import annotations

import argparse
import random

from fine_grained_gaussian_process_forcasting_torch.data import table
from fine_grained_gaussian_process_forcasting_torch.data.synthetic import (
    make_synthetic_frame,
)
from fine_grained_gaussian_process_forcasting_torch.train.harness import (
    ExperimentHarness,
    HarnessArgs,
    MultiSeedExperimentHarness,
)
from fine_grained_gaussian_process_forcasting_torch.train.observability import (
    profile_trace,
)


def _str2bool(x: str) -> bool:
    return str(x).lower() == "true"


def _str2bool_or_auto(x: str):
    """'auto' -> None (the model's default route); else bool."""
    return None if str(x).lower() == "auto" else _str2bool(x)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="forecast-blur-denoise trainer")
    parser.add_argument("--attn_type", type=str, default="ATA")
    parser.add_argument("--model_name", type=str, default="ATA")
    parser.add_argument("--exp_name", type=str, default="exchange")
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--n_trials", type=int, default=5)
    parser.add_argument("--denoising", type=_str2bool, default="True")
    parser.add_argument("--gp", type=_str2bool, default="True")
    parser.add_argument("--residual", type=_str2bool, default="False")
    parser.add_argument("--no-noise", dest="no_noise", type=_str2bool,
                        default="False")
    parser.add_argument("--input_corrupt_training", type=_str2bool,
                        default="False")
    parser.add_argument("--iso", type=_str2bool, default="False")
    parser.add_argument("--num_epochs", type=int, default=50)
    parser.add_argument("--pred_len", type=int, nargs="+", default=[96])
    parser.add_argument("--n_seeds", type=int, default=3)
    parser.add_argument("--multiseed", type=_str2bool, default="False",
                        help="train all n_seeds as one group: one step per "
                             "batch for every seed")
    parser.add_argument("--backbone", type=str, default="transformer")
    parser.add_argument("--out_dir", type=str, default=".")
    parser.add_argument("--data_csv", type=str, default=None,
                        help="path to the dataset csv ({exp_name}.csv default)")
    parser.add_argument("--synthetic_noise", type=str, default="iid",
                        choices=["iid", "ar1", "gp"],
                        help="corruption structure of the synthetic target "
                             "(ar1/gp give the GP blur model correlated "
                             "noise to learn)")
    parser.add_argument("--synthetic", action="store_true",
                        help="train on generated schema-matching data")
    parser.add_argument("--synthetic_profile", type=str,
                        default="stationary",
                        choices=["stationary", "field"],
                        help="'field' adds amplitude drift, regime "
                             "shifts and heteroscedastic corruption "
                             "(data/synthetic.py)")
    parser.add_argument("--use_pallas_gp", type=_str2bool, default="False",
                        help="the hidden GP layers' K through the rbf kernel")
    parser.add_argument("--use_pallas_attention", type=_str2bool_or_auto,
                        default="auto",
                        help="attention kernel route: 'auto' (default) = "
                             "basic attention by head dim on the card, the "
                             "conv family's plain op; True/False force the "
                             "kernel or the plain op")
    parser.add_argument("--use_fused_gp", type=_str2bool, default="True",
                        help="fused whole-marginal GP kernel")
    parser.add_argument("--num_inducing", type=int, default=512,
                        help="inducing points; 256 restores the "
                             "reference's value")
    parser.add_argument("--gp_hidden_dims", type=int, nargs="*", default=[],
                        help="widths of extra deep-GP hidden layers, e.g. "
                             "--gp_hidden_dims 8 (1 hidden layer of width 8)")
    parser.add_argument("--gp_kind", type=str, default="variational",
                        choices=["variational", "exact"])
    parser.add_argument("--gp_ls_init", type=str, default="0",
                        help="GP lengthscale init: 0 = reference, 'auto' = "
                             "sqrt(2 d_model), or an explicit float")
    parser.add_argument("--exact_noise_init", type=float, default=0.0,
                        help="exact-blur (gp_kind=exact) likelihood-noise "
                             "init: 0 = reference (~0.693), >0 explicit")
    parser.add_argument("--lam_clip_max", type=float, default=0.005,
                        help="ELBO-weight clip ceiling (reference 0.005; "
                             "0 = blur-only ablation arm)")
    parser.add_argument("--gp_inject", type=str, default="joint",
                        choices=["joint", "enc", "dec", "none"],
                        help="GP-blur injection point (ELBO unchanged); "
                             "'joint' = reference semantics")
    parser.add_argument("--max_train_samples", type=int, default=None)
    parser.add_argument("--clip_grad_norm", type=float, default=0.0,
                        help="global-norm gradient clipping; 0 = off "
                             "(reference semantics)")
    parser.add_argument("--nonfinite_guard", type=str, default="off",
                        choices=["off", "raise", "skip"],
                        help="non-finite-loss handling: off = reference "
                             "semantics, raise = fail with the first bad "
                             "step's index, skip = drop bad updates")
    parser.add_argument("--max_valid_samples", type=int, default=None)
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of the study")
    parser.add_argument("--d_model_choices", type=int, nargs="+",
                        default=[32, 16],
                        help="HPO grid for d_model (reference {32,16})")
    parser.add_argument("--stack_choices", type=int, nargs="+",
                        default=[1, 3],
                        help="HPO grid for stack_size (reference {1,3})")
    parser.add_argument("--dp", type=int, default=0,
                        help="data-parallel device count (not ported yet: "
                             "a value above 0 raises)")
    parser.add_argument("--fsdp", type=_str2bool, default="False",
                        help="ZeRO/FSDP sharding (not ported yet: raises)")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel device count (not ported yet: "
                             "a value above 1 raises)")
    return parser


def main(argv=None, device="cuda"):
    """Parse ``argv``, train and evaluate; returns each study's evaluation.
    ``device`` is where the models run (a keyword for callers and tests,
    not a flag)."""
    args = build_parser().parse_args(argv)
    if args.dp > 0 or args.tp > 1 or args.fsdp:
        if args.multiseed:
            raise SystemExit(
                "--multiseed and --dp/--tp are mutually exclusive: the "
                "multiseed trainer fills the card with the seed axis")
        raise NotImplementedError(
            "--dp, --tp and --fsdp are not ported yet (ROADMAP.md modules to "
            "port, item 13: parallel/mesh.py and parallel/sharding.py)")

    if args.synthetic:
        raw_data = make_synthetic_frame(args.exp_name, num_entities=8,
                                        steps_per_entity=1600, seed=0,
                                        noise=args.synthetic_noise,
                                        profile=args.synthetic_profile)
    else:
        csv_path = args.data_csv or f"{args.exp_name}.csv"
        raw_data = table.read_csv(csv_path, str_columns=("date",))

    random.seed(1234)
    seeds = [random.randint(1000, 9999) for _ in range(args.n_seeds)]
    results = []
    seed_groups = [seeds] if args.multiseed else [[s] for s in seeds]
    for seed_group in seed_groups:
        for pred_len in args.pred_len:
            seed = seed_group[0]
            # iso == denoising without GP and without no_noise
            gp = args.gp and not args.iso
            hargs = HarnessArgs(
                exp_name=args.exp_name,
                model_name=args.model_name,
                attn_type=args.attn_type,
                pred_len=pred_len,
                seed=seed,
                n_trials=args.n_trials,
                num_epochs=args.num_epochs,
                denoising=args.denoising,
                gp=gp,
                residual=args.residual,
                no_noise=args.no_noise,
                iso=args.iso,
                input_corrupt_training=args.input_corrupt_training,
                backbone=args.backbone,
                out_dir=args.out_dir,
                use_pallas_gp=args.use_pallas_gp,
                use_pallas_attention=args.use_pallas_attention,
                use_fused_gp=args.use_fused_gp,
                num_inducing=args.num_inducing,
                gp_hidden_dims=tuple(args.gp_hidden_dims),
                gp_kind=args.gp_kind,
                gp_ls_init=(-1.0 if args.gp_ls_init == "auto"
                            else float(args.gp_ls_init)),
                exact_noise_init=args.exact_noise_init,
                lam_clip_max=args.lam_clip_max,
                gp_inject=args.gp_inject,
                max_train_samples=args.max_train_samples,
                max_valid_samples=args.max_valid_samples,
                d_model_choices=tuple(args.d_model_choices),
                stack_choices=tuple(args.stack_choices),
                clip_grad_norm=args.clip_grad_norm,
                nonfinite_guard=args.nonfinite_guard,
            )
            if args.multiseed:
                harness = MultiSeedExperimentHarness(
                    raw_data, hargs, seeds=seed_group, device=device)
            else:
                harness = ExperimentHarness(raw_data, hargs, device=device)
            with profile_trace(args.profile_dir):
                harness.run_study()
            res = harness.evaluate()
            results.extend(res if isinstance(res, list) else [res])
    return results


if __name__ == "__main__":
    main()
