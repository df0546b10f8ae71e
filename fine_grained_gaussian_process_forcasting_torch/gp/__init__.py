"""Gaussian-process layers (counterpart of the JAX package's ``gp/``)."""

from fine_grained_gaussian_process_forcasting_torch.gp.deep_gp import (
    DeepGP,
    GPPosterior,
    gaussian_expected_log_prob,
    variational_elbo,
)
from fine_grained_gaussian_process_forcasting_torch.gp.exact import (
    ExactGPParams,
    exact_gp_mll,
    exact_gp_posterior,
    init_exact_gp,
)
from fine_grained_gaussian_process_forcasting_torch.gp.kernels import (
    matern_ard,
    rbf_ard,
    sq_dist,
)

__all__ = [
    "DeepGP",
    "GPPosterior",
    "gaussian_expected_log_prob",
    "variational_elbo",
    "ExactGPParams",
    "exact_gp_mll",
    "exact_gp_posterior",
    "init_exact_gp",
    "matern_ard",
    "rbf_ard",
    "sq_dist",
]
