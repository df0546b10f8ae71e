"""Gaussian-process layers (counterpart of the JAX package's ``gp/``)."""
