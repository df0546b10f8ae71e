"""Attention ops and their kernels (counterpart of the JAX package's ``ops/``)."""
