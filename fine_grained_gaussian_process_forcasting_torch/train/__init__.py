"""Serving (counterpart of the JAX package's ``train/``)."""
