"""Data containers (counterpart of the JAX package's ``data/``)."""
