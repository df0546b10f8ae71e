"""Models (counterpart of the JAX package's ``models/``)."""
