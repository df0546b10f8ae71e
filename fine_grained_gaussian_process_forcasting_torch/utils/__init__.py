"""Configuration and normalizer utilities (counterpart of the JAX package's
``utils/``)."""
