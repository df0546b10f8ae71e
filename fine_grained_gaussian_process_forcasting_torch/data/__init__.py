"""The data layer (the port's own copy of the JAX package's ``data/``, on
column tables instead of pandas frames): formatters, experiments, synthetic
frames, windowing and batching."""
