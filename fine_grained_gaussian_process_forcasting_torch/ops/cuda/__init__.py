"""Hand-written CUDA kernels for Hopper, each beside its plain-PyTorch version.

Counterpart of the JAX package's ``ops/pallas/``.
"""
