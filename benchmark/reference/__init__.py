"""The plain reference of the benchmark's configurations.

Plain PyTorch, written from the model's published description (an
Autoformer forecaster, one whitened variational GP over its hidden states
that blurs them, the same forecaster run again as the denoiser, the joint
loss MSE + lambda * (-ELBO), Noam-Adam).  It imports nothing of the program
and nothing of JAX, and takes from the program only the outputs it judges.
"""
