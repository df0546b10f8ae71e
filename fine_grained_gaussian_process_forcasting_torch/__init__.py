"""PyTorch / CUDA port of the forecast -> GP-blur -> denoise framework.

The JAX package ``fine_grained_gaussian_process_forcasting_tpu`` is the
reference; this package mirrors its layout (``gp/``, ``ops/``, ``models/``,
``train/``) and imports nothing from it.  Plain tensor code is PyTorch; the
TPU's Pallas kernels become hand-written CUDA kernels for Hopper under
``csrc/``, each with a plain-PyTorch version beside it that CPU tensors use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

import torch

# No TF32 anywhere: an fp32 product stays fp32 (a 16-bit ``compute_dtype`` is
# asked for explicitly and casts by hand).  The inducing-point Gram matrix
# feeds a Cholesky, and a TF32 product (about three decimal digits) makes it
# indefinite once the lengthscales shrink.  PyTorch's matmul default is already fp32, cuDNN's is
# TF32; pin both so the port never depends on the defaults.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
