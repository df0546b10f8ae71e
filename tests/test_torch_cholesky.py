"""PyTorch port vs the JAX package: the batched Cholesky against both
variants of the JAX package's Pallas kernel.

The port runs on the CPU, where ``batched_cholesky`` takes the kernel's
plain version (the library's factorization, NaN where it fails); the JAX
package runs ``_cholesky_impl`` in interpret mode, as its own tests do,
with the unblocked column recurrence (its default) and with the blocked
128-wide panels, at sizes on both sides of a panel boundary.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fine_grained_gaussian_process_forcasting_tpu.ops.pallas import (
    cholesky as jchol,
)
from fine_grained_gaussian_process_forcasting_torch.ops.cuda import (
    cholesky as tchol,
)

# the JAX package's Cholesky-kernel tolerance (tests/test_pallas_kernels.py)
TOL_CHOL = 2e-3


def _spd(b, n, seed):
    x = np.random.default_rng(seed).normal(size=(b, n, n)).astype(np.float32)
    return (x @ x.transpose(0, 2, 1) / n
            + np.eye(n, dtype=np.float32)).astype(np.float32)


@pytest.mark.parametrize("blocked", [False, True],
                         ids=["unblocked", "blocked"])
@pytest.mark.parametrize("n", [1, 127, 128, 129, 256])
def test_batched_cholesky_matches_each_pallas_variant(n, blocked):
    a = _spd(2, n, seed=n)
    want = np.asarray(jchol._cholesky_impl(jnp.asarray(a), blocked=blocked))
    got = tchol.batched_cholesky(torch.from_numpy(a))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL_CHOL,
                               atol=TOL_CHOL)
    assert torch.equal(torch.triu(got, 1), torch.zeros_like(got))
