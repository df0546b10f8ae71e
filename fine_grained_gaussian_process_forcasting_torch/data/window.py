"""Batched windows: the port's own copy of the JAX package's
``data/window.py`` ``BatchedSplit`` (numpy only)."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BatchedSplit:
    """A split regrouped into fixed-size batches (drop-last, like the
    reference's ``DataLoader(..., drop_last=True)``).

    Arrays are shaped ``(n_batches, batch_size, ...)`` so a training loop
    runs over the leading dim after a single copy to the device.
    """

    enc: np.ndarray  # (B, bs, enc_len, F)
    dec: np.ndarray  # (B, bs, dec_len, F)
    y: np.ndarray  # (B, bs, pred_len, 1)

    @property
    def n_batches(self) -> int:
        return self.enc.shape[0]

    def __iter__(self):
        for i in range(self.n_batches):
            yield self.enc[i], self.dec[i], self.y[i]
