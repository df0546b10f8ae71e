"""Univariate (target-only) data pipeline for the baseline models.

The port's own copy of the JAX package's ``data/univariate.py`` on column
tables (``data/table.py``): 0.8/0.1/0.1 row splits, 8*24-step target
history windows, random subsampling, fixed seed 1234.  Numpy only; the
arrays are bit-equal to the JAX loader's for the same frame:

- entities are visited in order of first appearance (``pandas.unique``),
  not in sorted-key order, because that order lays out the window starts
  that ``rng.choice`` picks from;
- one ``np.random.RandomState(seed)`` stream runs through the train, valid
  and test splits, in that order;
- windows are drawn with replacement only when there are fewer starts than
  samples.

Window layout: ``x_enc`` = first ``max_encoder_length - pred_len`` steps of
the history, ``x_dec`` = last ``pred_len`` steps of the history, ``y`` = the
next ``pred_len`` targets.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from fine_grained_gaussian_process_forcasting_torch.data import table


@dataclasses.dataclass
class UnivariateBatches:
    x_enc: np.ndarray  # (B, bs, enc_len - pred_len, 1)
    x_dec: np.ndarray  # (B, bs, pred_len, 1)
    y: np.ndarray  # (B, bs, pred_len, 1)

    @property
    def n_batches(self) -> int:
        return self.x_enc.shape[0]

    def __iter__(self):
        for i in range(self.n_batches):
            yield self.x_enc[i], self.x_dec[i], self.y[i]


def _first_appearance(groups: np.ndarray) -> np.ndarray:
    """The distinct values of ``groups`` in order of first appearance
    (``pandas.unique``)."""
    _, first = np.unique(groups, return_index=True)
    return groups[np.sort(first)]


def _windows_from_series(
    values: np.ndarray,
    groups: np.ndarray,
    total_len: int,
    n_samples: int,
    rng: np.random.RandomState,
) -> np.ndarray:
    """All (total_len)-step windows that stay within one entity, randomly
    subsampled to n_samples (with replacement when scarce)."""
    starts = []
    for g in _first_appearance(groups):
        idx = np.flatnonzero(groups == g)
        # contiguous runs assumed (frames sorted by id, time)
        lo, hi = idx[0], idx[-1] + 1
        if hi - lo >= total_len:
            starts.append(np.arange(lo, hi - total_len + 1))
    if not starts:
        raise ValueError("no entity long enough for the requested window")
    starts = np.concatenate(starts)
    sel = rng.choice(len(starts), size=n_samples,
                     replace=len(starts) < n_samples)
    chosen = starts[sel]
    gather = chosen[:, None] + np.arange(total_len)[None, :]
    return values[gather]  # (n_samples, total_len)


class UnivariateLoader:
    def __init__(
        self,
        data: table.Frame,
        target_col: str,
        pred_len: int,
        max_encoder_length: int = 8 * 24,
        max_train_sample: int = 32000,
        max_test_sample: int = 3840,
        batch_size: int = 256,
        id_col: str = "id",
        seed: int = 1234,
    ):
        self.pred_len = pred_len
        self.max_encoder_length = max_encoder_length
        rng = np.random.RandomState(seed)

        total_batches = int(table.n_rows(data) / batch_size)
        train_len = int(total_batches * batch_size * 0.8)
        valid_len = int(total_batches * batch_size * 0.1)

        splits = {
            "train": (slice(0, train_len), max_train_sample),
            "valid": (slice(train_len, train_len + valid_len),
                      max_test_sample),
            "test": (slice(train_len + valid_len, train_len + 2 * valid_len),
                     max_test_sample),
        }

        total_len = max_encoder_length + pred_len
        out = {}
        for name, (rows, n_samples) in splits.items():
            w = _windows_from_series(
                np.asarray(data[target_col][rows], dtype=np.float32),
                data[id_col][rows],
                total_len,
                n_samples,
                rng,
            )
            hist = w[:, :max_encoder_length, None]
            y = w[:, max_encoder_length:, None]
            nb = len(w) // batch_size
            cut = nb * batch_size

            def rg(a, nb=nb, bs=batch_size, cut=cut):
                return a[:cut].reshape(nb, bs, *a.shape[1:])

            out[name] = UnivariateBatches(
                x_enc=rg(hist[:, : max_encoder_length - pred_len]),
                x_dec=rg(hist[:, max_encoder_length - pred_len:]),
                y=rg(y),
            )
        self.train_loader = out["train"]
        self.valid_loader = out["valid"]
        self.test_loader = out["test"]


TARGET_COLUMNS = {
    "traffic": "values",
    "electricity": "power_usage",
    "exchange": "OT",
    "solar": "Power(MW)",
    "air_quality": "NO2",
    "watershed": "Conductivity",
    "covid": "PEOPLE_POSITIVE_NEW_CASES_COUNT",
}
