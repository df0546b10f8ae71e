"""Sliding-window sampling and batching: the port's own copy of the JAX
package's ``data/window.py``, on column tables (numpy only).

Semantics are the reference's, as the JAX package keeps them:

- a window of ``time_steps`` rows per (entity, end position); entities
  shorter than ``time_steps`` are skipped;
- a random subsample of ``max_samples`` windows without replacement under
  numpy's global generator, seeded 2436 and restored afterwards; when fewer
  windows exist, all of them, shuffled;
- the arrays keep ``max_samples`` rows and the tail stays zero, like the
  reference's pre-allocated buffers;
- splits: train = the first ``train_percent`` of the rows sorted by (id,
  time), valid = the next half of the rest, test = the *whole* frame;
- encoder block = the first ``num_encoder_steps`` rows, decoder block = the
  rows up to ``-pred_len``, target = the last ``pred_len`` rows;
- batches drop the last incomplete one.

The JAX package gathers the windows through its C++ helper with a numpy
fallback; here one numpy fancy-index gather per matrix does it (host code,
no kernel).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from fine_grained_gaussian_process_forcasting_torch.data import table
from fine_grained_gaussian_process_forcasting_torch.data.base import (
    InputTypes,
    get_single_col_by_input_type,
)

# numpy's global generator is seeded with this for the draws of a split
SAMPLING_SEED = 2436


@dataclasses.dataclass
class WindowedSplit:
    """All windows of one split, as dense float32 arrays."""

    enc_inputs: np.ndarray  # (N, num_encoder_steps, F)
    dec_inputs: np.ndarray  # (N, time_steps - num_encoder_steps - pred_len, F)
    outputs: np.ndarray  # (N, pred_len, 1)

    def __len__(self) -> int:
        return self.enc_inputs.shape[0]


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


def _entity_windows(df: table.Frame, id_col: str, time_steps: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(starts, entity codes, codes): the first row of every valid window
    and its entity, entities in order of their codes (first appearance, as
    ``pandas.factorize`` numbers them; sorted-key order for a frame sorted
    by id), each entity's run of rows taken as contiguous."""
    codes = table.factorize(df[id_col])
    n = len(codes)
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), codes
    boundaries = np.flatnonzero(np.diff(codes)) + 1
    run_starts = np.concatenate([[0], boundaries])
    run_ends = np.concatenate([boundaries, [n]])
    run_keys = codes[run_starts]
    starts, entity_of_window = [], []
    for r in np.argsort(run_keys, kind="stable"):
        s, e = run_starts[r], run_ends[r]
        if e - s >= time_steps:
            w = np.arange(s, e - time_steps + 1, dtype=np.int64)
            starts.append(w)
            entity_of_window.append(np.full(len(w), run_keys[r], np.int64))
    if not starts:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), codes
    return np.concatenate(starts), np.concatenate(entity_of_window), codes


def sample_windows(df: table.Frame, max_samples: int, time_steps: int,
                   num_encoder_steps: int, pred_len: int,
                   column_definition: Sequence) -> WindowedSplit:
    """Extract (enc, dec, y) windows, drawing from numpy's global
    generator; zero-padded to ``max_samples`` rows when fewer exist."""
    id_col = get_single_col_by_input_type(InputTypes.ID, column_definition)
    target_col = get_single_col_by_input_type(InputTypes.TARGET,
                                              column_definition)
    input_cols = [tup[0] for tup in column_definition
                  if tup[2] not in {InputTypes.ID, InputTypes.TIME}]

    starts, _, _ = _entity_windows(df, id_col, time_steps)
    num_valid = len(starts)
    if 0 < max_samples < num_valid:
        starts = starts[np.random.choice(num_valid, max_samples,
                                         replace=False)]
    else:  # all windows, shuffled, as the reference resamples them
        starts = starts[np.random.choice(num_valid, num_valid,
                                         replace=False)]

    n_real = len(starts)
    n_out = max_samples if max_samples > 0 else n_real
    inputs = np.zeros((n_out, time_steps, len(input_cols)), np.float32)
    outputs = np.zeros((n_out, pred_len, 1), np.float32)
    if n_real:
        rows = starts[:, None] + np.arange(time_steps)
        inputs[:n_real] = table.matrix(df, input_cols, np.float32)[rows]
        outputs[:n_real] = table.matrix(df, [target_col],
                                        np.float32)[rows[:, -pred_len:]]

    dec_len = time_steps - num_encoder_steps - pred_len
    return WindowedSplit(
        enc_inputs=inputs[:, :num_encoder_steps, :],
        dec_inputs=inputs[:, num_encoder_steps: num_encoder_steps + dec_len,
                          :],
        outputs=outputs,
    )


def _to_batches(split: WindowedSplit, batch_size: int) -> BatchedSplit:
    n = (len(split) // batch_size) * batch_size
    nb = n // batch_size

    def regroup(a: np.ndarray) -> np.ndarray:
        return a[:n].reshape(nb, batch_size, *a.shape[1:])

    return BatchedSplit(enc=regroup(split.enc_inputs),
                        dec=regroup(split.dec_inputs),
                        y=regroup(split.outputs))


def batch_sampled_data(data: table.Frame, train_percent: float,
                       max_samples: Tuple[int, int], time_steps: int,
                       num_encoder_steps: int, pred_len: int,
                       column_definition: Sequence, batch_size: int
                       ) -> Tuple[BatchedSplit, BatchedSplit, BatchedSplit]:
    """Sort -> split -> window-sample -> batch, under numpy's global
    generator seeded with ``SAMPLING_SEED`` (its state is restored
    afterwards)."""
    rng_state = np.random.get_state()
    np.random.seed(SAMPLING_SEED)
    try:
        time_col = get_single_col_by_input_type(InputTypes.TIME,
                                                column_definition)
        id_col = get_single_col_by_input_type(InputTypes.ID,
                                              column_definition)
        data = table.sort_by(data, [id_col, time_col])
        n = table.n_rows(data)
        train_len = int(n * train_percent)
        valid_len = int((n - train_len) / 2)
        train = table.take(data, slice(None, train_len))
        valid = table.take(data, slice(train_len, -valid_len if valid_len
                                       else None))
        test = data  # the whole frame, as the reference does
        train_max, valid_max = max_samples
        kw = dict(time_steps=time_steps, num_encoder_steps=num_encoder_steps,
                  pred_len=pred_len, column_definition=column_definition)
        sample_train = sample_windows(train, train_max, **kw)
        sample_valid = sample_windows(valid, valid_max, **kw)
        sample_test = sample_windows(test, valid_max, **kw)
    finally:
        np.random.set_state(rng_state)
    return (_to_batches(sample_train, batch_size),
            _to_batches(sample_valid, batch_size),
            _to_batches(sample_test, batch_size))
