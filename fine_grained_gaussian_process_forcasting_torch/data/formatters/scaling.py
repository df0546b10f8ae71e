"""numpy stand-ins for the two scikit-learn preprocessors the JAX package's
formatters use, with the same numbers.

``StandardScaler``: mean and population variance in float64 by the corrected
two-pass sums scikit-learn takes on a first ``fit``, over the same
column-major matrix (``table.matrix``, as ``DataFrame.values`` lays it out),
so each sum runs in the same order and gives the same bits; a feature whose
variance is within rounding of zero gets scale 1.  ``LabelEncoder``: the
sorted distinct values, and codes by ``searchsorted``.
"""

from __future__ import annotations

import numpy as np


class StandardScaler:
    mean_: np.ndarray
    var_: np.ndarray
    scale_: np.ndarray

    def fit(self, x: np.ndarray) -> "StandardScaler":
        x = np.asarray(x, dtype=np.float64)
        n = np.float64(x.shape[0])
        new_sum = np.sum(x, axis=0)
        self.mean_ = new_sum / n
        temp = x - new_sum / n
        correction = np.sum(temp, axis=0)
        temp **= 2
        unnormalized = np.sum(temp, axis=0)
        unnormalized -= correction ** 2 / n
        self.var_ = unnormalized / n
        eps = np.finfo(np.float64).eps
        constant = self.var_ <= (n * eps * self.var_
                                 + (n * self.mean_ * eps) ** 2)
        scale = np.sqrt(self.var_)
        scale[constant] = 1.0
        self.scale_ = scale
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        out = np.array(x, dtype=np.float64)
        out -= self.mean_
        out /= self.scale_
        return out

    def inverse_transform(self, x: np.ndarray) -> np.ndarray:
        out = np.array(x, dtype=np.float64)
        out *= self.scale_
        out += self.mean_
        return out


class LabelEncoder:
    classes_: np.ndarray

    def fit(self, values: np.ndarray) -> "LabelEncoder":
        self.classes_ = np.unique(values)
        return self

    def transform(self, values: np.ndarray) -> np.ndarray:
        codes = np.searchsorted(self.classes_, values)
        found = self.classes_[np.minimum(codes, len(self.classes_) - 1)]
        if not (found == values).all():
            raise ValueError("values not seen by fit")
        return codes.astype(np.int64)
