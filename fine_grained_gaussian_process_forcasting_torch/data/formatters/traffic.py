"""Traffic formatter: global (not per-entity) scaling.

The port's own copy of the JAX package's ``data/formatters/traffic.py`` on
column tables: one ``StandardScaler`` over all entities' real inputs and one
over the target, categoricals encoded over the whole frame.
"""

from __future__ import annotations

import numpy as np

from fine_grained_gaussian_process_forcasting_torch.data import table
from fine_grained_gaussian_process_forcasting_torch.data.base import (
    DataTypes,
    GenericDataFormatter,
    InputTypes,
)
from fine_grained_gaussian_process_forcasting_torch.data.formatters.electricity import (
    column_roles,
    fit_categoricals,
)
from fine_grained_gaussian_process_forcasting_torch.data.formatters.scaling import (
    StandardScaler,
)


class TrafficFormatter(GenericDataFormatter):
    _column_definition = [
        ("id", DataTypes.REAL_VALUED, InputTypes.ID),
        ("hours_from_start", DataTypes.REAL_VALUED, InputTypes.TIME),
        ("values", DataTypes.REAL_VALUED, InputTypes.TARGET),
        ("time_on_day", DataTypes.REAL_VALUED, InputTypes.KNOWN_INPUT),
        ("day_of_week", DataTypes.REAL_VALUED, InputTypes.KNOWN_INPUT),
        ("categorical_id", DataTypes.CATEGORICAL, InputTypes.STATIC_INPUT),
    ]

    def __init__(self, pred_len: int):
        self.pred_len = pred_len
        self.identifiers = None
        self._real_scalers = None
        self._cat_scalers = None
        self._target_scaler = None
        self._num_classes_per_cat_input = None

    def transform_data(self, df: table.Frame) -> table.Frame:
        self.set_scalers(df)
        return self.transform_inputs(df)

    def set_scalers(self, df: table.Frame) -> None:
        id_col, target_col, real_inputs, categorical_inputs = column_roles(
            self.get_column_definition())
        ids = df[id_col]
        first = np.sort(np.unique(ids, return_index=True)[1])
        self.identifiers = [v.item() for v in ids[first]]
        self._real_scalers = StandardScaler().fit(
            table.matrix(df, real_inputs))
        self._target_scaler = StandardScaler().fit(
            table.matrix(df, [target_col]))
        self._cat_scalers, self._num_classes_per_cat_input = (
            fit_categoricals(df, categorical_inputs))

    def transform_inputs(self, df: table.Frame) -> table.Frame:
        if self._real_scalers is None and self._cat_scalers is None:
            raise ValueError("Scalers have not been set!")
        _, _, real_inputs, categorical_inputs = column_roles(
            self.get_column_definition())
        output = dict(df)
        scaled = self._real_scalers.transform(table.matrix(df, real_inputs))
        for j, col in enumerate(real_inputs):
            output[col] = scaled[:, j]
        for col in categorical_inputs:
            output[col] = self._cat_scalers[col].transform(
                table.as_str(df[col]))
        return output

    def format_predictions(self, predictions: table.Frame) -> table.Frame:
        output = dict(predictions)
        for col in predictions:
            if col != "identifier":
                output[col] = self._target_scaler.inverse_transform(
                    predictions[col].reshape(-1, 1)).reshape(-1)
        return output

    def get_fixed_params(self) -> dict:
        decoder_steps = self.pred_len
        return {
            "total_time_steps": 192 + decoder_steps + self.pred_len,
            "num_encoder_steps": 192,
            "num_decoder_steps": decoder_steps,
            "num_epochs": 50,
            "early_stopping_patience": 5,
            "multiprocessing_workers": 5,
        }

    def get_default_model_params(self) -> dict:
        return {
            "hidden_layer_size": [8],
            "minibatch_size": [256],
            "num_heads": 8,
            "stack_size": [1],
            "context_lengths": [1, 3, 6, 9],
        }

    def get_num_samples_for_calibration(self, num_train: int = -1):
        if num_train == -1:
            return 32000, 3840
        return num_train, 3840
