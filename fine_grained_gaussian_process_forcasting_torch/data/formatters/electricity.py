"""Electricity formatter: the base per-entity-scaling implementation.

The port's own copy of the JAX package's ``data/formatters/electricity.py``
on column tables, with the scikit-learn preprocessors replaced by their
numpy stand-ins (``scaling.py``).  Same behaviour, reference quirks kept:
the scalers are fitted on the whole frame, not the train split; entities
shorter than ``total_time_steps`` are dropped; the categorical codes are
taken from the *unfiltered* frame's first rows and assigned by position onto
the filtered, regrouped output (misaligned whenever an entity was dropped).
"""

from __future__ import annotations

from fine_grained_gaussian_process_forcasting_torch.data import table
from fine_grained_gaussian_process_forcasting_torch.data.base import (
    DataTypes,
    GenericDataFormatter,
    InputTypes,
    extract_cols_from_data_type,
    get_single_col_by_input_type,
)
from fine_grained_gaussian_process_forcasting_torch.data.formatters.scaling import (
    LabelEncoder,
    StandardScaler,
)

_NOT_INPUTS = {InputTypes.ID, InputTypes.TIME}


def column_roles(defs):
    """(id column, target column, real inputs, categorical inputs) of a
    column definition."""
    return (get_single_col_by_input_type(InputTypes.ID, defs),
            get_single_col_by_input_type(InputTypes.TARGET, defs),
            extract_cols_from_data_type(DataTypes.REAL_VALUED, defs,
                                        _NOT_INPUTS),
            extract_cols_from_data_type(DataTypes.CATEGORICAL, defs,
                                        _NOT_INPUTS))


def fit_categoricals(df: table.Frame, categorical_inputs):
    """({column: LabelEncoder}, [number of classes]) over the whole frame's
    values as text."""
    scalers, num_classes = {}, []
    for col in categorical_inputs:
        srs = table.as_str(df[col])
        scalers[col] = LabelEncoder().fit(srs)
        num_classes.append(len(scalers[col].classes_))
    return scalers, num_classes


class ElectricityFormatter(GenericDataFormatter):
    """Per-entity z-score normalisation."""

    _column_definition = [
        ("id", DataTypes.REAL_VALUED, InputTypes.ID),
        ("hours_from_start", DataTypes.REAL_VALUED, InputTypes.TIME),
        ("power_usage", DataTypes.REAL_VALUED, InputTypes.TARGET),
        ("hour", DataTypes.REAL_VALUED, InputTypes.KNOWN_INPUT),
        ("day_of_week", DataTypes.REAL_VALUED, InputTypes.KNOWN_INPUT),
        ("categorical_id", DataTypes.CATEGORICAL, InputTypes.STATIC_INPUT),
    ]

    def __init__(self, pred_len: int):
        self.identifiers = None
        self._real_scalers = None
        self._cat_scalers = None
        self._target_scaler = None
        self._num_classes_per_cat_input = None
        self.pred_len = pred_len
        self._time_steps = self.get_fixed_params()["total_time_steps"]

    # ------------------------------------------------------------------ #

    def transform_data(self, df: table.Frame) -> table.Frame:
        """Calibrate the scalers on the full frame, then transform it."""
        self.set_scalers(df)
        return self.transform_inputs(df)

    def set_scalers(self, df: table.Frame) -> None:
        id_col, target_col, real_inputs, categorical_inputs = column_roles(
            self.get_column_definition())
        self._real_scalers, self._target_scaler = {}, {}
        identifiers = []
        for identifier, rows in table.groups(df, id_col):
            if len(rows) >= self._time_steps:
                sliced = table.take(df, rows)
                self._real_scalers[identifier] = StandardScaler().fit(
                    table.matrix(sliced, real_inputs))
                self._target_scaler[identifier] = StandardScaler().fit(
                    table.matrix(sliced, [target_col]))
            identifiers.append(identifier)
        self._cat_scalers, self._num_classes_per_cat_input = (
            fit_categoricals(df, categorical_inputs))
        self.identifiers = identifiers

    def transform_inputs(self, df: table.Frame) -> table.Frame:
        if self._real_scalers is None and self._cat_scalers is None:
            raise ValueError("Scalers have not been set!")
        id_col, _, real_inputs, categorical_inputs = column_roles(
            self.get_column_definition())
        parts = []
        for identifier, rows in table.groups(df, id_col):
            if len(rows) >= self._time_steps:
                sliced = table.take(df, rows)
                scaled = self._real_scalers[identifier].transform(
                    table.matrix(sliced, real_inputs))
                for j, col in enumerate(real_inputs):
                    sliced[col] = scaled[:, j]
                parts.append(sliced)
        output = table.concat(parts)
        n = table.n_rows(output)
        for col in categorical_inputs:
            # the reference's quirk: codes of the unfiltered frame's first n
            # rows, by position
            output[col] = self._cat_scalers[col].transform(
                table.as_str(df[col])[:n])
        return output

    def format_predictions(self, predictions: table.Frame):
        """Invert the target scaling per entity (column ``identifier``)."""
        if self._target_scaler is None:
            raise ValueError("Scalers have not been set!")
        parts = []
        for identifier, rows in table.groups(predictions, "identifier"):
            sliced = table.take(predictions, rows)
            scaler = self._target_scaler[identifier]
            for col in predictions:
                if col != "identifier":
                    sliced[col] = scaler.inverse_transform(
                        sliced[col].reshape(-1, 1)).reshape(-1)
            parts.append(sliced)
        return table.concat(parts) if parts else None

    # ------------------------------------------------------------------ #

    def get_default_model_params(self) -> dict:
        return {
            "hidden_layer_size": [8],
            "minibatch_size": [256],
            "num_heads": 8,
            "stack_size": [1],
            "context_lengths": [1, 3, 6, 9],
        }

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

    def get_num_samples_for_calibration(self, num_train: int = -1):
        if num_train == -1:
            return 32000, 3840
        return num_train, 3840
