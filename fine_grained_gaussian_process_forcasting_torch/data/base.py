"""Column type system and the generic data-formatter contract.

The port's own copy of the JAX package's ``data/base.py`` (which needs no
JAX, but the port imports nothing of that package): the column roles and
types, the column helpers, and the formatter ABC whose
``get_column_definition`` orders columns [id, time, reals...,
categoricals...], the order window extraction depends on.  Formatters here
work on the port's column tables (``data/table.py``), not pandas frames.
"""

from __future__ import annotations

import abc
import enum
from typing import List, Sequence, Tuple


class DataTypes(enum.IntEnum):
    """Numerical type of each column (reference ``Utils/base.py:24-28``)."""

    REAL_VALUED = 0
    CATEGORICAL = 1
    DATE = 2


class InputTypes(enum.IntEnum):
    """Role of each column (reference ``Utils/base.py:31-38``)."""

    TARGET = 0
    OBSERVED_INPUT = 1
    KNOWN_INPUT = 2
    STATIC_INPUT = 3
    ID = 4
    TIME = 5


ColumnDefinition = Tuple[str, DataTypes, InputTypes]


def get_single_col_by_input_type(
    input_type: InputTypes, column_definition: Sequence[ColumnDefinition]
) -> str:
    """Name of the single column with the given role (``Utils/utils.py:1-13``)."""
    cols = [tup[0] for tup in column_definition if tup[2] == input_type]
    if len(cols) != 1:
        raise ValueError(f"Invalid number of columns for {input_type}")
    return cols[0]


def extract_cols_from_data_type(
    data_type: DataTypes,
    column_definition: Sequence[ColumnDefinition],
    excluded_input_types: set,
) -> List[str]:
    """Column names of a data type, minus excluded roles (``Utils/utils.py:16-30``)."""
    return [
        tup[0]
        for tup in column_definition
        if tup[1] == data_type and tup[2] not in excluded_input_types
    ]


class GenericDataFormatter(abc.ABC):
    """Abstract base for all dataset formatters (``Utils/base.py:41-148``).

    Subclasses define ``_column_definition`` and implement scaling
    (``set_scalers`` / ``transform_inputs``) plus experiment parameters.
    """

    @abc.abstractmethod
    def set_scalers(self, df):
        raise NotImplementedError()

    @abc.abstractmethod
    def transform_inputs(self, df):
        raise NotImplementedError()

    @abc.abstractmethod
    def format_predictions(self, df):
        raise NotImplementedError()

    @abc.abstractmethod
    def transform_data(self, df):
        raise NotImplementedError()

    @property
    @abc.abstractmethod
    def _column_definition(self) -> List[ColumnDefinition]:
        raise NotImplementedError()

    def get_column_definition(self) -> List[ColumnDefinition]:
        """Validated, canonically ordered column definition.

        Order: [id, time, reals..., categoricals...] — exactly the
        reference's ordering (``Utils/base.py:70-104``) which downstream
        window extraction depends on.
        """
        column_definition = self._column_definition

        def _check_single_column(input_type):
            length = len([t for t in column_definition if t[2] == input_type])
            if length != 1:
                raise ValueError(
                    f"Illegal number of inputs ({length}) of type {input_type}"
                )

        _check_single_column(InputTypes.ID)
        _check_single_column(InputTypes.TIME)

        identifier = [t for t in column_definition if t[2] == InputTypes.ID]
        time = [t for t in column_definition if t[2] == InputTypes.TIME]
        real_inputs = [
            t
            for t in column_definition
            if t[1] == DataTypes.REAL_VALUED
            and t[2] not in {InputTypes.ID, InputTypes.TIME}
        ]
        categorical_inputs = [
            t
            for t in column_definition
            if t[1] == DataTypes.CATEGORICAL
            and t[2] not in {InputTypes.ID, InputTypes.TIME}
        ]
        return identifier + time + real_inputs + categorical_inputs

    def get_fixed_params(self) -> dict:
        raise NotImplementedError

    def get_num_samples_for_calibration(self, num_train: int = -1):
        """(train_samples, valid_samples); -1 uses all available."""
        return -1, -1

    def get_experiment_params(self) -> dict:
        """Fixed params + validated column definition (``Utils/base.py:132-148``)."""
        required_keys = ["total_time_steps"]
        fixed_params = self.get_fixed_params()
        for k in required_keys:
            if k not in fixed_params:
                raise ValueError(
                    f"Field {k} missing from fixed parameter definitions!"
                )
        fixed_params["column_definition"] = self.get_column_definition()
        return fixed_params
