"""Exchange formatter (reference ``data/exchange.py:20-67``).

The port's own copy of the JAX package's ``data/formatters/exchange.py``.
"""

from fine_grained_gaussian_process_forcasting_torch.data.base import (
    DataTypes,
    InputTypes,
)
from fine_grained_gaussian_process_forcasting_torch.data.formatters.electricity import (
    ElectricityFormatter,
)


class ExchangeFormatter(ElectricityFormatter):
    _column_definition = [
        ("hours_from_start", DataTypes.REAL_VALUED, InputTypes.TIME),
        ("OT", DataTypes.REAL_VALUED, InputTypes.TARGET),
        ("hour", DataTypes.REAL_VALUED, InputTypes.KNOWN_INPUT),
        ("0", DataTypes.REAL_VALUED, InputTypes.KNOWN_INPUT),
        ("1", DataTypes.REAL_VALUED, InputTypes.KNOWN_INPUT),
        ("2", DataTypes.REAL_VALUED, InputTypes.KNOWN_INPUT),
        ("3", DataTypes.REAL_VALUED, InputTypes.KNOWN_INPUT),
        ("4", DataTypes.REAL_VALUED, InputTypes.KNOWN_INPUT),
        ("5", DataTypes.REAL_VALUED, InputTypes.KNOWN_INPUT),
        ("day_of_week", DataTypes.REAL_VALUED, InputTypes.KNOWN_INPUT),
        ("id", DataTypes.REAL_VALUED, InputTypes.ID),
        ("categorical_id", DataTypes.CATEGORICAL, InputTypes.STATIC_INPUT),
    ]

    def get_default_model_params(self) -> dict:
        return {
            "hidden_layer_size": [8],
            "minibatch_size": [8],
            "num_heads": 8,
            "stack_size": [1],
            "context_lengths": [1, 3, 6, 9],
        }

    def get_num_samples_for_calibration(self, num_train: int = -1):
        if num_train == -1:
            return 512, 512
        return num_train, 512
