"""Watershed formatter (reference ``data/watershed.py:25-130``).

Differs from electricity in its column definition and shorter encoder
(96 steps instead of 192).

The port's own copy of the JAX package's ``data/formatters/watershed.py``.
"""

from fine_grained_gaussian_process_forcasting_torch.data.base import (
    DataTypes,
    InputTypes,
)
from fine_grained_gaussian_process_forcasting_torch.data.formatters.electricity import (
    ElectricityFormatter,
)


class WatershedFormatter(ElectricityFormatter):
    _column_definition = [
        ("id", DataTypes.REAL_VALUED, InputTypes.ID),
        ("hours_from_start", DataTypes.REAL_VALUED, InputTypes.TIME),
        ("Conductivity", DataTypes.REAL_VALUED, InputTypes.TARGET),
        ("Q", DataTypes.REAL_VALUED, InputTypes.KNOWN_INPUT),
        ("day_of_week", DataTypes.REAL_VALUED, InputTypes.KNOWN_INPUT),
        ("hour", DataTypes.REAL_VALUED, InputTypes.KNOWN_INPUT),
        ("categorical_id", DataTypes.CATEGORICAL, InputTypes.STATIC_INPUT),
    ]

    def get_fixed_params(self) -> dict:
        decoder_steps = 96 if self.pred_len <= 96 else self.pred_len
        return {
            "total_time_steps": 96 + decoder_steps + self.pred_len,
            "num_encoder_steps": 96,
            "num_decoder_steps": decoder_steps,
            "num_epochs": 50,
            "early_stopping_patience": 5,
            "multiprocessing_workers": 5,
        }
