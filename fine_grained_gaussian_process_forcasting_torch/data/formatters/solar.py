"""Solar formatter (reference ``data/solar.py:24-90``).

The port's own copy of the JAX package's ``data/formatters/solar.py``.
"""

from fine_grained_gaussian_process_forcasting_torch.data.base import (
    DataTypes,
    InputTypes,
)
from fine_grained_gaussian_process_forcasting_torch.data.formatters.electricity import (
    ElectricityFormatter,
)


class SolarFormatter(ElectricityFormatter):
    _column_definition = [
        ("hours_from_start", DataTypes.REAL_VALUED, InputTypes.TIME),
        ("day_of_week", DataTypes.REAL_VALUED, InputTypes.KNOWN_INPUT),
        ("hour", DataTypes.REAL_VALUED, InputTypes.KNOWN_INPUT),
        ("Power(MW)", DataTypes.REAL_VALUED, InputTypes.TARGET),
        ("id", DataTypes.REAL_VALUED, InputTypes.ID),
        ("categorical_id", DataTypes.CATEGORICAL, InputTypes.STATIC_INPUT),
        ("capacity", DataTypes.CATEGORICAL, InputTypes.STATIC_INPUT),
    ]
