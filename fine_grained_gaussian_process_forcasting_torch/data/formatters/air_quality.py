"""Air-quality formatter (reference ``data/air_quality.py:20-60``).

The port's own copy of the JAX package's ``data/formatters/air_quality.py``.
"""

from fine_grained_gaussian_process_forcasting_torch.data.base import (
    DataTypes,
    InputTypes,
)
from fine_grained_gaussian_process_forcasting_torch.data.formatters.electricity import (
    ElectricityFormatter,
)


class AirQualityFormatter(ElectricityFormatter):
    _column_definition = [
        ("hours_from_start", DataTypes.REAL_VALUED, InputTypes.TIME),
        ("NO2", DataTypes.REAL_VALUED, InputTypes.TARGET),
        ("CO", DataTypes.REAL_VALUED, InputTypes.KNOWN_INPUT),
        ("TEMP", DataTypes.REAL_VALUED, InputTypes.KNOWN_INPUT),
        ("hour", DataTypes.REAL_VALUED, InputTypes.KNOWN_INPUT),
        ("day_of_week", DataTypes.REAL_VALUED, InputTypes.KNOWN_INPUT),
        ("id", DataTypes.REAL_VALUED, InputTypes.ID),
    ]
