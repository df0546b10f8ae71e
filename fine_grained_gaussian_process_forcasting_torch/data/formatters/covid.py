"""Covid formatter (reference ``data/covid.py:20-55``).

Note the reference declares the duplicate column
``Population Staying at Home`` twice in its column definition; replicated
faithfully (the column is selected twice, doubling that feature).

The port's own copy of the JAX package's ``data/formatters/covid.py``.
"""

from fine_grained_gaussian_process_forcasting_torch.data.base import (
    DataTypes,
    InputTypes,
)
from fine_grained_gaussian_process_forcasting_torch.data.formatters.electricity import (
    ElectricityFormatter,
)


class CovidFormatter(ElectricityFormatter):
    _column_definition = [
        ("days_from_start", DataTypes.REAL_VALUED, InputTypes.TIME),
        ("PEOPLE_POSITIVE_NEW_CASES_COUNT", DataTypes.REAL_VALUED, InputTypes.TARGET),
        ("day_of_week", DataTypes.REAL_VALUED, InputTypes.KNOWN_INPUT),
        ("PEOPLE_DEATH_COUNT", DataTypes.REAL_VALUED, InputTypes.KNOWN_INPUT),
        ("Population Staying at Home", DataTypes.REAL_VALUED, InputTypes.KNOWN_INPUT),
        ("Population Staying at Home", DataTypes.REAL_VALUED, InputTypes.KNOWN_INPUT),
        ("Population Not Staying at Home", DataTypes.REAL_VALUED, InputTypes.KNOWN_INPUT),
        ("id", DataTypes.REAL_VALUED, InputTypes.ID),
        ("categorical_id", DataTypes.CATEGORICAL, InputTypes.STATIC_INPUT),
    ]
