"""The seven dataset formatters (the port's own copies of the JAX
package's ``data/formatters/``, on column tables)."""

from fine_grained_gaussian_process_forcasting_torch.data.formatters.air_quality import (
    AirQualityFormatter,
)
from fine_grained_gaussian_process_forcasting_torch.data.formatters.covid import (
    CovidFormatter,
)
from fine_grained_gaussian_process_forcasting_torch.data.formatters.electricity import (
    ElectricityFormatter,
)
from fine_grained_gaussian_process_forcasting_torch.data.formatters.exchange import (
    ExchangeFormatter,
)
from fine_grained_gaussian_process_forcasting_torch.data.formatters.solar import (
    SolarFormatter,
)
from fine_grained_gaussian_process_forcasting_torch.data.formatters.traffic import (
    TrafficFormatter,
)
from fine_grained_gaussian_process_forcasting_torch.data.formatters.watershed import (
    WatershedFormatter,
)

__all__ = [
    "AirQualityFormatter",
    "CovidFormatter",
    "ElectricityFormatter",
    "ExchangeFormatter",
    "SolarFormatter",
    "TrafficFormatter",
    "WatershedFormatter",
]
