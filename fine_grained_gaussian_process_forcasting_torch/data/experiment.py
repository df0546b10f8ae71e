"""Experiment registry: name -> csv path + formatter.

The port's own copy of the JAX package's ``data/experiment.py``
(``ExperimentConfig``, reference ``data_loader.py:35-94``).  The covid
formatter exists in the reference's ``data/covid.py`` but was
missing from its ``make_data_formatter`` map; registered here.
"""

from __future__ import annotations

import os

from fine_grained_gaussian_process_forcasting_torch.data.formatters import (
    AirQualityFormatter,
    CovidFormatter,
    ElectricityFormatter,
    ExchangeFormatter,
    SolarFormatter,
    TrafficFormatter,
    WatershedFormatter,
)

_FORMATTERS = {
    "electricity": ElectricityFormatter,
    "traffic": TrafficFormatter,
    "air_quality": AirQualityFormatter,
    "watershed": WatershedFormatter,
    "solar": SolarFormatter,
    "exchange": ExchangeFormatter,
    "covid": CovidFormatter,
}

_CSV_MAP = {
    "electricity": "hourly_electricity.csv",
    "traffic": "hourly_traffic.csv",
    "air_quality": "hourly_air_quality.csv",
    "favorita": "favorita_consolidated.csv",
    "watershed": "watershed.csv",
    "solar": "solar.csv",
    "ETTm2": "ETT.csv",
    "weather": "weather.csv",
    "camel": "camel.csv",
    "covid": "covid.csv",
    "exchange": "exchange.csv",
}


class ExperimentConfig:
    default_experiments = [
        "electricity",
        "traffic",
        "air_quality",
        "camel",
        "favorita",
        "watershed",
        "solar",
        "ETTm2",
        "weather",
        "covid",
        "exchange",
    ]

    def __init__(self, pred_len: int = 24, experiment: str = "covid", root_folder=None):
        if experiment not in self.default_experiments:
            raise ValueError(f"Unrecognised experiment={experiment}")
        if root_folder is None:
            root_folder = os.path.join(os.getcwd(), "outputs")
        self.root_folder = root_folder
        self.experiment = experiment
        self.data_folder = os.path.join(root_folder, experiment)
        self.pred_len = pred_len
        for d in (self.root_folder, self.data_folder):
            os.makedirs(d, exist_ok=True)

    @property
    def data_csv_path(self) -> str:
        return os.path.join(self.data_folder, _CSV_MAP[self.experiment])

    def make_data_formatter(self):
        if self.experiment not in _FORMATTERS:
            raise ValueError(
                f"experiment {self.experiment!r} has a download/ETL handler "
                "but no data formatter — the reference defines none either "
                "(its make_data_formatter map at data_loader.py:75-94 omits "
                f"it). Formatters exist for: {sorted(_FORMATTERS)}."
            )
        return _FORMATTERS[self.experiment](self.pred_len)
