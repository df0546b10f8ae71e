"""Unified experiment configuration tree: the port's own copy of the JAX
package's ``utils/config.py`` (same dataclasses, field names and defaults).

The reference scatters its knobs across argparse flags (``train.py:
249-262``), formatter fixed/model params (``data/electricity.py:213-239``)
and the inline HPO space (``train.py:117-119``).  This dataclass tree
carries the same knobs in one place; CLI layers populate it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class DataConfig:
    exp_name: str = "solar"
    pred_len: int = 96
    data_csv: Optional[str] = None
    synthetic: bool = False
    out_dir: str = "."


@dataclasses.dataclass
class ModelConfig:
    attn_type: str = "ATA"
    backbone: str = "transformer"
    denoising: bool = True
    gp: bool = True
    no_noise: bool = False
    iso: bool = False
    residual: bool = False
    input_corrupt_training: bool = False
    # 512: the field-protocol screen's winner (MSE 0.188 against 0.219 at
    # the reference's 256); 256 is the reference's value
    # (denoising_model/DeepGP.py:30)
    num_inducing: int = 512
    use_pallas_gp: bool = False


@dataclasses.dataclass
class OptimConfig:
    num_epochs: int = 50
    n_trials: int = 5
    lr_mul: float = 2.0
    d_model_choices: Tuple[int, ...] = (32, 16)
    stack_choices: Tuple[int, ...] = (1, 3)
    w_steps_choices: Tuple[int, ...] = (4000,)


@dataclasses.dataclass
class ParallelConfig:
    n_data: Optional[int] = None  # None => all devices
    n_model: int = 1


@dataclasses.dataclass
class ExperimentSpec:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)
    seed: int = 1234
    n_seeds: int = 3
