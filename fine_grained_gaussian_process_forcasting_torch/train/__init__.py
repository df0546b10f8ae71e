"""Training and serving (counterpart of the JAX package's ``train/``)."""

from fine_grained_gaussian_process_forcasting_torch.train.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from fine_grained_gaussian_process_forcasting_torch.train.schedule import (
    noam_adam,
)
from fine_grained_gaussian_process_forcasting_torch.train.trainer import (
    Trainer,
)

__all__ = ["Trainer", "noam_adam", "save_checkpoint", "load_checkpoint"]
