"""Data, tensor and FSDP parallelism over ``torch.distributed`` (the JAX
package's ``parallel/``): ``make_mesh`` and the collectives in ``mesh``,
the placement rules and ``ShardedParams`` in ``sharding``."""

from fine_grained_gaussian_process_forcasting_torch.parallel.mesh import (
    batch_slice,
    make_mesh,
    replicated,
)
from fine_grained_gaussian_process_forcasting_torch.parallel.sharding import (
    fsdp_specs,
    opt_state_shardings,
    param_shardings,
    param_specs,
)

__all__ = [
    "batch_slice",
    "make_mesh",
    "replicated",
    "fsdp_specs",
    "opt_state_shardings",
    "param_shardings",
    "param_specs",
]
