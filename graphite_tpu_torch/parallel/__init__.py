"""Factor-parallel execution over ``torch.distributed`` (``sharding``) and
the spawned ranks that run it (``launch``)."""

from .launch import run_ranks
from .sharding import (
    FACTOR_AXIS,
    Mesh,
    data_specs,
    make_mesh,
    shard_data,
    sharded_linearize_fn,
    sharded_lm,
    sharded_lm_step_fn,
)

__all__ = ["FACTOR_AXIS", "Mesh", "data_specs", "make_mesh", "run_ranks",
           "shard_data", "sharded_linearize_fn", "sharded_lm",
           "sharded_lm_step_fn"]
