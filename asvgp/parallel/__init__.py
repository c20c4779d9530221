"""Device-mesh parallelism: data-parallel training across devices."""

from asvgp.parallel.dp import (
    make_dp_train_step,
    make_dp_train_step_additive,
    make_dp_train_step_kron,
    shard_data,
)

__all__ = [
    "make_dp_train_step",
    "make_dp_train_step_additive",
    "make_dp_train_step_kron",
    "shard_data",
]
