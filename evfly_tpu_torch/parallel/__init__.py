"""Chunk-level data parallelism on ``torch.distributed``: the port of
``evfly_tpu/parallel``."""

from .data_parallel import (
    dp_chunked_demo_step,
    dp_train_demo_step,
    dryrun_chunked,
    make_dp_chunked_train_step,
    make_dp_train_step,
)
from .mesh import Mesh, make_mesh, replicate_params, shard_batch

__all__ = [
    "Mesh",
    "make_mesh",
    "replicate_params",
    "shard_batch",
    "make_dp_train_step",
    "make_dp_chunked_train_step",
    "dp_chunked_demo_step",
    "dp_train_demo_step",
    "dryrun_chunked",
]
