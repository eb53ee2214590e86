"""Distributed SpMV over ranks joined by ``torch.distributed``: the
all-gather, ring, multi-host and f64 schedules (the names of
``sparsetpu/dist/__init__.py``), the rank launcher and the dry run.

``import sparsetpu_torch`` does not import this subpackage; importing it
loads ``torch.distributed``.
"""

from .df64 import ShardedSpmvDF64, shard_spmv_df64
from .dryrun import dryrun_multichip
from .launch import run_ranks
from .multihost import init_multihost, is_multiprocess, shard_spmv_multihost
from .ring import RingShardedSpmv, ring_shard_spmv
from .spmv_dist import (ShardedSpmv, choose_schedule, make_mesh,
                        shard_spmv, shard_spmv_auto)

__all__ = ["ShardedSpmv", "RingShardedSpmv", "ShardedSpmvDF64",
           "choose_schedule", "make_mesh", "shard_spmv",
           "shard_spmv_auto", "ring_shard_spmv",
           "shard_spmv_df64", "init_multihost", "is_multiprocess",
           "shard_spmv_multihost", "dryrun_multichip", "run_ranks"]
