"""Multi-host distributed SpMV (counterpart of
``sparsetpu/dist/multihost.py``).

  ``init_multihost``        the process group from the environment that
                            ``torchrun`` sets (``MASTER_ADDR``,
                            ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``):
                            NCCL where CUDA is present, else gloo;
  ``shard_spmv_multihost``  each process packs only its own row band, with
                            a layout every process derives alike from the
                            whole matrix, so no process waits on another's
                            pack.

A rank already packs only its own band (``spmv_dist.shard_spmv``), so the
difference from the single-host path is the layout's source: the global
matrix's model choice here, shard 0's pack there.  The JAX package also
all-gathers the step counts and final flags (``multihost.py:101-110,
130-138``) and pads the finals (``_pad_finals`` :194) for its one SPMD
program's uniform shapes; a rank here runs its own shapes, so neither
exists.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..formats.csr import CSRMatrix
from ..pack.balance import balance_rows
from ..pack.gather_stream import _choose_layout, pack_gstream
from ..utils.config import SpmvConfig
from . import comm
from .spmv_dist import (ShardedSpmv, _band_device, _check_member,
                        _slice_rows, band_device)


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, *,
                   backend: Optional[str] = None, **kwargs) -> None:
    """``torch.distributed.init_process_group``: NCCL when CUDA is present,
    else gloo (``backend`` wins).  With no arguments, from the environment
    (``init_method="env://"``, as ``torchrun`` sets it); the JAX
    package's arguments (``multihost.py:38-51``) name the rendezvous
    ``tcp://{coordinator_address}`` ("host:port"), the world size and this
    process's rank.  ``kwargs`` go to ``init_process_group``.  Once per
    process, before any collective."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs.setdefault("init_method", "env://" if coordinator_address is None
                      else f"tcp://{coordinator_address}")
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(backend=backend, **kwargs)


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def shard_spmv_multihost(matrix: CSRMatrix, group=None,
                         config: Optional[SpmvConfig] = None, *,
                         interpret=False, device=None) -> ShardedSpmv:
    """Pack this rank's band with the global deterministic layout
    (``multihost.py:84-90``: (G, Q) from the whole matrix, ``config.vf``
    overriding Q, tiles_per_step from the per-band nnz) and upload it.
    ``matrix`` is the whole CSR on every rank (every host reads the file;
    each packs 1/P of it).  Returns a ``ShardedSpmv``."""
    _check_member(group)
    dev = band_device(device, interpret)
    n, me = comm.group_size(group), comm.group_rank(group)
    part = balance_rows(matrix, n)
    G, Q = _choose_layout(matrix)
    if config is not None and config.vf:
        Q = config.vf
    est_tiles = max(1, int(matrix.nr_nzeros // n * 1.3) // 1024)
    tps = 128 if est_tiles >= 1024 else (32 if est_tiles >= 128 else 8)
    pk = pack_gstream(_slice_rows(matrix, int(part.row_start[me]),
                                  int(part.row_end[me])),
                      config, G=G, Q=Q, tiles_per_step=tps,
                      shuffle_lanes=True)
    return ShardedSpmv(_band_device(pk, dev), group, part, matrix.nr_cols,
                       matrix.nr_nzeros)
