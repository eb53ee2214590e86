"""The collectives of the distributed SpMV, each carried by its group's
backend.

NCCL takes CUDA tensors.  gloo takes CPU tensors, and handles CUDA
tensors for a few collectives only (not for send and receive), so under
gloo a CUDA tensor is staged through pinned host memory for every
operation: one rule, chosen from the group's backend before the call,
never by catching an error.  The staging carries the exchange only; the
kernels run on the rank's device either way.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist


def _world(group):
    return dist.group.WORLD if group is None else group


def group_size(group) -> int:
    return dist.get_world_size(_world(group))


def group_rank(group) -> int:
    return dist.get_rank(_world(group))


def _global(group, r: int) -> int:
    """The global rank of group rank ``r``."""
    return dist.get_process_group_ranks(_world(group))[r]


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and \
        dist.get_backend(_world(group)) == dist.Backend.GLOO


def _pinned_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of ``t`` (waits for t's stream)."""
    return _pinned_like(t).copy_(t)


def all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``t`` (the same shape and type on every rank), in
    group-rank order, on t's device."""
    n = group_size(group)
    if _staged(t, group):
        h = _to_host(t)
        outs = [_pinned_like(h) for _ in range(n)]
        dist.all_gather(outs, h, group=group)
        return [o.to(t.device, non_blocking=True) for o in outs]
    outs = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(outs, t.contiguous(), group=group)
    return outs


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Group rank ``src``'s ``t`` on every rank (t gives the shape and type
    elsewhere), on t's device."""
    if _staged(t, group):
        h = _to_host(t)
        dist.broadcast(h, _global(group, src), group=group)
        return h.to(t.device, non_blocking=True)
    t = t.contiguous().clone()
    dist.broadcast(t, _global(group, src), group=group)
    return t


def broadcast_ints(values, src: int = 0, group=None,
                   device="cpu") -> List[int]:
    """Group rank ``src``'s Python ints on every rank (``values`` gives
    their count elsewhere), carried on ``device``."""
    t = torch.tensor([int(v) for v in values], dtype=torch.int64,
                     device=device)
    return [int(v) for v in broadcast(t, src, group).cpu()]


class Shift:
    """A started exchange of a ring stage: this rank's segment goes to its
    left neighbour while the right neighbour's arrives.  ``wait()`` returns
    the arrived segment, ready for work queued after it on the current
    stream.  Under NCCL the transfer runs on NCCL's stream, after the work
    queued before it started, and may overlap the kernels queued since;
    ``Work.wait`` makes the current stream wait for it."""

    def __init__(self, works, send: torch.Tensor, recv: torch.Tensor,
                 device: Optional[torch.device]):
        # send is held until the transfer is done
        self._works, self._send, self._recv = works, send, recv
        self._device = device

    def wait(self) -> torch.Tensor:
        for w in self._works:
            w.wait()
        if self._device is not None:
            return self._recv.to(self._device, non_blocking=True)
        return self._recv


def shift_left(t: torch.Tensor, group=None) -> Shift:
    """Start sending ``t`` to group rank (me - 1) mod n and receiving the
    same shape from (me + 1) mod n."""
    n, me = group_size(group), group_rank(group)
    left, right = _global(group, (me - 1) % n), _global(group, (me + 1) % n)
    staged = _staged(t, group)
    send = _to_host(t) if staged else t.contiguous()
    recv = _pinned_like(t) if staged else torch.empty_like(send)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, left, group),
        dist.P2POp(dist.irecv, recv, right, group)])
    return Shift(works, send, recv, t.device if staged else None)
