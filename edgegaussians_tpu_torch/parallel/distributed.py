"""Process groups, the rank's device, and the collectives of the sharded
trainers, on ``torch.distributed``.

Counterpart of ``edgegaussians_tpu/parallel/distributed.py`` in PyTorch's
idiom: one process per rank, launched by ``torch.distributed.run``
(torchrun), which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``.

- :func:`initialize` joins the process group, or does nothing in a
  process that no launcher started. ``backend=None`` resolves to NCCL for
  CUDA ranks, each on its own card, and to Gloo for CPU ranks; ``"gloo"``
  may be asked for with CUDA ranks (ranks that share a card must). Two
  NCCL ranks on one card raise; nothing switches backend on its own.
- The sharded steps reduce with :func:`all_reduce` over named mesh axes
  (``parallel/mesh.py``). With Gloo the tensors may lie on the card: the
  collectives are called on them as they are, and a collective the
  backend does not take on that device raises.
- :func:`replicate` broadcasts rank 0's parameters, Adam moments and
  bookkeeping after each replicated update, so that no rank's last bits
  can part from rank 0's;
  :func:`check_lockstep` raises when the ranks' states differ in any bit.
- :func:`sharded_sum2x` is the shard-sum probe: the kernel on this rank's
  shard, then one all-reduce.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from edgegaussians_tpu_torch.models.gaussians import GROUPS

# a hung peer fails the run after this long instead of stalling it
TIMEOUT = datetime.timedelta(seconds=300)
_LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                  "MASTER_PORT")


def launched() -> bool:
    """Whether a launcher (torchrun) started this process as a rank."""
    return "WORLD_SIZE" in os.environ


def initialize(backend: Optional[str] = None,
               device_type: str = "cuda") -> bool:
    """Join the process group torchrun describes; a no-op (False) in a
    process no launcher started, and when the group exists already.

    ``device_type`` is where the rank's tensors live: ``"cuda"`` puts rank
    r on ``cuda:LOCAL_RANK``, or on ``cuda:(LOCAL_RANK % device_count)``
    where ranks outnumber the cards (Gloo only; logged). ``backend`` None
    picks NCCL for CUDA ranks and Gloo for CPU ranks."""
    if dist.is_initialized() or not launched():
        return False
    missing = [v for v in _LAUNCHER_VARS if v not in os.environ]
    if missing:
        raise RuntimeError(f"launcher environment lacks {missing}")
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ["LOCAL_RANK"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}: 'nccl' or 'gloo'")
    if device_type == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("CUDA ranks asked for, but torch sees no GPU")
        if local_world > count:
            if backend == "nccl":
                raise RuntimeError(
                    f"NCCL needs one card per rank: {local_world} ranks on "
                    f"this host share {count} card(s); launch at most "
                    f"{count} ranks per host, or pass backend 'gloo'")
            if local_rank == 0:
                print(f"distributed: {local_world} ranks share {count} "
                      "card(s) (Gloo)")
        torch.cuda.set_device(local_rank % count)
        torch.cuda.init()
    elif backend == "nccl":
        raise ValueError("NCCL takes CUDA ranks only")
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=TIMEOUT)
    return True


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_distributed() -> bool:
    return dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def all_reduce(t: torch.Tensor, mesh, axes: Sequence[str],
               op: str = "sum") -> torch.Tensor:
    """Reduce ``t`` in place over the named mesh axes (SUM or MAX); the
    identity on a mesh with no process group."""
    group = mesh.group(axes)
    if group is not None:
        dist.all_reduce(t, dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=group)
    return t


def _state_tensors(state):
    m = state.model
    tensors = [getattr(m, g) for g in GROUPS]
    tensors += [x for g in GROUPS for x in state.opt.moments[g]]
    return tensors + [m.alive, m.absgrads, m.absgrad_count]


@torch.no_grad()
def replicate(state) -> None:
    """Broadcast rank 0's parameters, Adam moments, ``alive``, absgrads
    and step counts to every rank, in place; a no-op without a process
    group."""
    if not dist.is_initialized():
        return
    for t in _state_tensors(state):
        if t.dtype == torch.bool:
            u8 = t.to(torch.uint8)
            dist.broadcast(u8, src=0)
            t.copy_(u8.to(torch.bool))
        else:
            dist.broadcast(t.data, src=0)
    dev = state.model.means.device
    counts = torch.tensor([state.step] + [state.opt.counts[g]
                                          for g in GROUPS],
                          dtype=torch.int64, device=dev)
    dist.broadcast(counts, src=0)
    state.step, *rest = counts.tolist()
    state.opt.counts.update(zip(GROUPS, rest))


@torch.no_grad()
def state_checksum(state) -> torch.Tensor:
    """An int64 sum over the bits of every state tensor: equal on two
    ranks when their states are equal bit for bit, short of a collision."""
    total = torch.zeros((), dtype=torch.int64,
                        device=state.model.means.device)
    for i, t in enumerate(_state_tensors(state)):
        bits = t.contiguous().view(torch.uint8) if t.dtype == torch.bool \
            else t.contiguous().view(torch.int32)
        total += (i + 1) * bits.to(torch.int64).sum()
    return total + state.step


@torch.no_grad()
def check_lockstep(state, what: str = "") -> None:
    """Raise unless every rank holds the same state, bit for bit: the MAX
    over the ranks of each rank's :func:`state_checksum` and of its
    negation (the MIN) must both be this rank's."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    mine = state_checksum(state)
    both = torch.stack([mine, -mine])
    dist.all_reduce(both, dist.ReduceOp.MAX)
    if int(both[0]) != int(mine) or int(-both[1]) != int(mine):
        raise RuntimeError(f"ranks hold different states {what}: the "
                           "replicated parameters drifted apart")


def sharded_sum2x(x_local: torch.Tensor, mesh, axes: Sequence[str]
                  ) -> torch.Tensor:
    """The shard-sum probe: ``2 * sum`` over the rows of the whole array
    whose shard along ``axes`` this rank holds, as ``[1, 128]``: the
    kernel (``ops/shard_sum.py``) on the shard, then one all-reduce."""
    from edgegaussians_tpu_torch.ops.shard_sum import shard_sum2x
    return all_reduce(shard_sum2x(x_local), mesh, axes)
