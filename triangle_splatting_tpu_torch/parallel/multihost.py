"""Multi-process wiring over ``torch.distributed`` (port of
``triangle_splatting_tpu/parallel/multihost.py``).

One process drives one GPU. Every process of a job calls
:func:`maybe_initialize` (the ``trainer.distributed`` config block or the
``TS_*`` environment variables) before its first CUDA use; the trainers
call it from ``BaseTrainer.__init__``. A rank then works on
``cuda:{process_id % torch.cuda.device_count()}``, and the camera batch of
a data-parallel step is split over the ranks (``parallel/mesh.py``): the
JAX package's process-spanning mesh becomes the world group.

The backend is decided up front, never by catching an error: NCCL for a
CUDA device, Gloo for the CPU. A ``backend`` key of the block (or
``TS_BACKEND``, which mirrors it) overrides it; that is how several ranks
that share one GPU ask for Gloo, since NCCL refuses two ranks on one GPU
(its error is not caught). Gloo serves every collective the port uses
(SUM and MAX all-reduce, all-gather, broadcast) on CUDA tensors too, so no
collective is staged through the host by this module; Gloo itself copies
a CUDA tensor to the host for the reduction, while the port's arithmetic
stays on the card.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

# the standard launcher contract: one coordinator, ranked processes. The
# ``trainer.distributed`` keys ``coordinator`` / ``num_processes`` /
# ``process_id`` (and ``backend``) take precedence.
ENV_COORDINATOR = "TS_COORDINATOR"
ENV_NUM_PROCESSES = "TS_NUM_PROCESSES"
ENV_PROCESS_ID = "TS_PROCESS_ID"
ENV_BACKEND = "TS_BACKEND"
# a dead rank fails the job after this long instead of hanging it
TIMEOUT_S = 300.0


def _block(config):
    trainer = getattr(config, "trainer", None) if config is not None else None
    return getattr(trainer, "distributed", None) if trainer is not None else None


def distributed_settings(config=None):
    """(coordinator, num_processes, process_id) from the
    ``trainer.distributed`` block, else from ``TS_COORDINATOR`` /
    ``TS_NUM_PROCESSES`` / ``TS_PROCESS_ID``; None when neither asks for
    a distributed job."""
    blk = _block(config)
    if blk is not None:
        return (blk.coordinator, int(blk.num_processes), int(blk.process_id))
    if ENV_COORDINATOR in os.environ:
        return (os.environ[ENV_COORDINATOR], int(os.environ[ENV_NUM_PROCESSES]),
                int(os.environ[ENV_PROCESS_ID]))
    return None


def resolve_backend(config=None, device="cuda") -> str:
    """The block's ``backend``, else ``TS_BACKEND``, else NCCL for a CUDA
    device and Gloo for the CPU."""
    blk = _block(config)
    chosen = (getattr(blk, "backend", None) if blk is not None else None) \
        or os.environ.get(ENV_BACKEND)
    if chosen is None:
        chosen = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if chosen not in ("nccl", "gloo"):
        raise ValueError(f"unknown torch.distributed backend {chosen!r} (nccl, gloo)")
    return chosen


def rank_device(process_id: int) -> torch.device:
    """The GPU of a rank: ranks go round the visible cards."""
    return torch.device("cuda", process_id % torch.cuda.device_count())


def maybe_initialize(config=None, logger=None, device="cuda") -> bool:
    """``torch.distributed.init_process_group`` iff distributed mode is
    requested; a CUDA rank also selects its GPU first. Idempotent (a call
    after the group exists changes nothing). Returns whether the job has
    more than one process."""
    import torch.distributed as dist
    settings = distributed_settings(config)
    if settings is not None and not dist.is_initialized():
        coordinator, num_processes, process_id = settings
        chosen = resolve_backend(config, device)
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(rank_device(process_id))
        dist.init_process_group(
            chosen, init_method=f"tcp://{coordinator}", world_size=num_processes,
            rank=process_id,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        if logger is not None:
            logger.info(f"torch.distributed initialized: process {process_id}/"
                        f"{num_processes} via {coordinator}, backend {chosen}")
    return dist.is_initialized() and dist.get_world_size() > 1


def world() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) outside a job."""
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_main_process() -> bool:
    """True on rank 0 (the one that should write checkpoints and logs;
    collectives stay collective)."""
    return world()[0] == 0


@dataclass(frozen=True)
class DataGroup:
    """A group of ranks and the collectives a step runs over it.

    ``size`` ranks take cameras (the data axis of a JAX mesh); the others
    of ``group`` take none and add zeros to every all-reduce, zeros being
    the identity of SUM and of MAX over non-negative statistics. ``group``
    None is the world of one process outside any job: every collective is
    then the identity."""
    size: int
    rank: int
    world: int
    group: object = None
    backend: Optional[str] = None

    @property
    def takes_cameras(self) -> bool:
        return self.rank < self.size

    def all_reduce(self, tensors: Sequence[torch.Tensor], op: str = "sum") -> list:
        """SUM or MAX of each tensor over the group: one collective per
        dtype, on one flat buffer of that dtype's tensors."""
        tensors = list(tensors)
        if self.group is None:
            return tensors
        import torch.distributed as dist
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        out = list(tensors)
        for dt in dict.fromkeys(t.dtype for t in tensors):
            idx = [i for i, t in enumerate(tensors) if t.dtype == dt]
            flat = torch.cat([tensors[i].reshape(-1) for i in idx])
            dist.all_reduce(flat, op=rop, group=self.group)
            for i, part in zip(idx, torch.split(flat, [tensors[i].numel() for i in idx])):
                out[i] = part.view(tensors[i].shape)
        return out

    def reduce_dict(self, tree: dict, op: str = "sum") -> dict:
        return dict(zip(tree, self.all_reduce(list(tree.values()), op)))

    def all_gather(self, tensor: torch.Tensor) -> torch.Tensor:
        """(world, *shape): every rank's tensor in rank order."""
        if self.group is None:
            return tensor[None]
        import torch.distributed as dist
        t = tensor.contiguous()
        out = torch.empty((self.world * t.numel(),), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t.reshape(-1), group=self.group)
        return out.view((self.world,) + tuple(t.shape))


# a world of one process: every collective the identity (the single-view
# training step's group)
LOCAL = DataGroup(size=1, rank=0, world=1)


def world_group(size: Optional[int] = None) -> DataGroup:
    """The world as a DataGroup whose first ``size`` ranks take cameras."""
    import torch.distributed as dist
    rank, n = world()
    if not dist.is_initialized():
        return DataGroup(size=size or 1, rank=0, world=1)
    return DataGroup(size=size or n, rank=rank, world=n, group=dist.group.WORLD,
                     backend=dist.get_backend())


def make_global_mesh() -> DataGroup:
    """The data group over every rank of the job (the JAX package's mesh
    over the global device list)."""
    return world_group()


def tree_checksum(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """(n, 2) int64 on the host: per tensor, two sums of its bytes read as
    int32 words (the second position-weighted, both wrapping): equal bits
    give equal checksums."""
    rows = []
    for t in tensors:
        b = t.detach().contiguous().reshape(-1).view(torch.uint8)
        pad = (-b.numel()) % 4
        if pad:
            b = torch.cat([b, b.new_zeros(pad)])
        w = b.view(torch.int32).to(torch.int64)
        pos = torch.arange(w.numel(), device=w.device, dtype=torch.int64) % 1021 + 1
        rows.append(torch.stack([w.sum(), (w * pos).sum()]).cpu())
    if not rows:
        return torch.zeros((0, 2), dtype=torch.int64)
    return torch.stack(rows)


def _leaves(tree) -> list:
    """The tensors of a params / state / Adam tree (dataclasses, dicts,
    sequences), in a fixed order."""
    import dataclasses
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree) for x in _leaves(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


def check_replicated(group: DataGroup, *trees, what: str = "replicated inputs") -> None:
    """Raise unless every rank holds the same bits in ``trees``: a checksum
    per tensor, all-gathered and compared with rank 0's."""
    if group.group is None:
        return
    leaves = [x for tree in trees for x in _leaves(tree)]
    sums = tree_checksum(leaves)
    if group.backend == "nccl":
        sums = sums.to(torch.device("cuda", torch.cuda.current_device()))
    gathered = group.all_gather(sums)
    bad = (gathered != gathered[:1]).any(dim=-1).any(dim=-1).nonzero().flatten().tolist()
    if bad:
        raise RuntimeError(f"{what} differ across ranks: ranks {bad} disagree with rank 0")


def global_dp_inputs(group: DataGroup, global_batch: Sequence, *replicated):
    """This rank's contiguous share ``[r*L, (r+1)*L)`` of a global camera
    batch (L = len(batch) / group.size; empty on a rank that takes no
    camera), after checking that the ``replicated`` trees (params, Adam
    state, model state, ...) are equal across ranks. Returns
    ``(local_batch, *replicated)``."""
    n = len(global_batch)
    if n % group.size:
        raise ValueError(f"a batch of {n} views does not split over {group.size} ranks")
    L = n // group.size
    local = list(global_batch[group.rank * L:(group.rank + 1) * L]) \
        if group.takes_cameras else []
    if replicated:
        check_replicated(group, *replicated)
    return (local, *replicated)
