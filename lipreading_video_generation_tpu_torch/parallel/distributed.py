"""Process-group start-up: one process per GPU under ``torch.distributed``.

Port of ``lipreading_video_generation_tpu/parallel/distributed.py``. JAX runs
one controller per host and ``jax.distributed.initialize`` joins the hosts;
the port runs one process per card, started by ``python -m
torch.distributed.run`` (torchrun), which hands each process ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR`` / ``MASTER_PORT`` (in the
place of JAX's ``COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES``).
``initialize`` joins them into one process group, NCCL on the cards and gloo
on the CPU, and pins each process to its card (``cuda:LOCAL_RANK``). The
same ``build_mesh`` and trainers (``parallel/mesh.py``) then run on every
rank; each rank feeds its own share of a batch (``local_batch_slice``).
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

# the card this process was pinned to by ``initialize`` (None before it, or on the CPU)
_RANK_DEVICE: list = [None]


def initialize(rank: Optional[int] = None, world_size: Optional[int] = None,
               init_method: Optional[str] = None, backend: Optional[str] = None,
               device=None, store=None) -> Tuple[int, int]:
    """Join this process to the process group; returns (rank, world size).

    Nothing to do for a plain single process (no torchrun environment and no
    argument): the mesh is then 1×1. Under torchrun the arguments default to
    its ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` and its ``env://``
    rendezvous, so a one-process torchrun run still makes a process group of
    one (NCCL then runs every collective of the trainers, on one rank).
    ``store`` (e.g. a ``torch.distributed.FileStore``) replaces
    ``init_method``.

    The device: ``cuda:LOCAL_RANK`` by default, made this process's current
    card (``RuntimeError`` when the machine has no such card: ranks never
    share a GPU unnoticed); ``device="cpu"`` runs on the CPU. ``device`` may
    also name a card explicitly, which is how two ranks share one card (e.g.
    ``chip_smoke.py``, which needs ``backend="gloo"`` for it: NCCL refuses
    two ranks on one device). The backend is ``nccl`` on a card and
    ``gloo`` on the CPU unless ``backend`` says otherwise. Calling it again
    in a process that has a group returns that group's rank and size."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    launched = "MASTER_ADDR" in env and "WORLD_SIZE" in env
    if not (launched or init_method or store is not None or world_size is not None):
        return 0, 1
    rank = int(env.get("RANK", 0)) if rank is None else int(rank)
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else int(world_size)
    local_rank = int(env.get("LOCAL_RANK", rank))
    if device is None:
        from ..core.device import default_device

        default_device()        # RuntimeError without a CUDA device
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(
                f"initialize: LOCAL_RANK {local_rank} has no card "
                f"({torch.cuda.device_count()} visible); start at most one process per GPU, "
                f"or pass device='cpu'")
        device = torch.device("cuda", local_rank)
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        _RANK_DEVICE[0] = device
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if store is None and init_method is None:
        init_method = "env://"
    dist.init_process_group(backend, init_method=init_method, store=store, rank=rank,
                            world_size=world_size)
    return rank, world_size


def rank_device() -> Optional[torch.device]:
    """The card ``initialize`` pinned this process to, or None."""
    return _RANK_DEVICE[0] if dist.is_initialized() else None


def shutdown() -> None:
    """Leave the process group (if any); the next ``initialize`` starts anew."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _RANK_DEVICE[0] = None


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_batch_slice(global_batch: int) -> Tuple[int, int]:
    """(start, size) of this process's share of a global batch: the input
    contract of a multi-process run (each process reads only its share)."""
    n = process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} hosts")
    per = global_batch // n
    return process_index() * per, per


def global_batch_from_local(spec, batch, global_batch: int):
    """Each process's LOCAL share of a batch (made per ``local_batch_slice``)
    → the whole batch on every rank, the counterpart of the JAX package's
    global arrays: the shares are all-gathered over every process in rank
    order, on ``spec``'s device (or each leaf's own). ``shard_batch`` then
    hands each data rank its rows again. Leaves are arrays or tensors whose
    leading dim is this process's share."""
    from .mesh import _all_gather_world

    n = process_count()
    per = global_batch // n if global_batch % n == 0 else None
    if per is None:
        raise ValueError(f"global batch {global_batch} not divisible by {n} hosts")

    def gather(x):
        t = torch.as_tensor(x)
        if t.shape[0] != per:
            raise ValueError(f"local batch {t.shape[0]} != {global_batch} / {n}")
        if spec is not None and spec.device is not None:
            t = t.to(spec.device)
        return _all_gather_world(t)

    return {k: gather(v) for k, v in batch.items()}


def is_primary() -> bool:
    """True on the process that writes checkpoints, samples and metrics."""
    return process_index() == 0


def barrier() -> None:
    """Wait for every process (nothing to wait for without a group)."""
    if dist.is_initialized():
        dist.barrier()
