"""Checkpoints on ``torch.save`` with the JAX package's resume semantics.

Port of ``lipreading_video_generation_tpu/core/checkpoint.py``:
``CheckpointManager`` keeps step-numbered checkpoints of a state (any
object ``torch.save`` takes: a dict of ``state_dict``s, tensors, numbers),
at most ``max_to_keep`` of them, and restores the latest or a given step;
``save_once`` / ``load_once`` write and read one file. Saves are synchronous
(the JAX package's are asynchronous through Orbax, which the port does not
need; so ``wait`` and ``close`` do nothing) and atomic: a file is written
beside its final name and renamed. Under a process group only the primary
rank writes, and every rank waits at a barrier until the file is in place,
so all of them call ``save`` (the state is the same on every rank).
Orbax checkpoints are not read. ``restore`` and ``load_once`` map tensors
onto the CPU unless ``map_location`` says otherwise.
"""
from __future__ import annotations

import os
import re
from typing import Any, List, Optional

import torch

from ..parallel.distributed import barrier, is_primary

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def atomic_save(path: str, state: Any) -> None:
    if is_primary():
        tmp = path + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
    barrier()


class CheckpointManager:
    """Step-numbered checkpoints ``step_<n>.pt`` in ``directory``."""

    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def steps(self) -> List[int]:
        """The saved steps, ascending."""
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(self.directory))
                      if m)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def save(self, step: int, state: Any) -> None:
        """Write ``state`` as ``step``; drop the oldest beyond ``max_to_keep``."""
        atomic_save(self._path(step), state)
        if self.max_to_keep and is_primary():
            for old in self.steps()[:-self.max_to_keep]:
                os.remove(self._path(old))

    def restore(self, step: Optional[int] = None, map_location="cpu") -> Any:
        """The state saved at ``step`` (None: the latest);
        ``FileNotFoundError`` when there is none."""
        step = self.latest_step() if step is None else step
        if step is None or not os.path.exists(self._path(step)):
            raise FileNotFoundError(f"no checkpoint {'found' if step is None else step} in "
                                    f"{self.directory!r}")
        return torch.load(self._path(step), map_location=map_location, weights_only=True)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Nothing to wait for: ``save`` returns once the file is in place
        (JAX's manager waits here for its asynchronous saves)."""

    def close(self) -> None:
        """Nothing to release: the manager holds no thread or file."""


def save_once(path: str, state: Any) -> None:
    """One-shot save (an inference export)."""
    path = os.path.abspath(path)
    if is_primary():
        os.makedirs(os.path.dirname(path), exist_ok=True)
    atomic_save(path, state)


def load_once(path: str, map_location="cpu") -> Any:
    """What ``save_once`` wrote at ``path``."""
    return torch.load(os.path.abspath(path), map_location=map_location, weights_only=True)
