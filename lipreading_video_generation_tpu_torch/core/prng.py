"""Random draws of the trainers, from explicit ``torch.Generator``s.

Port of ``lipreading_video_generation_tpu/core/prng.py``. JAX threads
``jax.random`` keys; here a key is a 64-bit integer seed for a
``torch.Generator`` (``generator.manual_seed(key)``), derived the same way:
``make_root_key`` from the run's seed, ``step_key`` folds in a step counter,
``split_for`` folds in names (through the same ``_stable_hash``),
``key_iterator`` is a host-side stream. The fold is splitmix64, not
threefry, and Philox draws differently from threefry, so the two packages'
random streams differ: the tests hand JAX's draws to the port explicitly,
and parity never depends on a seed.
"""
from __future__ import annotations

from typing import Callable, Iterator, Tuple

import torch

_MASK64 = (1 << 64) - 1


def _mix64(z: int) -> int:
    """splitmix64's finaliser: a bijection of 64-bit integers."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def fold_in(key: int, data: int) -> int:
    """A new key from ``key`` and an integer (``jax.random.fold_in``)."""
    return _mix64(key ^ _mix64(int(data) & _MASK64))


def make_root_key(seed: int) -> int:
    return _mix64(int(seed) & _MASK64)


def step_key(root: int, step: int) -> int:
    """Deterministic per-step key: fold the step counter into the root key."""
    return fold_in(root, step)


def split_for(key: int, *names: str) -> Tuple[int, ...]:
    """Named splits: stable mapping from name to subkey independent of order."""
    return tuple(fold_in(key, _stable_hash(n)) for n in names)


def _stable_hash(name: str) -> int:
    h = 2166136261
    for c in name.encode():
        h = (h ^ c) * 16777619 % (1 << 32)
    return h


def key_iterator(seed: int) -> Iterator[int]:
    """Host-side infinite key stream (for data shuffling etc.)."""
    key = make_root_key(seed)
    i = 0
    while True:
        yield fold_in(key, i)
        i += 1


def uniform_timesteps(generator: torch.Generator, batch: int, num_timesteps: int) -> torch.Tensor:
    """t ~ U[0, num_timesteps), (batch,) int64 on the generator's device."""
    return torch.randint(0, num_timesteps, (batch,), generator=generator,
                         device=generator.device)


def seeded(build: Callable[[], torch.nn.Module], seed: int) -> torch.nn.Module:
    """``build()`` with the port's Flax-style init drawn from ``seed``,
    leaving the global random state as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()
