"""Random draws of the trainers, from explicit ``torch.Generator``s.

Port of ``lipreading_video_generation_tpu/core/prng.py``'s
``uniform_timesteps``. JAX folds the step into a root key; here each train
state owns one generator on its device and draws in order, so a run is
reproducible from its seed (and a checkpoint carries the generator's
state). The two random streams differ (threefry vs Philox): the tests hand
JAX's draws to the port explicitly.
"""
from __future__ import annotations

import torch


def uniform_timesteps(generator: torch.Generator, batch: int, num_timesteps: int) -> torch.Tensor:
    """t ~ U[0, num_timesteps), (batch,) int64 on the generator's device."""
    return torch.randint(0, num_timesteps, (batch,), generator=generator,
                         device=generator.device)
