"""GPipe pipeline parallelism over the mesh's ``model`` axis.

Port of ``lipreading_video_generation_tpu/parallel/pipeline.py``. A stack of
L homogeneous blocks splits into S contiguous stages, one a rank of the
model axis (stage s holds layers ``[s·L/S, (s+1)·L/S)`` and their Adam
moments only); microbatches stream through the stages in ``M + S − 1``
ticks, the activations moving one stage on each tick by a ``ppermute``, and
the last stage's outputs are summed over the axis (zeros elsewhere) so
every rank goes on with them. Each data row of the mesh pipelines its own
rows of the batch.

The JAX executor is one SPMD program; the port's is the same on every rank
too: which microbatch a stage takes and whether a tick's output is kept are
chosen with tensor selects, not Python branches on the rank, so every rank
records the same autograd graph and runs each ``ppermute``'s backward at
the same point (a collective needs all its ranks). Garbage that fills the
bubble is computed and dropped, as in JAX. The input enters through
``mesh.copy_to`` (only stage 0 reads it: its gradient is summed over the
stages) and the outputs leave through ``mesh.reduce_from`` (every rank
computes the same loss from them: the last stage gets the gradient once).

The layouts: ``stack_blocks`` / ``unstack_blocks`` convert a canonical
``state_dict`` (``blocks.{i}.*``) to the stacked one (``blocks.*`` with a
leading layer axis, the JAX package's ``pp_params``); ``shard_pp_state``
keeps this stage's layers of it (``pp_state_sharding`` says which leaves
split).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from . import mesh as pmesh

BLOCKS_KEY = "blocks"


def split_block_key(name: str, prefix: str = "blocks."):
    """``blocks.3.norm1.weight`` → (3, "norm1.weight"); None for a key
    outside the blocks."""
    if not name.startswith(prefix):
        return None
    index, _, rest = name[len(prefix):].partition(".")
    return (int(index), rest) if index.isdigit() and rest else None


def stack_blocks(params: Dict[str, torch.Tensor], num_layers: int,
                 prefix: str = "blocks.") -> Dict[str, torch.Tensor]:
    """Canonical ``{prefix}{i}.{name}`` entries → one ``blocks.{name}`` entry
    each, stacked over a leading layer axis; other entries pass through."""
    per_layer: Dict[str, list] = {}
    rest = {}
    for k, v in params.items():
        hit = split_block_key(k, prefix)
        if hit is None:
            rest[k] = v
        else:
            per_layer.setdefault(hit[1], [None] * num_layers)[hit[0]] = v
    stacked = {f"{BLOCKS_KEY}.{n}": torch.stack(vs) for n, vs in per_layer.items()}
    return {**rest, **stacked}


def unstack_blocks(params: Dict[str, torch.Tensor], num_layers: int,
                   prefix: str = "blocks.") -> Dict[str, torch.Tensor]:
    """Inverse of ``stack_blocks``: back to the canonical layout."""
    out = {}
    for k, v in params.items():
        if k.startswith(BLOCKS_KEY + "."):
            name = k[len(BLOCKS_KEY) + 1:]
            for i in range(num_layers):
                out[f"{prefix}{i}.{name}"] = v[i]
        else:
            out[k] = v
    return out


def stage_layers(num_layers: int, spec: Optional[pmesh.MeshSpec]) -> range:
    """The layers of this rank's stage (all of them on a 1×1 mesh);
    ``ValueError`` when the stages do not split them evenly."""
    s = 1 if pmesh.is_degenerate(spec) else spec.model_size
    if num_layers % s:
        raise ValueError(f"{num_layers} layers do not split over {s} pipeline stages")
    per = num_layers // s
    r = 0 if pmesh.is_degenerate(spec) else spec.model_rank
    return range(r * per, (r + 1) * per)


def pp_state_sharding(spec: pmesh.MeshSpec, tree: Dict[str, torch.Tensor],
                      blocks_key: str = BLOCKS_KEY) -> Dict[str, tuple]:
    """Layout of each leaf of a stacked tree: ``(model,)`` (the layer axis
    split over the stages) for the ``blocks`` leaves whose layer count the
    model axis divides, ``()`` (replicated) for the rest."""
    mp = 1 if pmesh.is_degenerate(spec) else spec.model_size
    return {k: ((spec.model_axis,) if k.startswith(blocks_key + ".") and mp > 1
                and v.ndim >= 1 and v.shape[0] % mp == 0 else ())
            for k, v in tree.items()}


def shard_pp_state(spec: pmesh.MeshSpec, tree: Dict[str, torch.Tensor],
                   blocks_key: str = BLOCKS_KEY) -> Dict[str, torch.Tensor]:
    """This rank's part of a stacked tree: its stage's layers of each
    ``blocks`` leaf, the rest whole."""
    layout = pp_state_sharding(spec, tree, blocks_key)
    out = {}
    for k, v in tree.items():
        if layout[k]:
            layers = stage_layers(v.shape[0], spec)
            v = v[layers.start:layers.stop]
        out[k] = v
    return out


def scan_blocks(block_apply: Callable, stacked_params, x: torch.Tensor) -> torch.Tensor:
    """Apply the layers in order (``block_apply(p, h)`` for each ``p`` of
    ``stacked_params``, an iterable of per-layer parameters or modules):
    the one-stage pipeline."""
    for p in stacked_params:
        x = block_apply(p, x)
    return x


def pipeline_blocks(stage_fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                    spec: Optional[pmesh.MeshSpec], n_micro: Optional[int] = None) -> torch.Tensor:
    """Run this data rank's rows ``x`` (B, ...) through the pipeline whose
    stage on this rank is ``stage_fn``; returns the last stage's (B, ...)
    output on every rank of the model axis. ``n_micro`` microbatches
    (default ``min(S, B)``, the fewest that keep every stage busy) must
    divide B. On a mesh without a model axis it is ``stage_fn(x)``."""
    S = 1 if pmesh.is_degenerate(spec) else spec.model_size
    if S == 1:
        return stage_fn(x)
    b = x.shape[0]
    M = n_micro if n_micro is not None else min(S, b)
    if b % M:
        raise ValueError(f"per-device batch {b} not divisible by n_micro {M}")
    axis = spec.model_axis
    idx = torch.tensor(spec.model_rank, device=x.device)
    first, last = idx == 0, idx == S - 1
    xm = pmesh.copy_to(x, spec, axis).reshape((M, b // M) + tuple(x.shape[1:]))
    state = torch.zeros_like(xm[0])
    outs = [torch.zeros_like(xm[0]) for _ in range(M)]
    for t in range(M + S - 1):
        # stage 0 takes microbatch t (past M: garbage that is never kept),
        # the others what the stage before sent last tick
        out = stage_fn(torch.where(first, xm[min(t, M - 1)], state))
        if t >= S - 1:      # the last stage finishes microbatch t − (S − 1)
            j = t - (S - 1)
            outs[j] = torch.where(last, out, outs[j])
        if t < M + S - 2:   # JAX's last permute carries nothing anyone reads
            state = pmesh.ppermute(out, spec, axis, 1)
    y = torch.stack(outs)
    y = pmesh.reduce_from(torch.where(last, y, torch.zeros_like(y)), spec, axis)
    return y.reshape(x.shape)
