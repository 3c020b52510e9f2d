"""The ``(data, model)`` device mesh and the collectives the port runs on it.

Port of ``lipreading_video_generation_tpu/parallel/mesh.py``. JAX drives one
``Mesh`` from a single controller and XLA inserts the collectives; the port
runs one process per GPU (``parallel/distributed.py``) and says every
collective itself. The names and the semantics stay JAX's:

- ``build_mesh`` lays the processes of the group out as a ``data`` ×
  ``model`` grid (a ``torch.distributed.device_mesh.DeviceMesh``), with the
  JAX package's divisibility checks and messages. Without a process group
  the mesh is 1×1 and every helper below does nothing, so entry points call
  them unconditionally and give ``mesh_spec=None``'s bits.
- Data parallelism: ``shard_batch`` hands each data rank its rows of a host
  batch that every rank holds (the whole batch when its rows do not divide:
  that batch runs replicated). Each rank's loss is the mean over its rows,
  so ``DataParallelOptimizer`` averages the gradients over ``data`` before
  the update: the mean over the global batch, as JAX's psum gives.
  Random draws of a sharded step (dropout masks, diffusion noise and
  timesteps) are made for the global batch and sliced: the callers that
  know axis 0 is the batch ask for that (``draw_batch``), so a sharded step
  draws what an unsharded one does.
- ZeRO-1 (``MeshConfig.zero1``): each rank holds and updates only its slice
  of every Adam moment leaf that ``zero1_partition_spec`` shards, then the
  updated params are all-gathered. Adam is elementwise, so the params equal
  plain data parallelism's bit for bit.
- Tensor parallelism over the model axis, in the JAX package's layout:
  ``param_partition_spec`` lists every ≥2-D leaf of at least
  ``model_shard_threshold`` elements whose output dim (``output_dim``: dim
  0 of a torch ``Linear``/conv weight, the last dim of a raw parameter;
  the Flax layout's last dim either way) the model axis divides, frozen
  experts included. ``shard_params`` / ``shard_state`` cut each such leaf,
  its EMA shadow and (in ``DataParallelOptimizer``) its Adam moments to
  this model rank's slice; a sharded ``Linear`` or conv computes its
  rank's output channels from the whole input and all-gathers them
  (column parallelism, ``models/layers.py``; its input gradient is
  summed over the model ranks in float32, ``column_input``), a raw
  parameter is gathered at its use (``whole_param``), so activations stay
  whole on every model
  rank and the rest of the step is replicated there. ``full_state_dict``
  and ``load_full_state_dict`` read and write the one-process layout.
  The model axis otherwise replicates compute unless a sequence-parallel
  ring (``ops/ring_attention.py``) or the pipeline (``parallel/pipeline.py``,
  whose state the TP rule does not place) claims it.

Collectives over a gloo group move CUDA tensors through host memory for the
transport only (gloo's point-to-point and all-gather take CPU tensors); the
route is chosen by the group's backend and logged once, and
``transport_stats`` counts the calls, bytes and seconds it took.

Differentiable collectives (``torch.distributed`` has no autograd):
``ppermute`` (its backward sends the gradient the other way), ``psum`` (its
VJP is a psum), and the pairs that join replicated and partial values:
``copy_to`` (identity, backward psum), ``reduce_from`` (psum, backward
identity), ``scatter_to`` (this rank's slice, backward all-gather) and
``gather_from`` (all-gather, backward this rank's slice); and
``column_input``, a column-parallel layer's whole input joined to its
rank's output channels. Every rank must
run the same graph: a collective's backward runs on all ranks of its group
or on none.
"""
from __future__ import annotations

import contextlib
import contextvars
import copy
import dataclasses
import logging
import math
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..core.config import MeshConfig

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class MeshSpec:
    """Resolved mesh: axis names and sizes, the ``DeviceMesh`` (None for the
    1×1 mesh of a process without a group) and this rank's device."""

    mesh: Any
    data_axis: str = "data"
    model_axis: str = "model"
    device: Optional[torch.device] = None
    model_shard_threshold: int = 2**22
    zero1: bool = False
    zero1_min_size: int = 2**16

    def size(self, axis: str) -> int:
        if axis not in (self.data_axis, self.model_axis):
            raise KeyError(f"mesh has no axis {axis!r} (axes {self.data_axis!r}, "
                           f"{self.model_axis!r})")
        return 1 if self.mesh is None else self.mesh.size(self._dim(axis))

    def rank(self, axis: str) -> int:
        """This process's index along ``axis``."""
        return 0 if self.mesh is None else self.mesh.get_local_rank(self._dim(axis))

    def group(self, axis: str):
        """The process group of this rank's row (``model``) or column
        (``data``) of the mesh; None without a process group."""
        return None if self.mesh is None else self.mesh.get_group(self._dim(axis))

    def _dim(self, axis: str) -> int:
        return 0 if axis == self.data_axis else 1

    @property
    def shape(self) -> Dict[str, int]:
        return {self.data_axis: self.data_size, self.model_axis: self.model_size}

    @property
    def data_size(self) -> int:
        return self.size(self.data_axis)

    @property
    def model_size(self) -> int:
        return self.size(self.model_axis)

    @property
    def data_rank(self) -> int:
        return self.rank(self.data_axis)

    @property
    def model_rank(self) -> int:
        return self.rank(self.model_axis)


def build_mesh(cfg: MeshConfig = MeshConfig(), device=None) -> MeshSpec:
    """A 2-D ``(data, model)`` mesh over the processes of the group.

    ``data_parallel=-1`` takes every process the model axis leaves. Without
    a process group (one process, no launcher) the mesh is 1×1 and every
    sharding below is a no-op: the same code runs anywhere. ``ValueError``
    as in the JAX package when the sizes do not divide the process count.
    ``device``: this rank's device (default: the card ``initialize`` pinned)."""
    from .distributed import rank_device

    n = dist.get_world_size() if dist.is_initialized() else 1
    mp = max(1, cfg.model_parallel)
    if n % mp != 0:
        raise ValueError(f"model_parallel={mp} does not divide device count {n}")
    dp = cfg.data_parallel if cfg.data_parallel > 0 else n // mp
    if dp * mp != n:
        raise ValueError(f"data_parallel*model_parallel = {dp * mp} != {n} devices")
    device = torch.device(device) if device is not None else rank_device()
    mesh = None
    if dist.is_initialized():
        from torch.distributed.device_mesh import DeviceMesh

        kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
        mesh = DeviceMesh(kind, torch.arange(n).reshape(dp, mp),
                          mesh_dim_names=(cfg.data_axis, cfg.model_axis))
    return MeshSpec(mesh, cfg.data_axis, cfg.model_axis, device, cfg.model_shard_threshold,
                    cfg.zero1, cfg.zero1_min_size)


def is_degenerate(spec: Optional[MeshSpec]) -> bool:
    """True for no mesh or the 1×1 mesh of a process without a group: every
    helper is then a no-op."""
    return spec is None or spec.mesh is None


# --------------------------------------------------------------------------
# transport


@dataclass
class TransportStats:
    """Host round trips of CUDA tensors through gloo groups: calls, bytes
    (one way) and host seconds spent in them (copies and the collective)."""

    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0
    logged: bool = False

    def reset(self) -> None:
        self.calls, self.bytes, self.seconds = 0, 0, 0.0


transport_stats = TransportStats()


def _via_host(group, t: torch.Tensor) -> bool:
    """Whether ``t`` crosses ``group`` through host memory: a CUDA tensor on
    a gloo group."""
    if not t.is_cuda or dist.get_backend(group) != "gloo":
        return False
    if not transport_stats.logged:
        transport_stats.logged = True
        log.info("gloo process group: CUDA tensors cross it through host memory")
    return True


def _timed_transport(group, tensors: Sequence[torch.Tensor], run: Callable) -> Any:
    """``run(tensors)`` with the tensors on the host when the group needs it;
    results come back to the first tensor's device."""
    if not tensors or not _via_host(group, tensors[0]):
        return run(list(tensors))
    dev = tensors[0].device
    torch.cuda.synchronize(dev)     # the work queued before is not the transport's time
    t0 = time.perf_counter()
    out = run([t.cpu() for t in tensors])
    moved = (out.to(dev) if isinstance(out, torch.Tensor)
             else [o.to(dev) for o in out])
    transport_stats.calls += 1
    transport_stats.bytes += sum(t.numel() * t.element_size() for t in tensors)
    transport_stats.seconds += time.perf_counter() - t0
    return moved


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The sum (or ``op``) of ``t`` over ``group`` (a new tensor)."""
    def run(ts):
        buf = ts[0].clone()
        dist.all_reduce(buf, op=op, group=group)
        return buf
    return _timed_transport(group, [t.contiguous()], run)


def _all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` of ``group``, concatenated along ``dim`` in rank order."""
    def run(ts):
        parts = [torch.empty_like(ts[0]) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, ts[0], group=group)
        return torch.cat(parts, dim=dim)
    return _timed_transport(group, [t.contiguous()], run)


def _broadcast(t: torch.Tensor, group, src_index: int = 0) -> torch.Tensor:
    """``t`` of the group's rank ``src_index``, on every rank (a new tensor)."""
    src = dist.get_global_rank(group, src_index)

    def run(ts):
        buf = ts[0].clone()
        dist.broadcast(buf, src=src, group=group)
        return buf
    return _timed_transport(group, [t.contiguous()], run)


def _ppermute(t: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Send ``t`` to the rank ``shift`` places on along ``group`` (cyclic)
    and receive from the rank ``shift`` places back."""
    n = dist.get_world_size(group)
    if shift % n == 0:
        return t.clone()
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)

    def run(ts):
        out = torch.empty_like(ts[0])
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, ts[0], dst, group),
                                       dist.P2POp(dist.irecv, out, src, group)])
        for r in reqs:
            r.wait()
        return out
    return _timed_transport(group, [t.contiguous()], run)


def _all_gather_world(t: torch.Tensor) -> torch.Tensor:
    return _all_gather(t, dist.group.WORLD) if dist.is_initialized() else t


# --------------------------------------------------------------------------
# differentiable collectives


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _ppermute(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, ctx.group, -ctx.shift), None, None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n, r = dist.get_world_size(group), dist.get_rank(group)
        size = x.shape[dim] // n
        return x.narrow(dim, r * size, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        ctx.size = x.shape[dim]
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.size, ctx.size).contiguous(), None, None


class _ColumnInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, x, grad_input, dtype, group):
        ctx.grad_input, ctx.dtype, ctx.group = grad_input, dtype, group
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        dx = None
        if ctx.needs_input_grad[1]:
            dx = _all_reduce(ctx.grad_input(g.float()), ctx.group).to(ctx.dtype)
        return g, dx, None, None, None


def _axis_group(spec: Optional[MeshSpec], axis: str):
    """The group of ``axis``, or None where the collective is the identity
    (no mesh, no group)."""
    return None if is_degenerate(spec) else spec.group(axis)


def ppermute(x: torch.Tensor, spec: MeshSpec, axis: str, shift: int = 1) -> torch.Tensor:
    """``lax.ppermute`` with the cyclic permutation i → i + shift along
    ``axis``; differentiable (the gradient goes i + shift → i)."""
    group = _axis_group(spec, axis)
    return x if group is None else _PPermute.apply(x, group, shift)


def psum(x: torch.Tensor, spec: MeshSpec, axis: str) -> torch.Tensor:
    """``lax.psum`` over ``axis``; its VJP is a psum (each rank's consumer
    holds a partial term of the loss)."""
    group = _axis_group(spec, axis)
    return x if group is None else _PSum.apply(x, group)


def copy_to(x: torch.Tensor, spec: MeshSpec, axis: str) -> torch.Tensor:
    """A replicated value entering per-rank work that uses only part of it:
    identity forward, the gradient summed over ``axis`` backward."""
    group = _axis_group(spec, axis)
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, spec: MeshSpec, axis: str) -> torch.Tensor:
    """Per-rank parts summed into a value every rank then uses the same way:
    psum forward, the (replicated) gradient passed through backward."""
    group = _axis_group(spec, axis)
    return x if group is None else _ReduceFrom.apply(x, group)


def scatter_to(x: torch.Tensor, spec: MeshSpec, axis: str, dim: int) -> torch.Tensor:
    """This rank's slice of a replicated ``x`` along ``dim``; the gradient of
    the whole is gathered from every rank's slice."""
    group = _axis_group(spec, axis)
    return x if group is None else _ScatterTo.apply(x, group, dim)


def gather_from(x: torch.Tensor, spec: MeshSpec, axis: str, dim: int) -> torch.Tensor:
    """Every rank's slice along ``dim``, concatenated: a replicated value;
    each rank's gradient is its slice of the replicated gradient."""
    group = _axis_group(spec, axis)
    return x if group is None else _GatherFrom.apply(x, group, dim)


def column_input(y: torch.Tensor, x: torch.Tensor, spec: MeshSpec, axis: str,
                 grad_input: Callable[[torch.Tensor], torch.Tensor],
                 dtype: torch.dtype) -> torch.Tensor:
    """``y``, this rank's output channels of a layer computed from
    ``x.detach()`` (its backward reaches this rank's weight and bias parts
    only), joined to the whole input ``x``: backward, ``x``'s gradient is
    ``grad_input(g)``, this rank's partial product of ``y``'s gradient
    ``g`` in float32, summed over ``axis`` in float32 and rounded once to
    ``dtype``, the compute dtype, where one process's input gradient is
    rounded. (``copy_to`` would sum partials that the layer's backward
    already rounded to a bf16 compute dtype, and then round the sum: three
    roundings where one process has one, a drift that grows layer by layer
    through a deep backward.)"""
    group = _axis_group(spec, axis)
    return y if group is None else _ColumnInput.apply(y, x, grad_input, dtype, group)


def all_gather(x: torch.Tensor, spec: Optional[MeshSpec], axis: str, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, concatenated along ``dim`` (no autograd)."""
    group = _axis_group(spec, axis)
    return x if group is None else _all_gather(x, group, dim)


def pmean(tensors: Dict[str, torch.Tensor], spec: Optional[MeshSpec],
          axis: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Each scalar's mean over ``axis`` (default ``data``): metrics of the
    global batch from each rank's mean over its rows."""
    axis = axis or (spec.data_axis if spec is not None else "data")
    group = _axis_group(spec, axis)
    if group is None or not tensors:
        return tensors
    keys = list(tensors)
    flat = torch.stack([torch.as_tensor(tensors[k]).detach().float().reshape(())
                        .to(torch.as_tensor(tensors[keys[0]]).device) for k in keys])
    flat = _all_reduce(flat, group) / dist.get_world_size(group)
    return {k: flat[i] for i, k in enumerate(keys)}


# --------------------------------------------------------------------------
# the live mesh and the rows of a sharded batch


@dataclass(frozen=True)
class RowShard:
    """This rank's rows ``[start, start + count)`` of a global batch of
    ``total`` real rows (rows past ``total`` are padding)."""

    total: int
    start: int
    count: int


_LIVE: contextvars.ContextVar = contextvars.ContextVar("lvg_torch_live_mesh", default=None)
_ROWS: contextvars.ContextVar = contextvars.ContextVar("lvg_torch_rows", default=None)


@contextlib.contextmanager
def use_mesh(spec: Optional[MeshSpec], rows: Optional[RowShard] = None):
    """Make ``spec`` the live mesh (the counterpart of JAX's ambient
    ``with mesh:``; ``live_ring_mesh`` reads it) and ``rows`` the rows this
    rank holds of the current global batch (``draw_batch`` and
    ``global_rows`` read them)."""
    t1, t2 = _LIVE.set(spec), _ROWS.set(rows)
    try:
        yield spec
    finally:
        _ROWS.reset(t2)
        _LIVE.reset(t1)


def live_mesh() -> Optional[MeshSpec]:
    return _LIVE.get()


def batch_is_sharded() -> bool:
    """Whether the live batch is split over the data ranks."""
    return _ROWS.get() is not None


def data_max(spec: Optional[MeshSpec]) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """A reducer that takes a tensor (a reduction over this rank's rows,
    e.g. a max-abs) to its max over the data ranks: the value of the global
    batch, as the JAX package's SPMD reduction gives it. None where there
    is one data rank."""
    if is_degenerate(spec) or spec.data_size == 1:
        return None
    group = spec.group(spec.data_axis)
    return lambda t: _all_reduce(t, group, dist.ReduceOp.MAX)


def draw_batch(draw: Callable[[Tuple[int, ...]], torch.Tensor], shape) -> torch.Tensor:
    """``draw(shape)`` for a tensor whose axis 0 is the batch (a dropout
    mask, diffusion noise, timesteps). Inside ``use_mesh(..., rows)`` it
    draws for the global batch, ``(rows.total,) + shape[1:]``, and returns
    this rank's rows of it (rows past the real ones, padding, get zeros):
    every rank then draws what one device draws for the whole batch.
    ``ValueError`` there when ``shape[0]`` is not this rank's row count."""
    shape = tuple(int(s) for s in shape)
    rows = _ROWS.get()
    if rows is None:
        return draw(shape)
    if not shape or shape[0] != rows.count:
        raise ValueError(f"draw_batch: axis 0 of {shape} is not this rank's {rows.count} "
                         "rows of the live batch")
    full = draw((rows.total,) + shape[1:])
    end = rows.start + rows.count
    if end > rows.total:
        full = torch.cat([full, full.new_zeros((end - rows.total,) + shape[1:])])
    return full[rows.start:end]


def global_rows(x):
    """This rank's rows of ``x``, given for the live global batch (its axis
    0 has the batch's ``total`` rows; e.g. a test's draws); ``x`` itself
    outside a sharded batch. ``ValueError`` when axis 0 is not the global
    batch."""
    rows = _ROWS.get()
    if rows is None or x is None:
        return x
    if np.ndim(x) < 1 or np.shape(x)[0] != rows.total:
        raise ValueError(f"global_rows: axis 0 of {np.shape(x)} is not the live batch's "
                         f"{rows.total} rows")
    return x[rows.start:rows.start + rows.count]


def _num_rows(batch) -> int:
    leaves = batch.values() if isinstance(batch, dict) else [batch]
    return next(np.shape(v)[0] for v in leaves if np.ndim(v) >= 1)


def run_sharded(spec: Optional[MeshSpec], fn: Callable, state, batch, *args, **kwargs):
    """``fn(state, this rank's rows of batch, *args, **kwargs)`` with
    ``spec`` live and the batch's rows known to ``draw_batch``; the returned
    metrics (a dict of scalars) averaged over ``data``. On a 1×1 mesh it is
    ``fn(state, batch, ...)``."""
    if is_degenerate(spec):
        return fn(state, batch, *args, **kwargs)
    rows = batch_rows(spec, _num_rows(batch))
    with use_mesh(spec, rows):
        metrics = fn(state, shard_batch(spec, batch), *args, **kwargs)
    return pmean(metrics, spec)


def batch_rows(spec: Optional[MeshSpec], n: int) -> Optional[RowShard]:
    """The ``RowShard`` of a global batch of ``n`` rows that ``shard_batch``
    splits over ``data``, or None where it runs whole on every rank."""
    if is_degenerate(spec) or n % spec.data_size or spec.data_size == 1:
        return None
    per = n // spec.data_size
    return RowShard(n, spec.data_rank * per, per)


def padded_rows(spec: MeshSpec, n: int) -> RowShard:
    """This rank's rows of ``n`` real rows padded to a data multiple."""
    per = pad_to_multiple(n, spec.data_size) // spec.data_size
    return RowShard(n, spec.data_rank * per, per)


# --------------------------------------------------------------------------
# batches


def _take_rows(x, axis: int, spec: MeshSpec):
    n = np.shape(x)[axis]
    if n % spec.data_size:
        return x
    per = n // spec.data_size
    start = spec.data_rank * per
    if isinstance(x, torch.Tensor):
        return x.narrow(axis, start, per)
    return np.asarray(x)[(slice(None),) * axis + (slice(start, start + per),)]


def shard_batch(spec: Optional[MeshSpec], batch):
    """This data rank's rows (axis 0) of every leaf of ``batch`` (a dict, or
    one array or tensor) that every rank holds; a leaf whose rows do not
    divide the data axis stays whole (that batch runs replicated)."""
    if is_degenerate(spec) or spec.data_size == 1:
        return batch
    if isinstance(batch, dict):
        return {k: (_take_rows(v, 0, spec) if np.ndim(v) >= 1 else v) for k, v in batch.items()}
    return _take_rows(batch, 0, spec) if np.ndim(batch) >= 1 else batch


def shard_stacked_batch(spec: Optional[MeshSpec], batches):
    """As ``shard_batch`` for leaves stacked over a leading step axis: the
    rows are axis 1."""
    if is_degenerate(spec) or spec.data_size == 1:
        return batches
    return {k: (_take_rows(v, 1, spec) if np.ndim(v) >= 2 else v) for k, v in batches.items()}


def per_device_batch(global_batch: int, spec: MeshSpec) -> int:
    if global_batch % spec.data_size != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by data axis {spec.data_size}")
    return global_batch // spec.data_size


def pad_to_multiple(n: int, m: int) -> int:
    return int(math.ceil(n / m) * m)


# --------------------------------------------------------------------------
# parameter layouts


_WEIGHT_MODULES = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d)


def output_dim(module: nn.Module, name: str, leaf) -> int:
    """The dim of a torch-layout leaf that holds its output features, the
    one the Flax layout keeps last: dim 0 of a ``Linear`` or conv weight
    (Flax stores these kernels (in, out) and (*kernel, in, out)), the last
    dim of every other leaf (a raw parameter such as ``pos_embedding``, an
    ``Embedding`` table: the two frameworks share their layout)."""
    return 0 if isinstance(module, _WEIGHT_MODULES) and name == "weight" else np.ndim(leaf) - 1


def param_partition_spec(leaf, spec: MeshSpec, model_shard_threshold: Optional[int] = None,
                         out_dim: int = -1) -> Tuple:
    """The JAX package's tensor-parallel layout of one leaf: ``()``
    replicated, or the model axis on the leaf's output dim ``out_dim``
    (``output_dim``; the default, the last dim, is the Flax layout's) of a
    ≥2-D leaf of at least ``model_shard_threshold`` elements whose output
    dim the model axis divides. On a torch leaf with its ``output_dim`` it
    picks the leaves and dims JAX's rule picks on the Flax leaf."""
    if model_shard_threshold is None:
        model_shard_threshold = spec.model_shard_threshold
    shape = tuple(np.shape(leaf))
    if spec.model_size == 1 or len(shape) < 2 or math.prod(shape) < model_shard_threshold:
        return ()
    d = out_dim % len(shape)
    if shape[d] % spec.model_size:
        return ()
    parts = [None] * len(shape)
    parts[d] = spec.model_axis
    return tuple(parts)


def zero1_partition_spec(leaf, spec: MeshSpec, out_dim: int = -1) -> Tuple:
    """ZeRO-1 layout of one optimizer-moment leaf (its whole shape), as in
    the JAX package: the tensor-parallel layout (``param_partition_spec``
    with the leaf's ``out_dim``), plus the data axis on the largest dim of
    the leaf that it divides and that layout leaves free; ``()`` (or the
    TP layout) for leaves below ``zero1_min_size``, scalars and leaves with
    no such dim."""
    base = param_partition_spec(leaf, spec, out_dim=out_dim)
    shape = tuple(np.shape(leaf))
    d = _zero1_dim(shape, spec, base.index(spec.model_axis) if base else None)
    if d is None:
        return base
    parts = list(base) + [None] * (len(shape) - len(base))
    parts[d] = spec.data_axis
    return tuple(parts)


def _zero1_dim(shape: Tuple[int, ...], spec: MeshSpec, model_dim: Optional[int]) -> Optional[int]:
    """The dim of a leaf of whole ``shape`` that ZeRO-1 puts on the data
    axis (the largest one it divides, other than the model-axis dim
    ``model_dim``), or None."""
    if not shape or math.prod(shape) < spec.zero1_min_size or spec.data_size == 1:
        return None
    free = [d for d in range(len(shape)) if d != model_dim and shape[d] % spec.data_size == 0]
    return max(free, key=lambda i: shape[i]) if free else None


def tensor_parallel_leaves(spec: MeshSpec, module: nn.Module) -> Dict[str, int]:
    """The parameters of ``module`` (trainable or frozen) that
    ``param_partition_spec`` shards over the model axis, each with its dim:
    the leaves JAX's rule picks. A module already placed answers with the
    layout it was cut to."""
    if is_placed(module):
        return {k: d for k, (_, d) in _tp_keys(module).items()}
    out: Dict[str, int] = {}
    for mname, mod in module.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            parts = param_partition_spec(p, spec, out_dim=output_dim(mod, pname, p))
            if parts:
                out[f"{mname}.{pname}" if mname else pname] = parts.index(spec.model_axis)
    return out


@dataclass
class TPLayout:
    """What a placed module holds: the mesh and, per parameter name, the
    dim along which the parameter is this model rank's slice."""

    spec: MeshSpec
    dims: Dict[str, int]


def tp_layout(module: nn.Module, name: str = "weight") -> Optional[Tuple[MeshSpec, int]]:
    """(mesh, dim) when ``module``'s parameter ``name`` is a model-axis
    slice, else None."""
    layout = module.__dict__.get("_tp_layout")
    if layout is None or name not in layout.dims:
        return None
    return layout.spec, layout.dims[name]


def whole_param(module: nn.Module, name: str) -> torch.Tensor:
    """``module``'s parameter ``name``, gathered over the model axis where
    it is a slice (differentiable: its backward hands this rank the slice
    of the gradient); the parameter itself elsewhere. Raw parameters of the
    models go through this at their use."""
    p = getattr(module, name)
    tp = tp_layout(module, name)
    return p if tp is None else gather_from(p, tp[0], tp[0].model_axis, tp[1])


def is_placed(module: nn.Module) -> bool:
    """Whether ``module`` (or a submodule) holds model-axis slices."""
    return any("_tp_layout" in m.__dict__ for m in module.modules())


def _slice(t: torch.Tensor, spec: MeshSpec, dim: int) -> torch.Tensor:
    """This model rank's slice of a whole ``t`` along ``dim``."""
    size = t.shape[dim] // spec.model_size
    return t.narrow(dim, spec.model_rank * size, size)


@torch.no_grad()
def _cut(spec: MeshSpec, module: nn.Module) -> None:
    """Cut every leaf the rule lists (``tensor_parallel_leaves``) to this
    model rank's slice, in place (the ``Parameter`` objects stay, so
    optimizers keep them), and record the layout on each module that holds
    one."""
    layouts: Dict[str, TPLayout] = {}
    for key, d in tensor_parallel_leaves(spec, module).items():
        p = module.get_parameter(key)
        p.data = _slice(p.data, spec, d).clone()
        mname, _, pname = key.rpartition(".")
        layouts.setdefault(mname, TPLayout(spec, {})).dims[pname] = d
    for mname, layout in layouts.items():
        module.get_submodule(mname)._tp_layout = layout


@torch.no_grad()
def shard_params(spec: Optional[MeshSpec], module: nn.Module) -> nn.Module:
    """Place ``module`` on the mesh, in place: its parameters and buffers
    broadcast from rank 0, then every parameter ``param_partition_spec``
    lists (``tensor_parallel_leaves``) cut to this model rank's slice along
    its output dim; the ``Linear`` and conv layers then compute column-
    parallel (``models/layers.py``). A module already placed is left as it
    is. ``full_state_dict`` reads the whole leaves back."""
    if is_degenerate(spec) or is_placed(module):
        return module
    broadcast_module(module, dist.group.WORLD)
    if spec.model_size > 1:
        _cut(spec, module)
    return module


def placed_copy(spec: Optional[MeshSpec], module: nn.Module) -> nn.Module:
    """A copy of ``module`` placed on the mesh (``shard_params``): serving
    entry points cut the copy, so the caller's module stays whole. On a
    1×1 mesh, or where nothing would be cut, the module itself (made the
    same on every rank)."""
    if is_degenerate(spec) or is_placed(module) or not tensor_parallel_leaves(spec, module):
        return shard_params(spec, module)
    return shard_params(spec, copy.deepcopy(module))


def _tp_keys(module: nn.Module) -> Dict[str, Tuple[MeshSpec, int]]:
    """``state_dict`` key → (mesh, dim) of every model-axis slice."""
    out = {}
    for mname, mod in module.named_modules():
        layout = mod.__dict__.get("_tp_layout")
        if layout is not None:
            prefix = f"{mname}." if mname else ""
            out.update({prefix + n: (layout.spec, d) for n, d in layout.dims.items()})
    return out


def full_state_dict(spec: Optional[MeshSpec], module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module``'s state dict in the one-process layout: each model-axis
    slice all-gathered into its whole leaf (a collective: every rank calls
    it), the rest as ``state_dict()`` gives it. ``spec`` is the mesh the
    module was placed on (None: the one its layout records).
    ``module.state_dict()`` itself keeps the slices, so a caller that
    misses this fails on shape."""
    sd = module.state_dict()
    for key, (placed, d) in _tp_keys(module).items():
        mesh = spec or placed
        sd[key] = _all_gather(sd[key].detach(), mesh.group(mesh.model_axis), d)
    return sd


def load_full_state_dict(spec: Optional[MeshSpec], module: nn.Module,
                         sd: Dict[str, torch.Tensor], strict: bool = True):
    """``module.load_state_dict`` of a state dict in the one-process layout
    (a checkpoint of one process, a bridged Flax tree): each leaf the
    module holds as a model-axis slice is cut to this rank's slice first.
    ``spec`` as in ``full_state_dict``."""
    keys = _tp_keys(module)
    if keys:
        sd = dict(sd)
        for key, (placed, d) in keys.items():
            if key in sd:
                sd[key] = _slice(torch.as_tensor(sd[key]), spec or placed, d)
    return module.load_state_dict(sd, strict=strict)


def _bucketed(tensors: Sequence[torch.Tensor], collective: Callable) -> None:
    """``collective`` (flat tensor → flat tensor) over the tensors, one call
    per dtype and device, the results copied back in place."""
    buckets: Dict[Tuple, List[torch.Tensor]] = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    for bucket in buckets.values():
        flat = collective(torch.cat([t.reshape(-1) for t in bucket]))
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


@torch.no_grad()
def broadcast_module(module: nn.Module, group, src_index: int = 0) -> None:
    """``module``'s parameters and buffers ← those of the group's rank
    ``src_index``."""
    _bucketed([t.data for t in list(module.parameters()) + list(module.buffers())],
              lambda flat: _broadcast(flat, group, src_index))


def _state_fields(state) -> Tuple[List[Tuple[str, nn.Module]], List[Tuple[str, Any]]]:
    mods, opts = [], []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, nn.Module):
            mods.append((f.name, v))
        elif isinstance(v, (torch.optim.Optimizer, DataParallelOptimizer)):
            opts.append((f.name, v))
    return mods, opts


def _slice_dims(modules: Sequence[nn.Module]) -> Dict[int, int]:
    """id(parameter) → its model-axis dim, for every slice that the placed
    ``modules`` hold."""
    return {id(m.get_parameter(k)): d for m in modules for k, (_, d) in _tp_keys(m).items()}


def _place_state(spec: MeshSpec, state, zero1: bool):
    mods, opts = _state_fields(state)
    for _, m in mods:
        shard_params(spec, m)
    for name, opt in opts:
        if not isinstance(opt, DataParallelOptimizer):
            setattr(state, name, DataParallelOptimizer(opt, spec, zero1, [m for _, m in mods]))
    return state


def replicate_state(spec: Optional[MeshSpec], state):
    """Every module of a train state (a dataclass of modules, optimizers and
    counters) placed by ``shard_params`` (the same on every rank, the
    leaves the tensor-parallel rule lists cut to this model rank's slice:
    params, the EMA and frozen experts alike), and each optimizer wrapped to
    average its gradients over ``data`` (``DataParallelOptimizer``), its
    Adam moments following their params' slices."""
    return state if is_degenerate(spec) else _place_state(spec, state, zero1=False)


def shard_opt_state(spec: MeshSpec, optimizer: torch.optim.Optimizer,
                    modules: Sequence[nn.Module] = ()) -> "DataParallelOptimizer":
    """``optimizer`` with its moments sharded over ``data`` per the ZeRO-1
    policy (``zero1_partition_spec``) and its gradients averaged there;
    ``modules``: the placed modules that hold its params."""
    return DataParallelOptimizer(optimizer, spec, zero1=True, modules=modules)


def shard_state(spec: Optional[MeshSpec], state):
    """``replicate_state``, with the optimizers' moments sharded over
    ``data`` when the mesh says ``zero1`` (``zero1_partition_spec``)."""
    if is_degenerate(spec):
        return state
    return _place_state(spec, state, zero1=spec.zero1 and spec.data_size > 1)


class DataParallelOptimizer:
    """An optimizer that averages its parameters' gradients over the data
    axis before each update, so every rank applies the global batch's mean
    gradient and the params stay the same on every rank of a model slice.

    Tensor parallelism (``modules``: the placed modules that hold the
    params; their slices are read from them once): a slice's gradient is
    local to its model rank and a replicated param's is the same on every
    model rank (a column-parallel layer's backward sums the input gradient
    over ``model``, ``column_input``), so the reduction stays over
    ``data``; each slice's Adam moments are slices too.

    With ``zero1`` each parameter whose ``zero1_partition_spec`` names the
    data axis is updated through a slice along that dim (the largest one
    of its whole shape that the data axis divides, other than a model-axis
    slice's dim, as JAX's rule picks it): the wrapped optimizer holds this rank's slice and
    its moments only, and after the update the slices are all-gathered into
    the parameter. Moments the optimizer already holds (a run resumed into
    the plain optimizer before it was wrapped, as the trainers do) are cut
    the same way. ``state_dict`` (a collective: every rank calls it)
    gathers the moments over ``data`` and ``model`` into the layout the
    plain optimizer of one process has; ``load_state_dict`` takes that
    layout. ``param_groups`` are the wrapped optimizer's (trainers set
    their rate there)."""

    def __init__(self, optimizer: torch.optim.Optimizer, spec: MeshSpec, zero1: bool = False,
                 modules: Sequence[nn.Module] = ()):
        self.optimizer = optimizer
        self.spec = spec
        self.axis = spec.data_axis
        self.group = spec.group(self.axis)
        self.size = spec.size(self.axis)
        self.tp = _slice_dims(modules)
        self.params: List[torch.Tensor] = [p for g in optimizer.param_groups for p in g["params"]]
        self.shards: List[Tuple[torch.Tensor, int, torch.Tensor]] = []
        # moments already there (a resumed run): whole, or cut to the model
        # slice by an earlier wrap; made local below
        restored = optimizer.state_dict() if optimizer.state else None
        if restored is not None:
            restored = self._map_state(restored, self._tp_local)
        if zero1 and self.size > 1:
            r = spec.rank(self.axis)
            for g in optimizer.param_groups:
                for i, p in enumerate(g["params"]):
                    d = _zero1_dim(self._whole_shape(p), spec, self.tp.get(id(p)))
                    if d is None:
                        continue
                    size = p.shape[d] // self.size
                    shard = nn.Parameter(p.detach().narrow(d, r * size, size).clone())
                    g["params"][i] = shard
                    self.shards.append((p, d, shard))
        if restored is not None:
            optimizer.load_state_dict(self._map_state(restored, self._zero1_local))

    def _whole_shape(self, p: torch.Tensor) -> Tuple[int, ...]:
        """``p``'s whole shape (a model-axis slice widened)."""
        shape = list(p.shape)
        if id(p) in self.tp:
            shape[self.tp[id(p)]] *= self.spec.model_size
        return tuple(shape)

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)
        for p in self.params:
            if p.grad is not None:
                if set_to_none:
                    p.grad = None
                else:
                    p.grad.zero_()

    @torch.no_grad()
    def reduce_gradients(self) -> None:
        """Each gradient ← its mean over the data axis (one collective per
        dtype and device)."""
        _bucketed([p.grad for p in self.params if p.grad is not None],
                  lambda flat: _all_reduce(flat, self.group).div_(self.size))

    @torch.no_grad()
    def step(self):
        self.reduce_gradients()
        r = self.spec.rank(self.axis)
        for p, d, shard in self.shards:
            size = shard.shape[d]
            shard.copy_(p.narrow(d, r * size, size))
            shard.grad = (None if p.grad is None
                          else p.grad.narrow(d, r * size, size).contiguous())
        self.optimizer.step()
        for p, d, shard in self.shards:
            if p.grad is not None:
                p.copy_(_all_gather(shard.detach(), self.group, d))

    def _positions(self) -> Dict[int, Tuple[torch.Tensor, Optional[int]]]:
        """Position of each param in the state dict's numbering → (the
        parameter, its ZeRO-1 dim or None)."""
        by_id = {id(shard): (p, d) for p, d, shard in self.shards}
        out, i = {}, 0
        for g in self.optimizer.param_groups:
            for q in g["params"]:
                out[i] = by_id.get(id(q), (q, None))
                i += 1
        return out

    def _map_state(self, sd: Dict[str, Any], fn: Callable) -> Dict[str, Any]:
        """``sd`` with each moment ``v`` (a tensor shaped like its param)
        replaced by ``fn(v, param, zero1_dim)``."""
        pos = self._positions()
        state = {}
        for i, s in sd["state"].items():
            p, d = pos[int(i)]
            state[i] = {k: (fn(v, p, d) if isinstance(v, torch.Tensor) and v.ndim == p.ndim
                            and v.ndim > 0 else v) for k, v in s.items()}
        return {**sd, "state": state}

    def _tp_local(self, v, p, d):
        """A whole moment → this model rank's slice (one already cut stays)."""
        t = self.tp.get(id(p))
        if t is None or v.shape[t] == p.shape[t]:
            return v
        return _slice(v, self.spec, t).clone()

    def _zero1_local(self, v, p, d):
        """A model-local moment → this data rank's ZeRO-1 slice."""
        if d is None:
            return v
        size = p.shape[d] // self.size
        return v.narrow(d, self.spec.rank(self.axis) * size, size).clone()

    def _whole(self, v, p, d):
        """This rank's moment → the whole leaf (gathered over data, then model)."""
        if d is not None:
            v = _all_gather(v, self.group, d)
        t = self.tp.get(id(p))
        if t is not None:
            v = _all_gather(v, self.spec.group(self.spec.model_axis), t)
        return v

    def state_dict(self) -> Dict[str, Any]:
        sd = self.optimizer.state_dict()
        if not (self.shards or self.tp):
            return sd
        return self._map_state(sd, self._whole)

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        if self.shards or self.tp:
            sd = self._map_state(self._map_state(sd, self._tp_local), self._zero1_local)
        self.optimizer.load_state_dict(sd)


def activation_constraint(x, *parts):
    """Identity. In the JAX package it pins an activation's layout over the
    mesh so that GSPMD partitions the matmuls around it; the port's
    tensor-parallel layers (``models/layers.py``) say their collectives
    themselves and hand back whole activations on every model rank, so
    there is nothing left to pin."""
    return x
