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
- The model axis replicates compute (every rank of a data row runs the same
  step on the same rows) unless a sequence-parallel ring
  (``ops/ring_attention.py``) or the pipeline (``parallel/pipeline.py``)
  claims it. Tensor parallelism (the JAX package's ``param_partition_spec``
  sharding of large kernels) is not ported: ``check_tensor_parallel``
  refuses a mesh on which a parameter would be sharded.

Collectives over a gloo group move CUDA tensors through host memory for the
transport only (gloo's point-to-point and all-gather take CPU tensors); the
route is chosen by the group's backend and logged once, and
``transport_stats`` counts the calls, bytes and seconds it took.

Differentiable collectives (``torch.distributed`` has no autograd):
``ppermute`` (its backward sends the gradient the other way), ``psum`` (its
VJP is a psum), and the pairs that join replicated and partial values:
``copy_to`` (identity, backward psum), ``reduce_from`` (psum, backward
identity), ``scatter_to`` (this rank's slice, backward all-gather) and
``gather_from`` (all-gather, backward this rank's slice). Every rank must
run the same graph: a collective's backward runs on all ranks of its group
or on none.
"""
from __future__ import annotations

import contextlib
import contextvars
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


def param_partition_spec(leaf, spec: MeshSpec,
                         model_shard_threshold: Optional[int] = None) -> Tuple:
    """The JAX package's tensor-parallel layout of one leaf in its Flax
    layout (output dimension last): ``()`` replicated, or the model axis on
    the last dim of a ≥2-D leaf of at least ``model_shard_threshold``
    elements whose last dim the model axis divides."""
    if model_shard_threshold is None:
        model_shard_threshold = spec.model_shard_threshold
    shape = tuple(np.shape(leaf))
    if (spec.model_size > 1 and len(shape) >= 2 and math.prod(shape) >= model_shard_threshold
            and shape[-1] % spec.model_size == 0):
        return (None,) * (len(shape) - 1) + (spec.model_axis,)
    return ()


def zero1_partition_spec(leaf, spec: MeshSpec) -> Tuple:
    """ZeRO-1 layout of one optimizer-moment leaf, as in the JAX package:
    the tensor-parallel layout, plus the data axis on the largest dim of
    the leaf that it divides and that layout leaves free; ``()`` (or the TP
    layout) for leaves below ``zero1_min_size``, scalars and leaves with no
    such dim."""
    base = param_partition_spec(leaf, spec)
    shape = tuple(np.shape(leaf))
    if (not shape or math.prod(shape) < spec.zero1_min_size or spec.data_size == 1):
        return base
    parts = list(base) + [None] * (len(shape) - len(base))
    free = [d for d in range(len(shape))
            if parts[d] is None and shape[d] % spec.data_size == 0]
    if not free:
        return base
    d = max(free, key=lambda i: shape[i])
    parts[d] = spec.data_axis
    return tuple(parts)


_WEIGHT_MODULES = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d)


def tensor_parallel_leaves(spec: MeshSpec, module: nn.Module) -> List[str]:
    """The trainable parameters of ``module`` that the JAX package's
    ``param_partition_spec`` would shard over the model axis: ≥2-D, at
    least ``model_shard_threshold`` elements, output features (dim 0 of a
    Linear or conv weight, the last dim otherwise) divisible by the model
    axis."""
    if spec.model_size == 1:
        return []
    out = []
    for mname, mod in module.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            if not p.requires_grad or p.ndim < 2 or p.numel() < spec.model_shard_threshold:
                continue
            out_dim = p.shape[0] if (isinstance(mod, _WEIGHT_MODULES)
                                     and pname == "weight") else p.shape[-1]
            if out_dim % spec.model_size == 0:
                out.append(f"{mname}.{pname}" if mname else pname)
    return out


def check_tensor_parallel(spec: Optional[MeshSpec], *modules: nn.Module) -> None:
    """``NotImplementedError`` when the mesh would shard a parameter over the
    model axis (tensor parallelism is not ported); otherwise the model axis
    replicates compute, as the JAX package's does below the threshold."""
    if is_degenerate(spec) or spec.model_size == 1:
        return
    leaves = [n for m in modules if m is not None for n in tensor_parallel_leaves(spec, m)]
    if leaves:
        raise NotImplementedError(
            f"tensor parallelism is not ported (ROADMAP §1 item 9): model_parallel="
            f"{spec.model_size} would shard {len(leaves)} parameter(s) of at least "
            f"model_shard_threshold={spec.model_shard_threshold} elements, e.g. {leaves[0]!r}; "
            f"raise mesh.model_shard_threshold above the largest parameter")


@torch.no_grad()
def shard_params(spec: Optional[MeshSpec], module: nn.Module) -> nn.Module:
    """Place ``module``'s parameters and buffers on the mesh: the same on
    every rank, broadcast from rank 0 (pure data parallelism; a mesh that
    would shard a parameter raises, see ``check_tensor_parallel``)."""
    if is_degenerate(spec):
        return module
    check_tensor_parallel(spec, module)
    broadcast_module(module, dist.group.WORLD)
    return module


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


def replicate_state(spec: Optional[MeshSpec], state):
    """Every module of a train state (a dataclass of modules, optimizers and
    counters) the same on every rank, and each optimizer wrapped to average
    its gradients over ``data`` (``DataParallelOptimizer``)."""
    if is_degenerate(spec):
        return state
    mods, opts = _state_fields(state)
    check_tensor_parallel(spec, *(m for _, m in mods))
    for _, m in mods:
        broadcast_module(m, dist.group.WORLD)
    for name, opt in opts:
        if not isinstance(opt, DataParallelOptimizer):
            setattr(state, name, DataParallelOptimizer(opt, spec, zero1=False))
    return state


def shard_opt_state(spec: MeshSpec, optimizer: torch.optim.Optimizer) -> "DataParallelOptimizer":
    """``optimizer`` with its moments sharded over ``data`` per the ZeRO-1
    policy (``zero1_partition_spec``) and its gradients averaged there."""
    return DataParallelOptimizer(optimizer, spec, zero1=True)


def shard_state(spec: Optional[MeshSpec], state):
    """``replicate_state``, with the optimizers' moments sharded over
    ``data`` when the mesh says ``zero1`` (``zero1_partition_spec``)."""
    if is_degenerate(spec):
        return state
    state = replicate_state(spec, state)
    if spec.zero1 and spec.data_size > 1:
        for name, opt in _state_fields(state)[1]:
            setattr(state, name, shard_opt_state(spec, opt.optimizer))
    return state


class DataParallelOptimizer:
    """An optimizer that averages its parameters' gradients over the data
    axis before each update, so every rank applies the global batch's mean
    gradient and the params stay the same on every rank.

    With ``zero1`` each parameter whose ``zero1_partition_spec`` names the
    data axis is updated through a slice along that dim: the wrapped
    optimizer holds this rank's slice and its moments only, and after the
    update the slices are all-gathered into the parameter; moments the
    optimizer already holds (a run resumed into the plain optimizer before
    it was wrapped, as the trainers do) are sliced the same way. ``state_dict``
    (a collective: every rank calls it) gathers the moments into the
    layout the plain optimizer has; ``load_state_dict`` takes that layout.
    ``param_groups`` are the wrapped optimizer's (trainers set their rate
    there)."""

    def __init__(self, optimizer: torch.optim.Optimizer, spec: MeshSpec, zero1: bool = False):
        self.optimizer = optimizer
        self.spec = spec
        self.axis = spec.data_axis
        self.group = spec.group(self.axis)
        self.size = spec.size(self.axis)
        self.params: List[torch.Tensor] = [p for g in optimizer.param_groups for p in g["params"]]
        self.shards: List[Tuple[torch.Tensor, int, torch.Tensor]] = []
        if zero1 and self.size > 1:
            # moments already there (a resumed run) are sliced like the params
            restored = optimizer.state_dict() if optimizer.state else None
            r = spec.rank(self.axis)
            for g in optimizer.param_groups:
                for i, p in enumerate(g["params"]):
                    layout = zero1_partition_spec(p, spec)
                    if self.axis not in layout:
                        continue
                    d = layout.index(self.axis)
                    size = p.shape[d] // self.size
                    shard = nn.Parameter(p.detach().narrow(d, r * size, size).clone())
                    g["params"][i] = shard
                    self.shards.append((p, d, shard))
            if restored is not None:
                self.load_state_dict(restored)

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

    def _shard_index(self) -> Dict[int, Tuple[int, torch.Tensor, int]]:
        """Position of each sharded param in the state dict's numbering →
        (dim, param)."""
        by_id = {id(shard): (d, p) for p, d, shard in self.shards}
        out, i = {}, 0
        for g in self.optimizer.param_groups:
            for q in g["params"]:
                if id(q) in by_id:
                    out[i] = by_id[id(q)]
                i += 1
        return out

    def state_dict(self) -> Dict[str, Any]:
        sd = self.optimizer.state_dict()
        if not self.shards:
            return sd
        index = self._shard_index()
        state = {}
        for i, s in sd["state"].items():
            if i in index:
                d, p = index[i]
                s = {k: (_all_gather(v, self.group, d)
                         if isinstance(v, torch.Tensor) and v.ndim == p.ndim else v)
                     for k, v in s.items()}
            state[i] = s
        return {**sd, "state": state}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        if self.shards:
            index = self._shard_index()
            r = self.spec.rank(self.axis)
            state = {}
            for i, s in sd["state"].items():
                i = int(i)
                if i in index:
                    d, p = index[i]
                    size = p.shape[d] // self.size
                    s = {k: (v.narrow(d, r * size, size).clone()
                             if isinstance(v, torch.Tensor) and v.ndim == p.ndim else v)
                         for k, v in s.items()}
                state[i] = s
            sd = {**sd, "state": state}
        self.optimizer.load_state_dict(sd)


def activation_constraint(x, *parts):
    """Identity: the JAX package's tensor-parallel activation hints have no
    counterpart until tensor parallelism is ported."""
    return x
