"""A local process group for checks of the port's multi-GPU parallelism,
and the functions the CPU tests run on each of its ranks.

``LocalGroup(n, init_file)`` starts ``n`` processes (``spawn``), joins them
through a ``torch.distributed.FileStore`` at ``init_file`` (no TCP port, so
several groups on one machine never collide) and runs ``group.run(fn,
*args)`` on every rank at once: ``fn`` must be importable by its module
path (a module-level function), its arguments picklable; each rank's result
comes back with tensors turned into numpy arrays. The CPU tests use it with
gloo on the CPU and ``chip_smoke.py`` with two gloo ranks sharing one card;
``torchrun`` is the launcher of real runs.

The functions import the port only, never JAX: the tests compute the JAX
side in their own process and hand both sides the same numpy inputs.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import time
import traceback
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from lipreading_video_generation_tpu_torch.core import config as tcfg
from lipreading_video_generation_tpu_torch.parallel import mesh as pmesh
from lipreading_video_generation_tpu_torch.parallel.distributed import (
    global_batch_from_local, is_primary, local_batch_slice)

_TIMEOUT_S = 900.0   # longest a task may run before ``run`` gives up on its ranks


def _to_host(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy() if x.dtype != torch.bfloat16 else \
            x.detach().float().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _worker(rank: int, world_size: int, init_file: str, device: str, backend: Optional[str],
            tasks, results) -> None:
    import torch.distributed as dist

    from lipreading_video_generation_tpu_torch.parallel.distributed import initialize, shutdown

    try:
        initialize(rank=rank, world_size=world_size, device=device, backend=backend,
                   store=dist.FileStore(init_file, world_size))
    except Exception:  # noqa: BLE001 — handed to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
        return
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args, kwargs = task
            try:
                results.put((rank, True, _to_host(fn(*args, **kwargs))))
            except Exception:  # noqa: BLE001 — handed to the parent, which raises it
                results.put((rank, False, traceback.format_exc()))
    finally:
        shutdown()


class LocalGroup:
    """``world_size`` worker processes in one process group on ``device``
    (``"cpu"``: gloo; a card: ``backend`` says which, e.g. gloo for two
    ranks on one card)."""

    def __init__(self, world_size: int, init_file: str, device: str = "cpu",
                 backend: Optional[str] = None):
        ctx = mp.get_context("spawn")
        self.world_size = world_size
        self._tasks = [ctx.Queue() for _ in range(world_size)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(target=_worker, daemon=True,
                                   args=(r, world_size, init_file, device, backend,
                                         self._tasks[r], self._results))
                       for r in range(world_size)]
        for p in self._procs:
            p.start()

    def run(self, fn: Callable, *args, **kwargs) -> List[Any]:
        """``fn(*args, **kwargs)`` on every rank; the results in rank order.
        ``RuntimeError`` with the traceback of the first rank that raised."""
        for q in self._tasks:
            q.put((fn, args, kwargs))
        out: List[Any] = [None] * self.world_size
        errors = []
        waited = 0.0
        pending = self.world_size
        while pending:
            try:
                rank, ok, value = self._results.get(timeout=1.0)
            except queue.Empty:
                waited += 1.0
                dead = [r for r, p in enumerate(self._procs) if not p.is_alive()]
                if dead or waited > _TIMEOUT_S:
                    raise RuntimeError(f"worker ranks {dead} ended" if dead else
                                       f"no result within {_TIMEOUT_S} s")
                continue
            pending -= 1
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise RuntimeError("\n".join(errors))
        return out

    def close(self) -> None:
        """Stop the workers and wait for them (killing those that hang)."""
        for q, p in zip(self._tasks, self._procs):
            if p.is_alive():
                q.put(None)
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)

    def __enter__(self) -> "LocalGroup":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# the tasks


def _threads():
    torch.set_num_threads(1)    # several ranks share the test worker's cores


def _mesh(mesh_kw):
    return pmesh.build_mesh(tcfg.MeshConfig(**(mesh_kw or {})))


def _sd(params):
    return {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


def mesh_info(mesh_kw):
    spec = _mesh(mesh_kw)
    return {"shape": spec.shape, "data_rank": spec.data_rank, "model_rank": spec.model_rank,
            "primary": is_primary(), "slice": local_batch_slice(8)}


def mesh_error(mesh_kw):
    try:
        _mesh(mesh_kw)
    except ValueError as e:
        return str(e)
    return None


def shard_rows(batch, stacked):
    spec = _mesh({})
    rows = pmesh.batch_rows(spec, len(batch["x"]))
    local = {"x": np.arange(2) + 10 * spec.data_rank}
    return {"batch": pmesh.shard_batch(spec, batch),
            "stacked": pmesh.shard_stacked_batch(spec, stacked),
            "rows": None if rows is None else (rows.total, rows.start, rows.count),
            "global": global_batch_from_local(spec, local, 2 * spec.data_size)["x"]}


def collectives():
    """Gradients of the differentiable collectives on rank-dependent inputs."""
    spec = _mesh({})
    r = float(spec.data_rank + 1)
    ax = spec.data_axis
    out = {}
    x = torch.tensor([1.0, 2.0, 3.0], requires_grad=True)
    # psum: a partial loss a rank; d(Σ_ranks w_r·psum(x·r))/dx_r = r·Σ w
    (pmesh.psum(x * r, spec, ax) * r).sum().backward()
    out["psum_grad"] = x.grad.clone()
    x.grad = None
    (pmesh.ppermute(x * r, spec, ax, 1) * torch.tensor([1.0, 10.0, 100.0]) * r).sum().backward()
    out["ppermute_grad"] = x.grad.clone()
    x.grad = None
    # replicated consumers: copy_to / reduce_from and scatter_to / gather_from
    (pmesh.copy_to(x, spec, ax) * r).sum().backward()
    out["copy_to_grad"] = x.grad.clone()
    x.grad = None
    y = pmesh.reduce_from(x * r, spec, ax)
    (y * y).sum().backward()
    out["reduce_from"] = y.detach()
    out["reduce_from_grad"] = x.grad.clone()
    z = torch.arange(4.0, requires_grad=True)
    part = pmesh.scatter_to(z, spec, ax, 0)
    whole = pmesh.gather_from(part * part, spec, ax, 0)
    (whole * torch.tensor([1.0, 2.0, 3.0, 4.0])).sum().backward()
    out["scatter_gather"] = whole.detach()
    out["scatter_gather_grad"] = z.grad.clone()
    out["pmean"] = pmesh.pmean({"a": torch.tensor(r)}, spec)["a"]
    return out


# ---------------------------------------------------------------------------
# data-parallel training


def whole_grads(spec, model):
    """Each parameter's gradient in the one-process layout: the model-axis
    slices of a tensor-parallel model gathered."""
    leaves = {} if spec is None else pmesh.tensor_parallel_leaves(spec, model)
    out = {}
    for n, p in model.named_parameters():
        g = p.grad
        if g is not None and n in leaves:
            g = pmesh.all_gather(g, spec, spec.model_axis, leaves[n])
        out[n] = None if g is None else g.clone()
    return out


def held_bytes(modules, optimizers, spec=None):
    """Bytes of the params of ``modules`` and of the Adam moments of
    ``optimizers`` that this rank holds; with ``spec``, the mesh the modules
    were placed on, what one process holds of the same state instead (each
    model-axis slice, and a ZeRO-1 moment's slice, at its whole size)."""
    size = {}
    for m in modules:
        leaves = {} if spec is None else pmesh.tensor_parallel_leaves(spec, m)
        for n, p in m.named_parameters():
            size[id(p)] = p.numel() * p.element_size() * (
                spec.model_size if n in leaves else 1)
    total = sum(size.values())
    for opt in optimizers:
        inner = getattr(opt, "optimizer", opt)
        whole = {id(s): id(p) for p, _, s in getattr(opt, "shards", [])}
        for q, st in inner.state.items():
            for k, v in st.items():
                if k in ("exp_avg", "exp_avg_sq"):
                    total += (v.numel() * v.element_size() if spec is None
                              else size[whole.get(id(q), id(q))])
    return total


def _plant(state_opt, model, spec, fault, fault_leaf):
    """Scale, on world rank 1, the gradient of ``fault_leaf`` (a name or a
    list of names; every gradient when None) by ``fault`` before the
    reduction."""
    import torch.distributed as dist

    if fault is None or dist.get_rank() != 1:
        return
    opt, reduce = state_opt, state_opt.reduce_gradients
    named = dict(model.named_parameters())
    names = [fault_leaf] if isinstance(fault_leaf, str) else fault_leaf
    targets = None if names is None else {id(named[n]) for n in names}

    def faulty():
        for p in opt.params:
            if p.grad is not None and (targets is None or id(p) in targets):
                p.grad.mul_(fault)
        reduce()

    opt.reduce_gradients = faulty


def diffusion_dp(cfg_kw, params, batches, draws, mesh_kw, ckpt_dir=None, device="cpu",
                 seed=0, fault=None, fault_leaf=None):
    """Steps of the diffusion trainer on this rank's rows, from ``params``
    (None: ``create_state``'s from ``seed``), with t and noise given for the
    global batch (``draws``; None: drawn from the state's generator). The
    reduced gradients of the first step (and of the last, ``last_grads``,
    where there are two or more), the losses and step times, the
    params and EMA after the last step (all three whole, in the one-process
    layout; ``local``: this rank's params as it holds them), the optimizer's
    per-param moment shapes, the tensor-parallel leaves and the bytes of
    params, EMA and moments this rank holds (``bytes_one``: one process's,
    counted from the same state). ``mesh_kw`` None: one process,
    no mesh. ``fault``: world rank 1 scales its gradient of ``fault_leaf``
    (a name or names; all of them when None) by it before the reduction (a
    planted fault)."""
    from lipreading_video_generation_tpu_torch.pipelines import train_diffusion as ttd

    on_card = torch.device(device).type == "cuda"
    if not on_card:
        _threads()
    cfg = tcfg.DiffusionConfig(**cfg_kw)
    spec = None if mesh_kw is None else _mesh(mesh_kw)
    state = ttd.create_state(cfg, seed=seed, device=device)
    if params is not None:
        state.model.load_state_dict(_sd(params))
        state.ema.load_state_dict(_sd(params))
    state = pmesh.shard_state(spec, state)
    _plant(state.optimizer, state.model, spec, fault, fault_leaf)
    pmesh.transport_stats.reset()      # the steps' transport, not the params' broadcast
    out = {"losses": [], "step_ms": [], "step_transport_s": 0.0}
    for i, batch in enumerate(batches):
        t, noise = draws[i] if draws is not None else (None, None)
        if on_card:
            torch.cuda.synchronize()
        t0, moved = time.perf_counter(), pmesh.transport_stats.seconds
        m = pmesh.run_sharded(spec, ttd.train_step, state, batch, cfg, t, noise)
        out["losses"].append(float(m["loss"]))
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["step_transport_s"] += pmesh.transport_stats.seconds - moved
        if i == 0:
            out["grads"] = whole_grads(spec, state.model)
        elif i == len(batches) - 1:
            out["last_grads"] = whole_grads(spec, state.model)
    out["params"] = pmesh.full_state_dict(spec, state.model)
    out["ema"] = pmesh.full_state_dict(spec, state.ema)
    out["local"] = state.model.state_dict()
    out["tp"] = {} if spec is None else pmesh.tensor_parallel_leaves(spec, state.model)
    out["bytes"] = held_bytes([state.model, state.ema], [state.optimizer])
    out["bytes_one"] = held_bytes([state.model, state.ema], [state.optimizer], spec)
    opt = state.optimizer
    inner = getattr(opt, "optimizer", opt)
    names = {id(p): n for n, p in state.model.named_parameters()}
    shards = {id(s): (names[id(p)], d) for p, d, s in getattr(opt, "shards", [])}
    out["moments"] = {}
    out["shards"] = len(getattr(opt, "shards", []))
    for g in inner.param_groups:
        for p in g["params"]:
            name, d = shards.get(id(p), (names.get(id(p)), None))
            out["moments"][name] = (tuple(inner.state[p]["exp_avg"].shape), d)
    if ckpt_dir is not None:
        path = ttd.save_checkpoint(ckpt_dir, state)
        out["checkpoint"] = {k: v for k, v in torch.load(path, weights_only=False)[
            "opt_state"]["state"].items()}
        out["checkpoint"] = {k: tuple(v["exp_avg"].shape) for k, v in out["checkpoint"].items()}
    return out


def gan_dp(cfg_kw, params, prep, mesh_kw, steps=1):
    """G+D steps of the GAN trainer on this rank's rows of an already
    prepared batch (``prepare_batch`` passes it through): the metrics, both
    networks' params after the steps and their gradients of the last step
    (whole, in the one-process layout), the tensor-parallel leaves of each
    network and SyncNet, and each rank's own slices (``local``)."""
    from lipreading_video_generation_tpu_torch.models import convert
    from lipreading_video_generation_tpu_torch.pipelines import train_gan as ttg

    _threads()
    ttg.prepare_batch = lambda b, cfg, audio_cfg, device: {
        k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    cfg = tcfg.GanConfig(**cfg_kw)
    spec = None if mesh_kw is None else _mesh(mesh_kw)
    state = ttg.create_state(cfg, syncnet_params=convert.syncnet_state_dict_from_flax(
        params["sync"]), device="cpu")
    state.gen.load_state_dict(convert.generator_state_dict_from_flax(params["gen"]))
    state.disc.load_state_dict(convert.discriminator_state_dict_from_flax(params["disc"]))
    state = pmesh.shard_state(spec, state)
    metrics = [pmesh.run_sharded(spec, ttg.train_step, state, prep, cfg)
               for _ in range(steps)]
    nets = {"gen": state.gen, "disc": state.disc, "sync": state.syncnet}
    return {"metrics": metrics,
            "gen": pmesh.full_state_dict(spec, state.gen),
            "disc": pmesh.full_state_dict(spec, state.disc),
            "grads": {k: whole_grads(spec, nets[k]) for k in ("gen", "disc")},
            "tp": {k: ({} if spec is None else pmesh.tensor_parallel_leaves(spec, m))
                   for k, m in nets.items()},
            "local": {k: nets[k].state_dict() for k in ("gen", "disc")}}


def tensor_parallel_refusal(threshold, batch=None, mesh=True):
    """A model_parallel=2 mesh over a ViViT whose 256×1024 MLP kernels reach
    the threshold (``mesh`` False: one process, no mesh): the leaves it
    shards, the shapes each rank holds and, given a ``batch``, one train
    step's loss and the params after it (whole)."""
    from lipreading_video_generation_tpu_torch.pipelines import train_vivit as ttv

    _threads()
    spec = _mesh({"model_parallel": 2, "model_shard_threshold": threshold}) if mesh else None
    state = ttv.create_state(tcfg.ViViTConfig(num_layers=1, num_classes=4, dtype="float32"),
                             device="cpu")
    state = pmesh.shard_state(spec, state)
    out = {"leaves": {} if spec is None else pmesh.tensor_parallel_leaves(spec, state.model),
           "shapes": {k: tuple(v.shape) for k, v in state.model.state_dict().items()}}
    if batch is not None:
        out["loss"] = float(pmesh.run_sharded(spec, ttv.train_step, state, batch)["loss"])
        out["params"] = pmesh.full_state_dict(spec, state.model)
    return out


def diffusion_train_loop(cfg_kw, batches, ckpt_dir, mesh_kw, num_steps=None,
                         checkpoint_every=None):
    """``train_diffusion.train`` itself on the group: the same feed on every
    rank, resuming from ``ckpt_dir``'s latest checkpoint, a checkpoint every
    ``checkpoint_every`` steps (default: at the end; the primary rank writes
    it) until ``num_steps`` (default: the feed's length)."""
    from lipreading_video_generation_tpu_torch.pipelines import train_diffusion as ttd

    _threads()
    cfg = tcfg.DiffusionConfig(**cfg_kw)
    feed = iter(batches)
    spec = _mesh(mesh_kw)
    state = ttd.train(cfg, lambda: next(feed, None), num_steps=num_steps or len(batches),
                      checkpoint_dir=ckpt_dir, checkpoint_every=checkpoint_every or len(batches),
                      mesh_spec=spec, device="cpu")
    return {"step": state.step, "params": pmesh.full_state_dict(spec, state.model),
            "files": sorted(os.listdir(ckpt_dir))}


# ---------------------------------------------------------------------------
# data-parallel serving


def sample_video_dp(cfg_kw, params, cond, audio, seed, steps, mesh_kw):
    from lipreading_video_generation_tpu_torch.models.unet_audio import UNetAudio
    from lipreading_video_generation_tpu_torch.pipelines import sample_diffusion as tsd

    _threads()
    cfg = tcfg.DiffusionConfig(**cfg_kw)
    model = UNetAudio(cfg).eval()
    model.load_state_dict(_sd(params))
    spec = None if mesh_kw is None else _mesh(mesh_kw)
    return tsd.sample_video(model, cond, audio, cfg, num_inference_steps=steps, eta=1.0,
                            mesh_spec=spec, generator=torch.Generator().manual_seed(seed))


def generate_frames_dp(gen_params, frames, boxes, mels, width, gan_kw, batch, mesh_kw,
                       device="cpu"):
    from lipreading_video_generation_tpu_torch.pipelines import inference as tinf

    if torch.device(device).type != "cuda":
        _threads()
    spec = None if mesh_kw is None else _mesh(mesh_kw)
    return tinf.generate_frames(_sd(gen_params), frames, boxes, mels,
                                tcfg.GanConfig(model_width=width, dtype="float32", **gan_kw),
                                tcfg.PreprocessConfig(gen_batch_size=batch),
                                model_width=width, mesh_spec=spec, device=device)


def predict_sharded_dp(cfg_kw, params, clips, int8, mesh_kw):
    from lipreading_video_generation_tpu_torch.models.vivit import ViViT
    from lipreading_video_generation_tpu_torch.pipelines import train_vivit as ttv

    _threads()
    model = ViViT(tcfg.ViViTConfig(**cfg_kw)).eval()
    model.load_state_dict(_sd(params))
    spec = None if mesh_kw is None else _mesh(mesh_kw)
    return ttv.predict_sharded(model, clips, mesh_spec=spec, int8=int8)


# ---------------------------------------------------------------------------
# sequence parallelism


def ring(q, k, v, do, causal, mesh_kw, axis):
    from lipreading_video_generation_tpu_torch.ops.ring_attention import ring_attention

    _threads()
    spec = _mesh(mesh_kw)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ring_attention(*leaves, mesh=spec, axis_name=axis, causal=causal)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    return {"out": out.detach(), "grads": list(grads)}


def vivit_sp(cfg_kw, params, clips, mesh_kw):
    """ViViT logits with ``sequence_parallel`` under the live mesh, and the
    gradient of their sum."""
    from lipreading_video_generation_tpu_torch.models.vivit import ViViT

    _threads()
    model = ViViT(tcfg.ViViTConfig(**cfg_kw)).eval()
    model.load_state_dict(_sd(params))
    spec = _mesh(mesh_kw)
    with pmesh.use_mesh(spec):
        logits = model(torch.from_numpy(clips))
        logits.sum().backward()
    return {"logits": logits.detach(),
            "grads": {n: p.grad for n, p in model.named_parameters()}}


def vivit_sp_over_data(cfg_kw, params):
    """A ring over the data axis while the batch is sharded over it."""
    from lipreading_video_generation_tpu_torch.models.vivit import ViViT

    cfg = tcfg.ViViTConfig(**cfg_kw, sequence_parallel=True, sequence_axis="data")
    model = ViViT(cfg).eval()
    model.load_state_dict(_sd(params))
    spec = _mesh({})
    clips = torch.zeros(4, 5, 32, 32, 1)
    with torch.no_grad(), pmesh.use_mesh(spec, pmesh.batch_rows(spec, 4)):
        return model(pmesh.shard_batch(spec, clips))


def unet_sp(cfg_kw, params, xt, cond, audio, t, mesh_kw):
    from lipreading_video_generation_tpu_torch.models.unet_audio import UNetAudio

    _threads()
    cfg = tcfg.DiffusionConfig(**cfg_kw)
    model = UNetAudio(cfg).eval()
    model.load_state_dict(_sd(params))
    spec = _mesh(mesh_kw)
    nchw = [torch.from_numpy(a).permute(0, 3, 1, 2) for a in (xt, cond)]
    rows = pmesh.batch_rows(spec, len(t))
    with torch.no_grad(), pmesh.use_mesh(spec, rows):
        out = model(*(pmesh.shard_batch(spec, a) for a in nchw),
                    pmesh.shard_batch(spec, torch.from_numpy(audio)),
                    pmesh.shard_batch(spec, torch.from_numpy(t)))
    return pmesh.all_gather(out.permute(0, 2, 3, 1), spec, spec.data_axis)


# ---------------------------------------------------------------------------
# pipeline parallelism


def pp_forward(cfg_kw, pp_params, clips, n_micro, mesh_kw):
    """``apply_pipelined`` logits on this data rank's rows, gathered."""
    from lipreading_video_generation_tpu_torch.models.vivit import apply_pipelined

    _threads()
    spec = _mesh(mesh_kw)
    with torch.no_grad():
        logits = apply_pipelined(tcfg.ViViTConfig(**cfg_kw), _sd(pp_params),
                                 pmesh.shard_batch(spec, torch.from_numpy(clips)), spec,
                                 n_micro=n_micro)
    return pmesh.all_gather(logits, spec, spec.data_axis)


def pp_step(cfg_kw, params, batch, n_micro, mesh_kw):
    """One pipeline train step from canonical params: the loss, each
    parameter's (data-averaged) gradient in the canonical naming, and the
    updated params gathered to the canonical layout."""
    from lipreading_video_generation_tpu_torch.models.vivit import pp_params
    from lipreading_video_generation_tpu_torch.parallel import pipeline as pipe
    from lipreading_video_generation_tpu_torch.pipelines import train_vivit as ttv

    _threads()
    cfg = tcfg.ViViTConfig(**cfg_kw)
    spec = _mesh(mesh_kw)
    state = ttv.create_state_pp(cfg, 0, spec, device="cpu")
    state.model.load_pp_state_dict(pp_params(_sd(params), cfg))
    state = ttv.place_pp_state(spec, state)
    step, _ = ttv.make_pp_train_step(cfg, spec, n_micro)
    m = pmesh.run_sharded(spec, step, state, batch)
    grads = {n: p.grad for n, p in state.model.named_parameters()}
    layers = pipe.stage_layers(cfg.num_layers, spec)
    canon_grads = {}
    for n, g in grads.items():
        hit = pipe.split_block_key(n)
        if hit is None:
            canon_grads[n] = g
        else:
            canon_grads[f"blocks.{layers[hit[0]]}.{hit[1]}"] = g
    canonical = ttv.pp_to_canonical(state, cfg, spec)
    return {"loss": float(m["loss"]), "grads": canon_grads,
            "params": canonical.model.state_dict(), "stage": list(layers),
            "stage_leaf": tuple(state.model.pp_state_dict()["blocks.qkv.weight"].shape)}


def pp_train_loop(cfg_kw, batches, mesh_kw):
    """``train_vivit.train`` with ``pipeline_parallel``: the canonical state
    it hands back, and its eval."""
    from lipreading_video_generation_tpu_torch.pipelines import train_vivit as ttv

    _threads()
    cfg = tcfg.Config(vivit=tcfg.ViViTConfig(**cfg_kw), mesh=tcfg.MeshConfig(**mesh_kw))
    state, best = ttv.train(cfg, lambda: iter(batches), lambda: iter(batches[:1]),
                            num_epochs=1, device="cpu")
    return {"step": state.step, "keys": sorted(state.model.state_dict()),
            "params": state.model.state_dict(), "best": best}


# ---------------------------------------------------------------------------
# tensor parallelism


def vivit_tp(cfg_kw, params, clips, mesh_kw):
    """ViViT logits on a mesh whose model axis shards its leaves (placed by
    ``shard_params``; with ``sequence_parallel`` in ``cfg_kw`` the ring
    runs over the same axis), and the gradient of their sum, whole. ``mesh_kw``
    None: one process."""
    from lipreading_video_generation_tpu_torch.models.vivit import ViViT

    _threads()
    model = ViViT(tcfg.ViViTConfig(**cfg_kw)).eval()
    model.load_state_dict(_sd(params))
    spec = None if mesh_kw is None else _mesh(mesh_kw)
    pmesh.shard_params(spec, model)
    with pmesh.use_mesh(spec):
        logits = model(torch.from_numpy(clips))
        logits.sum().backward()
    return {"logits": logits.detach(), "grads": whole_grads(spec, model),
            "tp": {} if spec is None else pmesh.tensor_parallel_leaves(spec, model)}


def predict_sharded_tp(cfg_kw, params, clips, int8, mesh_kw):
    """``predict_sharded`` log-probs, the caller's params after the call and
    the leaves the served copy shards."""
    from lipreading_video_generation_tpu_torch.models.vivit import ViViT
    from lipreading_video_generation_tpu_torch.pipelines import train_vivit as ttv

    _threads()
    model = ViViT(tcfg.ViViTConfig(**cfg_kw)).eval()
    model.load_state_dict(_sd(params))
    spec = None if mesh_kw is None else _mesh(mesh_kw)
    out = ttv.predict_sharded(model, clips, mesh_spec=spec, int8=int8)
    return {"out": out, "after": model.state_dict(), "placed": pmesh.is_placed(model),
            "tp": {} if spec is None else pmesh.tensor_parallel_leaves(spec, model)}


def pp_placement(cfg_kw, mesh_kw):
    """A pipeline state placed for training (``place_pp_state``): whether
    any leaf was cut by the tensor-parallel rule, and each stage leaf's
    shape before and after placement."""
    from lipreading_video_generation_tpu_torch.pipelines import train_vivit as ttv

    _threads()
    cfg = tcfg.ViViTConfig(**cfg_kw)
    spec = _mesh(mesh_kw)
    state = ttv.create_state_pp(cfg, 0, spec, device="cpu")
    before = {k: tuple(v.shape) for k, v in state.model.state_dict().items()}
    state = ttv.place_pp_state(spec, state)
    return {"placed": pmesh.is_placed(state.model), "before": before,
            "after": {k: tuple(v.shape) for k, v in state.model.state_dict().items()},
            "rule": pmesh.tensor_parallel_leaves(spec, state.model)}


def cli_main(argv, watch_root=None, device="cpu"):
    """``cli.main(argv, device=device)`` on every rank: {"rc": its exit
    code, "wrote": the paths under ``watch_root`` this rank wrote (``open``
    for writing, ``os.replace`` onto, ``torch.save`` to), recorded on every
    rank but the primary (which the command leaves its files to)}."""
    import builtins

    import torch.distributed as dist

    from lipreading_video_generation_tpu_torch import cli

    if torch.device(device).type != "cuda":
        _threads()
    wrote, patched = [], []
    if watch_root is not None and dist.get_rank() != 0:
        root = os.path.abspath(watch_root)

        def note(path) -> None:
            if isinstance(path, (str, os.PathLike)) and \
                    os.path.abspath(os.fspath(path)).startswith(root):
                wrote.append(os.fspath(path))

        real_open, real_replace, real_save = builtins.open, os.replace, torch.save

        def watched_open(file, mode="r", *a, **k):
            if any(c in mode for c in "wax+"):
                note(file)
            return real_open(file, mode, *a, **k)

        def watched_replace(src, dst, *a, **k):
            note(dst)
            return real_replace(src, dst, *a, **k)

        def watched_save(obj, f, *a, **k):
            note(f)
            return real_save(obj, f, *a, **k)

        for owner, name, fn in ((builtins, "open", watched_open),
                                (os, "replace", watched_replace), (torch, "save", watched_save)):
            patched.append((owner, name, getattr(owner, name)))
            setattr(owner, name, fn)
    try:
        rc = cli.main(list(argv), device=device)
    finally:
        for owner, name, fn in patched:
            setattr(owner, name, fn)
    return {"rc": rc, "wrote": wrote}


def preprocess_shares(n_clips, host_id=None, num_hosts=None):
    """The share of ``n_clips`` clips (their indices) that ``preprocess-gan``
    hands this rank's ``preprocess_dataset``, through the host id and count
    the CLI chooses (the pipeline and the detector stubbed out), or the
    exit code of a usage error."""
    from lipreading_video_generation_tpu_torch import cli
    from lipreading_video_generation_tpu_torch.pipelines import offline_preprocess as op

    seen = {}

    def fake(s3fd, records, out, cfg, host_id, num_hosts):
        seen["ids"] = [r for r in op.shard_for_host(list(range(n_clips)), host_id, num_hosts)]
        return len(seen["ids"]), 0

    real, real_s3fd = op.preprocess_dataset, cli._s3fd
    op.preprocess_dataset, cli._s3fd = fake, lambda checkpoint: torch.nn.Identity()
    try:
        argv = ["preprocess-gan", "--data-root", "/nonexistent", "--out", "/nonexistent"]
        if host_id is not None:
            argv += ["--host-id", str(host_id)]
        if num_hosts is not None:
            argv += ["--num-hosts", str(num_hosts)]
        try:
            rc = cli.main(argv, device="cpu")
        except SystemExit as e:
            return {"exit": e.code}
    finally:
        op.preprocess_dataset, cli._s3fd = real, real_s3fd
    return {"exit": rc, "ids": seen.get("ids")}


def vivit_loaded(cfg_kw, sd, clips, mesh_kw):
    """A ViViT placed on the mesh first (its init cut), then given a whole
    state dict through ``load_full_state_dict``: its logits, the whole
    state dict it reads back and its tensor-parallel leaves."""
    from lipreading_video_generation_tpu_torch.models.vivit import ViViT

    _threads()
    model = ViViT(tcfg.ViViTConfig(**cfg_kw)).eval()
    spec = None if mesh_kw is None else _mesh(mesh_kw)
    pmesh.shard_params(spec, model)
    pmesh.load_full_state_dict(spec, model, _sd(sd))
    with torch.no_grad():
        logits = model(torch.from_numpy(clips))
    return {"logits": logits, "whole": pmesh.full_state_dict(spec, model),
            "tp": {} if spec is None else pmesh.tensor_parallel_leaves(spec, model)}


def tp_layers(x, mesh_kw, dtype=torch.float32):
    """A stack of the port's layers (Linear, a grouped Conv1d, a Conv2d with
    and without a bias), computed in ``dtype``, at a threshold that cuts
    every weight, placed by ``shard_params`` (``mesh_kw`` None: one process,
    no mesh): the output of a forward from ``x`` and the whole gradient of
    its sum."""
    from lipreading_video_generation_tpu_torch.core.prng import seeded
    from lipreading_video_generation_tpu_torch.models import layers

    _threads()

    class Stack(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = layers.Linear(12, 16, dtype=dtype)
            self.grouped = layers.Conv1d(4, 8, 3, padding=1, groups=2, dtype=dtype)
            self.conv = layers.Conv2d(2, 6, 3, padding=1, dtype=dtype)
            self.plain = layers.Conv2d(6, 4, 1, bias=False, dtype=dtype)

        def forward(self, v):
            h = self.fc(v)                                     # (B, 12) -> (B, 16)
            h = self.grouped(h.reshape(-1, 4, 4))              # (B, 8, 4)
            return self.plain(self.conv(h.reshape(-1, 2, 4, 4)))

    model = seeded(Stack, 0)
    spec = None if mesh_kw is None else _mesh(mesh_kw)
    pmesh.shard_params(spec, model)
    xt = torch.from_numpy(x).requires_grad_()
    out = model(xt)
    out.float().sum().backward()
    return {"out": out.detach().float(), "grads": whole_grads(spec, model), "x_grad": xt.grad,
            "tp": {} if spec is None else pmesh.tensor_parallel_leaves(spec, model)}
