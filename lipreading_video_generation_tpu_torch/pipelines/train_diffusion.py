"""Conditional-DDPM training of the audio+image-conditioned U-Net.

Port of ``lipreading_video_generation_tpu/pipelines/train_diffusion.py``:
q-sample the target frame at a uniform timestep, predict ε with
``UNetAudio`` in train mode (dropout), ε-MSE in float32, Adam, EMA. On the
card the U-Net's attention runs K3 forward and K4/K5 backward
(``ops.attention``).

PyTorch idiom where JAX keeps a pure state: ``DiffusionTrainState`` holds
the model (float32 master params), its EMA copy, a ``torch.optim.Adam``
with optax ``adam``'s hyperparameters written out (β 0.9/0.999, eps 1e-8),
the step count and one ``torch.Generator`` on the model's device from
which t, the noise and the dropout masks are drawn in that order. The two
frameworks' random streams differ, so ``train_step`` also takes explicit
``t`` and ``noise`` (the tests feed JAX's draws). JAX's ``train_scan``
(several steps in one device program) is not carried over: a dispatch of
``steps_per_dispatch`` batches runs as that many ordinary steps.
Checkpoints are ``torch.save`` files of params, EMA, Adam moments, step and
generator state.

On a mesh (``parallel/mesh.py``; ``train`` builds one over the process
group as the JAX package's does over its devices) each data rank runs the
step on its rows of the batch, with t, the noise and the dropout masks drawn
for the global batch and sliced, the gradients averaged over ``data`` (and
the Adam moments sharded under ZeRO-1) and the metrics averaged; the
primary rank writes the checkpoints.

On the card, off a mesh, ``train_step`` runs the whole step (resize and
normalise, the draws, forward, loss, backward, Adam, EMA) as one CUDA
graph, captured once and replayed from static input buffers, so that the
card does not wait on the host's ~5,500 launches a step. ``step_route``
decides from what the step observes: a state's first step with a key
(``graph_key``: the batch's shapes, Adam's and the EMA's rates, the
tensors' addresses) runs eager and warms up, the next captures, the rest
replay. The graph draws from the state's generator at the offsets eager
steps would, so both routes give the same stream of draws.
"""
from __future__ import annotations

import copy
import dataclasses
import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.checkpoint import atomic_save
from ..core.config import DiffusionConfig, MeshConfig
from ..core.device import resolve_device
from ..core.prng import seeded, uniform_timesteps
from ..data.loader import dispatch_bounds, host_prefetch, take
from ..parallel import mesh as pmesh
from ..parallel.distributed import is_primary
from ..models.schedulers import make_scheduler
from ..models.unet_audio import UNetAudio
from ..ops import image as image_ops
from ..utils.profiling import annotate
from .losses import noise_mse

ADAM_BETAS = (0.9, 0.999)   # optax.adam's defaults
ADAM_EPS = 1e-8
BATCH_KEYS = ("target_frame", "cond_frame", "audio")   # what a step reads of a batch
ROUTES = ("eager", "capture", "graph")
_ROUTE_COUNTS = dict.fromkeys(ROUTES, 0)    # train_step.route_counts (held here: callers wrap it)


def normalize_audio(wave: torch.Tensor) -> torch.Tensor:
    """First-order high-pass (~300 Hz at 16 kHz) + per-clip standardisation
    (population std + 1e-6), as ``pipelines/train_diffusion.normalize_audio``
    of the JAX package."""
    alpha = 0.889  # exp(-2π·300/16000)
    hp = wave - alpha * F.pad(wave[..., :-1], (1, 0))
    mean = hp.mean(dim=-1, keepdim=True)
    std = hp.std(dim=-1, keepdim=True, correction=0) + 1e-6
    return (hp - mean) / std


@dataclasses.dataclass
class DiffusionTrainState:
    """Everything a step changes: ``model`` (train mode, float32 params),
    ``ema`` (a copy, eval mode, no grads), ``optimizer``, ``step`` and the
    ``generator`` of t, noise and dropout masks. ``graph`` holds the
    captured step (one at a time; it dies with the state) and ``key_after``
    the ``graph_key`` the last step ended with."""

    model: nn.Module
    ema: nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    generator: torch.Generator
    scheduler: Any
    ema_rate: float = 0.9999
    graph: Optional["GraphedStep"] = None
    key_after: Optional[tuple] = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def _adam_flags(device: torch.device) -> Dict[str, Any]:
    """Adam's flags for params on ``device``: on the card ``fused`` (the
    update in a few multi-tensor kernels, not a few for each tensor) and
    ``capturable`` (the step counts stay on the device, so a CUDA graph can
    hold the update); torch's defaults on the CPU."""
    on_card = device.type == "cuda"
    return {"fused": True if on_card else None, "capturable": on_card}


def _fit_adam(optimizer, device: torch.device) -> None:
    """Set ``_adam_flags(device)`` on ``optimizer`` (or the optimizer a
    mesh's wrapper holds) after a state dict was loaded into it, which
    brings the flags of the device it was saved on, and move its step
    counts where those flags keep them."""
    opt = getattr(optimizer, "optimizer", optimizer)
    flags = _adam_flags(device)
    for group in opt.param_groups:
        group.update(flags)
    for p, s in opt.state.items():
        if isinstance(s.get("step"), torch.Tensor):
            s["step"] = s["step"].to(p.device if flags["capturable"] else "cpu", torch.float32)


def new_state(model: nn.Module, cfg, seed: int, device, ema_rate: float) -> DiffusionTrainState:
    """A step-0 state around ``model`` on ``device``: EMA copy, Adam at
    ``cfg.learning_rate`` (``_adam_flags``), a generator seeded with
    ``seed``, ``cfg``'s noise schedule."""
    device = resolve_device(device)
    model = model.to(device).train()
    ema = copy.deepcopy(model).eval().requires_grad_(False)
    opt = torch.optim.Adam(model.parameters(), lr=cfg.learning_rate, betas=ADAM_BETAS,
                           eps=ADAM_EPS, **_adam_flags(device))
    gen = torch.Generator(device=device).manual_seed(seed)
    return DiffusionTrainState(model, ema, opt, 0, gen, make_scheduler(
        cfg.scheduler, cfg.num_timesteps, cfg.beta_start, cfg.beta_end), ema_rate)


def create_state(cfg: DiffusionConfig, seed: int = 0, device=None, ema_rate: float = 0.9999,
                 wav2vec2_checkpoint: Optional[str] = None) -> DiffusionTrainState:
    """A fresh train state: ``UNetAudio(cfg)`` initialised from ``seed``
    (Flax's init rules; the same seed gives the same params), EMA = a copy.
    ``wav2vec2_checkpoint`` (a ``port-wav2vec2 --out`` artifact) puts the
    ported encoder into the audio-encoder submodule (``cfg`` must be
    ``ports.diffusion_cfg_with_wav2vec2``'s: ``ValueError`` otherwise); it
    trains jointly with the U-Net, in the same Adam and EMA, as the
    reference's pretrained wav2vec2 does. ``device=None`` is the card
    (``core.device.default_device``)."""
    model = seeded(lambda: UNetAudio(cfg), seed)
    if wav2vec2_checkpoint:
        from ..models import ports

        w2v, _ = ports.load_wav2vec2_params(wav2vec2_checkpoint)
        model.load_state_dict(ports.graft_wav2vec2_into_diffusion(model.state_dict(), w2v))
    return new_state(model, cfg, seed, device, ema_rate)


@torch.no_grad()
def update_ema(ema: nn.Module, model: nn.Module, rate: float) -> None:
    """ema ← rate·ema + (1−rate)·params, in place (on a mesh, each
    tensor-parallel slice of the EMA with the same slice of the params)."""
    e = list(ema.parameters())
    torch._foreach_mul_(e, rate)
    torch._foreach_add_(e, [p.detach() for p in model.parameters()], alpha=1.0 - rate)


def _frames(x, size: int, device) -> torch.Tensor:
    """uint8 (B, h, w, C) → (B, C, size, size) in [-1, 1]: the antialiased
    resize as uint8 (rounded), then normalised."""
    img = image_ops.resize(torch.as_tensor(x).to(device), (size, size))
    return image_ops.normalize_uint8(img, symmetric=True).permute(0, 3, 1, 2)


def prepare_batch(batch: Dict[str, Any], cfg: DiffusionConfig, device) -> Dict[str, torch.Tensor]:
    """uint8 target/condition frames (B, h, w, 3) → ±1 (B, 3, im, im);
    raw audio (B, samples) → normalised; all on ``device``."""
    return {"target": _frames(batch["target_frame"], cfg.im_size, device),
            "cond": _frames(batch["cond_frame"], cfg.im_size, device),
            "audio": normalize_audio(torch.as_tensor(batch["audio"], dtype=torch.float32)
                                     .to(device))}


def draw_t_noise(state: DiffusionTrainState, like: torch.Tensor, num_timesteps: int, t=None,
                 noise=None):
    """(t, noise): as given (t (B,), noise (B, H, W, C) as in JAX; in a
    data-parallel step, the global batch's, of which this rank takes its
    rows), or drawn from the state's generator (for the global batch in a
    data-parallel step)."""
    gen = state.generator
    if t is None:
        t = pmesh.draw_batch(lambda s: uniform_timesteps(gen, s[0], num_timesteps),
                             (like.shape[0],))
    else:
        t = pmesh.global_rows(torch.as_tensor(t))
    if noise is None:
        noise = pmesh.draw_batch(lambda s: torch.randn(s, generator=gen, device=gen.device),
                                 like.shape)
    else:
        noise = pmesh.global_rows(torch.as_tensor(noise, dtype=torch.float32)).permute(0, 3, 1, 2)
    return t.to(like.device, torch.long), noise.to(like.device)


def apply_update(state: DiffusionTrainState, loss: torch.Tensor) -> None:
    """Backward, Adam, EMA, step + 1: the spans ``train/backward`` (on the
    calling thread; the autograd engine launches from its own) and
    ``train/optimizer``."""
    with annotate("train/backward"):
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
    with annotate("train/optimizer"):
        state.optimizer.step()
        update_ema(state.ema, state.model, state.ema_rate)
        state.step += 1


def _launch_step(state: DiffusionTrainState, batch: Dict[str, Any], cfg: DiffusionConfig,
                 t=None, noise=None) -> Dict[str, torch.Tensor]:
    """The step op by op, as eager steps run it and a capture records it:
    {"loss", "t_mean", "t", "noise"}. ``apply_update`` and ``noise_mse``
    are looked up in this module at the call, so that what is planted there
    is captured too."""
    with annotate("train/prepare"):
        prep = prepare_batch(batch, cfg, state.device)
    with annotate("train/noise"):
        t, noise = draw_t_noise(state, prep["target"], cfg.num_timesteps, t, noise)
        noisy = state.scheduler.add_noise(prep["target"], noise, t)
    with annotate("train/forward"):
        pred = state.model(noisy, prep["cond"], prep["audio"], t, generator=state.generator)
        loss = noise_mse(pred, noise)
    apply_update(state, loss)
    return {"loss": loss.detach(), "t_mean": t.float().mean(), "t": t, "noise": noise}


def eager_step(state: DiffusionTrainState, batch: Dict[str, Any], cfg: DiffusionConfig,
               t=None, noise=None) -> Dict[str, torch.Tensor]:
    """One step launched op by op (``train_step``'s eager route): program
    spans ``train/prepare``, ``train/noise``, ``train/forward`` (the model
    and the loss), then ``apply_update``'s."""
    out = _launch_step(state, batch, cfg, t, noise)
    return {"loss": out["loss"], "t_mean": out["t_mean"]}


@dataclasses.dataclass
class GraphedStep:
    """One captured training step: its ``key`` (``graph_key``), the CUDA
    ``graph``, the static device ``inputs`` it reads (``BATCH_KEYS``), the
    pinned ``staging`` they are copied through, the ``outputs`` each replay
    overwrites ({"loss", "t_mean", "t", "noise"}), how far the captured
    update moves ``state.step``, and the event after the last copy out of
    the staging."""

    key: tuple
    graph: Any
    inputs: Dict[str, torch.Tensor]
    staging: Dict[str, torch.Tensor]
    outputs: Dict[str, torch.Tensor]
    step_increment: int
    copied: Any


def graph_key(state: DiffusionTrainState, batch: Dict[str, Any], cfg: DiffusionConfig) -> tuple:
    """What a captured step depends on: the batch's shapes and dtypes,
    ``cfg``, Adam's rates, the EMA's, ``model.training`` and the address of
    every parameter, EMA parameter and optimizer state tensor (a restore,
    ``load_state_dict`` or a placement on a mesh that swaps one changes it)."""
    opt = state.optimizer
    tensors = [*state.model.parameters(), *state.ema.parameters(),
               *(v for s in getattr(opt, "state", {}).values() for v in s.values()
                 if isinstance(v, torch.Tensor))]
    groups = tuple((g["lr"], tuple(g["betas"]), g["eps"], g["weight_decay"])
                   for g in opt.param_groups)
    shapes = tuple((k, np.shape(batch[k]), str(getattr(batch[k], "dtype", None)))
                   for k in BATCH_KEYS)
    return (shapes, cfg, groups, state.ema_rate, state.model.training,
            tuple(x.data_ptr() for x in tensors))


def step_route(on_cuda: bool, mesh_live: bool, draws_given: bool, key: Optional[tuple],
               previous_key: Optional[tuple], held_key: Optional[tuple]) -> str:
    """The route of one training step, from what it observes: "eager" on
    the CPU, on a live mesh (its collectives cannot be captured), with t or
    noise given, and on a key's first step; "graph" (replay the held graph)
    where the key is the held graph's; "capture" where the key repeats the
    one the previous step ended with."""
    if not on_cuda or mesh_live or draws_given:
        return "eager"
    if key == held_key:
        return "graph"
    return "capture" if key == previous_key else "eager"


def _capture(state: DiffusionTrainState, batch: Dict[str, Any], cfg: DiffusionConfig,
             key: tuple) -> GraphedStep:
    """Static buffers shaped as ``batch``'s and the step captured over them;
    nothing runs. The gradients are made inside the capture, in the graph's
    pool, and stay the static gradients of every replay."""
    dev = state.device
    inputs, staging = {}, {}
    for k in BATCH_KEYS:
        src = torch.as_tensor(batch[k], dtype=torch.float32 if k == "audio" else None)
        inputs[k] = torch.empty(src.shape, dtype=src.dtype, device=dev)
        staging[k] = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(state.generator)
    step0 = state.step
    state.optimizer.zero_grad(set_to_none=True)
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        outputs = _launch_step(state, inputs, cfg)
    increment, state.step = state.step - step0, step0
    return GraphedStep(key, graph, inputs, staging, outputs, increment, torch.cuda.Event())


def _replay(state: DiffusionTrainState, held: GraphedStep,
            batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Copy ``batch`` into the static inputs (a host batch through the
    pinned staging, non-blocking: ``train/prepare``) and replay the graph
    (``train/replay``); the loss and the mean t as copies of its outputs."""
    with annotate("train/prepare"):
        held.copied.synchronize()      # the last copy out of the staging is done
        for k, dst in held.inputs.items():
            src = torch.as_tensor(batch[k])
            if src.is_cuda:
                dst.copy_(src)
            else:
                held.staging[k].copy_(src)
                dst.copy_(held.staging[k], non_blocking=True)
        held.copied.record()
    with annotate("train/replay"):
        held.graph.replay()
        state.step += held.step_increment
        return {"loss": held.outputs["loss"].clone(), "t_mean": held.outputs["t_mean"].clone()}


def train_step(state: DiffusionTrainState, batch: Dict[str, Any], cfg: DiffusionConfig,
               t=None, noise=None) -> Dict[str, torch.Tensor]:
    """One ε-MSE step on ``batch`` (uint8 ``target_frame``/``cond_frame``
    (B, h, w, 3), raw ``audio`` (B, samples)); updates ``state`` in place.
    Returns {"loss", "t_mean"} as device scalars (the graph route's are
    copies, which later replays leave alone). The route is
    ``step_route``'s, counted in ``train_step.route_counts`` ("graph"
    counts replays, the one after each capture too). Program spans: the
    eager route's (``eager_step``); on the graph route ``train/prepare``
    (the copy in), ``train/capture`` (once a key) and ``train/replay``."""
    state.model.train()
    on_cuda = state.device.type == "cuda"
    mesh_live = not pmesh.is_degenerate(pmesh.live_mesh())
    graphable = on_cuda and not mesh_live
    key = graph_key(state, batch, cfg) if graphable else None
    route = step_route(on_cuda, mesh_live, t is not None or noise is not None, key,
                       state.key_after, None if state.graph is None else state.graph.key)
    _ROUTE_COUNTS[route] += 1
    if route == "eager":
        metrics = eager_step(state, batch, cfg, t, noise)
    else:
        if route == "capture":
            state.graph = None          # one graph at a time: the old pool goes first
            with annotate("train/capture"):
                state.graph = _capture(state, batch, cfg, key)
            _ROUTE_COUNTS["graph"] += 1
        metrics = _replay(state, state.graph, batch)
    if graphable:
        state.key_after = graph_key(state, batch, cfg)
    return metrics


train_step.route_counts = _ROUTE_COUNTS


@torch.no_grad()
def eval_step(state: DiffusionTrainState, batch: Dict[str, Any], cfg: DiffusionConfig,
              t=None, noise=None) -> Dict[str, torch.Tensor]:
    """Held-out ε-MSE with the trained (not EMA) params, no dropout."""
    prep = prepare_batch(batch, cfg, state.device)
    t, noise = draw_t_noise(state, prep["target"], cfg.num_timesteps, t, noise)
    noisy = state.scheduler.add_noise(prep["target"], noise, t)
    state.model.eval()
    try:
        pred = state.model(noisy, prep["cond"], prep["audio"], t)
    finally:
        state.model.train()
    return {"eval/loss": noise_mse(pred, noise)}


def checkpoint_tree(state: DiffusionTrainState) -> Dict[str, Any]:
    """Everything resume needs: params, EMA, Adam moments, step and the
    generator's state, in the one-process layout: a state placed on a mesh
    gathers its tensor-parallel and ZeRO-1 slices (collectives: every rank
    builds the tree)."""
    return {"params": pmesh.full_state_dict(None, state.model),
            "ema_params": pmesh.full_state_dict(None, state.ema),
            "opt_state": state.optimizer.state_dict(), "step": state.step,
            "generator": state.generator.get_state()}


def restore_state(state: DiffusionTrainState, restored: Dict[str, Any]) -> DiffusionTrainState:
    """``checkpoint_tree``'s tree (one-process layout) into ``state``,
    placed on a mesh or not, saved on the card or on the CPU (Adam keeps
    ``state``'s device flags)."""
    pmesh.load_full_state_dict(None, state.model, restored["params"])
    pmesh.load_full_state_dict(None, state.ema, restored["ema_params"])
    state.optimizer.load_state_dict(restored["opt_state"])
    _fit_adam(state.optimizer, state.device)
    state.step = int(restored["step"])
    state.generator.set_state(restored["generator"])
    return state


def _ckpt_path(checkpoint_dir: str, step: int) -> str:
    return os.path.join(checkpoint_dir, f"step_{step:09d}.pt")


def latest_checkpoint(checkpoint_dir: str) -> Optional[str]:
    """Path of the highest-step checkpoint in ``checkpoint_dir``, or None."""
    if not os.path.isdir(checkpoint_dir):
        return None
    names = sorted(n for n in os.listdir(checkpoint_dir)
                   if n.startswith("step_") and n.endswith(".pt"))
    return os.path.join(checkpoint_dir, names[-1]) if names else None


def save_checkpoint(checkpoint_dir: str, state: DiffusionTrainState) -> str:
    """Write ``state`` at its step (atomic; on the primary rank, while every
    rank calls this: ZeRO-1 moments are gathered for it)."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = _ckpt_path(checkpoint_dir, state.step)
    atomic_save(path, checkpoint_tree(state))
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=False)


def resume(state: DiffusionTrainState, checkpoint_dir: Optional[str]) -> DiffusionTrainState:
    """Restore the latest checkpoint of ``checkpoint_dir`` into ``state``, if any."""
    path = latest_checkpoint(checkpoint_dir) if checkpoint_dir else None
    return restore_state(state, load_checkpoint(path)) if path else state


def load_sampling_params(checkpoint_path: str, use_ema: bool = True) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` to sample with (``model.load_state_dict``): from a
    checkpoint directory (latest step; EMA params by default) or a file
    holding ``{"params": ...}``."""
    path = latest_checkpoint(checkpoint_path) if os.path.isdir(checkpoint_path) else None
    if path is not None:
        return load_checkpoint(path)["ema_params" if use_ema else "params"]
    return load_checkpoint(checkpoint_path)["params"]


def _scalars(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}


def train(cfg: DiffusionConfig, batch_fn: Callable[[], Dict[str, Any]], num_steps: int = 1000,
          seed: int = 0, checkpoint_dir: Optional[str] = None, metrics_writer=None,
          checkpoint_every: int = 500, mesh_spec=None, steps_per_dispatch: int = 4,
          eval_batch_fn=None, eval_every: int = 500,
          wav2vec2_checkpoint: Optional[str] = None, device=None) -> DiffusionTrainState:
    """Step loop until ``num_steps`` (or the end of a finite feed: a
    ``StopIteration`` or ``None`` from ``batch_fn``). Batches come from a
    producer thread (``data.loader.host_prefetch``) that reads
    ``2 × steps_per_dispatch`` ahead; each dispatch takes up to
    ``steps_per_dispatch`` of them, cut at the next checkpoint and eval (as
    the JAX package's chunks are), and runs them as that many ``train_step``s,
    so the results equal one step a dispatch. ``metrics_writer.write(step,
    {name: float})`` after each step; with ``eval_batch_fn``, a held-out
    ε-MSE every ``eval_every`` steps (on the feed's next batch when it is
    ``batch_fn``); a checkpoint in ``checkpoint_dir`` every
    ``checkpoint_every`` steps. Resumes from the latest checkpoint there.

    ``mesh_spec`` (default: ``build_mesh()`` over the process group, 1×1
    without one) runs the steps data-parallel: every rank calls ``train``
    with the same feed and takes its rows of each batch; the primary rank
    writes the metrics and checkpoints."""
    spec = mesh_spec or pmesh.build_mesh(MeshConfig())
    state = resume(create_state(cfg, seed, device, wav2vec2_checkpoint=wav2vec2_checkpoint),
                   checkpoint_dir)
    state = pmesh.shard_state(spec, state)
    writer = metrics_writer if is_primary() else None
    feed = host_prefetch(batch_fn, depth=2 * max(1, steps_per_dispatch))
    try:
        while state.step < num_steps:
            raws = take(feed, dispatch_bounds(
                state.step, num_steps, steps_per_dispatch, checkpoint_every,
                eval_every if eval_batch_fn is not None else None))
            if not raws:
                break   # finite feed exhausted
            for batch in raws:
                metrics = pmesh.run_sharded(spec, train_step, state, batch, cfg)
                if writer is not None:
                    writer.write(state.step - 1, _scalars(metrics))
            step = state.step
            if eval_batch_fn is not None and step % eval_every == 0:
                if eval_batch_fn is batch_fn:   # the producer thread owns batch_fn
                    nb = take(feed, 1)
                    eb = nb[0] if nb else None
                else:
                    eb = eval_batch_fn()
                if eb is not None:
                    em = pmesh.run_sharded(spec, eval_step, state, eb, cfg)
                    if writer is not None:
                        writer.write(step - 1, _scalars(em))
            if checkpoint_dir and step % checkpoint_every == 0:
                save_checkpoint(checkpoint_dir, state)
    finally:
        feed.close()
    return state
