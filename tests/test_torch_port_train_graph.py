"""The diffusion training step's route (``train_diffusion.step_route``):
eager on the CPU, on a live mesh, with t or noise given and on a key's
first step; a capture where the key repeats the one the previous step
ended with; a replay where it is the held graph's. ``graph_key`` changes
with whatever a captured step depends on. The graph itself runs only on
the card (``tests/test_torch_port_cuda.py``); here, tiny CPU states."""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from lipreading_video_generation_tpu_torch.core.config import DiffusionConfig
from lipreading_video_generation_tpu_torch.pipelines import train_diffusion as ttd

TINY = dict(im_size=16, base_channels=32, channel_mult=(1, 2), num_res_blocks=1,
            attention_resolutions=(2,), num_heads=2, time_embed_dim=32, audio_embed_dim=32,
            audio_proj_dim=8, im_cond_channels=4, audio_samples=800, num_timesteps=50,
            dropout=0.1, dtype="float32")
K1, K2 = ("key", 1), ("key", 2)


@pytest.fixture(scope="module")
def cfg():
    return DiffusionConfig(**TINY)


def _batch(cfg, n=2, seed=0):
    rng = np.random.default_rng(seed)
    return {"target_frame": rng.integers(0, 256, (n, 20, 20, 3), dtype=np.uint8),
            "cond_frame": rng.integers(0, 256, (n, 20, 20, 3), dtype=np.uint8),
            "audio": rng.standard_normal((n, cfg.audio_samples)).astype(np.float32)}


# (on the card, mesh live, t/noise given, key, the previous step's end key,
# the held graph's key) → route
@pytest.mark.parametrize("observed,route", [
    ((False, False, False, K1, K1, K1), "eager"),      # the CPU
    ((True, True, False, K1, K1, K1), "eager"),        # a live mesh
    ((True, False, True, K1, K1, K1), "eager"),        # t and noise given
    ((True, False, False, K1, None, None), "eager"),   # a state's first step
    ((True, False, False, K2, K1, K1), "eager"),       # the key changed
    ((True, False, False, K1, K1, None), "capture"),   # the key repeats
    ((True, False, False, K1, K1, K2), "capture"),     # it repeats, the held graph is stale
    ((True, False, False, K1, K1, K1), "graph"),       # the held graph's key
    ((True, False, False, K1, K2, K1), "graph"),       # back to the held graph's key
])
def test_route_is_decided_by_what_the_step_observes(observed, route):
    assert ttd.step_route(*observed) == route


def test_key_repeats_across_steps_and_changes_with_what_a_graph_holds(cfg):
    state = ttd.create_state(cfg, seed=1, device="cpu")
    batch = _batch(cfg)
    first = ttd.graph_key(state, batch, cfg)
    assert ttd.graph_key(state, batch, cfg) == first
    ttd.train_step(state, batch, cfg)
    after = ttd.graph_key(state, batch, cfg)
    assert after != first                           # Adam's moments were made
    # a second step on the card would capture, a third replay
    assert ttd.step_route(True, False, False, after, after, None) == "capture"
    ttd.train_step(state, _batch(cfg, seed=1), cfg)
    assert ttd.graph_key(state, batch, cfg) == after  # the update stays in place

    changed = {"a swapped parameter": lambda s: setattr(
                   next(s.model.parameters()), "data", next(s.model.parameters()).data.clone()),
               "a swapped EMA parameter": lambda s: setattr(
                   next(s.ema.parameters()), "data", next(s.ema.parameters()).data.clone()),
               "a restored optimizer": lambda s: s.optimizer.load_state_dict(
                   copy.deepcopy(s.optimizer.state_dict())),
               "a changed lr": lambda s: s.optimizer.param_groups[0].update(lr=2e-4),
               "a changed EMA rate": lambda s: setattr(s, "ema_rate", 0.99),
               "eval mode": lambda s: s.model.eval()}
    for what, change in changed.items():
        st = ttd.create_state(cfg, seed=1, device="cpu")
        ttd.train_step(st, batch, cfg)
        before = ttd.graph_key(st, batch, cfg)
        change(st)
        assert ttd.graph_key(st, batch, cfg) != before, what
    assert ttd.graph_key(state, _batch(cfg, n=3), cfg) != after     # a short last batch
    assert ttd.graph_key(state, batch, dataclasses.replace(cfg, num_timesteps=60)) != after


def test_route_counts_count_eager_steps_on_the_cpu(cfg):
    state = ttd.create_state(cfg, seed=2, device="cpu")
    before = dict(ttd.train_step.route_counts)
    for i in range(3):
        m = ttd.train_step(state, _batch(cfg, seed=i), cfg)
        assert np.isfinite(float(m["loss"]))
    took = {r: n - before[r] for r, n in ttd.train_step.route_counts.items()}
    assert took == {"eager": 3, "capture": 0, "graph": 0}
    assert state.step == 3 and state.graph is None and state.key_after is None
    assert all(g.get("capturable") is False and g.get("fused") is None
               for g in state.optimizer.param_groups)


def test_restore_gives_adam_the_flags_of_the_states_device(cfg):
    """A checkpoint's Adam groups carry the flags of the device it was saved
    on (fused and capturable on the card); restored into a CPU state they
    are the CPU's, and the next step equals that of a state restored from
    a CPU checkpoint, bit for bit."""
    state = ttd.create_state(cfg, seed=3, device="cpu")
    ttd.train_step(state, _batch(cfg), cfg)
    tree = ttd.checkpoint_tree(state)
    from_card = copy.deepcopy(tree)
    for g in from_card["opt_state"]["param_groups"]:
        g.update(fused=True, capturable=True)
    runs = []
    for restored in (copy.deepcopy(tree), from_card):
        st = ttd.restore_state(ttd.create_state(cfg, seed=4, device="cpu"), restored)
        assert all(g["fused"] is None and g["capturable"] is False
                   for g in st.optimizer.param_groups)
        assert all(s["step"].device.type == "cpu" for s in st.optimizer.state.values())
        ttd.train_step(st, _batch(cfg, seed=1), cfg)
        runs.append([p.detach().clone() for p in st.model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*runs))

