"""``steps_per_dispatch`` in the port's three step loops (diffusion, SR,
GAN): a dispatch takes up to that many batches from the feed, cut at the
next eval and checkpoint, and runs them as ordinary steps, so 4 a dispatch
gives the params, metrics, evals, checkpoints and sample dumps of 1,
bit for bit, here over 7 steps with evals and checkpoints every 3."""
import os

import numpy as np
import pytest
import torch

from lipreading_video_generation_tpu_torch.core.config import (
    DiffusionConfig, GanConfig, SuperResConfig)
from lipreading_video_generation_tpu_torch.data import datasets as tdata
from lipreading_video_generation_tpu_torch.data.loader import dispatch_bounds
from lipreading_video_generation_tpu_torch.pipelines import train_diffusion as ttd
from lipreading_video_generation_tpu_torch.pipelines import train_gan as ttg
from lipreading_video_generation_tpu_torch.pipelines import train_superres as tsr

DIFF = DiffusionConfig(im_size=16, base_channels=16, channel_mult=(1, 2), num_res_blocks=1,
                       attention_resolutions=(2,), num_heads=2, time_embed_dim=16,
                       audio_embed_dim=16, audio_proj_dim=4, im_cond_channels=4,
                       audio_samples=800, num_timesteps=10, dropout=0.1, dtype="float32",
                       batch_size=2)
SR = SuperResConfig(im_size=16, low_size=8, base_channels=16, channel_mult=(1, 2),
                    num_res_blocks=1, attention_resolutions=(2,), num_heads=2,
                    time_embed_dim=16, num_timesteps=10, dropout=0.1, dtype="float32",
                    batch_size=2)
GAN = GanConfig(model_width=0.125, batch_size=2, dtype="float32", eval_interval=3,
                checkpoint_interval=3)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)   # six test workers share the host
    yield
    torch.set_num_threads(n)


class Writer:
    def __init__(self):
        self.rows = []

    def write(self, step, metrics):
        self.rows.append((step, {k: float(v) for k, v in metrics.items()}))


def _diffusion_feed(seed):
    rng = np.random.default_rng(seed)
    return lambda: {"cond_frame": rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8),
                    "target_frame": rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8),
                    "audio": rng.standard_normal((2, 800)).astype(np.float32)}


def _sr_feed(seed):
    rng = np.random.default_rng(seed)
    return lambda: {"target_frame": rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)}


def _gan_feed(seed):
    sampler = tdata.GanWindowSampler(tdata.synthetic_gan_clips(3, 18, 48, seed=seed), seed=seed)
    return lambda: sampler.sample_batch(2)


def _run(kind, spd, tmp_path):
    writer, ck = Writer(), str(tmp_path / f"{kind}{spd}")
    if kind == "diffusion":
        feed = _diffusion_feed(1)
        state = ttd.train(DIFF, feed, num_steps=7, seed=3, checkpoint_dir=ck, checkpoint_every=3,
                          metrics_writer=writer, steps_per_dispatch=spd, eval_batch_fn=feed,
                          eval_every=3, device="cpu")
        modules = (state.model, state.ema)
    elif kind == "superres":
        state = tsr.train(SR, _sr_feed(2), num_steps=7, seed=3, checkpoint_dir=ck,
                          checkpoint_every=3, metrics_writer=writer, steps_per_dispatch=spd,
                          device="cpu")
        modules = (state.model, state.ema)
    else:
        feed = _gan_feed(4)
        state = ttg.train(GAN, feed, eval_batch_fn=feed, num_steps=7, seed=3, checkpoint_dir=ck,
                          metrics_writer=writer, sample_dir=ck + "_samples",
                          steps_per_dispatch=spd, device="cpu")
        modules = (state.gen, state.disc)
    files = sorted(os.listdir(ck)) + sorted(os.listdir(ck + "_samples")
                                            if kind == "gan" else [])
    return state, modules, writer.rows, files


@pytest.mark.parametrize("kind", ["diffusion", "superres", "gan"])
def test_four_steps_a_dispatch_equal_one(kind, tmp_path):
    one, one_mods, one_rows, one_files = _run(kind, 1, tmp_path)
    four, four_mods, four_rows, four_files = _run(kind, 4, tmp_path)
    assert one.step == four.step == 7
    for a, b in zip(one_mods, four_mods):
        for (n, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), n
    assert [(s, sorted(m)) for s, m in one_rows] == [(s, sorted(m)) for s, m in four_rows]
    assert one_rows == four_rows
    steps = [s for s, _ in one_rows]
    if kind == "diffusion":
        assert steps == [0, 1, 2, 2, 3, 4, 5, 5, 6]
        assert one_files == four_files == ["step_000000003.pt", "step_000000006.pt"]
        assert torch.equal(one.generator.get_state(), four.generator.get_state())
    elif kind == "superres":
        assert steps == [1, 2, 3, 4, 5, 6, 7]
        assert one_files == four_files == ["step_000000003.pt", "step_000000006.pt",
                                           "step_000000007.pt"]
    else:
        assert steps == [0, 1, 2, 2, 3, 4, 5, 5, 6]
        assert one_files == four_files == ["step_3.pt", "step_6.pt", "step3.jpg", "step6.jpg"]
        assert one.syncnet_wt == four.syncnet_wt


@pytest.mark.parametrize("step,spd,intervals,want", [
    (0, 4, (3, 3), 3), (3, 4, (3, None), 3), (6, 4, (3, 3), 1), (0, 8, (500,), 7),
    (2, 0, (500,), 1), (5, 1, (3,), 1), (0, 4, (2, 3), 2),
])
def test_dispatch_bounds(step, spd, intervals, want):
    """Up to ``steps_per_dispatch`` (0 counts as 1, as in JAX), cut at
    ``num_steps`` (7) and at the next multiple of each interval."""
    assert dispatch_bounds(step, 7, spd, *intervals) == want
