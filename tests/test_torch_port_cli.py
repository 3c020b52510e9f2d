"""The port's command line (``lipreading_video_generation_tpu_torch.cli``)
on the CPU (``main(argv, device="cpu")``): each subcommand at a tiny size,
the config it builds against the JAX CLI's ``build_config``, and the
arguments it refuses."""
import argparse
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from lipreading_video_generation_tpu import cli as jcli
from lipreading_video_generation_tpu_torch import cli
from lipreading_video_generation_tpu_torch.pipelines import train_classifier as ttc
from lipreading_video_generation_tpu_torch.pipelines import train_diffusion as ttd

ROOT = Path(__file__).resolve().parent.parent


def _set(section, **kw):
    return [a for k, v in kw.items() for a in ("--set", f"{section}.{k}={v}")]


TINY_VIVIT = _set("vivit", num_classes=4, hidden_size=32, num_layers=1, num_heads=4,
                  mlp_dim=32, dtype="float32", batch_size=16)
TINY_DIFFUSION = _set("diffusion", im_size=16, base_channels=16, channel_mult="(1,2)",
                      num_res_blocks=1, attention_resolutions="(2,)", num_heads=2,
                      time_embed_dim=16, audio_embed_dim=16, audio_proj_dim=4,
                      im_cond_channels=4, audio_samples=800, num_timesteps=10,
                      dtype="float32", batch_size=2)
TINY_SUPERRES = _set("superres", im_size=16, low_size=8, base_channels=16,
                     channel_mult="(1,2)", num_res_blocks=1, attention_resolutions="(2,)",
                     num_heads=2, time_embed_dim=32, num_timesteps=10, dtype="float32",
                     batch_size=2)
TINY_CLASSIFIER = _set("classifier", num_classes=4, base_channels=8, channel_mult="(1,2)",
                       num_res_blocks=1, attention_resolutions="(2,)", num_heads=2,
                       time_embed_dim=16, batch_size=4, dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)   # six test workers share the host
    yield
    torch.set_num_threads(n)


def test_train_vivit(capsys):
    """``train-vivit``: 512 synthetic clips, ``--steps 4`` rounds up to one
    epoch of 32 steps (as in JAX), a metric line every 10 steps, then the
    best eval stats."""
    assert cli.main(["train-vivit", "--steps", "4", "--synthetic"] + TINY_VIVIT,
                    device="cpu") == 0
    out = capsys.readouterr()
    best = [ln for ln in out.out.splitlines() if ln.startswith("best: ")]
    assert len(best) == 1 and "'accuracy'" in best[0] and "'loss'" in best[0]
    steps = [ln.split("]")[0] for ln in out.err.splitlines() if ln.startswith("[step ")]
    assert steps == ["[step 10", "[step 20", "[step 30"]


def test_train_diffusion(tmp_path, capsys):
    """``train-diffusion --synthetic``: two steps and a checkpoint at step 2;
    ``--steps 4`` resumes from it and saves step 4."""
    ck = tmp_path / "ck"
    argv = ["train-diffusion", "--synthetic", "--checkpoint-dir", str(ck),
            "--checkpoint-every", "2"] + TINY_DIFFUSION
    assert cli.main(argv + ["--steps", "2"], device="cpu") == 0
    assert sorted(os.listdir(ck)) == ["step_000000002.pt"]
    assert cli.main(argv + ["--steps", "4"], device="cpu") == 0
    assert sorted(os.listdir(ck)) == ["step_000000002.pt", "step_000000004.pt"]
    assert ttd.load_checkpoint(ttd.latest_checkpoint(str(ck)))["step"] == 4


def test_train_superres(tmp_path):
    ck = tmp_path / "sr"
    assert cli.main(["train-superres", "--synthetic", "--steps", "1", "--checkpoint-dir",
                     str(ck)] + TINY_SUPERRES, device="cpu") == 0
    assert sorted(os.listdir(ck)) == ["step_000000001.pt"]


def test_train_noisy_classifier(tmp_path, capsys):
    out = tmp_path / "clf.pt"
    assert cli.main(["train-noisy-classifier", "--synthetic", "--steps", "1", "--out", str(out),
                     "--set", "diffusion.im_size=16"] + TINY_CLASSIFIER, device="cpu") == 0
    assert "trained noisy classifier" in capsys.readouterr().out
    params = ttc.load_classifier_params(str(out))
    assert params and all(t.dtype == torch.float32 for t in params.values())


@pytest.mark.parametrize("argv", [
    [],
    ["--seed", "5"] + TINY_VIVIT,
    TINY_DIFFUSION + TINY_CLASSIFIER + ["--set", "gan.serve_int8=true"],
    TINY_SUPERRES + ["--set", "preprocess.clahe_grid=(4,4)", "--set", "checkpoint_dir=x"],
], ids=range(4))
def test_build_config_matches_jax(argv):
    """The same ``--seed`` and ``--set`` arguments give the same config tree
    as the JAX CLI's ``build_config``."""
    p = argparse.ArgumentParser()
    p.add_argument("--set", action="append", default=[], dest="overrides")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    assert dataclasses.asdict(cli.build_config(args)) == dataclasses.asdict(
        jcli.build_config(args))


@pytest.mark.parametrize("argv,message", [
    (["train-diffusion", "--frame-index", "idx.pkl"], "ROADMAP §1 item 6"),
    (["train-diffusion", "--records-root", "recs/"], "ROADMAP §1 item 6"),
    (["train-diffusion", "--wav2vec2-checkpoint", "w2v/"], "ROADMAP §1 item 7"),
    (["train-superres", "--frame-index", "idx.pkl"], "ROADMAP §1 item 6"),
    (["train-diffusion", "--steps-per-dispatch", "4"], "unrecognized arguments"),
    (["train-vivit", "--set", "vivit.no_such_key=1"], "unknown config key"),
    (["train-vivit", "--set", "mesh.model_parallel=2"], "multi-GPU"),
    (["train-noisy-classifier", "--out", "x.pt"], "--synthetic"),
    (["sample-diffusion", "--out", "x.png"], "invalid choice"),
    (["lipread-e2e", "--epochs", "1"], "the following arguments are required: --data-root"),
], ids=lambda v: v[0] if isinstance(v, list) else None)
def test_refused_arguments_exit_with_a_usage_error(argv, message, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(argv, device="cpu")
    assert e.value.code == 2
    assert message in capsys.readouterr().err


def test_module_entry_point_runs_on_the_card_by_default():
    """``python -m …cli`` reaches ``main`` and, with no device given, the
    card: without one it stops with the port's "no CUDA device" error."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-m", "lipreading_video_generation_tpu_torch.cli",
                        "train-vivit", "--steps", "1"] + TINY_VIVIT,
                       capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert r.returncode == 1 and "no CUDA device" in r.stderr
    r = subprocess.run([sys.executable, "-m", "lipreading_video_generation_tpu_torch.cli",
                        "--help"], capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=120)
    assert r.returncode == 0
    for cmd in ("train-vivit", "train-diffusion", "train-superres", "train-noisy-classifier",
                "train-landmark", "lipread-e2e"):
        assert cmd in r.stdout
