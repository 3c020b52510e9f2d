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
    (["train-diffusion", "--wav2vec2-checkpoint", "w2v/"], "no port-wav2vec2 artifact"),
    (["sample-diffusion", "--frames", "3"], "the following arguments are required: --out"),
    (["sample-diffusion", "--sr-checkpoint", "sr/", "--out", "x.png"], "cascade mismatch"),
    (["train-vivit", "--set", "vivit.no_such_key=1"], "unknown config key"),
    (["train-vivit", "--set", "mesh.model_parallel=2"],
     "model_parallel=2 does not divide device count 1"),
    (["train-noisy-classifier", "--out", "x.pt"], "--synthetic"),
    (["pack-diffusion-records", "--synthetic"], "the following arguments are required: --out"),
    (["lipread-e2e", "--epochs", "1"], "the following arguments are required: --data-root"),
    (["pack-gan-records", "--synthetic"], "the following arguments are required: --out"),
    (["build-frame-index", "--out", "idx.pkl"],
     "the following arguments are required: --data-root"),
    (["train-gan", "--lip-expert-checkpoint", "le/", "--avhubert-checkpoint", "av/"],
     "mutually exclusive"),
    (["port-wav2vec2", "--out", "x"], "exactly one of --pth or --selftest"),
    (["port-avhubert", "--pth", "a.pt", "--selftest", "--out", "x"],
     "exactly one of --pth or --selftest"),
    (["train-feature-transformer", "--set", "feature_transformer.no_such_key=1"],
     "unknown config key"),
    (["port-densenet", "--out", "x"], "exactly one of --pth or --selftest"),
    (["eval-gan", "--synthetic"], "the following arguments are required: --checkpoint"),
    (["infer-lipsync", "--face", "f.mp4", "--audio", "a.wav"],
     "the following arguments are required: --out"),
    (["preprocess-gan", "--data-root", "d/"], "the following arguments are required: --out"),
    (["train-syncnet", "--objective", "hinge"], "invalid choice"),
], ids=lambda v: v[0] if isinstance(v, list) else None)
def test_refused_arguments_exit_with_a_usage_error(argv, message, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(argv, device="cpu")
    assert e.value.code == 2
    assert message in capsys.readouterr().err


def _jax_commands(capsys):
    with pytest.raises(SystemExit):
        jcli.main(["--help"])
    usage = capsys.readouterr().out
    return set(usage[usage.index("{") + 1:usage.index("}")].split(","))


def test_port_serves_every_command_of_the_jax_cli(capsys):
    """All 21 of the JAX CLI's subcommands, and no command waits."""
    want = _jax_commands(capsys)
    with pytest.raises(SystemExit):
        cli.main(["--help"], device="cpu")
    usage = capsys.readouterr().out
    got = set(usage[usage.index("{") + 1:usage.index("}")].split(","))
    assert got == want and len(want) == 21 and cli._WAITING == ()


def test_port_densenet_selftest_then_pth(tmp_path, capsys):
    """``port-densenet --selftest`` prints the JAX selftest's keys;
    ``--pth`` on the file it wrote gives the same artifact; the artifact
    feeds ``train-feature-transformer --densenet-checkpoint`` (no
    random-init warning)."""
    import json

    a = str(tmp_path / "a.pt")
    assert cli.main(["port-densenet", "--selftest", "--out", a], device="cpu") == 0
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r["selftest"] == "port-densenet" and r["feature_shape"] == [2, 1024]
    assert r["feature_l2"] > 0 and r["artifact"] == a
    b = str(tmp_path / "b.pt")
    assert cli.main(["port-densenet", "--pth", r["pth"], "--out", b], device="cpu") == 0
    assert f"ported densenet121 → {b}" in capsys.readouterr().out
    want, got = torch.load(a), torch.load(b)
    assert want.keys() == got.keys() and all(torch.equal(want[k], got[k]) for k in want)
    assert cli.main(["train-feature-transformer", "--synthetic", "--max-clips", "12",
                     "--densenet-checkpoint", b, "--set", "feature_transformer.num_epochs=1",
                     "--set", "feature_transformer.num_classes=4"], device="cpu") == 0
    out = capsys.readouterr()
    assert "val accuracy=" in out.out and "RANDOM-INIT" not in out.err


def test_train_feature_transformer_synthetic(capsys):
    """``train-feature-transformer --synthetic``: synthetic word clips →
    the random-init DenseNet121 (warned) → the FeatureTransformer at its
    defaults but 4 classes and 3 epochs (24 clips: 3 held out, one step of
    21 an epoch) → ``val accuracy=… loss=…``."""
    assert cli.main(["train-feature-transformer", "--synthetic", "--max-clips", "24",
                     "--set", "feature_transformer.num_classes=4",
                     "--set", "feature_transformer.num_epochs=3"], device="cpu") == 0
    out = capsys.readouterr()
    line = [ln for ln in out.out.splitlines() if ln.startswith("val accuracy=")]
    assert len(line) == 1 and " loss=" in line[0]
    assert 0.0 <= float(line[0].split("=")[1].split()[0]) <= 1.0
    assert "RANDOM-INIT" in out.err


TINY_GAN = _set("gan", model_width=0.125, batch_size=2, dtype="float32")


def test_gan_expert_chain(tmp_path, capsys):
    """train-syncnet (synthetic audio-visual clips, 2 held out for the AUC)
    → train-gan against the exported expert, with evals, the gate and
    checkpoints → eval-gan of the checkpoint directory."""
    sync = str(tmp_path / "sync.pt")
    assert cli.main(["train-syncnet", "--synthetic", "--steps", "2", "--eval-auc-every", "1",
                     "--out", sync] + TINY_GAN, device="cpu") == 0
    out = capsys.readouterr().out
    assert "held-out discrimination AUC=" in out and f"saved sync expert → {sync}" in out
    ck = str(tmp_path / "gan")
    assert cli.main(["train-gan", "--synthetic", "--steps", "4", "--syncnet-checkpoint", sync,
                     "--checkpoint-dir", ck, "--set", "gan.eval_interval=2",
                     "--set", "gan.checkpoint_interval=2"] + TINY_GAN, device="cpu") == 0
    assert sorted(os.listdir(ck)) == ["step_2.pt", "step_4.pt"]
    assert cli.main(["eval-gan", "--checkpoint", ck, "--synthetic", "--batches", "2",
                     "--syncnet-checkpoint", sync] + TINY_GAN, device="cpu") == 0
    out = capsys.readouterr().out
    for key in ("eval/l1", "eval/psnr", "eval/ssim", "eval/sync_loss"):
        assert f"{key}: " in out
    assert "untrained SyncNet" not in out


def _clip_dir(path, frames: int, seed: int):
    """A preprocess-gan clip directory: {i}.jpg of 32×32 and audio.wav."""
    import cv2
    import numpy as np
    from lipreading_video_generation_tpu_torch.data import video as tvideo

    rng = np.random.default_rng(seed)
    path.mkdir(parents=True)
    for i in range(frames):
        cv2.imwrite(str(path / f"{i}.jpg"), rng.integers(0, 256, (32, 32, 3), np.uint8))
    tvideo.save_wav(str(path / "audio.wav"),
                    rng.standard_normal(16000 * frames // 25).astype(np.float32))


def test_gan_commands_on_preprocessed_clips(tmp_path, capsys):
    """--preprocessed-root: every clip directory under it (train-syncnet with
    --eval-auc-every holds the last two out); an empty root is refused."""
    root = tmp_path / "pre"
    for i in range(4):
        _clip_dir(root / "spk" / f"{i:05d}", 20, i)
    assert cli.main(["train-syncnet", "--preprocessed-root", str(root), "--steps", "1",
                     "--eval-auc-every", "1"] + TINY_GAN, device="cpu") == 0
    assert "held-out discrimination AUC=" in capsys.readouterr().out
    assert cli.main(["train-gan", "--preprocessed-root", str(root), "--steps", "1"] + TINY_GAN,
                    device="cpu") == 0
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit) as e:
        cli.main(["train-gan", "--preprocessed-root", str(tmp_path / "empty")], device="cpu")
    assert e.value.code == 2 and "no clip directory" in capsys.readouterr().err


def test_preprocess_gan_and_infer_lipsync(tmp_path, capsys):
    """preprocess-gan over an LRS2-style tree (mp4, sidecar wav, transcript)
    → clip directories; infer-lipsync of a face video and a wav with a
    generator saved by save_once, in dynamic int8, pads and no smoothing."""
    import numpy as np
    from lipreading_video_generation_tpu_torch.core.checkpoint import save_once
    from lipreading_video_generation_tpu_torch.core.prng import seeded
    from lipreading_video_generation_tpu_torch.data import video as tvideo
    from lipreading_video_generation_tpu_torch.models.generator import TalkingFaceGenerator

    rng = np.random.default_rng(0)
    data = tmp_path / "lrs2" / "spk"
    data.mkdir(parents=True)
    video = str(data / "00001.mp4")
    tvideo.write_video(video, rng.integers(0, 256, (6, 48, 48, 3), np.uint8))
    tvideo.save_wav(str(data / "00001.wav"), rng.standard_normal(3840).astype(np.float32))
    (data / "00001.txt").write_text("Text:  HELLO THERE\nConf:  5\n")
    out = tmp_path / "pre"
    assert cli.main(["preprocess-gan", "--data-root", str(tmp_path / "lrs2"), "--out", str(out)],
                    device="cpu") == 0
    assert "ok=1 failed=0" in capsys.readouterr().out
    clip = out / "spk" / "00001"
    assert sorted(os.listdir(clip)) == sorted([f"{i}.jpg" for i in range(6)]
                                              + ["audio.wav", "text.txt"])
    assert (clip / "text.txt").read_text() == "hello there\n"

    gen = str(tmp_path / "gen.pt")
    save_once(gen, {"gen": seeded(lambda: TalkingFaceGenerator(width=0.125), 3).state_dict()})
    result = str(tmp_path / "result.mp4")
    assert cli.main(["infer-lipsync", "--face", video, "--audio", str(data / "00001.wav"),
                     "--out", result, "--checkpoint", gen, "--int8", "--nosmooth",
                     "--pads", "0", "4", "0", "0"] + TINY_GAN, device="cpu") == 0
    assert "(6 frames, muxed=" in capsys.readouterr().out and os.path.exists(result)


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
                "train-landmark", "lipread-e2e", "build-frame-index", "pack-gan-records",
                "pack-diffusion-records", "sample-diffusion", "train-feature-transformer",
                "port-densenet"):
        assert cmd in r.stdout


def _lrs2_tree(root, n=2, frames=14, size=32):
    """An LRS2-layout tree: <spk>/<id>.mp4 (OpenCV), a sidecar wav and a
    transcript each."""
    import cv2
    import numpy as np
    from lipreading_video_generation_tpu_torch.data import video as tvideo

    spk = root / "spk"
    spk.mkdir(parents=True)
    for i in range(n):
        rng = np.random.default_rng(i)
        w = cv2.VideoWriter(str(spk / f"{i:05d}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 25.0,
                            (size, size))
        for _ in range(frames):
            w.write(rng.integers(0, 256, (size, size, 3), dtype=np.uint8))
        w.release()
        tvideo.save_wav(str(spk / f"{i:05d}.wav"),
                        rng.standard_normal(640 * frames).astype(np.float32))
        (spk / f"{i:05d}.txt").write_text("Text:  HELLO THERE\nConf:  5\n")
    return str(root)


def test_build_frame_index_then_train_on_it(tmp_path, capsys):
    """build-frame-index over an OpenCV-written tree gives the JAX package's
    index; train-diffusion and train-superres take it (--frame-index)."""
    from lipreading_video_generation_tpu.data import datasets as jdata
    from lipreading_video_generation_tpu.data import manifest as jmanifest
    from lipreading_video_generation_tpu_torch.data import datasets as tdata

    root = _lrs2_tree(tmp_path / "lrs2")
    idx = str(tmp_path / "idx.pkl")
    assert cli.main(["build-frame-index", "--data-root", root, "--out", idx, "--step", "4"],
                    device="cpu") == 0
    records, _ = jmanifest.build_manifest(root)
    want = jdata.build_frame_index([r.video_path for r in records], step=4)
    got = tdata.load_frame_index(idx)
    assert len(got) == 6 and [tuple(vars(i).values()) for i in got] == [
        (i.video_path, i.frame_start, i.frame_end) for i in want]
    assert f"6 frame pairs → {idx}" in capsys.readouterr().out
    ck = tmp_path / "ck"
    assert cli.main(["train-diffusion", "--frame-index", idx, "--steps", "2",
                     "--checkpoint-dir", str(ck), "--checkpoint-every", "2"] + TINY_DIFFUSION,
                    device="cpu") == 0
    assert sorted(os.listdir(ck)) == ["step_000000002.pt"]
    sr = tmp_path / "sr"
    assert cli.main(["train-superres", "--frame-index", idx, "--steps", "3",
                     "--steps-per-dispatch", "2", "--checkpoint-dir", str(sr)] + TINY_SUPERRES,
                    device="cpu") == 0
    assert sorted(os.listdir(sr)) == ["step_000000003.pt"]


def _same_files(a, b):
    import filecmp

    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    assert all(filecmp.cmp(os.path.join(a, n), os.path.join(b, n), shallow=False) for n in names)


def test_pack_records_equal_the_jax_cli_and_train_from_them(tmp_path, capsys):
    """pack-gan-records / pack-diffusion-records --synthetic write the JAX
    CLI's files byte for byte; train-gan and train-diffusion stream them by
    the native route, several steps a dispatch."""
    from lipreading_video_generation_tpu_torch.data import records as trec

    for cmd, sets, b in (("pack-gan-records", [], 340484),
                         ("pack-diffusion-records", TINY_DIFFUSION, 4736)):
        argv = [cmd, "--synthetic", "--num-records", "3"] + sets
        assert cli.main(argv + ["--out", str(tmp_path / f"t{cmd}")], device="cpu") == 0
        assert f"3 records ({b} B each)" in capsys.readouterr().out
        assert jcli.main(argv + ["--out", str(tmp_path / f"j{cmd}")]) == 0
        _same_files(tmp_path / f"t{cmd}", tmp_path / f"j{cmd}")
    before = trec.iter_record_batches.route_counts["native"]
    ck = tmp_path / "gan"
    assert cli.main(["train-gan", "--records-root", str(tmp_path / "tpack-gan-records"),
                     "--steps", "3", "--steps-per-dispatch", "4", "--checkpoint-dir", str(ck),
                     "--set", "gan.checkpoint_interval=3"] + TINY_GAN, device="cpu") == 0
    assert sorted(os.listdir(ck)) == ["step_3.pt"]
    ck = tmp_path / "diff"
    assert cli.main(["train-diffusion", "--records-root",
                     str(tmp_path / "tpack-diffusion-records"), "--steps", "3",
                     "--checkpoint-dir", str(ck), "--checkpoint-every", "3"] + TINY_DIFFUSION,
                    device="cpu") == 0
    assert sorted(os.listdir(ck)) == ["step_000000003.pt"]
    assert trec.iter_record_batches.route_counts["native"] == before + 2


def _png(path):
    import cv2

    return cv2.imread(str(path), cv2.IMREAD_UNCHANGED)[:, :, ::-1]


def test_sample_diffusion(tmp_path, capsys):
    """One frame from inputs drawn as the JAX CLI draws them equals
    ``sample`` called directly (same seeded model, generator seed); a clip
    from a checkpoint's EMA as PNGs and as video; a frame conditioned on a
    video; a guided frame; a two-stage cascade."""
    import numpy as np
    from lipreading_video_generation_tpu_torch.core.prng import seeded
    from lipreading_video_generation_tpu_torch.models.unet_audio import UNetAudio
    from lipreading_video_generation_tpu_torch.pipelines import sample_diffusion as tsd

    out = tmp_path / "x.png"
    assert cli.main(["sample-diffusion", "--ddim-steps", "3", "--seed", "2", "--out", str(out)]
                    + TINY_DIFFUSION, device="cpu") == 0
    assert f"wrote {out} (+1 snapshots available)" in capsys.readouterr().out
    cfg = cli.build_config(argparse.Namespace(seed=2, overrides=TINY_DIFFUSION[1::2]))
    d = cfg.diffusion
    rng = np.random.default_rng(2)         # the JAX CLI's draws, in its order
    cond = rng.integers(0, 256, (1, d.im_size, d.im_size, 3), dtype=np.uint8)
    audio = rng.standard_normal((1, d.audio_samples)).astype(np.float32)
    x0, _ = tsd.sample(seeded(lambda: UNetAudio(d), 2).eval(), cond, audio, d,
                       num_inference_steps=3, generator=torch.Generator().manual_seed(2))
    np.testing.assert_array_equal(_png(out), (x0[0] * 255).to(torch.uint8).numpy())

    ck = str(tmp_path / "ck")
    assert cli.main(["train-diffusion", "--synthetic", "--steps", "1", "--checkpoint-dir", ck,
                     "--checkpoint-every", "1"] + TINY_DIFFUSION, device="cpu") == 0
    clip = str(tmp_path / "clip")
    assert cli.main(["sample-diffusion", "--checkpoint", ck, "--frames", "3", "--ddim-steps",
                     "2", "--sampler", "dpmpp", "--out", clip] + TINY_DIFFUSION,
                    device="cpu") == 0
    assert f"wrote 3-frame clip → {clip}" in capsys.readouterr().out
    frames = [_png(f"{clip}.{j:04d}.png") for j in range(3)]
    assert all(f.shape == (16, 16, 3) for f in frames)
    assert cli.main(["sample-diffusion", "--checkpoint", ck, "--no-ema", "--frames", "2",
                     "--ddim-steps", "2", "--out", clip + ".mp4"] + TINY_DIFFUSION,
                    device="cpu") == 0
    assert os.path.getsize(clip + ".mp4") > 0

    video = os.path.join(_lrs2_tree(tmp_path / "lrs2", n=1), "spk", "00000.mp4")
    assert cli.main(["sample-diffusion", "--cond-video", video, "--ddim-steps", "2", "--eta",
                     "1", "--out", str(tmp_path / "v.png")] + TINY_DIFFUSION, device="cpu") == 0

    clf = str(tmp_path / "clf.pt")
    assert cli.main(["train-noisy-classifier", "--synthetic", "--steps", "1", "--out", clf]
                    + TINY_DIFFUSION + TINY_CLASSIFIER, device="cpu") == 0
    assert cli.main(["sample-diffusion", "--classifier-checkpoint", clf, "--class-label", "1",
                     "--guidance-scale", "3", "--ddim-steps", "2", "--out",
                     str(tmp_path / "g.png")] + TINY_DIFFUSION + TINY_CLASSIFIER,
                    device="cpu") == 0
    assert _png(tmp_path / "g.png").shape == (16, 16, 3)

    sr = str(tmp_path / "sr")
    assert cli.main(["train-superres", "--synthetic", "--steps", "1", "--checkpoint-dir", sr]
                    + TINY_SUPERRES, device="cpu") == 0
    assert cli.main(["sample-diffusion", "--sr-checkpoint", sr, "--sr-steps", "2",
                     "--ddim-steps", "2", "--out", str(tmp_path / "hi.png")] + TINY_DIFFUSION
                    + TINY_SUPERRES + ["--set", "diffusion.im_size=8"], device="cpu") == 0
    assert _png(tmp_path / "hi.png").shape == (16, 16, 3)
