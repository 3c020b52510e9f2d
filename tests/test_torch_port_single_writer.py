"""Under a process group every output of the port's CLI is written once, by
the primary rank, and equals what one process writes.

``cli.main`` joins every rank to the group (torchrun), and every rank runs
the command: the commands that write files leave them to the primary rank,
behind a barrier (``parallel.distributed.write_once``, ``atomic_save``).
The group here is two gloo ranks on the CPU (``torch_parallel_tasks.LocalGroup``);
its non-primary rank records any write under the output directory
(``torch_parallel_tasks.cli_main(..., watch_root=...)``), which must be
none, and the files are compared byte for byte with the same command run in this process (one
thread, as each rank has). ``preprocess-gan`` takes its host id and count
from the rank and the world size, and refuses both flags under a group.
"""
import os

import numpy as np
import pytest
import torch

from lipreading_video_generation_tpu_torch import cli

import torch_parallel_tasks as tasks
from torch_parallel_tasks import LocalGroup


def _set(section, **kw):
    return [a for k, v in kw.items() for a in ("--set", f"{section}.{k}={v}")]


TINY_DIFFUSION = _set("diffusion", im_size=16, base_channels=16, channel_mult="(1,2)",
                      num_res_blocks=1, attention_resolutions="(2,)", num_heads=2,
                      time_embed_dim=16, audio_embed_dim=16, audio_proj_dim=4,
                      im_cond_channels=4, audio_samples=800, num_timesteps=10,
                      dtype="float32", batch_size=2)
TINY_CLASSIFIER = _set("classifier", num_classes=4, base_channels=8, channel_mult="(1,2)",
                       num_res_blocks=1, attention_resolutions="(2,)", num_heads=2,
                       time_embed_dim=16, batch_size=4, dtype="float32")
TINY_GAN = _set("gan", model_width=0.125, batch_size=2, dtype="float32")


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    with LocalGroup(2, str(tmp_path_factory.mktemp("gloo") / "store")) as g:
        yield g


def _one_process(argv):
    """``argv`` in this process on one thread (the ranks' count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert cli.main(argv, device="cpu") == 0
    finally:
        torch.set_num_threads(n)


def _files(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def _same_as_one_process(group, tmp_path, argv_at):
    """``argv_at(dir)`` on the group (the non-primary rank writes nothing
    under its directory) and in this process: the two directories hold the same
    files, byte for byte, and no temporary file is left."""
    g, one = tmp_path / "group", tmp_path / "one"
    g.mkdir()
    one.mkdir()
    assert group.run(tasks.cli_main, argv_at(str(g)), str(g)) == [{"rc": 0, "wrote": []}] * 2
    _one_process(argv_at(str(one)))
    got, want = _files(g), _files(one)
    assert sorted(got) == sorted(want) and want
    assert not [n for n in got if n.endswith(".tmp")]
    for name in want:
        assert got[name] == want[name], name
    return got


def _lrs2_tree(root, n=2, frames=10, size=32):
    """An LRS2-layout tree of OpenCV-written mp4s with transcripts."""
    import cv2

    spk = root / "spk"
    spk.mkdir(parents=True)
    for i in range(n):
        rng = np.random.default_rng(i)
        w = cv2.VideoWriter(str(spk / f"{i:05d}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 25.0,
                            (size, size))
        for _ in range(frames):
            w.write(rng.integers(0, 256, (size, size, 3), dtype=np.uint8))
        w.release()
        (spk / f"{i:05d}.txt").write_text("Text:  HELLO THERE\nConf:  5\n")
    return str(root)


def test_build_frame_index_writes_once(group, tmp_path):
    root = _lrs2_tree(tmp_path / "lrs2")
    got = _same_as_one_process(group, tmp_path, lambda d: [
        "build-frame-index", "--data-root", root, "--out", os.path.join(d, "idx.pkl"),
        "--step", "4"])
    assert list(got) == ["idx.pkl"]


@pytest.mark.parametrize("cmd,extra", [
    ("pack-diffusion-records", TINY_DIFFUSION),
    ("pack-gan-records", TINY_GAN),
], ids=["diffusion", "gan"])
def test_pack_records_write_once(group, tmp_path, cmd, extra):
    got = _same_as_one_process(group, tmp_path, lambda d: [
        cmd, "--synthetic", "--out", os.path.join(d, "recs"), "--num-records", "3"] + extra)
    assert sorted(got) == [os.path.join("recs", n) for n in
                           ("000000.rec", "000001.rec", "000002.rec", "records_spec.json")]


def test_train_noisy_classifier_writes_once(group, tmp_path):
    got = _same_as_one_process(group, tmp_path, lambda d: [
        "train-noisy-classifier", "--synthetic", "--steps", "1", "--out",
        os.path.join(d, "clf.pt"), "--set", "diffusion.im_size=16"] + TINY_CLASSIFIER)
    assert list(got) == ["clf.pt"]


def test_port_selftest_writes_once(group, tmp_path):
    """``port-wav2vec2 --selftest``: the seeded source file, the artifact's
    state dict and its config.json, each written once."""
    got = _same_as_one_process(group, tmp_path, lambda d: [
        "port-wav2vec2", "--selftest", "--out", os.path.join(d, "w2v")])
    assert sorted(got) == sorted([os.path.join("w2v", "wav2vec2.config.json"),
                                  os.path.join("w2v", "wav2vec2.pt"), "w2v.selftest_src.pth"])


def test_preprocess_gan_takes_its_share_from_the_rank(group):
    """Without --host-id/--num-hosts each rank takes every world-size-th
    clip from its rank on (5 clips: ranks 0 and 1 take [0, 2, 4] and
    [1, 3]); either flag under a group of 2 is a usage error; one process
    still takes the flags."""
    got = group.run(tasks.preprocess_shares, 5)
    assert [g["ids"] for g in got] == [[0, 2, 4], [1, 3]]
    for kw in ({"host_id": 0}, {"num_hosts": 2}, {"host_id": 1, "num_hosts": 2}):
        assert [g["exit"] for g in group.run(tasks.preprocess_shares, 5, **kw)] == [2, 2]
    assert tasks.preprocess_shares(5, host_id=1, num_hosts=2)["ids"] == [1, 3]
    assert tasks.preprocess_shares(5)["ids"] == [0, 1, 2, 3, 4]
