"""The port's pretrained-model commands on the CPU (``cli.main(argv,
device="cpu")``): ``port-s3fd``, ``port-avhubert`` and ``port-wav2vec2``
(each with ``--selftest`` and with ``--pth``), ``train-lip-expert``, and the
flags ``train-diffusion --wav2vec2-checkpoint`` (then ``sample-diffusion``
on what it trained) and ``train-gan --lip-expert-checkpoint`` /
``--avhubert-checkpoint``, at tiny sizes."""
import json

import numpy as np
import pytest
import torch

from lipreading_video_generation_tpu_torch import cli
from lipreading_video_generation_tpu_torch.models import ports, selftest
from lipreading_video_generation_tpu_torch.pipelines import train_diffusion as ttd
from lipreading_video_generation_tpu_torch.pipelines import train_lip_expert as ttle


def _set(section, **kw):
    return [a for k, v in kw.items() for a in ("--set", f"{section}.{k}={v}")]


TINY_GAN = _set("gan", model_width=0.125, batch_size=2, dtype="float32", lip_weight=0.5)
TINY_DIFFUSION = _set("diffusion", im_size=16, base_channels=16, channel_mult="(1,2)",
                      num_res_blocks=1, attention_resolutions="(2,)", num_heads=2,
                      time_embed_dim=16, audio_proj_dim=4, im_cond_channels=4,
                      audio_samples=800, num_timesteps=10, dtype="float32", batch_size=2)
# the small wav2vec2 of models/selftest, for a command that reads no artifact
SMALL_W2V = _set("diffusion", audio_encoder="wav2vec2", audio_embed_dim=64, w2v_num_layers=2,
                 w2v_num_heads=4, w2v_ffn_dim=128, w2v_conv_dim="(24,24,24)",
                 w2v_conv_kernel="(10,3,3)", w2v_conv_stride="(5,2,2)", w2v_pos_conv_kernel=16,
                 w2v_pos_conv_groups=4)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)   # six test workers share the host
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["s3fd", "avhubert", "wav2vec2"])
def test_port_command_selftest_then_pth(tmp_path, capsys, name):
    """``--selftest`` writes a checkpoint in the published layout, ports it
    and runs the model (a JSON line); ``--pth`` on that file ports it again
    to the same weights."""
    out = str(tmp_path / ("art.pt" if name == "s3fd" else "art"))
    assert cli.main([f"port-{name}", "--selftest", "--out", out], device="cpu") == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["selftest"] == f"port-{name}" and len(summary["pth_sha256"]) == 64
    again = str(tmp_path / ("again.pt" if name == "s3fd" else "again"))
    extra = ["--num-heads", "4"] if name == "wav2vec2" else []
    assert cli.main([f"port-{name}", "--pth", summary["pth"], "--out", again] + extra,
                    device="cpu") == 0
    assert "ported" in capsys.readouterr().out
    if name == "s3fd":
        a, b = ports.load_s3fd_params(out), ports.load_s3fd_params(again)
        assert summary["n_detections"] >= 1
    elif name == "avhubert":
        a, b = ports.load_avhubert_expert(out)[1], ports.load_avhubert_expert(again)[1]
        assert summary["feature_shape"] == [1, 3, 64]
    else:
        a, b = ports.load_wav2vec2_params(out)[0], ports.load_wav2vec2_params(again)[0]
        assert summary["config"]["conv_dim"] == [24, 24, 24]
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_train_lip_expert_then_train_gan_with_it(tmp_path, capsys):
    """``train-lip-expert --synthetic`` (word-coded clips with transcripts)
    saves the expert; ``train-gan --lip-expert-checkpoint`` at
    ``gan.lip_weight`` 0.5 trains against it on transcript batches."""
    le = str(tmp_path / "le.pt")
    assert cli.main(["train-lip-expert", "--synthetic", "--steps", "2", "--out", le]
                    + _set("gan", batch_size=2), device="cpu") == 0
    out = capsys.readouterr()
    assert "saved expert" in out.out and "loss=" in out.err
    params = ttle.load_params(le)
    assert set(params) == set(ttle.default_expert().state_dict())
    ck = str(tmp_path / "gan")
    assert cli.main(["train-gan", "--synthetic", "--steps", "2", "--lip-expert-checkpoint", le,
                     "--checkpoint-dir", ck, "--set", "gan.checkpoint_interval=2"] + TINY_GAN,
                    device="cpu") == 0
    line = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("[step 0]")][0]
    lip = float(line.split("loss/lip=")[1].split(",")[0])
    assert lip > 1.0          # character cross-entropy of an expert that read 2 batches


def test_train_gan_with_avhubert_checkpoint(tmp_path, capsys):
    av = str(tmp_path / "av")
    assert cli.main(["port-avhubert", "--selftest", "--out", av], device="cpu") == 0
    capsys.readouterr()
    assert cli.main(["train-gan", "--synthetic", "--steps", "1", "--avhubert-checkpoint", av]
                    + TINY_GAN, device="cpu") == 0
    line = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("[step 0]")][0]
    assert 0 < float(line.split("loss/lip=")[1].split(",")[0]) < 1e3


def test_train_diffusion_with_wav2vec2_then_sample(tmp_path, capsys):
    """``train-diffusion --wav2vec2-checkpoint`` takes the encoder's sizes
    from the artifact, starts it from the ported weights and trains it
    jointly; ``sample-diffusion`` samples the checkpoint with the same
    sizes given by ``--set``."""
    w2v = str(tmp_path / "w2v")
    assert cli.main(["port-wav2vec2", "--selftest", "--out", w2v], device="cpu") == 0
    ck = str(tmp_path / "ck")
    assert cli.main(["train-diffusion", "--synthetic", "--steps", "2", "--wav2vec2-checkpoint",
                     w2v, "--checkpoint-dir", ck, "--checkpoint-every", "2"] + TINY_DIFFUSION,
                    device="cpu") == 0
    saved = ttd.load_checkpoint(ttd.latest_checkpoint(ck))
    ported, _ = ports.load_wav2vec2_params(w2v)
    trained = {k[len("audio_encoder."):]: v for k, v in saved["params"].items()
               if k.startswith("audio_encoder.")}
    assert set(trained) == set(ported)
    assert not torch.equal(trained["proj.weight"], ported["proj.weight"])   # trained jointly
    assert float((trained["proj.weight"] - ported["proj.weight"]).abs().max()) < 1e-3
    capsys.readouterr()
    out = str(tmp_path / "x0")
    assert cli.main(["sample-diffusion", "--checkpoint", ck, "--ddim-steps", "2", "--frames", "2",
                     "--out", out] + TINY_DIFFUSION + SMALL_W2V, device="cpu") == 0
    assert "2-frame clip" in capsys.readouterr().out
    assert (tmp_path / "x0.0000.png").exists() and (tmp_path / "x0.0001.png").exists()


def test_train_lip_expert_needs_transcripts(tmp_path, capsys):
    """On clip directories without ``text.txt`` the command says so."""
    import wave

    clip = tmp_path / "clips" / "c0"
    clip.mkdir(parents=True)
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    for i in range(20):
        cv2.imwrite(str(clip / f"{i}.jpg"), rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
    with wave.open(str(clip / "audio.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.zeros(16000, np.int16).tobytes())
    with pytest.raises(SystemExit) as e:
        cli.main(["train-lip-expert", "--preprocessed-root", str(tmp_path / "clips")],
                 device="cpu")
    assert e.value.code == 2 and "needs transcripts" in capsys.readouterr().err


def test_selftest_wav2vec2_writes_both_weight_norm_layouts(tmp_path):
    a = selftest.make_wav2vec2_selftest_pth(str(tmp_path / "a.pth"), weight_norm="weight_g")
    b = selftest.make_wav2vec2_selftest_pth(str(tmp_path / "b.pth"),
                                            weight_norm="parametrizations")
    sa, _, _ = ports.port_wav2vec2(a, str(tmp_path / "A"))
    sb, _, _ = ports.port_wav2vec2(b, str(tmp_path / "B"))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
