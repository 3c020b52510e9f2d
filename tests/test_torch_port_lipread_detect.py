"""The port's face detection — box math, S3FD, face tracks — against the JAX
package, on the same numpy inputs and the same weights (Flax params bridged
by ``models.convert.s3fd_state_dict_from_flax``)."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from lipreading_video_generation_tpu.core.config import PreprocessConfig as JPre
from lipreading_video_generation_tpu.models import face_api as jface
from lipreading_video_generation_tpu.models import s3fd as js3fd
from lipreading_video_generation_tpu.ops import bbox as jbbox
from lipreading_video_generation_tpu.pipelines import inference as jinf
from lipreading_video_generation_tpu_torch.core.config import PreprocessConfig as TPre
from lipreading_video_generation_tpu_torch.models import face_api as tface
from lipreading_video_generation_tpu_torch.models import s3fd as ts3fd
from lipreading_video_generation_tpu_torch.models.convert import s3fd_state_dict_from_flax
from lipreading_video_generation_tpu_torch.ops import bbox as tbbox
from lipreading_video_generation_tpu_torch.pipelines import inference as tinf

HW = 64


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)   # six test workers share the host
    yield
    torch.set_num_threads(n)


def flax_s3fd_params(seed: int) -> dict:
    """Weights in the Flax ``S3FD``'s tree and shapes, made with numpy (a
    Flax init costs ~14 s of CPU here): HWIO kernels ~ N(0, 1/fan_in), as
    Flax's lecun-normal init draws them, small biases, the L2Norm scales at
    their init (10, 8, 5). The classifier heads'
    kernels get 3× that: their face scores then spread instead of crowding
    around 0.5 within float32 noise of each other (checked by
    ``_top_scores_apart``)."""
    rng = np.random.default_rng(seed)
    params = {}
    with torch.device("meta"):                  # names and shapes only
        shapes = ts3fd.S3FD().state_dict()
    for name, p in shapes.items():
        mod, leaf = name.rsplit(".", 1)
        if p.ndim == 4:
            o, i, kh, kw = p.shape
            std = np.sqrt(1.0 / (i * kh * kw)) * (3.0 if mod.endswith("_conf") else 1.0)
            params.setdefault(mod, {})["kernel"] = (
                std * rng.standard_normal((kh, kw, i, o))).astype(np.float32)
        elif leaf == "bias":
            params[mod]["bias"] = (0.01 * rng.standard_normal(p.shape)).astype(np.float32)
        else:
            scale = dict((n, c) for n, _, c in ts3fd._NORMS)[mod]
            params[mod] = {"weight": np.full(p.shape, scale, np.float32)}
    return params


@pytest.fixture(scope="module")
def s3fd():
    """Flax S3FD params for the module, the port's S3FD on the same weights,
    and 6 frames of 64×64 RGB with a drawn face."""
    params = flax_s3fd_params(0)
    model = ts3fd.S3FD().eval()
    model.load_state_dict(s3fd_state_dict_from_flax(params))
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (6, HW, HW, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:HW, 0:HW]
    for t in range(6):
        frames[t][((xx - 32 - t) / 18) ** 2 + ((yy - 30) / 24) ** 2 <= 1] = (190, 160, 140)
    return params, model, frames.astype(np.uint8)


def _boxes(rng, n, lo=20.0, hi=200.0):
    c = rng.uniform(lo, hi, (n, 2))
    s = rng.uniform(5, 40, (n, 2))
    return np.concatenate([c - s, c + s], axis=1).astype(np.float32)


def _close(got, want, rel=1e-6):
    """Within ``rel`` of the largest |value| of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * max(1.0, np.abs(want).max()))


def test_box_math_matches_jax():
    """iou_matrix, encode, decode, make_anchor_grid and dense_decode_scale
    within 1e-6 relative (float32 arithmetic in the same order)."""
    rng = np.random.default_rng(1)
    a, b = _boxes(rng, 9), _boxes(rng, 7)
    _close(tbbox.iou_matrix(torch.from_numpy(a), torch.from_numpy(b)),
           jbbox.iou_matrix(jnp.asarray(a), jnp.asarray(b)))
    priors = np.concatenate([rng.uniform(40, 120, (9, 2)), rng.uniform(16, 64, (9, 2))],
                            axis=1).astype(np.float32)
    _close(tbbox.encode(torch.from_numpy(a), torch.from_numpy(priors)),
           jbbox.encode(jnp.asarray(a), jnp.asarray(priors)))
    loc = rng.normal(0, 0.5, (3, 9, 4)).astype(np.float32)
    _close(tbbox.decode(torch.from_numpy(loc), torch.from_numpy(priors)[None]),
           jbbox.decode(jnp.asarray(loc), jnp.asarray(priors)[None]))
    np.testing.assert_array_equal(tbbox.make_anchor_grid(5, 7, 16),
                                  jbbox.make_anchor_grid(5, 7, 16))
    cls = rng.normal(0, 2, (2, 5, 7, 2)).astype(np.float32)
    reg = rng.normal(0, 0.5, (2, 5, 7, 4)).astype(np.float32)
    for got, want in zip(tbbox.dense_decode_scale(torch.from_numpy(cls), torch.from_numpy(reg), 16),
                         jbbox.dense_decode_scale(jnp.asarray(cls), jnp.asarray(reg), 16)):
        _close(got, want)


@pytest.mark.parametrize("case", ["random", "ties", "fewer_than_max_keep", "below_threshold"])
def test_nms_matches_jax(case):
    """``idx`` and ``keep`` equal, batched over images: the port takes its
    top slots with a stable descending sort, so tied scores keep the lower
    index first as ``lax.top_k`` does; fewer boxes than ``max_keep`` pad with
    index 0 and keep False."""
    rng = np.random.default_rng(2)
    n, max_keep = {"fewer_than_max_keep": (5, 8)}.get(case, (40, 8))
    boxes = np.stack([_boxes(rng, n, 20, 80) for _ in range(3)])
    scores = rng.uniform(0.0, 1.0, (3, n)).astype(np.float32)
    if case == "ties":
        scores = np.round(scores * 4) / 4          # five distinct values
        boxes[:, n // 2:] = boxes[:, :n - n // 2]  # tied scores on equal boxes too
    if case == "below_threshold":
        scores[:, ::2] = 0.01
    idx_t, keep_t = tbbox.nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.3,
                              max_keep=max_keep, score_threshold=0.05)
    assert idx_t.shape == keep_t.shape == (3, max_keep)
    for i in range(3):
        idx_j, keep_j = jbbox.nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), 0.3,
                                  max_keep=max_keep, score_threshold=0.05)
        np.testing.assert_array_equal(idx_t[i].numpy(), np.asarray(idx_j))
        np.testing.assert_array_equal(keep_t[i].numpy(), np.asarray(keep_j))


def test_s3fd_heads_and_decode_match_jax(s3fd):
    """The 12 heads within 1e-4 abs (of each head's largest |value|) and
    1e-4 relative at 64×64 (float32 convolutions, sums in another order);
    ``decode_detections`` within 1e-3 px and 1e-5 in score."""
    params, model, frames = s3fd
    bgr = frames[..., ::-1].astype(np.float32)
    heads_j = js3fd.S3FD().apply({"params": params}, js3fd.preprocess_input(jnp.asarray(bgr)))
    with torch.no_grad():
        heads_t = model(ts3fd.preprocess_input(torch.from_numpy(np.ascontiguousarray(bgr))))
    assert len(heads_t) == 12
    for t, j in zip(heads_t, heads_j):
        j = np.asarray(j)
        np.testing.assert_allclose(t.permute(0, 2, 3, 1).numpy(), j, rtol=1e-4,
                                   atol=1e-4 * np.abs(j).max())
    boxes_j, scores_j = js3fd.decode_detections(heads_j)
    boxes_t, scores_t = ts3fd.decode_detections(heads_t)
    np.testing.assert_allclose(boxes_t.numpy(), np.asarray(boxes_j), rtol=0, atol=1e-3)
    np.testing.assert_allclose(scores_t.numpy(), np.asarray(scores_j), rtol=0, atol=1e-5)


def _top_scores_apart(scores: np.ndarray, k: int = 9, gap: float = 1e-4) -> bool:
    """No two of each image's top ``k`` scores (the 8 slots and the next),
    and none of them and the 0.5 threshold, lie within ``gap`` of each
    other: then which anchors fill the slots, their order and their validity
    cannot flip on float32 rounding."""
    for s in scores:
        top = np.sort(np.append(s[np.argsort(s)[::-1][:k]], 0.5))
        if np.diff(top).min() <= gap:
            return False
    return True


@pytest.mark.parametrize("flip", [False, True], ids=["detect_faces", "flip_detect"])
def test_detect_faces_matches_jax(s3fd, flip):
    """Valid slots equal, their boxes within 1e-3 px and scores within
    1e-5, on inputs whose top scores lie more than 1e-4 apart (checked)."""
    params, model, frames = s3fd
    bgr = frames[..., ::-1].astype(np.float32)
    jfn, tfn = (js3fd.flip_detect, ts3fd.flip_detect) if flip else (js3fd.detect_faces,
                                                                   ts3fd.detect_faces)
    _, scores_all = js3fd.decode_detections(js3fd.S3FD().apply(
        {"params": params}, js3fd.preprocess_input(jnp.asarray(bgr[:, :, ::-1] if flip else bgr))))
    assert _top_scores_apart(np.asarray(scores_all))
    bj, sj, vj = (np.asarray(a) for a in jfn(js3fd.S3FD(), params, jnp.asarray(bgr)))
    bt, st, vt = (a.numpy() for a in tfn(model, torch.from_numpy(np.ascontiguousarray(bgr))))
    np.testing.assert_array_equal(vt, vj)
    assert vj.any()
    np.testing.assert_allclose(bt[vt], bj[vj], rtol=0, atol=1e-3)
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-5)


@pytest.mark.parametrize("pads,nosmooth,n_frames", [((0, 0, 0, 0), False, 6),
                                                    ((2, 10, 3, 1), True, 6),
                                                    ((0, 10, 0, 0), False, 5)])
def test_detect_face_tracks_matches_jax(s3fd, pads, nosmooth, n_frames):
    """(T, 4) y1y2x1x2 tracks within 1e-3 px: detection batches of 6 (5
    frames: the batch padded by repeating the last frame), best face per
    frame, carry-forward of undetected frames, pads clipped to the frame,
    smoothing."""
    params, model, frames = s3fd
    frames = frames[:n_frames]
    kw = dict(pads=pads, nosmooth=nosmooth)
    want = jinf.detect_face_tracks(params, frames, JPre(face_det_batch_size=6), **kw)
    got = tinf.detect_face_tracks(model, frames, TPre(face_det_batch_size=6), **kw)
    assert got.dtype == torch.float32 and got.shape == (len(frames), 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def test_detect_face_tracks_fills_undetected_frames_as_jax(s3fd, monkeypatch):
    """Frames 0-1 and 4 undetected: 0-1 take frame 2's box, 4 takes 3's; with
    no detection at all every box is the whole frame. The same detections
    go into both sides' fill logic."""
    _, model, frames = s3fd
    rng = np.random.default_rng(3)
    boxes = _boxes(rng, len(frames), 10, 50)[:, None].repeat(8, 1)
    for valid in ([False, False, True, True, False, True], [False] * 6):
        v = np.array(valid)[:, None].repeat(8, 1)

        def fake(n):
            return boxes[:n], np.ones((n, 8), np.float32), v[:n]

        monkeypatch.setattr(jinf, "detect_faces", lambda m, p, x, **k: fake(len(x)))
        monkeypatch.setattr(tinf, "detect_faces",
                            lambda m, x, **k: tuple(map(torch.from_numpy, fake(len(x)))))
        cfg = dict(face_det_batch_size=len(frames))
        want = jinf.detect_face_tracks(None, frames, JPre(**cfg), nosmooth=True)
        got = tinf.detect_face_tracks(model, frames, TPre(**cfg), nosmooth=True)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0)


def test_s3fd_pth_layout_round_trip(s3fd, tmp_path):
    """The port's ``state_dict`` is ``s3fd.pth``'s layout: JAX's
    ``convert_torch_state_dict`` of it gives back the Flax params and
    ``s3fd_state_dict_from_flax`` of those the state dict (inverses), and a
    ``torch.save``d one loads through ``lipreading_e2e.run``'s
    ``s3fd_checkpoint`` path (``load_state_dict``, strict)."""
    params, model, _ = s3fd
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = js3fd.convert_torch_state_dict(sd)
    assert set(back) == set(params)
    for mod, leaves in params.items():
        assert set(back[mod]) == set(leaves)
        for leaf, arr in leaves.items():
            np.testing.assert_array_equal(back[mod][leaf], arr)
    again = s3fd_state_dict_from_flax(back)
    assert set(again) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(again[k].numpy(), v)
    path = tmp_path / "s3fd.pt"
    torch.save(model.state_dict(), path)
    fresh = ts3fd.S3FD()
    fresh.load_state_dict(torch.load(path, weights_only=True))
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v)


def test_face_alignment_matches_jax(s3fd):
    """``get_detections_for_batch``: per image the best face's int box, or
    None, as the JAX API gives it."""
    params, model, frames = s3fd
    bgr = np.ascontiguousarray(frames[..., ::-1])
    want = jface.FaceAlignment(params=params).get_detections_for_batch(bgr)
    api = tface.FaceAlignment(state_dict=model.state_dict(), device="cpu")
    assert api.get_detections_for_batch(bgr) == want
