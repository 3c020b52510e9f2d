"""The port's lip-landmark regressor, its training, and the image ops it
needs (``map_coordinates``, ``resize(method="nearest")``), against the JAX
package on the same numpy inputs and weights (Flax params bridged by
``models.convert.lip_landmark_state_dict_from_flax``); the checkpoints of
``core.checkpoint``."""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lipreading_video_generation_tpu.models import lip_landmark as jll
from lipreading_video_generation_tpu.ops import image as jim
from lipreading_video_generation_tpu.pipelines import train_landmark as jtl
from lipreading_video_generation_tpu_torch.core import checkpoint as tckpt
from lipreading_video_generation_tpu_torch.models import lip_landmark as tll
from lipreading_video_generation_tpu_torch.models.convert import lip_landmark_state_dict_from_flax
from lipreading_video_generation_tpu_torch.ops import image as tim
from lipreading_video_generation_tpu_torch.pipelines import train_landmark as ttl


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)   # six test workers share the host
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def net():
    """One Flax init (width 32) for the module and the port on its weights."""
    params = jax.tree_util.tree_map(np.asarray, jll.init_params(jax.random.PRNGKey(0)))
    model = tll.LipLandmarkNet().eval()
    model.load_state_dict(lip_landmark_state_dict_from_flax(params))
    return params, model


def _crops(n, seed):
    return np.random.default_rng(seed).uniform(0, 1, (n, 64, 64, 1)).astype(np.float32)


def test_landmark_net_matches_jax(net):
    """Points within 1e-5 (float32; sums in another order)."""
    params, model = net
    x = _crops(3, 0)
    want = np.asarray(jll.LipLandmarkNet().apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 4, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_predict_mouth_boxes_matches_jax(net):
    """Crop, regress, map back, expand: (T, 4) boxes within 1e-3 px."""
    params, model = net
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (4, 96, 96, 3), dtype=np.uint8)
    boxes = (np.tile([10.0, 80.0, 12.0, 84.0], (4, 1)) + rng.uniform(-4, 4, (4, 4))).astype(
        np.float32)
    want = np.asarray(jll.predict_mouth_boxes(params, jnp.asarray(frames), jnp.asarray(boxes)))
    got = tll.predict_mouth_boxes(model, torch.from_numpy(frames), torch.from_numpy(boxes))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


def test_train_step_matches_jax(net):
    """One L1 + Adam step on the same arrays from the same params: loss
    within 1e-6, updated params within 1e-5. Adam's first update is
    lr·g/(|g| + 1e-8), which float32 noise in a gradient below 1e-6 (the
    heatmap bias's is 0 in exact arithmetic) moves by up to 2·lr: such
    entries are held to 2·lr, and may be at most 1 in 10^4 of the params (18
    of ~490,000 here)."""
    params, _ = net
    rng = np.random.default_rng(2)
    x = _crops(8, 3)
    pts = rng.uniform(0.2, 0.8, (8, 4, 2)).astype(np.float32)
    jstate = jtl.create_state(jax.random.PRNGKey(0))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jstate.replace(params=jparams, opt_state=jstate.tx.init(jparams))
    jstate, jm = jtl.train_step(jstate, jnp.asarray(x), jnp.asarray(pts))
    state = ttl.create_state(device="cpu")
    state.model.load_state_dict(lip_landmark_state_dict_from_flax(params))
    m = ttl.train_step(state, torch.from_numpy(x), torch.from_numpy(pts))
    assert state.step == 1
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=0, atol=1e-6)
    want = lip_landmark_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jstate.params))
    got = state.model.state_dict()
    grads = {k: p.grad for k, p in state.model.named_parameters()}
    assert set(got) == set(want) == set(grads)
    lr, ill_posed = 3e-4, 0
    for k in want:
        g = grads[k].numpy()
        d = np.abs(got[k].numpy() - want[k].numpy())
        small = np.abs(g) < 1e-6
        assert d[~small].max(initial=0) <= 1e-5, k
        assert d[small].max(initial=0) <= 2 * lr, k
        ill_posed += int((d[small] > 1e-5).sum())
    assert ill_posed <= 1e-4 * sum(v.numel() for v in got.values())


def test_render_faces_matches_jax():
    """The renderer on the same parameter arrays: images and points within
    1e-5."""
    rng = np.random.default_rng(4)
    n, size = 5, 64
    args = [rng.uniform(lo, hi, n).astype(np.float32)
            for lo, hi in ((0.35, 0.65), (0.55, 0.8), (0.08, 0.2), (0.03, 0.09), (0.55, 0.85))]
    noise = (0.03 * rng.standard_normal((n, size, size))).astype(np.float32)
    want_img, want_pts = jll._render_faces(*map(jnp.asarray, args), jnp.asarray(noise), size)
    got_img, got_pts = tll._render_faces(*map(torch.from_numpy, args), torch.from_numpy(noise), size)
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_pts.numpy(), np.asarray(want_pts), rtol=0, atol=1e-5)


def test_map_coordinates_matches_jax():
    """``ops.image.map_coordinates`` against ``jax.scipy.ndimage.map_coordinates(
    order=1, mode="nearest")`` at coordinates inside, on the edge and
    outside the image: within 1e-5."""
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 1, (3, 17, 23)).astype(np.float32)
    ys = rng.uniform(-3, 20, (3, 9, 11)).astype(np.float32)
    xs = rng.uniform(-3, 26, (3, 9, 11)).astype(np.float32)
    ys[:, 0, :3], xs[:, 0, :3] = [0.0, 16.0, 16.5], [0.0, 22.0, -0.5]
    want = np.stack([np.asarray(jax.scipy.ndimage.map_coordinates(
        jnp.asarray(img[i]), [jnp.asarray(ys[i]), jnp.asarray(xs[i])], order=1, mode="nearest"))
        for i in range(3)])
    got = tim.map_coordinates(torch.from_numpy(img), torch.from_numpy(ys), torch.from_numpy(xs))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("size", [(7, 5), (16, 16), (40, 9), (13, 31)])
def test_resize_nearest_matches_jax(dtype, size):
    """``resize(method="nearest")`` picks JAX's source pixels: equal."""
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (2, 13, 11, 3)).astype(dtype)
    want = np.asarray(jim.resize(jnp.asarray(img), size, "nearest"))
    got = tim.resize(torch.from_numpy(img), size, "nearest")
    assert got.dtype == torch.from_numpy(img).dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_affine_warp_moves_points_with_the_image():
    """Bright dots drawn at the 4 points land, after the warp, at the warped
    points (each dot's brightest pixel within 1 px)."""
    size, n = 64, 3
    rng = np.random.default_rng(7)
    pts = rng.uniform(0.3, 0.7, (n, 4, 2)).astype(np.float32)
    pts[:, :, 0] += np.array([-0.15, 0.15, 0.0, 0.0], np.float32)
    pts[:, :, 1] += np.array([0.0, 0.0, -0.15, 0.15], np.float32)
    yy, xx = np.mgrid[0:size, 0:size] + 0.5
    img = np.zeros((n, size, size, 1), np.float32)
    for i in range(n):
        for x, y in pts[i] * size:
            img[i, ..., 0] += np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / 2.0)
    theta = torch.tensor([0.3, -0.2, 0.0])
    scale, tx, ty = torch.tensor([1.1, 0.9, 1.0]), torch.tensor([0.05, -0.04, 0.0]), \
        torch.tensor([-0.03, 0.02, 0.0])
    out, moved = ttl.affine_warp(torch.from_numpy(img), torch.from_numpy(pts), theta, scale, tx, ty)
    assert out.shape == img.shape and moved.shape == pts.shape
    for i in range(n):
        for x, y in moved[i].numpy() * size:
            near = (np.abs(xx - x) <= 3) & (np.abs(yy - y) <= 3)
            j = np.argmax(np.where(near, out[i, ..., 0].numpy(), -1))
            assert abs(xx.flat[j] - x) <= 1.0 and abs(yy.flat[j] - y) <= 1.0


def test_augmentations_keep_shapes_and_range():
    """The curriculum and the photometric jitter: shapes kept, values and
    points in [0, 1], the same draws from the same generator state, other
    draws after it."""
    gen = torch.Generator().manual_seed(0)
    imgs, pts = tll.synthetic_face_batch(gen, 6)
    assert imgs.shape == (6, 64, 64, 1) and pts.shape == (6, 4, 2)
    assert ((pts > 0) & (pts < 1)).all() and imgs.min() >= 0 and imgs.max() <= 1
    outs = []
    for seed in (1, 1, 2):
        g = torch.Generator().manual_seed(seed)
        outs.append(ttl.full_augment(g, imgs, pts) + (ttl.photometric_augment(g, imgs),))
    for a, p, ph in outs:
        assert a.shape == imgs.shape and p.shape == pts.shape and ph.shape == imgs.shape
        for t in (a, p, ph):
            assert t.min() >= 0 and t.max() <= 1
    assert all(torch.equal(x, y) for x, y in zip(outs[0], outs[1]))
    assert not torch.equal(outs[0][0], outs[2][0])
    shifted, spts = tll.shifted_face_batch(torch.Generator().manual_seed(3), 4)
    assert shifted.shape == (4, 64, 64, 1) and spts.shape == (4, 4, 2)
    assert shifted.min() >= 0 and shifted.max() <= 1 and spts.min() >= 0 and spts.max() <= 1


def test_train_and_load_params_round_trip(tmp_path):
    """``train`` (a few steps, loss printed at ``log_every``) saves the
    final params; ``load_params`` gives a net with the same weights; a
    checkpoint of another net raises ``ValueError``."""
    state = ttl.train(num_steps=2, batch_size=4, checkpoint_dir=str(tmp_path / "lm"),
                      log_every=1, device="cpu")
    loaded = ttl.load_params(str(tmp_path / "lm"), device="cpu")
    for k, v in state.model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v)
    tckpt.save_once(str(tmp_path / "bad" / "params.pt"),
                    {"params": tll.init_params(width=16)})
    with pytest.raises(ValueError, match="retrain"):
        ttl.load_params(str(tmp_path / "bad"), device="cpu")


def test_checkpoint_manager_keeps_the_latest(tmp_path):
    """Step-numbered saves, ``max_to_keep`` oldest dropped, ``restore`` of
    the latest or a given step, ``FileNotFoundError`` where there is none."""
    mgr = tckpt.CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    for step in (1, 5, 9):
        mgr.save(step, {"w": torch.full((3,), float(step)), "step": step})
    assert mgr.steps() == [5, 9] and mgr.latest_step() == 9
    assert mgr.restore()["step"] == 9 and torch.equal(mgr.restore(5)["w"], torch.full((3,), 5.0))
    with pytest.raises(FileNotFoundError):
        mgr.restore(1)
    assert sorted(os.listdir(tmp_path)) == ["step_5.pt", "step_9.pt"]


def test_checkpoint_manager_wait_and_close_are_no_ops(tmp_path):
    """Saves are synchronous: ``wait`` and ``close`` (the JAX manager's
    wait for its asynchronous saves and its shutdown) change nothing, and
    the manager still saves and restores after ``close``."""
    mgr = tckpt.CheckpointManager(str(tmp_path), max_to_keep=2)
    mgr.save(3, {"step": 3})
    assert mgr.wait() is None and mgr.close() is None
    assert mgr.steps() == [3] and mgr.restore()["step"] == 3
    mgr.save(4, {"step": 4})
    assert mgr.latest_step() == 4
