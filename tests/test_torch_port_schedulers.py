"""The port's noise schedulers against the JAX package's, on the same
numpy inputs. Where JAX draws noise from a key, the test draws the same
normal numbers with that key and hands them to the port as ``z``."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from lipreading_video_generation_tpu.models import schedulers as js
from lipreading_video_generation_tpu.pipelines import sample_diffusion as jsd
from lipreading_video_generation_tpu_torch.models import schedulers as ts
from lipreading_video_generation_tpu_torch.pipelines import sample_diffusion as tsd

_KINDS = ["linear", "linear_v2", "cosine"]
# float32 elementwise updates of values ≲ 10: a few ulp, more where 1/√ᾱ is large
TOL = 2e-5


def _pair(kind, T=100):
    return (js.make_scheduler(kind, T, 1e-4, 0.02), ts.make_scheduler(kind, T, 1e-4, 0.02))


def _x(seed, shape=(3, 4, 4, 2)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("kind", _KINDS)
def test_tables_match_jax(kind):
    j, t = _pair(kind)
    for name in ("betas", "alphas", "alpha_cum_prod", "sqrt_alpha_cum_prod",
                 "sqrt_one_minus_alpha_cum_prod"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
        assert getattr(t, name).dtype == np.float64


@pytest.mark.parametrize("kind", _KINDS)
def test_add_noise_and_pred_x0_match_jax(kind):
    j, t = _pair(kind)
    x0, eps, tt = _x(0), _x(1), np.array([0, 37, 99], np.int32)
    want = np.asarray(j.add_noise(jnp.asarray(x0), jnp.asarray(eps), jnp.asarray(tt)))
    got = t.add_noise(torch.from_numpy(x0), torch.from_numpy(eps), torch.from_numpy(tt).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    want = np.asarray(j.pred_x0(jnp.asarray(x0), jnp.asarray(eps), jnp.asarray(tt)))
    got = t.pred_x0(torch.from_numpy(x0), torch.from_numpy(eps), torch.from_numpy(tt).long())
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", _KINDS)
def test_sample_prev_timestep_matches_jax(kind):
    """t = 0 (no noise added, except cosine's floor) and t > 0."""
    j, t = _pair(kind)
    xt, eps, tt = _x(2), _x(3), np.array([0, 1, 63], np.int32)
    key = jax.random.key(7)
    z = np.array(jax.random.normal(key, xt.shape))
    want_x, want_x0 = j.sample_prev_timestep(jnp.asarray(xt), jnp.asarray(eps),
                                             jnp.asarray(tt), key)
    got_x, got_x0 = t.sample_prev_timestep(torch.from_numpy(xt), torch.from_numpy(eps),
                                           torch.from_numpy(tt).long(), torch.from_numpy(z))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_x0.numpy(), np.asarray(want_x0), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("eta", [0.0, 1.0])
@pytest.mark.parametrize("t_prev", [[60, 20, 0], [-1, -1, -1]])
def test_ddim_prev_matches_jax(eta, t_prev):
    j, t = _pair("linear")
    xt, eps = _x(4), _x(5)
    tt, tp = np.array([80, 40, 10], np.int32), np.array(t_prev, np.int32)
    key = jax.random.key(8)
    z = np.array(jax.random.normal(key, xt.shape))
    want = j.ddim_prev(jnp.asarray(xt), jnp.asarray(eps), jnp.asarray(tt), jnp.asarray(tp),
                       key, eta=eta)
    got = t.ddim_prev(torch.from_numpy(xt), torch.from_numpy(eps), torch.from_numpy(tt).long(),
                      torch.from_numpy(tp).long(), eta, torch.from_numpy(z))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("step", ["first", "middle", "final"])
def test_dpmpp_2m_prev_matches_jax(step):
    """The first step (no history: first order), a second-order step and the
    final step to x0 (returns D exactly; the masked lanes hold inf/nan)."""
    j, t = _pair("linear")
    xt, eps, d_prev = _x(6), _x(7), np.clip(_x(8), -1, 1)
    t_now, t_prev, t_last, use = {"first": (90, 60, 90, False), "middle": (60, 30, 90, True),
                                  "final": (30, -1, 60, False)}[step]
    b = xt.shape[0]
    args_j = [jnp.full((b,), v, jnp.int32) for v in (t_now, t_prev)]
    want = j.dpmpp_2m_prev(jnp.asarray(xt), jnp.asarray(eps), *args_j, jnp.asarray(d_prev),
                           jnp.full((b,), t_last, jnp.int32), jnp.asarray(use))
    args_t = [torch.full((b,), v, dtype=torch.long) for v in (t_now, t_prev)]
    got = t.dpmpp_2m_prev(torch.from_numpy(xt), torch.from_numpy(eps), *args_t,
                          torch.from_numpy(d_prev), torch.full((b,), t_last, dtype=torch.long),
                          use)
    for g, w in zip(got, want):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)
    if step == "final":
        np.testing.assert_array_equal(got[0].numpy(), got[1].numpy())


@pytest.mark.parametrize("T,N", [(500, 300), (500, 10), (50, 4), (7, 7)])
def test_ddim_timesteps_match_jax(T, N):
    got = tsd.ddim_timesteps(T, N)
    np.testing.assert_array_equal(got, jsd.ddim_timesteps(T, N))
    assert len(np.unique(got)) == N


def test_scheduler_noise_from_generator():
    """Without ``z`` the noise comes from the generator: same seed, same
    draw; eta 0 draws nothing."""
    _, t = _pair("linear")
    xt, eps, tt = (torch.from_numpy(a) for a in (_x(9), _x(10), np.array([5, 6, 7])))
    a = t.sample_prev_timestep(xt, eps, tt, generator=torch.Generator().manual_seed(3))[0]
    b = t.sample_prev_timestep(xt, eps, tt, generator=torch.Generator().manual_seed(3))[0]
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    g = torch.Generator().manual_seed(3)
    state = g.get_state()
    t.ddim_prev(xt, eps, tt, tt - 5, 0.0, generator=g)
    assert torch.equal(g.get_state(), state)
