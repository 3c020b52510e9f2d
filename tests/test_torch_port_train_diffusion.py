"""The port's diffusion trainer against the JAX package's, on the same
perturbed params (through ``models.convert``), the same numpy batch and
JAX's own draws of t and noise.

Tiny configuration: 16×16 frames, base 32, channel_mult (1, 2), one res
block, attention at ds 1 (256 tokens: the flash path, JAX's Pallas forward
and backward in interpret mode) and ds 2 (64 tokens: einsum), 2 heads, a
32-wide audio encoder at 800 samples, float32, dropout 0. Float32 on both
sides, where the point is the algorithm; each tolerance states its bound.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from lipreading_video_generation_tpu.core import prng as jprng
from lipreading_video_generation_tpu.core.config import DiffusionConfig as JCfg
from lipreading_video_generation_tpu.core.config import ViViTConfig as JViViTCfg
from lipreading_video_generation_tpu.models.unet_audio import UNetAudio as JUNetAudio
from lipreading_video_generation_tpu.models.vivit import ViViT as JViViT
from lipreading_video_generation_tpu.pipelines import losses as jlosses
from lipreading_video_generation_tpu.pipelines import train_diffusion as jtd
from lipreading_video_generation_tpu_torch.core.config import DiffusionConfig as TCfg
from lipreading_video_generation_tpu_torch.core.config import ViViTConfig as TViViTCfg
from lipreading_video_generation_tpu_torch.models import convert
from lipreading_video_generation_tpu_torch.models.unet import ResBlock, dropout_mask
from lipreading_video_generation_tpu_torch.models.unet_audio import UNetAudio
from lipreading_video_generation_tpu_torch.models.vivit import ViViT
from lipreading_video_generation_tpu_torch.pipelines import train_diffusion as ttd

TINY = dict(im_size=16, base_channels=32, channel_mult=(1, 2), num_res_blocks=1,
            attention_resolutions=(1, 2), num_heads=2, time_embed_dim=32,
            audio_embed_dim=32, audio_proj_dim=8, im_cond_channels=4,
            audio_samples=800, num_timesteps=50, dropout=0.0, dtype="float32")
B = 2


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)   # six test workers share the host
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _batch(seed):
    """Frames at ``im_size``, where the resize of ``prepare_batch`` is the
    identity on both sides: a resize to another size may round a tie to the
    other uint8 level (tests/test_torch_port_diffusion_slice.py), which
    would move the loss by more than float32 rounding does."""
    rng = np.random.default_rng(seed)
    return {"target_frame": rng.integers(0, 256, (B, 16, 16, 3), dtype=np.uint8),
            "cond_frame": rng.integers(0, 256, (B, 16, 16, 3), dtype=np.uint8),
            "audio": rng.standard_normal((B, 800)).astype(np.float32)}


def _jax_draws(key, step, cfg):
    """t and noise as ``train_diffusion._train_step_impl`` draws them."""
    kt, kn, _ = jax.random.split(jprng.step_key(key, step), 3)
    return (np.array(jprng.uniform_timesteps(kt, B, cfg.num_timesteps)),
            np.array(jax.random.normal(kn, (B, cfg.im_size, cfg.im_size, 3))))


@pytest.fixture(scope="module")
def jax_run():
    """One JAX state with perturbed params (the Flax init zeroes the output
    conv, which would zero every other gradient): the loss and gradients of
    step 0 and the params and EMA after two ``train_step``s."""
    cfg = JCfg(**TINY)
    key = jax.random.key(0)
    state = jtd.create_state(cfg, key)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32), state.params)
    state = state.replace(params=params, ema_params=params, opt_state=state.tx.init(params))
    batch = _batch(2)
    draws = [_jax_draws(key, s, cfg) for s in range(2)]

    prep = jtd.prepare_batch({k: jnp.asarray(v) for k, v in batch.items()}, cfg)
    t0, noise0 = (jnp.asarray(a) for a in draws[0])
    noisy = jtd.make_scheduler(cfg.scheduler, cfg.num_timesteps, cfg.beta_start,
                               cfg.beta_end).add_noise(prep["target"], noise0, t0)

    def loss_fn(p):
        pred = JUNetAudio(cfg).apply({"params": p}, noisy, prep["cond"], prep["audio"], t0)
        return jlosses.noise_mse(pred, noise0)

    loss0, grads0 = jax.jit(jax.value_and_grad(loss_fn))(params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    losses = []
    for _ in range(2):
        state, m = jtd.train_step(state, jbatch, key, cfg)
        losses.append(float(m["loss"]))
    return {"params0": params, "batch": batch, "draws": draws, "loss0": float(loss0),
            "grads0": _np_tree(grads0), "losses": losses,
            "params2": _np_tree(state.params), "ema2": _np_tree(state.ema_params)}


def _port_state(params, cfg=None):
    cfg = cfg or TCfg(**TINY)
    state = ttd.create_state(cfg, device="cpu")
    sd = convert.unet_audio_state_dict_from_flax(params, cfg)
    state.model.load_state_dict(sd)
    state.ema.load_state_dict(sd)
    return state


def _close_trees(got, want, rtol, atol):
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].detach().numpy(), want[name].numpy(),
                                   rtol=rtol, atol=atol, err_msg=name)


def test_loss_and_every_gradient_match_jax(jax_run):
    """ε-MSE and the gradient of every parameter (Flax's gradient tree put
    through the same bridge): float32, other summation orders in every conv
    and GEMM and in the flash backward; 1e-4 of each tensor's largest
    gradient, 1e-3 relative."""
    state = _port_state(jax_run["params0"])
    prep = ttd.prepare_batch(jax_run["batch"], state.model.cfg, "cpu")
    t, noise = ttd.draw_t_noise(state, prep["target"], 50, *jax_run["draws"][0])
    noisy = state.scheduler.add_noise(prep["target"], noise, t)
    loss = ttd.noise_mse(state.model(noisy, prep["cond"], prep["audio"], t), noise)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jax_run["loss0"], rtol=1e-5)
    want = convert.unet_audio_state_dict_from_flax(jax_run["grads0"], state.model.cfg)
    got = dict(state.model.named_parameters())
    assert set(got) == set(want)
    # A bias under a GroupNorm of one channel per group has an exact gradient
    # of 0; what both sides compute there is cancellation noise of the whole
    # backward, bounded by 1e-7 of the model's largest gradient.
    gmax = max(w.abs().max().item() for w in want.values())
    for name, w in want.items():
        atol = max(1e-4 * w.abs().max().item(), 1e-7 * gmax)
        np.testing.assert_allclose(got[name].grad.numpy(), w.numpy(), rtol=1e-3, atol=atol,
                                   err_msg=name)


def test_adam_and_ema_match_optax():
    """Three Adam + EMA updates on identical numpy gradients: torch's Adam
    with optax ``adam``'s hyperparameters and the in-place EMA against
    optax and ``update_ema``; float32 rounding only (1e-6)."""
    cfg = TCfg(**TINY)
    state = ttd.create_state(cfg, seed=5, ema_rate=0.99, device="cpu")
    names = [n for n, _ in state.model.named_parameters()]
    params = {n: p.detach().numpy().copy() for n, p in state.model.named_parameters()}
    tx = optax.adam(cfg.learning_rate)
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    opt, jema = tx.init(jp), dict(jp)
    rng = np.random.default_rng(6)
    for _ in range(3):
        grads = {n: rng.standard_normal(a.shape).astype(np.float32) * 1e-2
                 for n, a in params.items()}
        for n, p in state.model.named_parameters():
            p.grad = torch.from_numpy(grads[n])
        state.optimizer.step()
        ttd.update_ema(state.ema, state.model, state.ema_rate)
        updates, opt = tx.update({n: jnp.asarray(g) for n, g in grads.items()}, opt, jp)
        jp = optax.apply_updates(jp, updates)
        jema = jtd.update_ema(jema, jp, 0.99)
    for n, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[n]), rtol=0, atol=1e-6)
    for n, e in state.ema.named_parameters():
        np.testing.assert_allclose(e.numpy(), np.asarray(jema[n]), rtol=0, atol=1e-6)
    assert names


def test_two_train_steps_match_jax(jax_run):
    """Two whole ``train_step``s fed JAX's t and noise: losses, params and
    EMA against JAX's. Adam's first steps move each weight by about lr·sign(g)
    whatever |g| is, so a gradient component within float32 noise of zero
    may step the other way: params agree to 1e-6 except at most 0.1% of
    them, which stay within 2·2·lr."""
    state = _port_state(jax_run["params0"])
    cfg = state.model.cfg
    losses = [ttd.train_step(state, jax_run["batch"], cfg, *d)["loss"].item()
              for d in jax_run["draws"]]
    assert state.step == 2
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=1e-5)
    for got, want_tree in ((state.model, jax_run["params2"]), (state.ema, jax_run["ema2"])):
        want = convert.unet_audio_state_dict_from_flax(want_tree, cfg)
        diffs = np.concatenate([np.abs(got.state_dict()[n].numpy() - w.numpy()).ravel()
                                for n, w in want.items()])
        assert (diffs > 1e-6).mean() <= 1e-3 and diffs.max() <= 4 * cfg.learning_rate, (
            (diffs > 1e-6).mean(), diffs.max())


def test_dropout_train_and_eval():
    """Eval mode is deterministic; train mode drops at rate p with kept
    values scaled by 1/(1−p), from the generator it is given; dropout 0 in
    train mode equals eval."""
    mask = dropout_mask((200_000,), 0.1, torch.Generator().manual_seed(0), "cpu")
    assert abs(mask.float().mean().item() - 0.9) < 3e-3
    block = ResBlock(8, 8, 16, torch.float32, dropout=0.25)
    torch.nn.init.normal_(block.conv2.weight)
    x, emb = torch.randn(2, 8, 6, 6), torch.randn(2, 16)
    keep = dropout_mask((2, 8, 6, 6), 0.25, torch.Generator().manual_seed(1), "cpu")
    h = {}
    block.conv2.register_forward_hook(lambda m, i, o: h.update(x=i[0]))
    block(x, emb, keep)
    dropped = h["x"]
    block(x, emb)
    np.testing.assert_allclose(dropped.detach().numpy(),
                               torch.where(keep, h["x"] / 0.75, 0.0).detach().numpy(),
                               rtol=1e-6, atol=1e-7)

    inputs = (torch.randn(2, 3, 16, 16), torch.rand(2, 3, 16, 16) * 2 - 1,
              torch.randn(2, 800), torch.tensor([3, 40]))
    cfg = TCfg(**dict(TINY, dropout=0.1))
    model = ttd.seeded(lambda: UNetAudio(cfg), 0)
    for p in model.parameters():   # wake the zero-initialised layers
        torch.nn.init.normal_(p, std=0.05) if p.ndim > 1 and p.abs().max() == 0 else None
    with torch.no_grad():
        model.eval()
        e1, e2 = model(*inputs), model(*inputs)
        model.train()
        t1 = model(*inputs, generator=torch.Generator().manual_seed(2))
        t2 = model(*inputs, generator=torch.Generator().manual_seed(2))
        t3 = model(*inputs, generator=torch.Generator().manual_seed(3))
    assert torch.equal(e1, e2) and torch.equal(t1, t2)
    assert not torch.allclose(t1, e1) and not torch.allclose(t1, t3)
    no_drop = ttd.seeded(lambda: UNetAudio(TCfg(**TINY)), 0)
    no_drop.load_state_dict(model.state_dict())
    with torch.no_grad():
        assert torch.equal(no_drop.train()(*inputs), e1)


def _loss_and_grads(cfg, seed=0):
    state = ttd.create_state(cfg, seed=seed, device="cpu")
    prep = ttd.prepare_batch(_batch(3), cfg, "cpu")
    t, noise = ttd.draw_t_noise(state, prep["target"], cfg.num_timesteps)
    noisy = state.scheduler.add_noise(prep["target"], noise, t)
    pred = state.model(noisy, prep["cond"], prep["audio"], t, generator=state.generator)
    loss = ttd.noise_mse(pred + 0.1 * noisy, noise)   # past the zero-initialised output conv
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in state.model.named_parameters()}


def test_remat_gives_the_same_gradients():
    """``remat=True`` recomputes each ResBlock in the backward
    (``torch.utils.checkpoint``) with the dropout mask drawn before it: the
    same loss and gradients, bit for bit."""
    cfg = TCfg(**dict(TINY, dropout=0.2))
    loss, grads = _loss_and_grads(cfg)
    loss_r, grads_r = _loss_and_grads(dataclasses.replace(cfg, remat=True))
    assert loss == loss_r
    for n, g in grads.items():
        assert torch.equal(g, grads_r[n]), n


def test_checkpoint_round_trip_resumes_bit_exactly(tmp_path):
    """``train`` for 3 steps straight, and for 2 steps, then resumed from
    its checkpoint for the third: the same params, EMA, Adam moments and
    generator state (t, noise and dropout masks all come from it)."""
    cfg = TCfg(**dict(TINY, dropout=0.1))
    batches = [_batch(10 + i) for i in range(3)]

    def feed():
        it = iter(batches)
        return lambda: next(it, None)

    class Writer:
        def __init__(self):
            self.rows = []

        def write(self, step, metrics):
            self.rows.append((step, metrics))

    straight = ttd.train(cfg, feed(), num_steps=3, seed=4, device="cpu")
    writer = Writer()
    ttd.train(cfg, feed(), num_steps=2, seed=4, checkpoint_dir=str(tmp_path),
              checkpoint_every=2, metrics_writer=writer, device="cpu")
    assert [s for s, _ in writer.rows] == [0, 1] and "loss" in writer.rows[0][1]
    assert ttd.latest_checkpoint(str(tmp_path)).endswith("step_000000002.pt")
    rest = iter(batches[2:])
    resumed = ttd.train(cfg, lambda: next(rest, None), num_steps=3, seed=4,
                        checkpoint_dir=str(tmp_path), checkpoint_every=2, device="cpu")
    assert resumed.step == straight.step == 3
    for a, b in ((resumed.model, straight.model), (resumed.ema, straight.ema)):
        for (n, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), n
    assert torch.equal(resumed.generator.get_state(), straight.generator.get_state())
    ema = ttd.load_sampling_params(str(tmp_path))
    assert set(ema) == set(straight.model.state_dict())


def test_same_seed_same_params_and_eval_step():
    cfg = TCfg(**TINY)
    a, b, c = (ttd.create_state(cfg, seed=s, device="cpu") for s in (7, 7, 8))
    sa, sb, sc = (s.model.state_dict() for s in (a, b, c))
    assert all(torch.equal(sa[n], sb[n]) for n in sa)
    assert not all(torch.equal(sa[n], sc[n]) for n in sa)
    assert all(p.dtype == torch.float32 for p in sa.values())
    # the zero-initialised layers, as in Flax: the output conv predicts ε = 0
    assert a.model.unet.out_conv.weight.abs().max() == 0
    m = ttd.eval_step(a, _batch(4), cfg)
    assert np.isfinite(m["eval/loss"].item()) and a.model.training
    # the 1×1 mesh of one process gives mesh_spec=None's state
    from lipreading_video_generation_tpu_torch.parallel.mesh import build_mesh

    plain = ttd.train(cfg, lambda: None, device="cpu")
    meshed = ttd.train(cfg, lambda: None, mesh_spec=build_mesh(), device="cpu")
    assert plain.step == meshed.step == 0
    for n, v in plain.model.state_dict().items():
        assert torch.equal(v, meshed.model.state_dict()[n])
    with pytest.raises(FileNotFoundError, match="wav2vec2.config.json"):
        ttd.create_state(cfg, wav2vec2_checkpoint="w2v", device="cpu")


def _round_as_before(model, sd):
    """``sd`` with the params the port used to store in bf16 rounded to
    bf16: the weights and biases of its layers that compute in bf16."""
    low = {f"{m}.{p}" for m, mod in model.named_modules()
           if getattr(mod, "compute_dtype", None) == torch.bfloat16 for p in ("weight", "bias")}
    return {n: t.to(torch.bfloat16).float() if n in low else t for n, t in sd.items()}


def test_bf16_models_keep_float32_master_params():
    """A bf16 UNetAudio and a bf16 ViViT loaded from a Flax float32 tree give
    the float32 arrays back bit for bit (they were rounded to bf16 before the
    port kept float32 master params), and compute exactly what they computed
    with params rounded at load: casting once at load and casting at each
    call round the same way."""
    cfg = TCfg(**dict(TINY, dtype="bfloat16"))
    s = cfg.im_size
    jparams = JUNetAudio(JCfg(**TINY)).init(
        jax.random.key(0), jnp.zeros((1, s, s, 3)), jnp.zeros((1, s, s, 3)),
        jnp.zeros((1, 800)), jnp.zeros((1,), jnp.int32))["params"]
    rng = np.random.default_rng(0)
    jparams = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32), jparams)
    sd = convert.unet_audio_state_dict_from_flax(jparams, cfg)
    model = UNetAudio(cfg).eval()
    model.load_state_dict(sd)
    for n, t in model.state_dict().items():
        assert t.dtype == torch.float32 and torch.equal(t, sd[n]), n
    rounded = UNetAudio(cfg).eval()
    rounded.load_state_dict(_round_as_before(rounded, sd))
    inputs = (torch.randn(2, 3, s, s), torch.rand(2, 3, s, s) * 2 - 1, torch.randn(2, 800),
              torch.tensor([3, 40]))
    with torch.no_grad():
        assert torch.equal(model(*inputs), rounded(*inputs))

    vcfg = dict(num_layers=2, hidden_size=64, num_heads=4, mlp_dim=128, num_classes=8)
    clips = rng.uniform(0, 1, (2, 5, 32, 32, 1)).astype(np.float32)
    vparams = JViViT(JViViTCfg(**vcfg, dtype="float32")).init(
        jax.random.key(1), jnp.asarray(clips))["params"]
    vparams = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + 0.05 * rng.standard_normal(np.shape(a)).astype(np.float32), vparams)
    vsd = convert.vivit_state_dict_from_flax(vparams)
    vivit = ViViT(TViViTCfg(**vcfg)).eval()            # bf16 by default
    vivit.load_state_dict(vsd)
    for n, t in vivit.state_dict().items():
        assert t.dtype == torch.float32 and torch.equal(t, vsd[n]), n
    vrounded = ViViT(TViViTCfg(**vcfg)).eval()
    vrounded.load_state_dict(_round_as_before(vrounded, vsd))
    with torch.no_grad():
        assert torch.equal(vivit(torch.from_numpy(clips)), vrounded(torch.from_numpy(clips)))
