"""The port's training step against the JAX package, tiny geometry, CPU.

Both sides get the same random weights (std 1/sqrt(fan_in), nothing left at
zero) through the parameter bridge, the same batch (numpy) and the same
random draws: the JAX draws of `training_loss` (posterior noise, t,
diffusion noise) are made with jax.random and injected into the port. The
JAX model runs its plain XLA path; the port runs every kernel switch on
(flash attention, fused transformer, fused GroupNorm), whose wrappers take
their plain versions on CPU tensors, through the same autograd.Functions the
card uses. float32 throughout, so the two differ by summation order only:
1e-4 absolute on encoder latents of magnitude ~1, 1e-5 relative on the
loss, 1e-4 relative L2 per gradient leaf, and 1e-6 absolute on parameters
and EMA shadows after three optimizer updates (the updates are ~1e-3).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers on the cores, and
# a torch pool per worker oversubscribes them
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from upgpt_tpu.training import ema as jema  # noqa: E402
from upgpt_tpu.training import lr as jlr  # noqa: E402
from upgpt_tpu.training import train_state as jts  # noqa: E402
from upgpt_tpu.zoo import build_latent_diffusion as jax_build  # noqa: E402
from upgpt_torch.convert.from_jax import (  # noqa: E402
    flatten_tree, load_jax_params, torch_array, torch_key,
)
from upgpt_torch.training import lr as tlr  # noqa: E402
from upgpt_torch.training.train_state import (  # noqa: E402
    create_train_state, eval_step, train_step,
)
from upgpt_torch.zoo import build_latent_diffusion  # noqa: E402

B = 2


def _random_params(shapes, seed):
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(size=leaf.shape) / np.sqrt(fan_in)
        base = 1.0 if "scale" in name else 0.0
        return base + 0.1 * rng.normal(size=leaf.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(draw(p, a), jnp.float32), shapes)


def _port_model(params):
    tm = build_latent_diffusion("tiny", device="cpu",
                                use_fused_groupnorm=True)
    return load_jax_params(tm, params)


@pytest.fixture(scope="module")
def setup():
    jm = jax_build("tiny", use_flash_attention=False)
    params = _random_params(
        jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)), seed=0)
    rng = np.random.default_rng(1)
    h, w = jm.config.latent_size
    batch = {
        "image": rng.uniform(-1.0, 1.0, size=(B, 2 * h, 2 * w, 3)),
        "person_mask": rng.choice([-1.0, -0.99215686], size=(B, h, w, 1)),
        "text_emb": rng.normal(size=(B, 77, 768)),
        "style_emb": rng.normal(size=(B, 9, 768)),
        "smpl": rng.normal(size=(B, 1, 85)),
        "loss_w": rng.uniform(0.5, 1.5, size=(B, h, w, 1)),
    }
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    key = jax.random.PRNGKey(3)
    trainable = {k: v for k, v in params.items() if k != "vae"}
    frozen = {"vae": params["vae"]}
    loss_and_grad = jax.jit(jax.value_and_grad(
        lambda p: jm.training_loss(p, batch, key, frozen_params=frozen),
        has_aux=True))
    (loss, metrics), grads = loss_and_grad(trainable)
    return jm, params, batch, key, metrics, grads


def _jax_draws(jm, params, batch, key):
    """The draws of the JAX `training_loss` (latent_diffusion.py:342-346)."""
    k_enc, k_t, k_noise = jax.random.split(key, 3)
    post = jm.vae.apply({"params": params["vae"]}, batch["image"],
                        method="encode")
    shape = post.mean.shape
    return {
        "posterior_noise": torch.from_numpy(np.array(
            jax.random.normal(k_enc, shape, post.mean.dtype))),
        "t": torch.from_numpy(np.array(jax.random.randint(
            k_t, (B,), 0, jm.schedule.num_timesteps))).long(),
        "noise": torch.from_numpy(np.array(
            jax.random.normal(k_noise, shape, jnp.float32))),
    }


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_encode_first_stage_mode_matches_jax(setup):
    jm, params, batch, *_ = setup
    want = jax.jit(jm.encode_first_stage_mode)(params, batch["image"])
    tm = _port_model(params)
    got = tm.encode_first_stage_mode(torch.from_numpy(batch["image"]))
    assert got.shape == (B, 32, 24, 4) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_training_loss_and_gradients_match_jax(setup):
    jm, params, batch, key, metrics, grads = setup
    tm = _port_model(params)
    state = create_train_state(tm, learning_rate=2e-6)
    draws = _jax_draws(jm, params, batch, key)
    # the gradients stay on the parameters after the step
    state, got = train_step(tm, state, _torch_batch(batch), draws=draws)
    for name in ("loss", "loss_simple", "loss_vlb"):
        np.testing.assert_allclose(got[name].item(), float(metrics[name]),
                                   rtol=1e-5)
    by_name = dict(zip(state.names, state.params))
    flat = flatten_tree(grads)
    assert len(flat) == len(by_name)
    total = np.sqrt(sum(np.sum(np.square(g)) for g in flat.values()))
    np.testing.assert_allclose(got["grad_norm"].item(), total, rtol=1e-5)
    for jk, g in flat.items():
        want = torch_array(jk, g)
        got_g = by_name[torch_key(jk)].grad.numpy()
        if np.linalg.norm(want) < 1e-6 * total:
            # exactly zero up to rounding: at this width each of the 32
            # groups of a 32-channel GroupNorm holds one channel, so a
            # per-channel shift before it (a conv or emb_proj bias) moves
            # nothing; both sides give ~1e-8 of noise there
            assert np.linalg.norm(got_g) < 1e-6 * total, jk
            continue
        rel = np.linalg.norm(got_g - want) / np.linalg.norm(want)
        assert rel <= 1e-4, (jk, rel)
    pose = by_name["pose.proj.weight"].grad
    assert pose.abs().max() > 0
    # the frozen VAE gets no gradient
    assert all(p.grad is None for p in tm.vae.parameters())


def test_adamw_and_ema_match_optax():
    """Three updates on fixed random gradients, with a warm-up schedule, so
    the LR convention (the schedule sees the pre-update count) and the
    EMA's decay ramp both show. A one-level U-Net keeps the JAX side's
    compile short; the update is per leaf, so the width does not matter."""
    from upgpt_tpu.models.unet import UNetConfig as JaxUNetConfig
    from upgpt_torch.models.unet import UNetConfig

    small = dict(in_channels=5, model_channels=32, out_channels=4,
                 num_res_blocks=1, attention_resolutions=(),
                 channel_mult=(1,), num_heads=4, context_dim=768)
    jm = jax_build("tiny", use_flash_attention=False,
                   unet=JaxUNetConfig(**small))
    params = _random_params(
        jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)), seed=4)
    trainable = {k: v for k, v in params.items() if k != "vae"}
    sched_args = ([2], [1.0], [1.0], [0.1], [10**13])
    jstate = jts.create_train_state(
        trainable, learning_rate=1e-3,
        scheduler=jlr.lambda_linear_schedule(*sched_args))
    tm = load_jax_params(build_latent_diffusion(
        "tiny", device="cpu", unet=UNetConfig(**small)), params)
    state = create_train_state(
        tm, learning_rate=1e-3,
        scheduler=tlr.lambda_linear_schedule(*sched_args))
    by_name = dict(zip(state.names, state.params))
    shadow = dict(zip(state.names, state.ema.shadow))
    rng = np.random.default_rng(5)
    apply = jax.jit(lambda s, g: s.apply_gradients(g))
    for _ in range(3):
        g = jax.tree.map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), trainable)
        for jk, a in flatten_tree(g).items():
            by_name[torch_key(jk)].grad = torch.from_numpy(
                np.array(torch_array(jk, a)))
        jstate = apply(jstate, g)
        state.apply_gradients()
        for tree, port in ((jstate.params, by_name),
                           (jstate.ema.shadow, shadow)):
            for jk, a in flatten_tree(tree).items():
                np.testing.assert_allclose(
                    port[torch_key(jk)].detach().numpy(),
                    torch_array(jk, a), atol=1e-6, err_msg=jk)
    assert state.step == int(jstate.step) == 3
    assert state.ema.num_updates == int(jstate.ema.num_updates)


@pytest.mark.parametrize("kind,args", [
    ("linear", ([1], [1.0], [1.0], [1e-6], [10**13])),
    ("linear", ([3, 5], [0.1, 0.2], [1.0, 0.8], [1e-6, 0.3], [10, 20])),
    ("cosine", (4, 0.01, 1.0, 0.001, 20)),
])
def test_lr_schedules_match_jax(kind, args):
    name = ("lambda_linear_schedule" if kind == "linear"
            else "lambda_warmup_cosine")
    want, got = getattr(jlr, name)(*args), getattr(tlr, name)(*args)
    for step in (0, 1, 2, 3, 4, 9, 10, 11, 15, 19, 20, 29, 30, 45, 10**6):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-9)


def test_ema_decay_matches_jax():
    from upgpt_torch.training.ema import ema_decay

    for n in (0, 1, 2, 10, 1000, 10**6):
        state = jema.EmaState(shadow=None, num_updates=jnp.int32(n),
                              decay=0.9999)
        assert ema_decay(n, 0.9999) == float(jema.ema_decay(state))


def test_train_and_eval_steps(setup):
    jm, params, batch, key, *_ = setup
    tm = _port_model(params)
    # no warm-up: the default schedule's first step is at 1e-6 of the LR
    state = create_train_state(tm, learning_rate=1e-4,
                               scheduler=lambda step: 1.0)
    tb = _torch_batch(batch)
    draws = _jax_draws(jm, params, batch, key)
    before = eval_step(tm, state, tb, draws=draws)
    assert set(before) == {"loss", "loss_simple", "loss_vlb", "loss_ema",
                           "loss_simple_ema", "loss_vlb_ema"}
    # the shadow starts as a copy of the parameters
    assert before["loss_ema"].item() == before["loss"].item()
    start = [p.detach().clone() for p in state.params]
    state, metrics = train_step(tm, state, tb, torch.Generator().manual_seed(0))
    assert set(metrics) == {"loss", "loss_simple", "loss_vlb", "grad_norm"}
    assert torch.isfinite(metrics["loss"]) and metrics["grad_norm"] > 0
    assert state.step == 1 and state.ema.num_updates == 1
    assert any(not torch.equal(a, p) for a, p in zip(start, state.params))
    after = eval_step(tm, state, tb, draws=draws)
    assert after["loss"].item() != before["loss"].item()
    assert after["loss_ema"].item() != after["loss"].item()
    # eval_step puts the raw weights back
    _, again = tm.training_loss(tb, draws=draws)
    assert again["loss"].item() == after["loss"].item()


def test_training_draws_follow_the_generator():
    tm = build_latent_diffusion("tiny", device="cpu")
    a = tm.training_draws(3, torch.Generator().manual_seed(4))
    b = tm.training_draws(3, torch.Generator().manual_seed(4))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["posterior_noise"].shape == a["noise"].shape == (3, 32, 24, 4)
    assert a["t"].dtype == torch.int64 and 0 <= a["t"].min()
    assert a["t"].max() < 1000
