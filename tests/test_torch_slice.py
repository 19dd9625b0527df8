"""The port's sampling slice against the JAX package, tiny geometry, CPU.

Both sides get the same random weights (std 1/sqrt(fan_in), nothing left at
zero) through the parameter bridge and the same inputs, made with numpy.
The JAX model runs with its kernels off (plain XLA, float32); the port runs
its default configuration, whose kernel wrappers take their plain versions
on CPU tensors. float32 everywhere, so the two differ only by summation
order: 1e-4 on U-Net outputs and images of magnitude ~1, and 2e-4 on
latents of magnitude ~20 after 4 DDIM steps (measured: 2e-5).
uint8 images may differ by at most one level (a value on a rounding edge).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from upgpt_tpu.inference.pipeline import (  # noqa: E402
    GenerationPipeline as JaxPipeline,
)
from upgpt_tpu.zoo import build_latent_diffusion as jax_build  # noqa: E402
from upgpt_torch.convert.from_jax import load_jax_params  # noqa: E402
from upgpt_torch.inference.pipeline import GenerationPipeline  # noqa: E402
from upgpt_torch.zoo import build_latent_diffusion  # noqa: E402

B, STEPS = 2, 4


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


@pytest.fixture(scope="module")
def models():
    jm = jax_build("tiny", use_flash_attention=False)
    params = _random_params(
        jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)), seed=0)
    tm = load_jax_params(build_latent_diffusion("tiny", device="cpu"),
                         params)
    rng = np.random.default_rng(1)
    h, w = jm.config.latent_size
    batch = {
        "text_emb": rng.normal(size=(B, 77, 768)),
        "style_emb": rng.normal(size=(B, 9, 768)),
        "smpl": rng.normal(size=(B, 1, 85)),
        "person_mask": rng.choice([-1.0, -0.99215686], size=(B, h, w, 1)),
    }
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    return jm, params, tm, batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_tiny_unet_eval_matches_jax(models):
    jm, params, tm, batch = models
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, 32, 24, 5)).astype(np.float32)
    t = np.array([3, 777], np.int32)
    ctx = rng.normal(size=(B, 87, 768)).astype(np.float32)
    want = jax.jit(lambda p, *a: jm.unet.apply({"params": p}, *a))(
        params["unet"], x, t, ctx)
    with torch.no_grad():
        got = tm.unet(torch.from_numpy(x), torch.from_numpy(t),
                      torch.from_numpy(ctx))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_tiny_decoder_matches_jax(models):
    jm, params, tm, _ = models
    z = np.random.default_rng(3).normal(size=(B, 32, 24, 4)).astype(
        np.float32)
    want = jax.jit(jm.decode_first_stage)(params, z)
    with torch.no_grad():
        got = tm.decode_first_stage(torch.from_numpy(z))
    assert got.shape == (B, 64, 48, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def _jax_draws(key, shape, steps, eta):
    """The x_T and per-step noise the JAX pipeline draws from `key`
    (pipeline.py:152-168, ddim.py:129-134)."""
    key, k_noise = jax.random.split(key)
    x_t = jax.random.normal(k_noise, shape)
    noise = []
    k = key
    for _ in range(steps if eta else 0):
        k, k_n = jax.random.split(k)
        noise.append(jax.random.normal(k_n, shape, jnp.float32))
    return (torch.from_numpy(np.array(x_t)),
            torch.from_numpy(np.stack(noise)) if noise else None)


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_tiny_pipeline_matches_jax(models, eta):
    jm, params, tm, batch = models
    key = jax.random.PRNGKey(7)
    jpipe = JaxPipeline(jm, num_steps=STEPS, eta=eta, decode=False)
    z_want = np.asarray(jpipe.generate(params, batch, key))
    img_want = jax.jit(jm.decode_first_stage)(params, z_want)
    img_want = np.asarray(jnp.round(
        (jnp.clip(img_want, -1.0, 1.0) + 1.0) * 127.5).astype(jnp.uint8))

    shape = (B,) + tuple(jm.config.latent_size) + (4,)
    x_t, noise = _jax_draws(key, shape, STEPS, eta)
    tb = _torch_batch(batch)
    z = GenerationPipeline(tm, num_steps=STEPS, eta=eta, decode=False
                           ).generate(tb, x_T=x_t, noise=noise)
    np.testing.assert_allclose(z.numpy(), z_want, atol=2e-4)
    img = GenerationPipeline(tm, num_steps=STEPS, eta=eta, output_uint8=True
                             ).generate(tb, x_T=x_t, noise=noise)
    assert img.dtype == torch.uint8 and img.shape == img_want.shape
    diff = np.abs(img.numpy().astype(np.int32) - img_want.astype(np.int32))
    assert diff.max() <= 1


def test_unported_samplers_raise(models):
    _, _, tm, _ = models
    for sampler in ("dpm++", "unipc"):
        with pytest.raises(NotImplementedError):
            GenerationPipeline(tm, num_steps=8, sampler=sampler)


def test_pipeline_reports_the_steps_that_run(models):
    # 30 does not divide 1000: the uniform grid runs 31 steps, and both
    # pipelines report the table's length, not the requested count
    from upgpt_tpu.diffusion.schedule import make_ddim_schedule

    jm, _, tm, batch = models
    want = make_ddim_schedule(jm.schedule, 30, eta=1.0).num_steps
    assert want == JaxPipeline(jm, num_steps=30).num_steps == 31
    pipe = GenerationPipeline(tm, num_steps=30, eta=1.0, decode=False)
    assert pipe.num_steps == want
    h, w = jm.config.latent_size
    noise = torch.zeros(pipe.num_steps, B, h, w, 4)
    out = pipe.generate(_torch_batch(batch), x_T=torch.zeros(B, h, w, 4),
                        noise=noise)
    assert out.shape == (B, h, w, 4)


def test_generator_draws_are_reproducible(models):
    _, _, tm, batch = models
    pipe = GenerationPipeline(tm, num_steps=STEPS, eta=1.0, decode=False)
    tb = _torch_batch(batch)
    a = pipe.generate(tb, torch.Generator().manual_seed(5))
    b = pipe.generate(tb, torch.Generator().manual_seed(5))
    c = pipe.generate(tb, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    shared = pipe.generate(tb, torch.Generator().manual_seed(5),
                           shared_x_T=True)
    assert torch.isfinite(shared).all()


@pytest.mark.parametrize("parameterization", ["eps", "v", "x0"])
def test_to_eps_matches_jax(parameterization):
    jm = jax_build("tiny", use_flash_attention=False,
                   parameterization=parameterization)
    tm = build_latent_diffusion("tiny", device="cpu",
                                parameterization=parameterization)
    rng = np.random.default_rng(8)
    out = rng.normal(size=(3, 4, 5, 4)).astype(np.float32)
    x = rng.normal(size=(3, 4, 5, 4)).astype(np.float32)
    t = np.array([1, 500, 999], np.int32)
    want = jm.to_eps(jnp.asarray(out), jnp.asarray(x), jnp.asarray(t))
    got = tm.to_eps(torch.from_numpy(out), torch.from_numpy(x),
                    torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_cfg_eps_model_matches_jax():
    from upgpt_tpu.diffusion.ddim import cfg_eps_model as jax_cfg
    from upgpt_torch.diffusion.ddim import cfg_eps_model

    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 4, 3, 4)).astype(np.float32)
    t = np.array([10, 20], np.int32)
    c = {"c": rng.normal(size=(2, 1)).astype(np.float32)}
    u = {"c": rng.normal(size=(2, 1)).astype(np.float32)}

    def model(xp, tp, cond, lib):
        return xp * lib.reshape(cond["c"], (-1, 1, 1, 1)) + lib.reshape(
            tp, (-1, 1, 1, 1)) * 0.01

    want = jax_cfg(lambda *a: model(*a, jnp), jax.tree.map(jnp.asarray, c),
                   jax.tree.map(jnp.asarray, u), 3.0)(jnp.asarray(x),
                                                      jnp.asarray(t))
    tc = {k: torch.from_numpy(v) for k, v in c.items()}
    tu = {k: torch.from_numpy(v) for k, v in u.items()}
    got = cfg_eps_model(lambda *a: model(*a, torch), tc, tu, 3.0)(
        torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_build_defaults_to_the_card():
    # the entry point builds on the card unless the caller names a device
    if torch.cuda.is_available():
        model = build_latent_diffusion("tiny")
        assert model.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            build_latent_diffusion("tiny")
    assert build_latent_diffusion("tiny", device="cpu").device.type == "cpu"
