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
# one intra-op thread: the suite runs several workers on the cores, and
# a torch pool per worker oversubscribes them
torch.set_num_threads(1)

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


@pytest.fixture(scope="module")
def jax_decode(models):
    """JAX's decoder, compiled once for the module's decoder checks."""
    return jax.jit(models[0].decode_first_stage)


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


def test_tiny_decoder_matches_jax(models, jax_decode):
    jm, params, tm, _ = models
    z = np.random.default_rng(3).normal(size=(B, 32, 24, 4)).astype(
        np.float32)
    want = jax_decode(params, z)
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
def test_tiny_pipeline_matches_jax(models, jax_decode, eta):
    jm, params, tm, batch = models
    key = jax.random.PRNGKey(7)
    jpipe = JaxPipeline(jm, num_steps=STEPS, eta=eta, decode=False)
    z_want = np.asarray(jpipe.generate(params, batch, key))
    img_want = jax_decode(params, z_want)
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


@pytest.mark.parametrize("kw", [dict(sampler="plms"),
                                dict(sampler="dpm"),
                                dict(schedule_method="linear"),
                                dict(sampler="unipc", timesteps=[1, 500])])
def test_unported_samplers_raise(models, kw):
    # the pipeline routes ddim, dpm++ and unipc on the uniform, quad and
    # karras grids, as JAX's does; anything else (PLMS is a sampler
    # function, not a pipeline route) is a ValueError on both sides
    jm, _, tm, _ = models
    with pytest.raises(ValueError):
        JaxPipeline(jm, num_steps=8, **kw)
    with pytest.raises(ValueError):
        GenerationPipeline(tm, num_steps=8, **kw)


@pytest.mark.parametrize("sampler", ["dpm++", "unipc"])
@pytest.mark.parametrize("method,steps", [("uniform", 8), ("quad", 8),
                                          ("karras", 8), ("karras", 200)])
def test_ode_samplers_report_their_table_steps(models, sampler, method,
                                               steps):
    # the karras grid dedupes at high counts: num_steps is what runs
    jm, _, tm, _ = models
    want = JaxPipeline(jm, num_steps=steps, sampler=sampler,
                       schedule_method=method).num_steps
    pipe = GenerationPipeline(tm, num_steps=steps, sampler=sampler,
                              schedule_method=method)
    assert pipe.num_steps == want == pipe.solver.num_steps
    assert (want < steps) == (method == "karras" and steps == 200)


@pytest.mark.parametrize("sampler", ["unipc", "dpm++"])
def test_ode_sampler_routes_match_jax(models, sampler):
    jm, params, tm, batch = models
    key = jax.random.PRNGKey(11)
    want = np.asarray(JaxPipeline(
        jm, num_steps=STEPS, sampler=sampler, schedule_method="karras",
        decode=False).generate(params, batch, key))
    shape = (B,) + tuple(jm.config.latent_size) + (4,)
    x_t, _ = _jax_draws(key, shape, STEPS, 0.0)  # an ODE solver: x_T only
    got = GenerationPipeline(tm, num_steps=STEPS, sampler=sampler,
                             schedule_method="karras", decode=False
                             ).generate(_torch_batch(batch), x_T=x_t)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


def test_generate_progressive_matches_jax(models):
    jm, params, tm, batch = models
    key = jax.random.PRNGKey(12)
    final_want, prog_want = JaxPipeline(jm, num_steps=STEPS, eta=1.0
                                        ).generate_progressive(
        params, batch, key, n_frames=3)
    # ddim_sample draws x_T and its noise from `key` as the pipeline does
    shape = (B,) + tuple(jm.config.latent_size) + (4,)
    x_t, noise = _jax_draws(key, shape, STEPS, 1.0)
    final, prog = GenerationPipeline(tm, num_steps=STEPS, eta=1.0
                                     ).generate_progressive(
        _torch_batch(batch), n_frames=3, x_T=x_t, noise=noise)
    assert tuple(prog.shape) == (B, 3) + tuple(final.shape[1:])
    assert tuple(final.shape) == (B, 64, 48, 3)
    np.testing.assert_allclose(final.numpy(), np.asarray(final_want),
                               atol=1e-4)
    np.testing.assert_allclose(prog.numpy(), np.asarray(prog_want),
                               atol=1e-4)
    with pytest.raises(ValueError):
        GenerationPipeline(tm, num_steps=STEPS, sampler="unipc"
                           ).generate_progressive(_torch_batch(batch))


def test_x_t_seed_rows(models):
    # two samples of equal conditioning: equal seeds give equal x_T rows,
    # so latents equal up to the batched U-Net's summation order (1e-5);
    # different seeds give latents that differ at order 1
    _, _, tm, batch = models
    same = {k: torch.from_numpy(np.repeat(v[:1], B, axis=0))
            for k, v in batch.items()}
    pipe = GenerationPipeline(tm, num_steps=STEPS, eta=0.0, decode=False)
    out = {}
    for seeds in ((5, 5), (5, 6)):
        same["x_T_seed"] = torch.tensor(seeds, dtype=torch.int32)
        out[seeds] = pipe.generate(same, torch.Generator().manual_seed(1))
    np.testing.assert_allclose(out[5, 5][0], out[5, 5][1], atol=1e-5)
    assert (out[5, 6][0] - out[5, 6][1]).abs().max() > 0.1
    # a row's x_T depends on the call's generator and its own seed only
    np.testing.assert_allclose(out[5, 5][0], out[5, 6][0], atol=1e-5)
    same["x_T_seed"] = torch.tensor([5, 5, 5])
    with pytest.raises(ValueError, match="x_T_seed"):
        pipe.generate(same)


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


# ---------------------------------------------------------------- surfaces


@pytest.mark.parametrize("kw", [
    dict(text_override=[True, False] * 4 + [True]),
    dict(drop_slots=[1, 4]),
    dict(text_override=[False] * 8 + [True], drop_slots=[8]),
    dict(),
])
@pytest.mark.parametrize("lead", [(), (2,)])
def test_mix_style_matches_jax(kw, lead):
    from upgpt_tpu.inference.pipeline import mix_style as jax_mix
    from upgpt_torch.inference.pipeline import mix_style

    rng = np.random.default_rng(20)
    img, txt = (rng.normal(size=lead + (9, 16)).astype(np.float32)
                for _ in range(2))
    empty = rng.normal(size=(16,)).astype(np.float32)
    want = jax_mix(jnp.asarray(img), jnp.asarray(txt),
                   empty_style_emb=jnp.asarray(empty), **kw)
    got = mix_style(torch.from_numpy(img), torch.from_numpy(txt),
                    empty_style_emb=torch.from_numpy(empty), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_interpolate_smpl_matches_jax():
    from upgpt_tpu.inference.pipeline import interpolate_smpl as jax_interp
    from upgpt_torch.inference.pipeline import interpolate_smpl

    rng = np.random.default_rng(21)
    src, dst = (rng.normal(size=(1, 85)).astype(np.float32)
                for _ in range(2))
    alphas = np.linspace(0.0, 1.0, 5).astype(np.float32)
    want = jax_interp(jnp.asarray(src), jnp.asarray(dst),
                      jnp.asarray(alphas))
    got = interpolate_smpl(torch.from_numpy(src), torch.from_numpy(dst),
                           torch.from_numpy(alphas))
    assert tuple(got.shape) == (5, 1, 85)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("channel", [False, True])
def test_mask_interpolation_bit_equal_to_jax(channel):
    from upgpt_tpu.inference import pipeline as jp
    from upgpt_torch.inference import pipeline as tp

    assert (tp.MASK_BG, tp.MASK_BOX) == (jp.MASK_BG, jp.MASK_BOX)
    assert tp.STYLE_NAMES == jp.STYLE_NAMES
    src = np.full((32, 24), tp.MASK_BG, np.float32)
    src[3:11, 2:9] = tp.MASK_BOX
    dst = np.full((32, 24), tp.MASK_BG, np.float32)
    dst[14:30, 9:22] = tp.MASK_BOX
    dst[20, 5] = 0.3  # a stray pixel widens the box
    if channel:
        src, dst = src[..., None], dst[..., None]
    np.testing.assert_array_equal(tp._mask_bbox(dst[..., 0] if channel
                                                else dst),
                                  jp._mask_bbox(dst[..., 0] if channel
                                                else dst))
    for alpha in (0.0, 0.3, 0.5, 1.0):
        got, want = (m.interp_mask(src, dst, alpha) for m in (tp, jp))
        assert got.dtype == want.dtype and np.array_equal(got, want)
    alphas = [1.0, 0.75, 0.2]
    got, want = (m.interpolate_masks(src, dst, alphas) for m in (tp, jp))
    assert got.shape == (3,) + src.shape and np.array_equal(got, want)


def test_chained_upscale_options(models):
    # upscale_steps != num_steps, an explicit lr_hw, UniPC on the karras
    # grid, shared_x_T: each stage has JAX's table lengths and grid, and
    # the chain is its two stages back to back
    from upgpt_tpu.inference.pipeline import ChainedUpscalePipeline as JaxChain
    from upgpt_torch.inference.pipeline import (
        ChainedUpscalePipeline, prepare_lr_condition,
    )

    jm, _, tm, batch = models
    jup = jax_build("tiny_upscale", use_flash_attention=False)
    up = build_latent_diffusion("tiny_upscale", device="cpu")
    lr_hw = tuple(up.config.latent_size)
    kw = dict(num_steps=5, upscale_steps=3, sampler="unipc",
              schedule_method="karras", lr_hw=lr_hw)
    want = JaxChain(jm, jup, **kw)
    pipe = ChainedUpscalePipeline(tm, up, **kw)
    assert (pipe.base.num_steps, pipe.up.num_steps) == (
        want.base.num_steps, want.up.num_steps) == (5, 3)
    assert np.array_equal(pipe.up.solver.timesteps, want.up.unipc.timesteps)
    assert pipe.lr_hw == tuple(want.lr_hw) == lr_hw
    tb = _torch_batch(batch)
    gen = torch.Generator().manual_seed(8)
    up_x_t = torch.randn((B,) + lr_hw + (3,), generator=gen)
    got = pipe.generate(tb, torch.Generator().manual_seed(9),
                        shared_x_T=True, up_x_T=up_x_t)
    img256 = pipe.base.generate(tb, torch.Generator().manual_seed(9),
                                shared_x_T=True)
    tail = pipe.up.generate(
        {"text_emb": tb["text_emb"], "style_emb": tb["style_emb"],
         "person_mask": prepare_lr_condition(img256, lr_hw)}, x_T=up_x_t)
    assert tuple(got.shape) == (B, 64, 48, 3)
    assert torch.equal(got, tail)
