"""The port's 256->512 upscale path against the JAX package, on CPU.

- `prepare_lr_condition`: the edge pad and the antialiased bilinear resize
  agree with `jax.image.resize` to float32 rounding (measured: 3.4e-6 on
  values in [-1, 1]; atol 2e-5).
- A tiny kl-f4 decoder with the VAE's fused GroupNorm on: the JAX side runs
  its Pallas kernels in interpret mode, the port its twins; both compute in
  float32, so outputs of magnitude ~1 agree to 1e-4, the bound the tiny
  kl-f8 decoder test uses.
- The parameter bridge carries the full-width upscale tree, key for key
  and shape for shape (checked on abstract shapes: no weights are made).
- The tiny + tiny_upscale chain: both sides get the same random weights
  through the bridge, the same inputs, and the port is handed the draws
  JAX's `ChainedUpscalePipeline` takes from each stage's key. Kernels off
  on both sides and float32, so the float images differ only by summation
  order through two 4-step DDIM stages and two decoders: atol 5e-5
  (measured: 3.8e-6). With the port's kernel switches on, its twins round
  the ResBlock activations and weights to bf16, so the chain moves by bf16
  rounding: relative L2 of the uint8 images below 2e-2 (measured: 2.3e-3).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers on the cores, and
# a torch pool per worker oversubscribes them
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from upgpt_tpu.inference.pipeline import (  # noqa: E402
    ChainedUpscalePipeline as JaxChain, prepare_lr_condition as jax_lr,
)
from upgpt_tpu.models.vae import (  # noqa: E402
    AutoencoderConfig as JaxAEConfig, Decoder as JaxDecoder,
)
from upgpt_tpu.zoo import build_latent_diffusion as jax_build  # noqa: E402
from upgpt_torch.convert.from_jax import (  # noqa: E402
    flatten_tree, load_jax_params, torch_array, torch_key,
)
from upgpt_torch.diffusion.latent_diffusion import (  # noqa: E402
    LatentDiffusion,
)
from upgpt_torch.inference.pipeline import (  # noqa: E402
    ChainedUpscalePipeline, UpscalePipeline, prepare_lr_condition,
)
from upgpt_torch.models.vae import AutoencoderConfig, Decoder  # noqa: E402
from upgpt_torch.ops import fused_gn  # noqa: E402
from upgpt_torch.zoo import _BUILDERS, build_latent_diffusion  # noqa: E402

B, STEPS = 2, 4


@pytest.mark.parametrize("shape,out_hw", [((2, 256, 192, 3), (128, 96)),
                                          ((2, 64, 48, 3), (32, 24))])
def test_prepare_lr_condition_matches_jax(shape, out_hw):
    x = np.random.default_rng(0).uniform(-1, 1, size=shape).astype(
        np.float32)
    want = jax_lr(jnp.asarray(x), out_hw)
    got = prepare_lr_condition(torch.from_numpy(x), out_hw)
    assert got.shape == (shape[0],) + out_hw + (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def _random_params(shapes, seed):
    """std 1/sqrt(fan_in) weights, norm scales 1 + 0.1 N, biases 0.1 N."""
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


def test_tiny_kl_f4_decoder_with_fused_groupnorm_matches_jax():
    over = dict(ch=32, num_res_blocks=1, resolution=64,
                use_fused_groupnorm=True)
    jdec = JaxDecoder(JaxAEConfig.kl_f4(**over))
    z = np.random.default_rng(1).normal(size=(B, 16, 12, 3)).astype(
        np.float32)
    params = _random_params(
        jax.eval_shape(jdec.init, jax.random.PRNGKey(0), z)["params"], 2)
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(jdec.apply)({"params": params}, z)
    dec = load_jax_params(Decoder(AutoencoderConfig.kl_f4(**over)), params)
    before = fused_gn.tiled_group_norm.launches
    with torch.no_grad():
        got = dec(torch.from_numpy(z))
    assert fused_gn.tiled_group_norm.launches == before  # CPU: the twins
    assert got.shape == (B, 64, 48, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("variant", ["upscale"])
def test_bridge_carries_the_full_width_tree(variant):
    jm = jax_build(variant)
    # zero-stride int8 stand-ins of the abstract shapes
    shapes = flatten_tree(jax.tree.map(
        lambda a: np.broadcast_to(np.int8(0), a.shape),
        jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))))
    with torch.device("meta"):
        tm = LatentDiffusion(_BUILDERS[variant](torch.float32, {
            k: False for k in ("use_flash_attention", "use_fused_transformer",
                               "use_fused_groupnorm", "use_fused_resblock",
                               "use_fused_vae_groupnorm")}))
    target = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    mapped = {torch_key(k): torch_array(k, v).shape
              for k, v in shapes.items()}
    assert mapped == target
    if variant == "upscale":
        assert target["unet.conv_in.weight"] == (256, 6, 3, 3)
        assert target["unet.out_conv.weight"] == (3, 256, 3, 3)
        assert target["vae.decoder.conv_in.weight"] == (512, 3, 3, 3)
        assert tm.pose is None


@pytest.fixture(scope="module")
def chain():
    base, up = (jax_build(v, use_flash_attention=False)
                for v in ("tiny", "tiny_upscale"))
    params = {
        "base": _random_params(jax.eval_shape(base.init_params,
                                              jax.random.PRNGKey(0)), 10),
        "up": _random_params(jax.eval_shape(up.init_params,
                                            jax.random.PRNGKey(1)), 11)}
    rng = np.random.default_rng(12)
    h, w = base.config.latent_size
    batch = {
        "text_emb": rng.normal(size=(B, 77, 768)),
        "style_emb": rng.normal(size=(B, 9, 768)),
        "smpl": rng.normal(size=(B, 1, 85)),
        "person_mask": rng.choice([-1.0, -0.99215686], size=(B, h, w, 1)),
    }
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    key = jax.random.PRNGKey(13)
    want = np.asarray(JaxChain(base, up, num_steps=STEPS, eta=1.0).generate(
        params, batch, key))
    return base, up, params, batch, key, want


def _jax_draws(key, shape):
    """The x_T and per-step noise a JAX GenerationPipeline draws from `key`
    at eta 1 (pipeline.py:152-168, ddim.py:129-134)."""
    key, k_noise = jax.random.split(key)
    x_t = jax.random.normal(k_noise, shape)
    noise = []
    for _ in range(STEPS):
        key, k_n = jax.random.split(key)
        noise.append(jax.random.normal(k_n, shape, jnp.float32))
    return (torch.from_numpy(np.array(x_t)),
            torch.from_numpy(np.stack(noise)))


def _port_chain(base, up, params, kernels):
    switches = dict(use_fused_transformer=kernels,
                    use_fused_groupnorm=kernels, use_fused_resblock=kernels,
                    use_fused_vae_groupnorm=kernels)
    tb = load_jax_params(build_latent_diffusion(
        "tiny", device="cpu", **switches), params["base"])
    tu = load_jax_params(build_latent_diffusion(
        "tiny_upscale", device="cpu", **switches), params["up"])
    return tb, tu


def _draws(base, up, key):
    k_base, k_up = jax.random.split(key)
    x_t, noise = _jax_draws(k_base, (B,) + tuple(base.config.latent_size)
                            + (4,))
    up_x_t, up_noise = _jax_draws(k_up, (B,) + tuple(up.config.latent_size)
                                  + (3,))
    return dict(x_T=x_t, noise=noise, up_x_T=up_x_t, up_noise=up_noise)


def test_tiny_chain_matches_jax(chain):
    base, up, params, batch, key, want = chain
    tb, tu = _port_chain(base, up, params, kernels=False)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = ChainedUpscalePipeline(tb, tu, num_steps=STEPS, eta=1.0).generate(
        tbatch, **_draws(base, up, key))
    assert got.shape == want.shape == (B, 64, 48, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)


def test_tiny_chain_with_kernel_switches_stays_close(chain):
    base, up, params, batch, key, want = chain
    tb, tu = _port_chain(base, up, params, kernels=True)
    assert tb.unet.config.fused_level == 2
    assert tu.vae.config.use_fused_groupnorm
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    pipe = ChainedUpscalePipeline(tb, tu, num_steps=STEPS, eta=1.0,
                                  output_uint8=True)
    draws = _draws(base, up, key)
    got = pipe.generate(tbatch, **draws)
    assert got.dtype == torch.uint8 and got.shape == (B, 64, 48, 3)
    ref = torch.from_numpy(np.round((np.clip(want, -1, 1) + 1) * 127.5))
    rel = ((got.float() - ref).norm() / ref.norm()).item()
    assert rel < 2e-2
    # the upscale stage alone, from the same 256 image, is the chain's tail
    img256 = pipe.base.generate(tbatch, x_T=draws["x_T"],
                                noise=draws["noise"])
    tail = UpscalePipeline(tu, num_steps=STEPS, eta=1.0, output_uint8=True
                           ).upscale(img256, tbatch["text_emb"],
                                     tbatch["style_emb"], x_T=draws["up_x_T"],
                                     noise=draws["up_noise"])
    assert torch.equal(tail, got)


def test_chain_draws_come_from_one_generator(chain):
    base, up, params, batch, _, _ = chain
    tb, tu = _port_chain(base, up, params, kernels=False)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    pipe = ChainedUpscalePipeline(tb, tu, num_steps=STEPS, eta=1.0)
    a = pipe.generate(tbatch, torch.Generator().manual_seed(3))
    b = pipe.generate(tbatch, torch.Generator().manual_seed(3))
    c = pipe.generate(tbatch, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
