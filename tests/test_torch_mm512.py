"""The port's mm_512 against the JAX package's `_mm_512`, on CPU.

- The configuration, field by field: the interp_256 U-Net over a 64x48
  latent and kl-f8 at 512px. The kernel switches are left out: the port's
  zoo sets them as the sampling benchmark does for every variant.
- At mm_512's 64x48 latent with narrow widths (model_channels 32, ch_mult
  (1, 2), attention at ds1, so its self-attention runs over T = 3,072
  tokens): one U-Net eval through the bridge, and a narrow kl-f8 decoder
  from the 64x48 latent to 512x384 (its mid AttnBlock at T 3,072, d 128).
  The JAX side runs its plain path (`use_flash_attention=False`); the port
  its default switches, whose wrappers take their plain versions on CPU
  tensors (the ds1 block the twin with the flash wrapper, as mm_512's ds1
  does on the card). float32 on both sides, so they differ by summation
  order only: atol 1e-4 on outputs of magnitude ~1, the bound the tiny
  slice uses (measured: 2.9e-6 on the U-Net's eps of max 2.4, 6.2e-6 on
  the decoder's image of max 3.1).
- K1's gate admits mm_512's ds2 block (T 768, C 448), which JAX's VMEM
  budget refuses (ROADMAP §3 P5).
- `configs/deepfashion/mm_512.yaml` instantiates the port's model.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers on the cores, and
# a torch pool per worker oversubscribes them
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from upgpt_tpu.models.unet import UNetConfig as JaxUNetConfig  # noqa: E402
from upgpt_tpu.models.vae import (  # noqa: E402
    AutoencoderConfig as JaxAEConfig,
)
from upgpt_tpu.ops import fused_transformer as jft  # noqa: E402
from upgpt_tpu.zoo import _mm_512 as jax_mm_512  # noqa: E402
from upgpt_tpu.zoo import build_latent_diffusion as jax_build  # noqa: E402
from upgpt_torch.config import (  # noqa: E402
    apply_dotlist, instantiate_from_config, load_config,
)
from upgpt_torch.convert.from_jax import load_jax_params  # noqa: E402
from upgpt_torch.diffusion.latent_diffusion import (  # noqa: E402
    LatentDiffusion,
)
from upgpt_torch.models.unet import UNetConfig  # noqa: E402
from upgpt_torch.models.vae import AutoencoderConfig  # noqa: E402
from upgpt_torch.ops import fused_transformer as tft  # noqa: E402
from upgpt_torch.zoo import _BUILDERS, _dtype  # noqa: E402

_SWITCHES = {"use_flash_attention", "use_fused_transformer",
             "use_fused_groupnorm", "use_fused_resblock", "use_checkpoint"}
_KERNELS = {"use_flash_attention": True, "use_fused_transformer": True,
            "use_fused_groupnorm": False, "use_fused_resblock": False,
            "use_fused_vae_groupnorm": False}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW_UNET = dict(in_channels=5, model_channels=32, out_channels=4,
                   num_res_blocks=1, attention_resolutions=(1,),
                   channel_mult=(1, 2), num_heads=4, context_dim=768)
NARROW_VAE = dict(ch=32, ch_mult=(1, 2, 4, 4), num_res_blocks=1,
                  resolution=512)


def _random_params(shapes, seed):
    """Every leaf drawn: kernels N(0, 1/fan_in), norm scales 1 + 0.1 N,
    the rest 0.1 N, so no zero-initialised layer hides a path."""
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


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _same_fields(port, ref, where):
    p, r = _fields(port), _fields(ref)
    shared = (set(p) & set(r)) - _SWITCHES
    assert shared, where
    for name in sorted(shared - {"dtype", "unet", "vae"}):
        assert p[name] == r[name], f"{where}.{name}: {p[name]} != {r[name]}"
    if "dtype" in shared:
        assert str(p["dtype"]).split(".")[-1] == jnp.dtype(r["dtype"]).name
    return shared


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_config_matches_jax_field_by_field(dtype):
    port = _BUILDERS["mm_512"](_dtype(dtype), _KERNELS)
    ref = jax_mm_512(jnp.dtype(dtype), False, False)
    shared = _same_fields(port, ref, "mm_512")
    assert {"unet", "vae", "latent_size", "latent_channels"} <= shared
    _same_fields(port.unet, ref.unet, "mm_512.unet")
    _same_fields(port.vae, ref.vae, "mm_512.vae")
    assert port.latent_size == (64, 48) and port.vae.resolution == 512
    # the mm_512 U-Net is interp_256's, over 4x the tokens
    assert port.unet == _BUILDERS["interp_256"](_dtype(dtype), _KERNELS).unet


@pytest.fixture(scope="module")
def narrow():
    jm = jax_build("mm_512", use_flash_attention=False,
                   unet=JaxUNetConfig(**NARROW_UNET,
                                      use_flash_attention=False),
                   vae=JaxAEConfig.kl_f8(**NARROW_VAE))
    params = _random_params(
        jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)), seed=0)
    from upgpt_torch.zoo import build_latent_diffusion

    tm = build_latent_diffusion(
        "mm_512", device="cpu",
        unet=UNetConfig(**NARROW_UNET, use_fused_transformer=True),
        vae=AutoencoderConfig.kl_f8(**NARROW_VAE, use_flash_attention=True))
    load_jax_params(tm, params)
    return jm, params, tm


def test_narrow_unet_at_the_512px_latent_matches_jax(narrow):
    jm, params, tm = narrow
    h, w = jm.config.latent_size
    assert (h, w) == (64, 48)
    # ds1's self-attention is over 3,072 tokens: past K1's dispatch rule,
    # inside the flash gate, so the port runs the twin + flash wrapper
    assert not tft.fused_transformer_qualifies(h * w, 32, 4, 87)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, h, w, 5)).astype(np.float32)
    t = np.array([511], np.int32)
    ctx = rng.normal(size=(1, 87, 768)).astype(np.float32)
    want = jax.jit(lambda p, *a: jm.unet.apply({"params": p}, *a))(
        params["unet"], x, t, ctx)
    with torch.no_grad():
        got = tm.unet(torch.from_numpy(x), torch.from_numpy(t),
                      torch.from_numpy(ctx))
    assert got.shape == (1, h, w, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_narrow_kl_f8_decoder_at_512px_matches_jax(narrow):
    jm, params, tm = narrow
    z = np.random.default_rng(2).normal(size=(1, 64, 48, 4)).astype(
        np.float32)
    want = jax.jit(jm.decode_first_stage)(params, z)
    with torch.no_grad():
        got = tm.decode_first_stage(torch.from_numpy(z))
    assert got.shape == (1, 512, 384, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_ds2_block_admitted_past_jax_gate():
    # P5: mm_512's ds2 SpatialTransformer, (T 768, C 448), 8 heads, an
    # 87-token context: the port's gate admits it, JAX's VMEM budget not
    args = (768, 448, 8, 87)
    assert tft.fused_transformer_qualifies(*args)
    assert not jft.fused_transformer_qualifies(*args)
    # interp_256's ds2 (T 192) qualifies on both sides
    assert jft.fused_transformer_qualifies(192, 448, 8, 87)


def test_yaml_config_instantiates_the_port_model():
    cfg = load_config(os.path.join(REPO, "configs/deepfashion/mm_512.yaml"))
    assert cfg["model"]["target"] == "upgpt_tpu.zoo.build_latent_diffusion"
    # the full-width geometry on the meta device: every module, no weights
    cfg = apply_dotlist(cfg, ["model.params.device=meta"])
    with torch.device("meta"):
        model = instantiate_from_config(cfg["model"])
    assert isinstance(model, LatentDiffusion)
    assert model.config == _BUILDERS["mm_512"](torch.bfloat16, _KERNELS)
    assert next(model.parameters()).dtype == torch.bfloat16
    assert sum(p.numel() for p in model.parameters()) > 5e8
