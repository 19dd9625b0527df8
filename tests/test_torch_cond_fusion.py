"""The text-style fusion route (inshop_laion) and rematerialisation, against
the JAX package on the CPU in float32.

- `TextStyleCrossAttention` (8 heads of 96 over 9 style slots) within 1e-5
  of JAX's; `build_context` with the fusion: (B, 78, 768), the fused text
  and the pose token, against JAX's; the cond stage in both `style_encode`
  modes on tiny CLIP towers.
- One `training_loss` and its gradients on `tiny` with cond_fusion="image"
  and JAX's draws injected, the port with `use_checkpoint=True` against
  JAX's remat and against itself without it (1e-6 relative): the loss
  within 1e-5, each gradient leaf within 1e-4 relative L2, and the fusion,
  pose and U-Net groups all with gradients.
- `zoo.inshop_laion` on abstract shapes (the meta device): JAX's config
  with the fusion on the interp_256 geometry, nothing initialised.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from upgpt_torch.convert.from_jax import (  # noqa: E402
    flatten_tree, load_jax_params, torch_array, torch_key,
)
from upgpt_torch.data.tokenizer import CLIPTokenizer  # noqa: E402
from upgpt_torch.inference.encoders import (  # noqa: E402
    CLIPConditioningEncoder,
)
from upgpt_torch.models import clip as tclip  # noqa: E402
from upgpt_torch.models.cond_fusion import (  # noqa: E402
    CLIPTextImageCrossAttenStage, TextStyleCrossAttention,
)
from upgpt_torch.training.train_state import (  # noqa: E402
    create_train_state, train_step, trainable_parameters,
)
from upgpt_torch.zoo import build_latent_diffusion  # noqa: E402
from upgpt_tpu.data.tokenizer import (  # noqa: E402
    CLIPTokenizer as JaxTokenizer,
)
from upgpt_tpu.inference import encoders as jenc  # noqa: E402
from upgpt_tpu.models import clip as jclip  # noqa: E402
from upgpt_tpu.models import cond_fusion as jfusion  # noqa: E402
from upgpt_tpu.zoo import build_latent_diffusion as jax_build  # noqa: E402

B = 2


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _random_params(shapes, seed):
    """std 1/sqrt(fan_in) kernels, norm scales 1 + 0.1 N, the rest 0.1 N:
    nothing left at zero, so every group gets a gradient on step one."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "kernel" in name or "embedding" in name:
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(size=leaf.shape) / np.sqrt(fan_in)
        base = 1.0 if "scale" in name else 0.0
        return base + 0.1 * rng.normal(size=leaf.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(draw(p, a), jnp.float32), shapes)


def test_text_style_cross_attention_matches_jax():
    jm = jfusion.TextStyleCrossAttention(dim=768)
    rng = np.random.default_rng(0)
    text = rng.normal(size=(B, 77, 768)).astype(np.float32)
    styles = rng.normal(size=(B, 9, 768)).astype(np.float32)
    params = _random_params(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), text, styles)["params"], 1)
    with jax.default_matmul_precision("highest"):
        want = jm.apply({"params": params}, jnp.asarray(text),
                        jnp.asarray(styles))
    tm = load_jax_params(TextStyleCrossAttention(dim=768), params)
    with torch.no_grad():
        got = tm(torch.from_numpy(text), torch.from_numpy(styles))
    assert got.shape == (B, 77, 768) and got.dtype == torch.float32
    assert _rel(got, want) <= 1e-5


@pytest.fixture(scope="module")
def fusion_models():
    """`tiny` with cond_fusion="image" on both sides, the port's with every
    kernel switch on (their plain versions on the CPU) and remat on, JAX's
    with remat on, on the same random weights."""
    jm = jax_build("tiny", use_flash_attention=False, use_checkpoint=True,
                   cond_fusion="image")
    params = _random_params(
        jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)), seed=2)
    return jm, params


def _port(params, use_checkpoint):
    return load_jax_params(build_latent_diffusion(
        "tiny", device="cpu", use_fused_groupnorm=True,
        use_checkpoint=use_checkpoint, cond_fusion="image"), params)


def _batch(jm, seed=3):
    rng = np.random.default_rng(seed)
    h, w = jm.config.latent_size
    batch = {
        "image": rng.uniform(-1.0, 1.0, size=(B, 2 * h, 2 * w, 3)),
        "person_mask": rng.uniform(-1.0, 1.0, size=(B, h, w, 1)),
        "text_emb": rng.normal(size=(B, 77, 768)),
        "style_emb": rng.normal(size=(B, 9, 768)),
        "smpl": rng.normal(size=(B, 1, 85)),
        "loss_w": rng.uniform(0.5, 1.5, size=(B, h, w, 1)),
    }
    return {k: v.astype(np.float32) for k, v in batch.items()}


def test_build_context_with_fusion_matches_jax(fusion_models):
    jm, params = fusion_models
    batch = _batch(jm)
    with jax.default_matmul_precision("highest"):
        want = jm.build_context(params, batch["text_emb"],
                                batch["style_emb"], batch["smpl"])
    tm = _port(params, False)
    with torch.no_grad():
        got = tm.build_context(*(torch.from_numpy(batch[k]) for k in (
            "text_emb", "style_emb", "smpl")))
    assert tuple(got.shape) == tuple(want.shape) == (B, 78, 768)
    assert _rel(got, want) <= 1e-5
    with pytest.raises(ValueError, match="style_emb"):
        tm.build_context(torch.from_numpy(batch["text_emb"]))


@pytest.mark.parametrize("mode", ["image", "text"])
def test_cond_stage_modes_match_jax(mode):
    merges = [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o</w>")]
    tok = CLIPTokenizer(merges=merges)
    tcfg = dict(vocab_size=tok.eos_id + 1, hidden_size=64, num_layers=1,
                num_heads=4, projection_dim=64)
    vcfg = dict(image_size=28, patch_size=14, hidden_size=64, num_layers=1,
                num_heads=4, projection_dim=64)
    jt = jclip.CLIPTextTower(jclip.CLIPTextConfig(**tcfg))
    jv = jclip.CLIPVisionTower(jclip.CLIPVisionConfig(**vcfg))
    tparams = _random_params(jax.eval_shape(
        jt.init, jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32))[
        "params"], 4)
    vparams = _random_params(jax.eval_shape(
        jv.init, jax.random.PRNGKey(1), jnp.zeros((1, 28, 28, 3)))[
        "params"], 5)
    jstage = jfusion.CLIPTextImageCrossAttenStage(
        jenc.CLIPConditioningEncoder(
            tparams, vparams, JaxTokenizer(merges=merges),
            jclip.CLIPTextConfig(**tcfg), jclip.CLIPVisionConfig(**vcfg)),
        style_encode=mode, dim=64)
    fparams = _random_params(jax.eval_shape(
        lambda k: jstage.init_params(k, dim=64), jax.random.PRNGKey(2)), 6)
    stage = CLIPTextImageCrossAttenStage(
        CLIPConditioningEncoder(
            load_jax_params(tclip.CLIPTextTower(
                tclip.CLIPTextConfig(**tcfg)), tparams),
            load_jax_params(tclip.CLIPVisionTower(
                tclip.CLIPVisionConfig(**vcfg)), vparams), tok),
        load_jax_params(TextStyleCrossAttention(dim=64), fparams),
        style_encode=mode)
    txt = ["hello", "hell o hello"]
    if mode == "image":
        styles = np.random.default_rng(7).integers(
            0, 256, (B, 9, 28, 28, 3)).astype(np.uint8)
    else:
        styles = [[f"hello {i}" for i in range(9)],
                  ["hell"] * 4 + ["o"] * 5]
    with jax.default_matmul_precision("highest"):
        want = jstage(fparams, txt, styles)
    with torch.no_grad():
        got = stage(txt, styles)
    assert got.shape == (B, 77, 64)
    assert _rel(got, want) <= 1e-4
    with pytest.raises(ValueError, match="style_encode"):
        CLIPTextImageCrossAttenStage(None, None, style_encode="pixels")


def _jax_loss_and_grads(jm, params, batch, key):
    trainable = {k: v for k, v in params.items() if k != "vae"}
    frozen = {"vae": params["vae"]}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jm.training_loss(p, batch, key, frozen_params=frozen),
        has_aux=True))(trainable)
    return float(loss), grads


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


def test_training_loss_gradients_and_remat_match_jax(fusion_models):
    jm, params = fusion_models
    batch = _batch(jm, seed=8)
    key = jax.random.PRNGKey(9)
    jloss, jgrads = _jax_loss_and_grads(jm, params, batch, key)
    draws = _jax_draws(jm, params, batch, key)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    runs = {}
    for remat in (False, True):
        tm = _port(params, remat)
        assert tm.unet.config.use_checkpoint is remat
        state = create_train_state(tm, learning_rate=2e-6)
        state, metrics = train_step(tm, state, tbatch, draws=draws)
        runs[remat] = (metrics["loss"].item(),
                       {n: p.grad.clone() for n, p in
                        zip(state.names, state.params)})
    names = [n for n, _ in trainable_parameters(tm)]
    assert any(n.startswith("cond_fusion.") for n in names)
    # rematerialised == kept, on the CPU
    (l0, g0), (l1, g1) = runs[False], runs[True]
    assert abs(l1 - l0) <= 1e-6 * abs(l0)
    for n in names:
        scale = float(g0[n].norm()) or 1.0
        assert float((g1[n] - g0[n]).norm()) <= 1e-6 * scale, n
    # against JAX's remat
    np.testing.assert_allclose(l1, jloss, rtol=1e-5)
    flat = flatten_tree(jgrads)
    assert len(flat) == len(names)
    total = np.sqrt(sum(np.sum(np.square(g)) for g in flat.values()))
    norms = {}
    for jk, g in flat.items():
        want = torch_array(jk, g)
        got = g1[torch_key(jk)].numpy()
        norms.setdefault(jk.split("/")[0], []).append(np.linalg.norm(got))
        if np.linalg.norm(want) < 1e-6 * total:
            # zero up to rounding on both sides (see test_torch_training)
            assert np.linalg.norm(got) < 1e-5 * total, jk
            continue
        assert (np.linalg.norm(got - want) / np.linalg.norm(want)
                <= 1e-4), jk
    for group in ("cond_fusion", "pose", "unet"):
        assert max(norms[group]) > 0, group


def test_zoo_inshop_laion_on_abstract_shapes():
    with torch.device("meta"):
        model = build_latent_diffusion("inshop_laion", dtype="bfloat16",
                                       device="meta", use_checkpoint=True)
    jm = jax_build("inshop_laion", dtype="bfloat16", use_checkpoint=True)
    cfg, jcfg = model.config, jm.config
    assert cfg.cond_fusion == jcfg.cond_fusion == "image"
    assert model.cond_fusion is not None and model.pose is not None
    assert cfg.unet.use_checkpoint and jcfg.unet.use_checkpoint
    for field in ("in_channels", "model_channels", "out_channels",
                  "num_res_blocks", "attention_resolutions", "channel_mult",
                  "num_heads", "transformer_depth", "context_dim"):
        assert getattr(cfg.unet, field) == getattr(jcfg.unet, field), field
    assert cfg.latent_size == jcfg.latent_size == (32, 24)
    assert cfg.pose_input_dim == jcfg.pose_input_dim == 85
    assert dataclasses.replace(cfg, cond_fusion=None) == \
        build_latent_diffusion("interp_256", dtype="bfloat16", device="meta",
                               use_checkpoint=True).config
    # the fusion's parameters: JAX's tree (as init_params makes it), by
    # the bridge's names and layout
    shapes = jax.eval_shape(jfusion.TextStyleCrossAttention(dim=768).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 77, 768)),
                            jnp.zeros((1, 9, 768)))["params"]
    tree = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes)
    fusion = {torch_key(f"cond_fusion/{k}"): tuple(
        torch_array(f"cond_fusion/{k}", v).shape)
        for k, v in flatten_tree(tree).items()}
    assert fusion == {n: tuple(p.shape)
                      for n, p in model.named_parameters()
                      if n.startswith("cond_fusion.")}
    assert fusion["cond_fusion.cross_att.to_q.weight"] == (768, 768)


def test_chip_smoke_counts_the_recompute():
    """The launches chip_smoke.py expects of an inshop_laion train step
    from the structure: with `use_checkpoint` the backward runs every
    fused SpatialTransformer (K1) and every ResBlock's GroupNorms (K5)
    again, the out head's once; K1's recompute backward (K3, K4) and the
    VAE encoder's flash forward are as without; a validation forward has
    no recompute. The context is 78 tokens."""
    import chip_smoke

    counts = {}
    for remat in (True, False):
        with torch.device("meta"):
            model = build_latent_diffusion(
                "inshop_laion", dtype="bfloat16", param_dtype="float32",
                device="meta", use_fused_groupnorm=True,
                use_checkpoint=remat)
        assert chip_smoke.context_tokens(model) == 78
        counts[remat] = chip_smoke.expected_train_counts(model)
        forward = chip_smoke.expected_train_counts(model, backward=False)
        assert (forward["fused_transformer_block"],
                forward["fused_group_norm"], forward["flash_attention"],
                forward["flash_backward_dq"]) == (10, 45, 1, 0)
    on, off = counts[True], counts[False]
    assert (off["fused_transformer_block"], off["fused_group_norm"]) == (
        10, 45)
    assert (on["fused_transformer_block"], on["fused_group_norm"]) == (
        20, 2 * 44 + 1)
    for k in ("flash_attention", "flash_backward_dq", "flash_backward_dkv"):
        assert on[k] == off[k] == (6 if k == "flash_attention" else 5), k
