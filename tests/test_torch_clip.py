"""The port's CLIP towers, converters and conditioning encoder against the
JAX package's, on the CPU in float32.

- The text tower (QuickGELU and exact GELU), the vision tower and
  `StyleImageEncoder` at 2 layers, width 64, 4 heads, 28x28 images in
  14x14 patches, on random weights carried across by the bridge: hidden
  states and pooled features within 1e-4 of max|ref|. Token rows are
  EOS-padded, so the pooling must take the first of several maxima.
- Each converter: one synthetic state dict with the upstream key names (HF
  or openai; no `transformers` here) through JAX's converter into JAX's
  tower and through the port's into the port's, the port's geometry read
  from the tensors' shapes (width 128: 2 heads of 64).
- `normalize_to_clip`; `CLIPConditioningEncoder.encode_batch` with uint8
  and float style crops against JAX's; the trainer's split of it
  (`tokenize_batch` + `encode_device`) against the whole.
- R6: JAX's CLI builds both towers with QuickGELU for every variant; the
  port takes exact GELU for the fusion variant's laion towers.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from upgpt_torch.convert import clip_weights as tcw  # noqa: E402
from upgpt_torch.convert.from_jax import load_jax_params  # noqa: E402
from upgpt_torch.data.tokenizer import CLIPTokenizer  # noqa: E402
from upgpt_torch.inference.encoders import (  # noqa: E402
    CLIPConditioningEncoder,
)
from upgpt_torch.models import clip as tclip  # noqa: E402
from upgpt_torch.ops.basic import normalize_to_clip  # noqa: E402
from upgpt_tpu.convert import clip_weights as jcw  # noqa: E402
from upgpt_tpu.data.tokenizer import (  # noqa: E402
    CLIPTokenizer as JaxTokenizer,
)
from upgpt_tpu.inference import encoders as jenc  # noqa: E402
from upgpt_tpu.models import clip as jclip  # noqa: E402
from upgpt_tpu.ops.basic import normalize_to_clip as jax_normalize  # noqa: E402

TOL = 1e-4
TEXT = dict(vocab_size=99, hidden_size=64, num_layers=2, num_heads=4,
            max_positions=16, projection_dim=32)
VISION = dict(image_size=28, patch_size=14, hidden_size=64, num_layers=2,
              num_heads=4, projection_dim=32)
MERGES = [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o</w>"),
          ("s", "h"), ("i", "r"), ("t", "</w>"), ("sh", "ir"),
          ("shir", "t</w>"), ("r", "e"), ("d", "</w>"), ("re", "d</w>")]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _perturbed(params, seed):
    """Every leaf moved off its init (LayerNorm scales and biases too)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.normal(
            size=a.shape), jnp.float32), params)


def _ids(b, t, vocab, seed, lengths):
    """EOS-padded rows: BOS, random ids, then the largest id (EOS) to the
    end, so every row has several maxima."""
    rng = np.random.default_rng(seed)
    ids = np.full((b, t), vocab - 1, np.int32)
    for i, n in enumerate(lengths):
        ids[i, 0] = vocab - 2
        ids[i, 1:n] = rng.integers(0, vocab - 2, n - 1)
    return ids


@pytest.mark.parametrize("quick", [True, False])
def test_text_tower_matches_jax(quick):
    jcfg = jclip.CLIPTextConfig(quick_gelu=quick, **TEXT)
    jt = jclip.CLIPTextTower(jcfg)
    ids = _ids(3, 16, TEXT["vocab_size"], 1, [5, 9, 15])
    params = _perturbed(jt.init(jax.random.PRNGKey(0), jnp.asarray(ids))[
        "params"], 2)
    with jax.default_matmul_precision("highest"):
        jh, jp = jt.apply({"params": params}, jnp.asarray(ids))
    tower = load_jax_params(tclip.CLIPTextTower(
        tclip.CLIPTextConfig(quick_gelu=quick, **TEXT)), params)
    with torch.no_grad():
        th, tp = tower(torch.from_numpy(ids))
    assert th.dtype == tp.dtype == torch.float32
    assert _rel(th, jh) <= TOL and _rel(tp, jp) <= TOL
    # pooled at the first EOS of each padded row
    first = [5, 9, 15]
    want = th[torch.arange(3), first] @ tower.text_projection
    torch.testing.assert_close(tp, want, rtol=0, atol=0)


def test_causal_mask_keeps_scores_float32():
    """The causal mask is float32's most negative value added to float32
    scores: a token's hidden state depends on no later token."""
    tower = tclip.CLIPTextTower(tclip.CLIPTextConfig(**TEXT)).eval()
    ids = _ids(2, 16, TEXT["vocab_size"], 3, [16, 16])
    ids[1] = ids[0]
    ids[1, 8:] = (ids[1, 8:] + 1) % 90
    with torch.no_grad():
        h, _ = tower(torch.from_numpy(ids))
    torch.testing.assert_close(h[0, :8], h[1, :8], rtol=0, atol=0)
    assert not torch.equal(h[0, 8:], h[1, 8:])


def test_vision_tower_and_style_encoder_match_jax():
    jcfg = jclip.CLIPVisionConfig(**VISION)
    rng = np.random.default_rng(4)
    styles = rng.normal(size=(2, 3, 28, 28, 3)).astype(np.float32)
    jv = jclip.StyleImageEncoder(jcfg)
    params = _perturbed(jv.init(jax.random.PRNGKey(1), jnp.asarray(styles))[
        "params"], 5)
    with jax.default_matmul_precision("highest"):
        jstyle = jv.apply({"params": params}, jnp.asarray(styles))
        jh, jp = jclip.CLIPVisionTower(jcfg).apply(
            {"params": params["vision"]}, jnp.asarray(styles[0]))
    enc = load_jax_params(tclip.StyleImageEncoder(
        tclip.CLIPVisionConfig(**VISION)), params)
    with torch.no_grad():
        tstyle = enc(torch.from_numpy(styles))
        th, tp = enc.vision(torch.from_numpy(styles[0]))
    assert tuple(tstyle.shape) == (2, 3, 32) and tuple(th.shape) == (3, 5, 64)
    assert _rel(tstyle, jstyle) <= TOL
    assert _rel(th, jh) <= TOL and _rel(tp, jp) <= TOL


# ------------------------------------------------ converters

W, LAYERS, VOCAB, POS = 128, 2, 99, 16


def _g(rng, *shape, scale=None):
    scale = 1 / np.sqrt(shape[-1]) if scale is None else scale
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _ln(rng, sd, prefix, w=W):
    sd[f"{prefix}.weight"] = 1 + _g(rng, w, scale=0.1)
    sd[f"{prefix}.bias"] = _g(rng, w, scale=0.1)


def _lin(rng, sd, prefix, o, i):
    sd[f"{prefix}.weight"] = _g(rng, o, i)
    sd[f"{prefix}.bias"] = _g(rng, o, scale=0.1)


def _hf_layers(rng, sd, p):
    for i in range(LAYERS):
        lp = f"{p}encoder.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _lin(rng, sd, f"{lp}.self_attn.{proj}", W, W)
        _ln(rng, sd, f"{lp}.layer_norm1")
        _ln(rng, sd, f"{lp}.layer_norm2")
        _lin(rng, sd, f"{lp}.mlp.fc1", 4 * W, W)
        _lin(rng, sd, f"{lp}.mlp.fc2", W, 4 * W)


def _openai_layers(rng, sd, p, w=W, layers=LAYERS):
    for i in range(layers):
        lp = f"{p}transformer.resblocks.{i}"
        sd[f"{lp}.attn.in_proj_weight"] = _g(rng, 3 * w, w)
        sd[f"{lp}.attn.in_proj_bias"] = _g(rng, 3 * w, scale=0.1)
        _lin(rng, sd, f"{lp}.attn.out_proj", w, w)
        _ln(rng, sd, f"{lp}.ln_1", w)
        _ln(rng, sd, f"{lp}.ln_2", w)
        _lin(rng, sd, f"{lp}.mlp.c_fc", 4 * w, w)
        _lin(rng, sd, f"{lp}.mlp.c_proj", w, 4 * w)


def hf_text(seed=0, projection=True):
    rng = np.random.default_rng(seed)
    p = "text_model."
    sd = {f"{p}embeddings.token_embedding.weight": _g(rng, VOCAB, W, scale=1),
          f"{p}embeddings.position_embedding.weight": _g(rng, POS, W,
                                                         scale=0.1)}
    _hf_layers(rng, sd, p)
    _ln(rng, sd, f"{p}final_layer_norm")
    if projection:
        sd["text_projection.weight"] = _g(rng, 96, W)
    return sd


def openai_clip(seed=0, image=28, patch=14, vocab=VOCAB, pos=POS,
                text_width=W, vision_width=W, layers=LAYERS, proj=96):
    """An openai-clip CLIP state dict: text side and `visual.` side."""
    rng = np.random.default_rng(seed)
    tw, vw = text_width, vision_width
    sd = {"token_embedding.weight": _g(rng, vocab, tw, scale=1),
          "positional_embedding": _g(rng, pos, tw, scale=0.1),
          "text_projection": _g(rng, tw, proj)}
    _openai_layers(rng, sd, "", tw, layers)
    _ln(rng, sd, "ln_final", tw)
    n = (image // patch) ** 2
    sd.update({"visual.conv1.weight": _g(rng, vw, 3, patch, patch,
                                         scale=1 / (3 * patch)),
               "visual.class_embedding": _g(rng, vw, scale=1),
               "visual.positional_embedding": _g(rng, n + 1, vw, scale=0.1),
               "visual.proj": _g(rng, vw, proj)})
    _openai_layers(rng, sd, "visual.", vw, layers)
    _ln(rng, sd, "visual.ln_pre", vw)
    _ln(rng, sd, "visual.ln_post", vw)
    return sd


def hf_vision(seed=0):
    rng = np.random.default_rng(seed)
    p = "vision_model."
    sd = {f"{p}embeddings.patch_embedding.weight": _g(rng, W, 3, 14, 14,
                                                      scale=1 / 42),
          f"{p}embeddings.class_embedding": _g(rng, W, scale=1),
          f"{p}embeddings.position_embedding.weight": _g(rng, 5, W,
                                                         scale=0.1),
          "visual_projection.weight": _g(rng, 96, W)}
    _hf_layers(rng, sd, p)
    _ln(rng, sd, f"{p}pre_layrnorm")
    _ln(rng, sd, f"{p}post_layernorm")
    return sd


def _torch_sd(sd):
    return {k: torch.from_numpy(v) for k, v in sd.items()}


@pytest.mark.parametrize("layout,quick", [("hf", False), ("hf-bare", True),
                                          ("openai", True)])
def test_text_converters_match_jax(layout, quick):
    sd = (openai_clip(1) if layout == "openai"
          else hf_text(2, projection=layout == "hf"))
    convert = (jcw.convert_openai_clip_text if layout == "openai"
               else jcw.convert_hf_clip_text)
    jparams = convert(sd, num_layers=LAYERS)
    jcfg = jclip.CLIPTextConfig(
        vocab_size=VOCAB, hidden_size=W, num_layers=LAYERS, num_heads=2,
        max_positions=POS, quick_gelu=quick,
        projection_dim=jparams["text_projection"].shape[1])
    ids = _ids(2, POS, VOCAB, 6, [7, 12])
    with jax.default_matmul_precision("highest"):
        jh, jp = jclip.CLIPTextTower(jcfg).apply({"params": jparams},
                                                 jnp.asarray(ids))
    assert tcw.text_layout(sd) == layout.split("-")[0]
    tower = tcw.text_tower_from_state_dict(_torch_sd(sd), quick)
    assert tower.config == tclip.CLIPTextConfig(
        vocab_size=VOCAB, hidden_size=W, num_layers=LAYERS, num_heads=2,
        max_positions=POS, quick_gelu=quick,
        projection_dim=jcfg.projection_dim)
    with torch.no_grad():
        th, tp = tower(torch.from_numpy(ids))
    assert _rel(th, jh) <= TOL and _rel(tp, jp) <= TOL
    # the converter alone, numpy in, equals the tower's weights
    port = (tcw.convert_openai_clip_text if layout == "openai"
            else tcw.convert_hf_clip_text)(sd, num_layers=LAYERS)
    assert set(port) == set(tower.state_dict())


@pytest.mark.parametrize("layout", ["hf", "openai"])
def test_vision_converters_match_jax(layout):
    sd = openai_clip(3) if layout == "openai" else hf_vision(4)
    convert = (jcw.convert_openai_clip_vision if layout == "openai"
               else jcw.convert_hf_clip_vision)
    jparams = convert(sd, num_layers=LAYERS)
    jcfg = jclip.CLIPVisionConfig(image_size=28, patch_size=14, hidden_size=W,
                                  num_layers=LAYERS, num_heads=2,
                                  quick_gelu=False, projection_dim=96)
    pixels = np.random.default_rng(7).normal(size=(3, 28, 28, 3)).astype(
        np.float32)
    with jax.default_matmul_precision("highest"):
        jh, jp = jclip.CLIPVisionTower(jcfg).apply({"params": jparams},
                                                   jnp.asarray(pixels))
    assert tcw.vision_layout(sd) == layout
    tower = tcw.vision_tower_from_state_dict(_torch_sd(sd), False)
    assert tower.config == tclip.CLIPVisionConfig(
        image_size=28, patch_size=14, hidden_size=W, num_layers=LAYERS,
        num_heads=2, quick_gelu=False, projection_dim=96)
    with torch.no_grad():
        th, tp = tower(torch.from_numpy(pixels))
    assert _rel(th, jh) <= TOL and _rel(tp, jp) <= TOL


def test_geometry_from_the_port_layout_and_layouts_refused():
    tower = tcw.text_tower_from_state_dict(_torch_sd(openai_clip(5)), True)
    again = tcw.text_tower_from_state_dict(tower.state_dict(), True)
    assert again.config == tower.config and tcw.text_layout(
        tower.state_dict()) == "port"
    vision = tcw.vision_tower_from_state_dict(_torch_sd(openai_clip(5)), True)
    # StyleImageEncoder's `vision.` prefix is taken off
    style = {f"vision.{k}": v for k, v in vision.state_dict().items()}
    assert tcw.vision_tower_from_state_dict(style, True).config == \
        vision.config
    assert not again.token_embedding.weight.requires_grad
    assert tcw.heads_for_width(1024) == 16 and tcw.heads_for_width(768) == 12
    with pytest.raises(ValueError, match="multiple of 64"):
        tcw.heads_for_width(96)
    with pytest.raises(ValueError, match="text state dict"):
        tcw.text_layout({"x": torch.zeros(1)})
    with pytest.raises(ValueError, match="vision state dict"):
        tcw.vision_layout({"x": torch.zeros(1)})


# ------------------------------------------------ pixels and the encoder

def test_normalize_to_clip_matches_jax():
    x = np.random.default_rng(8).uniform(-1, 1, (2, 5, 4, 3)).astype(
        np.float32)
    got = normalize_to_clip(torch.from_numpy(x))
    want = np.asarray(jax_normalize(jnp.asarray(x)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert normalize_to_clip(torch.from_numpy(x),
                             torch.bfloat16).dtype == torch.bfloat16


@pytest.fixture(scope="module")
def encoders():
    """The same tiny towers and merges on both sides."""
    tok = CLIPTokenizer(merges=list(MERGES))
    vocab = tok.eos_id + 1  # EOS is the largest id
    tcfg = dict(TEXT, vocab_size=vocab, max_positions=77)
    ids = tok(["hello"])
    jt = jclip.CLIPTextTower(jclip.CLIPTextConfig(**tcfg))
    tparams = _perturbed(jt.init(jax.random.PRNGKey(2), jnp.asarray(ids))[
        "params"], 9)
    jv = jclip.CLIPVisionTower(jclip.CLIPVisionConfig(**VISION))
    vparams = _perturbed(jv.init(jax.random.PRNGKey(3), jnp.zeros(
        (1, 28, 28, 3)))["params"], 10)
    theirs = jenc.CLIPConditioningEncoder(
        tparams, vparams, JaxTokenizer(merges=list(MERGES)),
        jclip.CLIPTextConfig(**tcfg), jclip.CLIPVisionConfig(**VISION))
    ours = CLIPConditioningEncoder(
        load_jax_params(tclip.CLIPTextTower(tclip.CLIPTextConfig(**tcfg)),
                        tparams),
        load_jax_params(tclip.CLIPVisionTower(tclip.CLIPVisionConfig(
            **VISION)), vparams), tok)
    return ours, theirs


@pytest.mark.parametrize("uint8", [True, False])
def test_encode_batch_matches_jax(encoders, uint8):
    ours, theirs = encoders
    rng = np.random.default_rng(11)
    crops = rng.integers(0, 256, (2, 9, 28, 28, 3)).astype(np.uint8)
    crops[1, 4] = 0  # an empty slot: normalize(black)
    styles = crops if uint8 else ((crops / 255.0 - jenc_mean()) /
                                  jenc_std()).astype(np.float32)
    batch = {"txt": ["hello red shirt", "a  RED&amp;shirt hello"],
             "styles": styles, "smpl": np.zeros((2, 1, 85), np.float32)}
    with jax.default_matmul_precision("highest"):
        want = theirs.encode_batch(batch)
    got = ours.encode_batch(batch)
    assert got["text_emb"].shape == (2, 77, 64)
    assert got["style_emb"].shape == (2, 9, 32)
    assert _rel(got["text_emb"], want["text_emb"]) <= TOL
    assert _rel(got["style_emb"], want["style_emb"]) <= TOL
    assert got["smpl"] is batch["smpl"]
    # the trainer's split: tokens on the host, the towers on the device
    host = ours.tokenize_batch(batch)
    np.testing.assert_array_equal(host["token_ids"],
                                  ours.tokenizer(batch["txt"]))
    dev = ours.encode_device({"token_ids": torch.from_numpy(
        host["token_ids"]), "styles": torch.from_numpy(styles)})
    assert set(dev) == {"text_emb", "style_emb"}
    torch.testing.assert_close(dev["text_emb"], got["text_emb"], rtol=0,
                               atol=0)
    torch.testing.assert_close(dev["style_emb"], got["style_emb"], rtol=0,
                               atol=0)
    assert not dev["text_emb"].requires_grad
    pooled = ours.text_pooled(batch["txt"])
    with jax.default_matmul_precision("highest"):
        assert _rel(pooled, theirs.text_pooled(batch["txt"])) <= TOL


def jenc_mean():
    from upgpt_tpu.data.transforms import CLIP_MEAN
    return CLIP_MEAN


def jenc_std():
    from upgpt_tpu.data.transforms import CLIP_STD
    return CLIP_STD


# ------------------------------------------------ R6


def test_r6_activation_follows_the_variant(tmp_path, monkeypatch):
    """The reference fault R6: JAX's `cli._build_cond_encoder` builds both
    towers with the default QuickGELU for every variant
    (`upgpt_tpu/cli.py:38-42`), though inshop_laion_clip.yaml:52 and
    zoo.py:80 say that variant's laion towers use exact GELU. The port
    picks exact GELU for a model with the text-style fusion and QuickGELU
    otherwise; the two towers' outputs differ."""
    import sys
    import types

    from upgpt_torch import cli as tcli
    from upgpt_torch.zoo import build_latent_diffusion
    from upgpt_tpu import cli as jcli

    sd = openai_clip(12, vocab=CLIPTokenizer(merges=list(MERGES)).eos_id + 1,
                     pos=77)
    torch.save(_torch_sd(sd), tmp_path / "clip.pt")
    (tmp_path / "bpe.txt").write_text(
        "\n".join(" ".join(m) for m in MERGES) + "\n")
    clip = {"clip": {"text_params": str(tmp_path / "clip.pt"),
                     "vision_params": str(tmp_path / "clip.pt"),
                     "bpe_path": str(tmp_path / "bpe.txt")}}

    # JAX's: every variant gets the default configs (QuickGELU)
    seen = {}

    class Recorder:
        def __init__(self, text_params, vision_params, tokenizer,
                     text_config=None, vision_config=None):
            seen["text"] = text_config or jclip.CLIPTextConfig()
            seen["vision"] = vision_config or jclip.CLIPVisionConfig()

    fake_ocp = types.ModuleType("orbax.checkpoint")
    fake_ocp.StandardCheckpointer = lambda: types.SimpleNamespace(
        restore=lambda path: {})
    import orbax

    monkeypatch.setitem(sys.modules, "orbax.checkpoint", fake_ocp)
    monkeypatch.setattr(orbax, "checkpoint", fake_ocp, raising=False)
    monkeypatch.setattr(jenc, "CLIPConditioningEncoder", Recorder)
    jcli._build_cond_encoder(clip, model=None)
    assert seen["text"].quick_gelu and seen["vision"].quick_gelu

    outs = {}
    for fusion, quick in (("image", False), (None, True)):
        model = build_latent_diffusion("tiny", device="cpu",
                                       cond_fusion=fusion)
        enc = tcli._build_cond_encoder(clip, model)
        assert enc.text_tower.config.quick_gelu is quick
        assert enc.style_encoder.vision.config.quick_gelu is quick
        outs[quick] = enc.text_hidden(["hello shirt"])
    assert not torch.allclose(outs[False], outs[True])


def test_request_builder_takes_the_clip_embeddings(encoders):
    """`cli serve` packs requests on the host: the CLIP encoder's device
    tensors become float32 host arrays there."""
    from upgpt_torch.inference.http_serve import RequestBuilder

    ours, _ = encoders
    cond = RequestBuilder(ours, mask_hw=(4, 3), context_dim=64).build(
        {"txt": "hello red shirt", "seed": 3})
    assert cond["text_emb"].dtype == np.float32
    assert cond["text_emb"].shape == (77, 64)
    np.testing.assert_array_equal(
        cond["text_emb"], ours.text_hidden(["hello red shirt"])[0].numpy())
