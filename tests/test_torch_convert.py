"""The Lightning converter (`upgpt_torch.convert.lightning`) and `cli
convert` against the JAX package's `convert/torch_to_jax.py`, on the CPU.

No released checkpoint is in the repository, so the reference's layout is
built here, independently of the port's key tables: JAX parameter trees of
three topologies at width 32 (`tiny`; interp_256's ch_mult 1/2/4/4, two
res blocks and attention at 1/2/4 with kl-f8's first stage and the
inshop_laion fusion; upscale's 1/2/2/4 with attention at 8/4/2 and kl-f4),
their shapes from `jax.eval_shape` (no flax init), filled with seeded
values; a test-local inverse of JAX's layout rules, written the way the
reference's constructors number their modules, gives the reference-named
state dict S. S is pinned by JAX's converters: they rebuild the tree leaf
for leaf and read every key of S. The port's conversion of S, through a
`torch.save`d Lightning file, must then equal the parameter bridge's
mapping of the same tree (`from_jax.state_dict_from_jax`), bit for bit.

Also: `split_ldm_checkpoint` and `ema_unet_state_dict` against JAX's on a
file with a LitEma shadow and `num_batches_tracked` buffers; the loader
never runs a global the pickle names (ROADMAP P8, where JAX's
`weights_only=False` does); strictness (a missing key, a leftover U-Net key
and a bad shape raise, naming the key); `cli convert` -> `cli sample` at
`tiny` equal to JAX's sampling of its own conversion, with JAX's x_T and
per-step noise injected (float32, kernels off: summation order only,
atol 5e-5; measured 2.0e-6).
"""

import dataclasses
import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from upgpt_tpu.convert import torch_to_jax as jconv  # noqa: E402
from upgpt_tpu.diffusion.latent_diffusion import (  # noqa: E402
    LatentDiffusion as JaxLD,
)
from upgpt_tpu.inference.pipeline import (  # noqa: E402
    GenerationPipeline as JaxPipeline,
)
from upgpt_tpu.zoo import build_latent_diffusion as jax_build  # noqa: E402
from upgpt_torch import cli  # noqa: E402
from upgpt_torch.convert import lightning  # noqa: E402
from upgpt_torch.convert.from_jax import (  # noqa: E402
    flatten_tree, state_dict_from_jax,
)
from upgpt_torch.diffusion.latent_diffusion import LatentDiffusion  # noqa: E402
from upgpt_torch.zoo import _BUILDERS  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "deepfashion", "interp_256.yaml")
KERNELS_OFF = dict.fromkeys(("use_flash_attention", "use_fused_transformer",
                             "use_fused_groupnorm", "use_fused_resblock",
                             "use_fused_vae_groupnorm"), False)
# (variant, width): tiny as it is; inshop_laion (interp_256's topology with
# the fusion) and upscale at width 32
TOPOLOGIES = [("tiny", None), ("inshop_laion", 32), ("upscale", 32)]
STEPS = 4


# ------------------------------------------- the reference layout, by hand

def _random_tree(shapes, seed):
    """std 1/sqrt(fan_in) kernels, norm scales 1 + 0.1 N, biases 0.1 N."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        z = rng.normal(size=leaf.shape)
        if "kernel" in name:
            z = z / np.sqrt(np.prod(leaf.shape[:-1]))
        else:
            z = ("scale" in name) + 0.1 * z
        return z.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _ref_leaf(path: str, leaf: str, value, as_conv1x1=False):
    """One JAX leaf in the reference's torch layout."""
    if leaf == "kernel":
        if value.ndim == 4:  # HWIO -> OIHW
            return f"{path}.weight", value.transpose(3, 2, 0, 1)
        w = value.T  # (in, out) -> (out, in)
        return f"{path}.weight", w[:, :, None, None] if as_conv1x1 else w
    return f"{path}.{ {'scale': 'weight'}.get(leaf, leaf)}", value


def _emit(out, prefix, subtree, rules=(), conv1x1=()):
    """Every leaf of `subtree` under the module path `prefix`, its own
    path rewritten by the (regex, replacement) `rules` on the "/"-joined
    JAX path."""
    for key, value in flatten_tree(subtree).items():
        *path, leaf = key.split("/")
        p = "/".join(path)
        for rx, rep in rules:
            p = re.sub(rx, rep, p)
        module = ".".join(x for x in (prefix, p.replace("/", ".")) if x)
        name, arr = _ref_leaf(module, leaf, value,
                              as_conv1x1=p.split("/")[-1] in conv1x1)
        out[name] = np.ascontiguousarray(arr)


_RES = [("^norm_in", "in_layers.0"), ("^conv_in", "in_layers.2"),
        ("^emb_proj", "emb_layers.1"), ("^norm_out", "out_layers.0"),
        ("^conv_out", "out_layers.3"), ("^skip", "skip_connection")]
_ST = [(r"^block_(\d+)", r"transformer_blocks/\1"),
       (r"/to_out$", "/to_out/0"), (r"ff/proj_in$", "ff/net/0/proj"),
       (r"ff/proj_out$", "ff/net/2")]
_VAE = [(r"(down|up)_(\d+)_(block|attn)_(\d+)", r"\1/\2/\3/\4"),
        (r"down_(\d+)_downsample", r"down/\1/downsample"),
        (r"up_(\d+)_upsample", r"up/\1/upsample"),
        (r"mid_(block_\d|attn_1)", r"mid/\1")]


def reference_unet(tree, cfg) -> dict:
    """The reference UNetModel's state dict (openaimodel.py:516-692): its
    input_blocks / middle_block / output_blocks lists built as its
    constructor appends them, each layer named by the JAX module it is."""
    inputs = [[("conv", "conv_in")]]
    ds = 1
    for level in range(len(cfg.channel_mult)):
        for i in range(cfg.num_res_blocks):
            layers = [("res", f"down_{level}_{i}_res")]
            if ds in cfg.attention_resolutions:
                layers.append(("st", f"down_{level}_{i}_attn"))
            inputs.append(layers)
        if level != len(cfg.channel_mult) - 1:
            inputs.append([("op", f"down_{level}_downsample")])
            ds *= 2
    outputs = []
    for level in reversed(range(len(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            layers = [("res", f"up_{level}_{i}_res")]
            if ds in cfg.attention_resolutions:
                layers.append(("st", f"up_{level}_{i}_attn"))
            if level and i == cfg.num_res_blocks:
                layers.append(("conv_up", f"up_{level}_upsample"))
                ds //= 2
            outputs.append(layers)
    middle = [("res", "mid_res1"), ("st", "mid_attn"), ("res", "mid_res2")]
    rules = {"res": _RES, "st": _ST, "conv": [], "op": [("^conv", "op")],
             "conv_up": []}
    out = {}
    for block, layers in ([(f"input_blocks.{n}", ls)
                           for n, ls in enumerate(inputs)]
                          + [("middle_block", middle)]
                          + [(f"output_blocks.{n}", ls)
                             for n, ls in enumerate(outputs)]):
        for j, (kind, name) in enumerate(layers):
            _emit(out, f"{block}.{j}", tree[name], rules[kind],
                  conv1x1=("proj_in", "proj_out") if kind == "st" else ())
    for name, ref in (("time_embed_0", "time_embed.0"),
                      ("time_embed_2", "time_embed.2"),
                      ("out_norm", "out.0"), ("out_conv", "out.2")):
        _emit(out, ref, tree[name])
    return out


def reference_state_dict(tree, cfg) -> dict:
    """{bucket: reference-named numpy state dict} of a JAX params tree."""
    buckets = {"unet": reference_unet(tree["unet"], cfg.unet), "vae": {}}
    _emit(buckets["vae"], "", tree["vae"], _VAE)
    if "pose" in tree:
        buckets["pose"] = {"model.weight": np.ascontiguousarray(
                               tree["pose"]["proj"]["kernel"].T),
                           "model.bias": tree["pose"]["proj"]["bias"]}
    if "cond_fusion" in tree:
        buckets["fusion"] = {}
        _emit(buckets["fusion"], "", tree["cond_fusion"],
              [(r"/to_out$", "/to_out/0")])
    return buckets


def lightning_file(buckets, path, ema=None, extra=None):
    """`buckets` in the reference's Lightning layout, written with
    torch.save; `ema` (reference U-Net names) becomes LitEma's shadow."""
    prefix = {"unet": "model.diffusion_model.", "vae": "first_stage_model.",
              "pose": "extra_cond_models.0.", "fusion": "cond_stage_model."}
    sd = {prefix[b] + k: torch.from_numpy(np.array(v))
          for b, part in buckets.items() for k, v in part.items()}
    for k, v in (ema or {}).items():
        sd["model_ema." + ("diffusion_model." + k).replace(".", "")] = (
            torch.from_numpy(np.array(v)))
    sd.update(extra or {})
    torch.save({"state_dict": sd, "global_step": 7,
                "pytorch-lightning_version": "1.4.2"}, path)
    return path


class _Recorded:
    """A value JAX's `_np` reads through `.detach().cpu().numpy()`, noting
    its key."""

    def __init__(self, key, value, log):
        self.key, self.value, self.log = key, value, log

    def detach(self):
        return self

    def cpu(self):
        return self

    def numpy(self):
        self.log.add(self.key)
        return self.value


def _recording(sd, log):
    return {k: _Recorded(k, v, log) for k, v in sd.items()}


def _configs(variant, width):
    """(JAX LatentDiffusion, port config) of one topology."""
    jm = jax_build(variant, use_flash_attention=False)
    pcfg = _BUILDERS[variant](torch.float32, KERNELS_OFF)
    if width is not None:
        jcfg = dataclasses.replace(
            jm.config, unet=dataclasses.replace(jm.config.unet,
                                                model_channels=width),
            vae=dataclasses.replace(jm.config.vae, ch=width))
        jm = JaxLD(jcfg)
        pcfg = dataclasses.replace(
            pcfg, unet=dataclasses.replace(pcfg.unet, model_channels=width),
            vae=dataclasses.replace(pcfg.vae, ch=width))
    return jm, pcfg


@pytest.fixture(scope="module", params=TOPOLOGIES,
                ids=[v for v, _ in TOPOLOGIES])
def topology(request):
    variant, width = request.param
    jm, pcfg = _configs(variant, width)
    tree = _random_tree(jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)),
                        seed=len(variant))
    return variant, jm, pcfg, tree, reference_state_dict(tree, jm.config)


def _assert_same_tree(got, want):
    g, w = flatten_tree(got), flatten_tree(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_reference_layout_is_pinned_by_jax(topology):
    """JAX's converters rebuild the tree from S, reading every key."""
    _, jm, _, tree, s = topology
    cfg = jm.config
    for bucket, convert, want in (
            ("unet", lambda sd: jconv.convert_unet_state_dict(sd, cfg.unet),
             tree["unet"]),
            ("vae", lambda sd: jconv.convert_vae_state_dict(sd, cfg.vae),
             tree["vae"]),
            ("pose", jconv.convert_linear_project_state_dict,
             tree.get("pose")),
            ("fusion", jconv.convert_cond_fusion_state_dict,
             tree.get("cond_fusion"))):
        if bucket not in s:
            assert want is None
            continue
        log = set()
        _assert_same_tree(convert(_recording(s[bucket], log)), want)
        assert log == set(s[bucket]), sorted(set(s[bucket]) - log)[:5]


def test_port_conversion_equals_the_bridge_bit_for_bit(topology, tmp_path):
    variant, _, pcfg, tree, s = topology
    path = lightning_file(s, tmp_path / "ref.ckpt")
    torch.manual_seed(0)
    model = LatentDiffusion(pcfg)
    got, record = lightning.convert_buckets(
        lightning.split_ldm_checkpoint(path), model)
    want = state_dict_from_jax(flatten_tree(tree), model)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]), k
    assert record["submodels"] == sorted(
        {"unet", "vae"} | ({"pose"} if "pose" in s else set())
        | ({"cond_fusion"} if "fusion" in s else set()))
    assert record["ema"] is False and record["unread"] == {}
    # the writer is the tables read backwards: S again, key for key
    model.load_state_dict(got, strict=True)
    back = lightning.to_lightning_state_dict(model)
    flat = {("model.diffusion_model." if b == "unet" else
             "first_stage_model." if b == "vae" else
             "extra_cond_models.0." if b == "pose" else
             "cond_stage_model.") + k: v
            for b, part in s.items() for k, v in part.items()}
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k].numpy(), flat[k], err_msg=k)


# ------------------------------------------------ split, EMA, loading, P8

@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    jm, pcfg = _configs("tiny", None)
    tree = _random_tree(jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)),
                        seed=4)
    s = reference_state_dict(tree, jm.config)
    path = lightning_file(
        s, tmp_path_factory.mktemp("tiny") / "interp_256.ckpt",
        ema={k: v * 0.5 for k, v in s["unet"].items()},
        extra={"model_ema.decay": torch.tensor(0.9999),
               "model_ema.num_updates": torch.tensor(7),
               "betas": torch.linspace(0, 1, 5),
               "cond_stage_model.transformer.frozen": torch.ones(3)})
    return jm, pcfg, tree, s, path


def test_split_and_ema_equal_jax(tiny, tmp_path):
    _, _, _, s, _ = tiny
    # LitEma shadows the trainable tensors only, not a BatchNorm's
    # num_batches_tracked
    unet = dict(s["unet"])
    unet["input_blocks.1.0.num_batches_tracked"] = np.array(3, np.int64)
    path = lightning_file(
        {**s, "unet": unet}, tmp_path / "bn.ckpt",
        ema={k: v * 0.5 for k, v in s["unet"].items()},
        extra={"model_ema.num_updates": torch.tensor(7),
               "betas": torch.linspace(0, 1, 5),
               "cond_stage_model.transformer.frozen": torch.ones(3)})
    got = lightning.split_ldm_checkpoint(path)
    want = jconv.split_ldm_checkpoint(str(path))
    assert sorted(got) == sorted(want) == sorted(
        ["unet", "vae", "extra_cond_0", "ema", "other", "cond_stage"])
    for b in want:
        assert sorted(got[b]) == sorted(want[b]), b
        for k in want[b]:
            assert got[b][k].dtype == torch.float32
            np.testing.assert_array_equal(got[b][k].numpy(), want[b][k])
    got_ema = lightning.ema_unet_state_dict(got)
    want_ema = jconv.ema_unet_state_dict(want)
    assert sorted(got_ema) == sorted(want_ema) == sorted(unet)
    for k in want_ema:
        np.testing.assert_array_equal(got_ema[k].numpy(), want_ema[k])
    # the buffer the shadow lacks keeps its raw value
    assert float(got_ema["input_blocks.1.0.num_batches_tracked"]) == 3.0
    assert float(got_ema["out.2.bias"][0]) == 0.5 * s["unet"]["out.2.bias"][0]
    assert lightning.ema_unet_state_dict({"unet": got["unet"]}) is None


SIDE_EFFECTS = []


def record_side_effect(tag):
    """What a malicious pickle would run on load."""
    SIDE_EFFECTS.append(tag)
    return tag


class _Payload:
    def __reduce__(self):
        return (record_side_effect, ("ran",))


def test_p8_loading_never_runs_a_pickled_global(tiny, tmp_path):
    _, _, _, s, _ = tiny
    path = tmp_path / "evil.ckpt"
    sd = {"model.diffusion_model." + k: torch.from_numpy(np.array(v))
          for k, v in s["unet"].items()}
    torch.save({"state_dict": sd,
                "hyper_parameters": {"callback": _Payload()},
                "pytorch-lightning_version": "1.4.2"}, path)
    SIDE_EFFECTS.clear()
    got = lightning.split_ldm_checkpoint(path)
    assert SIDE_EFFECTS == []
    assert sorted(got["unet"]) == sorted(s["unet"])
    for k, v in s["unet"].items():
        np.testing.assert_array_equal(got["unet"][k].numpy(), v)
    # JAX's loader unpickles with weights_only=False: the global runs
    jconv.split_ldm_checkpoint(str(path))
    assert SIDE_EFFECTS == ["ran"]


def test_conversion_is_strict_and_names_the_key(tiny):
    _, pcfg, _, _, path = tiny
    model = LatentDiffusion(pcfg)
    buckets = lightning.split_ldm_checkpoint(path)

    def convert(bucket=None, key=None, value=None, ema=False):
        b = {k: dict(v) for k, v in buckets.items()}
        if value is None and bucket is not None:
            b[bucket].pop(key)
        elif bucket is not None:
            b[bucket][key] = value
        return lightning.convert_buckets(b, model, ema=ema)

    state, record = convert(ema=True)
    assert record["ema"] is True and record["unread"] == {
        "other": ["betas"], "cond_stage": ["transformer.frozen"]}
    assert torch.equal(state["unet.out_conv.bias"],
                       buckets["ema"]["diffusion_modelout2bias"])
    # a module tensor the file lacks
    with pytest.raises(ValueError,
                       match="'input_blocks.1.1.proj_in.weight'"):
        convert("unet", "input_blocks.1.1.proj_in.weight", ema=True)
    # a U-Net key nothing reads
    with pytest.raises(ValueError, match="'input_blocks.9.9.extra'"):
        convert("unet", "input_blocks.9.9.extra", torch.zeros(1))
    # a shape that disagrees
    with pytest.raises(ValueError, match="'out.2.bias'"):
        convert("unet", "out.2.bias", torch.zeros(5))
    with pytest.raises(ValueError, match="no model_ema shadow"):
        lightning.convert_buckets({"unet": buckets["unet"]}, model, ema=True)


# ------------------------------------------- cli convert -> cli sample

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


def test_cli_convert_then_sample_equals_jax(tiny, tmp_path, monkeypatch,
                                             capsys):
    from upgpt_torch.data.tree import write_fashion_tree
    from upgpt_torch.inference import pipeline

    jm, _, tree, s, path = tiny
    out = tmp_path / "tiny.pt"
    record = cli.main(["convert", "--torch-ckpt", str(path), "--out",
                       str(out), "--variant", "tiny"])
    assert record["ema"] is False and "pose" in record["submodels"]
    assert "converted" in capsys.readouterr().out
    data = write_fashion_tree(tmp_path / "tree", {"validation": (2, 0)},
                              image_hw=(16, 16), seed=3)
    dotlist = [f"data.{s}.params.{k}={v}"
               for s in ("train", "validation", "test")
               for k, v in (("folder", data["folder"]),
                            ("data_file", data["data_file"]),
                            ("pair_file", f"['{data['validation']}']"),
                            ("image_size", "[16,16]"), ("f", 2))]
    dotlist += ["model.params.variant=tiny", "model.params.device=cpu",
                "model.params.dtype=float32", "model.params.latent_size=(8,8)"]
    key = jax.random.PRNGKey(11)
    x_t, noise = _jax_draws(key, (2, 8, 8, 4))
    seen = {}
    generate = pipeline.GenerationPipeline.generate

    def injected(self, batch, gen=None, **kw):
        seen.update(batch)
        return generate(self, batch, gen, x_T=x_t, noise=noise)

    monkeypatch.setattr(pipeline.GenerationPipeline, "generate", injected)
    got = cli.main(["sample", "--base", CONFIG, "--debug-encoder", "--ckpt",
                    str(out), "--batch", "2", "--steps", str(STEPS), "--out",
                    str(tmp_path / "samples")] + dotlist)
    monkeypatch.undo()
    # JAX: its own conversion of the same file, on the batch the port drew
    buckets = jconv.split_ldm_checkpoint(str(path))
    params = {"unet": jconv.convert_unet_state_dict(buckets["unet"],
                                                    jm.config.unet),
              "vae": jconv.convert_vae_state_dict(buckets["vae"],
                                                  jm.config.vae),
              "pose": jconv.convert_linear_project_state_dict(
                  buckets["extra_cond_0"])}
    jbatch = {k: jnp.asarray(seen[k].float().numpy())
              for k in ("text_emb", "style_emb", "smpl", "person_mask")}
    jm8 = jax_build("tiny", use_flash_attention=False, latent_size=(8, 8))
    want = JaxPipeline(jm8, num_steps=STEPS, eta=1.0).generate(
        params, jbatch, key)
    assert got.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got, np.asarray(want), atol=5e-5)


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
