"""The port's four product walkthroughs (`upgpt_torch.examples`) on the
CPU, with the arguments `tests/test_examples.py` gives the JAX ones: tiny
geometry, the debug encoder, DDIM-2, and checkpoints orbax writes here in
the layout of JAX's `cli convert` (parameter trees from `jax.eval_shape`
and seeded numpy).

- Each example's `conditioning(...)` equals the batch the JAX example's
  steps build from `upgpt_tpu`'s pieces, rebuilt here, exactly (the
  lerped SMPL vectors of `pose_interpolation` too).
- Each written JPEG equals the port pipeline's image, written the same
  way, on that batch and a generator seeded as the example seeds it,
  byte for byte; the sizes and frame counts are those
  `tests/test_examples.py` asserts.
"""

import io
import os

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
ocp = pytest.importorskip("orbax.checkpoint")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_cli import tiny_tree  # noqa: E402,F401  (fixture reuse)
from upgpt_torch import cli  # noqa: E402
from upgpt_torch.config import merge_configs  # noqa: E402
from upgpt_torch.examples import (  # noqa: E402
    pose_interpolation, pose_transfer, style_mixing, to_uint8,
    upscale_chain,
)
from upgpt_torch.inference.pipeline import (  # noqa: E402
    GenerationPipeline, UpscalePipeline,
)


@pytest.fixture(scope="module")
def example_env(tmp_path_factory):
    """Tiny configs, as tests/test_examples.py writes them, and seeded
    convert-layout orbax checkpoints for both stages."""
    from upgpt_tpu.config import instantiate_from_config

    root = tmp_path_factory.mktemp("examples")
    out = {}
    for name, variant in (("base", "tiny"), ("up", "tiny_upscale")):
        cfg = {"model": {"target": "upgpt_tpu.zoo.build_latent_diffusion",
                         "params": {"variant": variant,
                                    "use_flash_attention": False}}}
        path = root / f"{name}.yaml"
        path.write_text(yaml.safe_dump(cfg))
        model = instantiate_from_config(cfg["model"])
        shapes = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
        rng = np.random.default_rng(0 if name == "base" else 1)
        params = jax.tree.map(lambda a: np.asarray(
            0.05 * rng.standard_normal(a.shape), np.float32), shapes)
        ckpt = root / f"ckpt_{name}"
        ckptr = ocp.StandardCheckpointer()
        ckptr.save(ckpt.absolute(), params)
        ckptr.wait_until_finished()
        out[name] = (str(path), str(ckpt))
    return out


def _data_args(tree):
    return ["--folder", str(tree), "--data-file", str(tree / "map.csv"),
            "--image-dir", "img_64", "--image-size", "64", "48", "--f", "2",
            "--debug-encoder", "--steps", "2", "--device", "cpu"]


def _jax_steps(base, tree, rows):
    """The JAX example's first steps: its config's model (unbuilt
    weights), its encoder and the pair samples of `rows`."""
    from upgpt_tpu.cli import _build_cond_encoder
    from upgpt_tpu.config import instantiate_from_config, merge_configs \
        as jax_merge
    from upgpt_tpu.data.deepfashion import DeepFashionPair

    cfg = jax_merge([base])
    model = instantiate_from_config(cfg["model"])
    enc = _build_cond_encoder(cfg, model, allow_debug=True)
    ds = DeepFashionPair(folder=str(tree), image_dir="img_64", pair_file=[],
                         data_file=str(tree / "map.csv"),
                         input_mask_type="bbox", image_size=(64, 48), f=2)
    ds.rows = [{"from": a, "to": b} for a, b in rows]
    return enc, [ds[i] for i in range(len(rows))]


def _port_env(mod, argv, base, ckpt):
    """The example's parsed flags, its model (loaded as `main` loads it)
    and encoder, and the batch of its `conditioning`."""
    args = mod.parser().parse_args(argv)
    cfg = merge_configs([base])
    model, _ = cli._load_model(cfg["model"], ckpt, device="cpu")
    enc = cli._build_cond_encoder(cfg, model, allow_debug=True)
    return args, model, enc, mod.conditioning(args, enc, model.device)


def _assert_batch(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        g = got[k].numpy()
        assert g.dtype == np.float32 and g.shape == np.shape(v), k
        np.testing.assert_array_equal(g, np.asarray(v, np.float32),
                                      err_msg=k)


def _jpeg(img) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(to_uint8(img)).save(buf, format="JPEG")
    return buf.getvalue()


def _size(path):
    from PIL import Image

    return Image.open(path).size


GENERATE = ("text_emb", "style_emb", "smpl", "person_mask")


def test_pose_transfer(example_env, tiny_tree, tmp_path):  # noqa: F811
    from upgpt_tpu.data.deepfashion import collate

    base, ckpt = example_env["base"]
    out = tmp_path / "sample.jpg"
    argv = ["--base", base, "--ckpt", ckpt, "--src", "MEN/x_1_a.jpg",
            "--pose-of", "WOMEN/y_1_b.jpg", "--out", str(out)
            ] + _data_args(tiny_tree)
    pose_transfer.main(argv)
    assert _size(out) == (48, 64)
    args, model, _, batch = _port_env(pose_transfer, argv, base, ckpt)
    enc, (sample,) = _jax_steps(base, tiny_tree,
                                [("MEN/x_1_a.jpg", "WOMEN/y_1_b.jpg")])
    want = enc.encode_batch(collate([sample]))
    _assert_batch(batch, {k: want[k] for k in GENERATE})
    img = GenerationPipeline(model, num_steps=2, eta=1.0).generate(
        batch, torch.Generator().manual_seed(args.seed))[0]
    assert out.read_bytes() == _jpeg(img)


def test_pose_interpolation(example_env, tiny_tree, tmp_path):  # noqa: F811
    from upgpt_tpu.data.deepfashion import collate
    from upgpt_tpu.inference.pipeline import (
        interpolate_masks, interpolate_smpl,
    )

    base, ckpt = example_env["base"]
    out = tmp_path / "interp"
    argv = ["--base", base, "--ckpt", ckpt, "--src", "MEN/x_1_a.jpg",
            "--pose-a", "MEN/x_1_a.jpg", "--pose-b", "WOMEN/y_1_b.jpg",
            "--frames", "3", "--out", str(out)] + _data_args(tiny_tree)
    pose_interpolation.main(argv)
    frames = [f"{out}_{i:03d}.jpg" for i in range(3)]
    assert all(os.path.exists(f) for f in frames)
    assert {_size(f) for f in frames} == {(48, 64)}
    _, model, _, batch = _port_env(pose_interpolation, argv, base, ckpt)
    enc, (sa, sb) = _jax_steps(base, tiny_tree,
                               [("MEN/x_1_a.jpg", "MEN/x_1_a.jpg"),
                                ("MEN/x_1_a.jpg", "WOMEN/y_1_b.jpg")])
    first = enc.encode_batch(collate([sa]))
    alphas = np.linspace(1.0, 0.0, 3).astype(np.float32)
    smpl = np.asarray(interpolate_smpl(
        jnp.asarray(sa["smpl"]), jnp.asarray(sb["smpl"]),
        jnp.asarray(alphas)))
    _assert_batch(batch, {
        "text_emb": np.repeat(np.asarray(first["text_emb"]), 3, 0),
        "style_emb": np.repeat(np.asarray(first["style_emb"]), 3, 0),
        "smpl": smpl.reshape(3, 1, -1),
        "person_mask": interpolate_masks(sa["person_mask"],
                                         sb["person_mask"], alphas)})
    imgs = GenerationPipeline(model, num_steps=2, eta=1.0).generate(
        batch, torch.Generator().manual_seed(0), shared_x_T=True)
    assert [open(f, "rb").read() for f in frames] == [_jpeg(i) for i in imgs]


def test_style_mixing(example_env, tiny_tree, tmp_path):  # noqa: F811
    from upgpt_tpu.data.deepfashion import collate
    from upgpt_tpu.data.transforms import CLIP_MEAN, CLIP_STD
    from upgpt_tpu.inference.pipeline import STYLE_NAMES, mix_style

    base, ckpt = example_env["base"]
    out = tmp_path / "mixed.jpg"
    argv = ["--base", base, "--ckpt", ckpt, "--src", "MEN/x_1_a.jpg",
            "--style-texts", '{"top": "red shirt"}', "--drop-slots",
            "outer", "--out", str(out)] + _data_args(tiny_tree)
    style_mixing.main(argv)
    assert _size(out) == (48, 64)
    _, model, _, batch = _port_env(style_mixing, argv, base, ckpt)
    enc, (sample,) = _jax_steps(base, tiny_tree,
                                [("MEN/x_1_a.jpg", "MEN/x_1_a.jpg")])
    want = enc.encode_batch(collate([sample]))
    texts = ["red shirt" if n == "top" else "" for n in STYLE_NAMES]
    empty = np.broadcast_to((-CLIP_MEAN / CLIP_STD),
                            (1, 1, 224, 224, 3)).astype(np.float32)
    style = mix_style(
        jnp.asarray(want["style_emb"]),
        jnp.asarray(np.asarray(enc.text_pooled(texts))[None]),
        [n == "top" for n in STYLE_NAMES],
        drop_slots=[STYLE_NAMES.index("outer")],
        empty_style_emb=jnp.asarray(
            np.asarray(enc.style_embeddings(empty))[0, 0]))
    _assert_batch(batch, {**{k: want[k] for k in GENERATE},
                          "style_emb": np.asarray(style)})
    img = GenerationPipeline(model, num_steps=2, eta=1.0).generate(
        batch, torch.Generator().manual_seed(0))[0]
    assert out.read_bytes() == _jpeg(img)


def test_upscale_chain(example_env, tiny_tree, tmp_path):  # noqa: F811
    from upgpt_tpu.data.deepfashion import collate

    base, ckpt_b = example_env["base"]
    up, ckpt_u = example_env["up"]
    out = tmp_path / "upscaled.jpg"
    argv = ["--base-256", base, "--base-512", up, "--ckpt-256", ckpt_b,
            "--ckpt-512", ckpt_u, "--src", "MEN/x_1_a.jpg", "--pose-of",
            "WOMEN/y_1_b.jpg", "--out", str(out)] + _data_args(tiny_tree)
    upscale_chain.main(argv)
    assert os.path.exists(out)
    args = upscale_chain.parser().parse_args(argv)
    m256, _ = cli._load_model(merge_configs([base])["model"], ckpt_b,
                              device="cpu")
    m512, _ = cli._load_model(merge_configs([up])["model"], ckpt_u,
                              device="cpu")
    enc = cli._build_cond_encoder(merge_configs([base]), m256,
                                  allow_debug=True)
    batch = upscale_chain.conditioning(args, enc, m256.device)
    jenc, (sample,) = _jax_steps(base, tiny_tree,
                                 [("MEN/x_1_a.jpg", "WOMEN/y_1_b.jpg")])
    want = jenc.encode_batch(collate([sample]))
    _assert_batch(batch, {k: want[k] for k in GENERATE})
    img256 = GenerationPipeline(m256, num_steps=2, eta=1.0).generate(
        batch, torch.Generator().manual_seed(0))
    img = UpscalePipeline(m512, num_steps=2, eta=1.0).upscale(
        img256, batch["text_emb"], batch["style_emb"],
        torch.Generator().manual_seed(1))[0]
    assert out.read_bytes() == _jpeg(img)
    # the upscale stage's image: its latent times its VAE's factor
    h, w = m512.config.latent_size
    f = 2 ** (len(m512.config.vae.ch_mult) - 1)
    assert _size(out) == (f * w, f * h)
