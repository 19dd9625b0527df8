"""The port's reader of the JAX package's orbax checkpoints
(`upgpt_torch.convert.ocdbt`, `upgpt_torch.convert.orbax`) on the CPU.

- Trees written here by orbax's `StandardCheckpointer` (nested dicts,
  lists and tuples, named tuples, None and empty containers; float32,
  bfloat16, float16, float64, int32, int64, uint8 and bool leaves; python
  and 0-d scalars; leaves below and above the inline limit; optax's
  state) restore through `convert.orbax.restore` equal to orbax's own
  restore, bit for bit. orbax writes every tree with a 100 MB node limit,
  one leaf node in practice; a 2,000-leaf tree written through orbax's
  own option builder with a 4 KB node limit has a B-tree of height 2,
  which the reader reports. The `use_ocdbt=False` layout is read, zarr v3
  is refused by name, a flipped byte fails the CRC-32C check naming the
  file, and the store's keys and values equal tensorstore's. zarr v2
  arrays tensorstore writes with C and F order, chunk grids with partial
  edges, missing chunks, no compressor and scalars read as tensorstore
  reads them.
- At tiny geometry, JAX's `cli convert` tree and JAX's trainer payload
  (`Trainer._payload`, EMA first) read through `checkpoint.read_weights`
  as `convert.from_jax` maps JAX's in-memory trees; the port's model from
  the orbax tree matches JAX's `apply` (1e-4, as tests/test_torch_slice.py
  holds it). Every entry point that takes weights (`cli sample`, with a
  distilled student's sidecar too, `cli test`, `cli serve` with
  `--upscale-ckpt`, `cli distill --teacher-ckpt`, the app's `--ckpt` and
  `--upscale-ckpt`) gives from the orbax directory what it gives from the
  `.pt` of the same weights. `--fid-weights DIR` matches JAX's
  `InceptionFeatureFn` on the same images; orbax CLIP towers give JAX's
  towers' outputs.
- The committed fixtures (`tests/torch_fixtures/orbax/`): `tiny_trainer`
  equals its MANIFEST.json (sha256 of every leaf), and every leaf of the
  full-width `interp_256_tiled` (~2 GB decoded) equals its regenerated
  pattern.
"""

import argparse
import hashlib
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
ocp = pytest.importorskip("orbax.checkpoint")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from upgpt_torch import cli  # noqa: E402
from upgpt_torch.checkpoint import (  # noqa: E402
    load_checkpoint, read_weights, save_checkpoint,
)
from upgpt_torch.convert.from_jax import (  # noqa: E402
    flatten_tree, load_jax_params, state_dict_from_jax,
)
from upgpt_torch.convert.ocdbt import OcdbtStore  # noqa: E402
from upgpt_torch.convert.orbax import (  # noqa: E402
    OrbaxCheckpoint, is_orbax_dir, restore,
)
from upgpt_torch.data.tree import write_fashion_tree  # noqa: E402
from upgpt_torch.zoo import build_latent_diffusion  # noqa: E402
from upgpt_tpu.zoo import build_latent_diffusion as jax_build  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "torch_fixtures", "orbax")
CONFIG = os.path.join(REPO, "configs", "deepfashion", "interp_256.yaml")
MODEL = ["model.params.variant=tiny", "model.params.device=cpu",
         "model.params.latent_size=(8,8)"]


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    # its import pulls in TensorFlow here (~17 s a process)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _save(tree, path, **handler):
    """`tree` through orbax's StandardCheckpointer (its handler's options
    where given)."""
    if handler:
        ckptr = ocp.Checkpointer(ocp.StandardCheckpointHandler(**handler))
        ckptr.save(os.path.abspath(path), args=ocp.args.StandardSave(tree))
    else:
        ckptr = ocp.StandardCheckpointer()
        ckptr.save(os.path.abspath(path), tree)
        ckptr.wait_until_finished()
    return str(path)


def _orbax_restore(path, **handler):
    if handler:
        return ocp.Checkpointer(ocp.StandardCheckpointHandler(
            **handler)).restore(os.path.abspath(path))
    return ocp.StandardCheckpointer().restore(os.path.abspath(path))


def assert_same(want, got, path="tree"):
    """orbax's restored tree against the port's, bit for bit."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_same(want[k], got[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(want, got)):
            assert_same(a, b, f"{path}/{i}")
    elif want is None or isinstance(want, (bool, int, float)):
        assert type(got) is type(want) and got == want, (path, want, got)
    else:
        a = np.asarray(want)
        if a.dtype.name == "bfloat16":
            assert isinstance(got, torch.Tensor), path
            assert got.dtype == torch.bfloat16, path
            assert tuple(got.shape) == a.shape, path
            assert got.view(torch.int16).numpy().tobytes() == a.view(
                np.uint16).tobytes(), path
        else:
            assert isinstance(got, np.ndarray), (path, type(got))
            assert got.dtype == a.dtype and got.shape == a.shape, path
            assert got.tobytes() == a.tobytes(), path


def _trees():
    rng = np.random.default_rng(0)
    import optax

    params = {"w": jnp.asarray(rng.normal(size=(16, 8)), jnp.float32),
              "b": jnp.asarray(rng.normal(size=(8,)), jnp.bfloat16)}
    adam = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-3))
    return {
        "nested": {"a": {"b": {"c": np.arange(5, dtype=np.int32)}},
                   "list": [np.zeros(2, np.float32),
                            [np.ones(3, np.uint8), {"x": np.int64(4)}]],
                   "tuple": (np.float32(1.5), np.arange(3.0)),
                   "none": None, "empty_dict": {}, "empty_list": []},
        "dtypes": {
            "f32": rng.normal(size=(7, 5)).astype(np.float32),
            "bf16": jnp.asarray(rng.normal(size=(4, 9)), jnp.bfloat16),
            "f16": rng.normal(size=(33,)).astype(np.float16),
            "f64": rng.normal(size=(3, 3)),
            "i32": rng.integers(-9, 9, (6,), dtype=np.int32),
            "i64": rng.integers(-2**40, 2**40, (2, 2), dtype=np.int64),
            "u8": rng.integers(0, 255, (5, 2, 3), dtype=np.uint8),
            "bool": rng.random(11) > 0.5,
            "jax_f32": jnp.asarray(rng.normal(size=(4, 4)), jnp.float32)},
        "scalars": {"step": 7, "lr": 2.5e-4, "zero_d": np.float32(3.0),
                    "jax_zero_d": jnp.asarray(9, jnp.int32),
                    "bf16_zero_d": jnp.asarray(1.25, jnp.bfloat16)},
        "large": {"big": rng.normal(size=(300, 41)).astype(np.float32),
                  "small": rng.normal(size=(3,)).astype(np.float32),
                  "zeros": np.zeros((512, 64), np.float32)},
        "optax": {"params": params, "opt_state": adam.init(params)},
    }


@pytest.mark.parametrize("name", sorted(_trees()))
def test_restore_equals_orbax(name, tmp_path):
    path = _save(_trees()[name], tmp_path / name)
    assert is_orbax_dir(path) and not is_orbax_dir(tmp_path)
    assert_same(_orbax_restore(path), restore(path))


def test_a_btree_of_height_two(tmp_path, monkeypatch):
    from orbax.checkpoint._src.serialization import tensorstore_utils as tu

    add_options = tu.add_ocdbt_write_options

    def small_nodes(spec, *args, **kwargs):
        add_options(spec, *args, **kwargs)
        spec["config"]["max_decoded_node_bytes"] = 4096

    monkeypatch.setattr(tu, "add_ocdbt_write_options", small_nodes)
    rng = np.random.default_rng(1)
    tree = {f"leaf_{i:04d}": rng.normal(size=(4,)).astype(np.float32)
            for i in range(2000)}
    tree["big"] = rng.normal(size=(300, 7)).astype(np.float32)
    path = _save(tree, tmp_path / "deep")
    ckpt = OrbaxCheckpoint(path)
    got = ckpt.restore()
    assert ckpt.store.height >= 1 and ckpt.store.nodes > 100
    assert len(ckpt.store.keys()) == 2 * len(tree)
    assert_same(_orbax_restore(path), got)


def test_store_equals_tensorstore(tmp_path):
    ts = pytest.importorskip("tensorstore")
    path = _save(_trees()["large"], tmp_path / "large")
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{os.path.abspath(path)}/"}
                         ).result()
    keys = sorted(k.decode() for k in kv.list().result())
    store = OcdbtStore(path)
    assert store.keys() == keys
    for k in keys:
        assert store.read(k) == kv.read(k.encode()).result().value


def test_without_ocdbt(tmp_path):
    tree = _trees()["dtypes"]
    path = _save(tree, tmp_path / "plain", use_ocdbt=False)
    assert not os.path.exists(os.path.join(path, "manifest.ocdbt"))
    assert_same(_orbax_restore(path, use_ocdbt=False), restore(path))


def test_zarr3_is_refused(tmp_path):
    path = tmp_path / "z3"
    ckptr = ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_zarr3=True))
    ckptr.save(os.path.abspath(path),
               args=ocp.args.PyTreeSave({"a": np.ones(3, np.float32)}))
    assert json.loads((path / "_METADATA").read_text())["use_zarr3"]
    with pytest.raises(ValueError, match="use_zarr3"):
        restore(path)


def _node_files(path):
    out = []
    for root, _, files in os.walk(path):
        for f in files:
            full = os.path.join(root, f)
            with open(full, "rb") as fh:
                if fh.read(4) == bytes.fromhex("0cdb20de"):
                    out.append(full)
    return out


def test_a_flipped_byte_fails_the_crc(tmp_path):
    path = _save(_trees()["nested"], tmp_path / "t")
    root_node = [f for f in _node_files(path)
                 if "ocdbt.process" not in f]
    assert len(root_node) == 1
    data = bytearray(open(root_node[0], "rb").read())
    data[len(data) // 2] ^= 0x10
    open(root_node[0], "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC-32C") as err:
        restore(path)
    assert os.path.basename(root_node[0]) in str(err.value)
    manifest = os.path.join(path, "manifest.ocdbt")
    data = bytearray(open(manifest, "rb").read())
    data[20] ^= 1
    open(manifest, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="manifest.ocdbt: CRC-32C"):
        restore(path)


@pytest.mark.parametrize("ocdbt", [True, False])
def test_zarr_layouts_as_tensorstore_reads_them(tmp_path, ocdbt):
    """Arrays tensorstore's zarr driver writes (orbax's writer) in the
    layouts orbax itself does not produce: F order, chunk grids with
    partial edges, chunks never written (the fill value), no compressor,
    a scalar; each read through `OrbaxCheckpoint.read_array` equals
    tensorstore's read."""
    ts = pytest.importorskip("tensorstore")
    root = tmp_path / "arrays"
    kvstore = ({"driver": "ocdbt", "base": f"file://{root}/"} if ocdbt
               else {"driver": "file", "path": f"{root}/"})
    rng = np.random.default_rng(4)
    cases = {
        "f_order": (rng.normal(size=(10, 7)).astype(np.float32),
                    dict(chunks=[4, 3], order="F",
                         compressor={"id": "zstd", "level": 3})),
        "c_grid": (rng.integers(0, 99, (9, 5, 4), dtype=np.int32),
                   dict(chunks=[2, 5, 3], order="C", compressor=None)),
        "sparse": (None, dict(chunks=[4, 4], order="C", fill_value=1.5,
                              compressor={"id": "zstd", "level": 1})),
        "scalar": (np.asarray(7, np.int64),
                   dict(chunks=[], order="C", compressor=None)),
    }
    tree_meta = {}
    for name, (value, meta) in cases.items():
        shape = [8, 8] if value is None else list(value.shape)
        dtype = "<f4" if value is None else value.dtype.str
        arr = ts.open({"driver": "zarr", "kvstore": kvstore, "path": name,
                       "metadata": {"shape": shape, "dtype": dtype,
                                    "fill_value": meta.pop(
                                        "fill_value", None), **meta},
                       "create": True}).result()
        if value is None:  # two of the four chunks written
            arr[0:4, 0:4] = np.full((4, 4), 2.0, np.float32)
            arr[4:8, 4:6] = np.full((4, 2), 3.0, np.float32)
        else:
            arr[...] = value
        tree_meta[f"('{name}',)"] = {
            "key_metadata": [{"key": name, "key_type": 2}],
            "value_metadata": {"value_type": "np.ndarray",
                               "skip_deserialize": False}}
    (root / "_METADATA").write_text(json.dumps(
        {"tree_metadata": tree_meta, "use_ocdbt": ocdbt,
         "use_zarr3": False}))
    got = restore(root)
    for name in cases:
        want = ts.open({"driver": "zarr", "kvstore": kvstore,
                        "path": name}).result().read().result()
        assert got[name].dtype == want.dtype, name
        np.testing.assert_array_equal(got[name], want, err_msg=name)
    assert got["sparse"][0, 7] == 1.5 and got["sparse"][5, 5] == 3.0


# ------------------------------------------------ weights at tiny geometry


def _random_params(shapes, seed):
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(size=leaf.shape) / np.sqrt(fan_in)
        base = 1.0 if "scale" in name else 0.0
        return base + 0.1 * rng.normal(size=leaf.shape)

    return jax.device_get(jax.tree_util.tree_map_with_path(
        lambda p, a: np.asarray(draw(p, a), np.float32), shapes))


def _state(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """JAX's tiny model at the 8x8 latent and seeded weights; its `cli
    convert` tree and trainer payload written by orbax; the port's model
    through the bridge and its `.pt`."""
    from upgpt_tpu.training.train_state import create_train_state
    from upgpt_tpu.training.trainer import Trainer

    root = tmp_path_factory.mktemp("tiny")
    jm = jax_build("tiny", use_flash_attention=False, latent_size=(8, 8))
    params = _random_params(
        jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)), seed=0)
    _save(params, root / "convert")
    trainable = {k: params[k] for k in ("unet", "pose")}
    state = create_train_state(trainable, learning_rate=1e-4)
    ema = jax.tree_util.tree_map(lambda p: 0.5 * p, trainable)
    state = state.replace(ema=state.ema._replace(shadow=ema))
    _save(jax.device_get(Trainer._payload(state, {"vae": params["vae"]})),
          root / "trainer")
    port = load_jax_params(build_latent_diffusion(
        "tiny", device="cpu", latent_size=(8, 8)), params)
    save_checkpoint(port, root / "same.pt")
    return jm, params, ema, port, root


def test_convert_layout_reads_as_the_bridge(tiny):
    _, params, _, port, root = tiny
    trainable, vae = read_weights(root / "convert")
    want = port.state_dict()
    assert set(trainable) | {f"vae.{k}" for k in vae} == set(want)
    for k, v in trainable.items():
        assert torch.equal(v, want[k]), k
    for k, v in vae.items():
        assert torch.equal(v, want[f"vae.{k}"]), k
    model = load_checkpoint(build_latent_diffusion(
        "tiny", device="cpu", latent_size=(8, 8)), root / "convert")
    assert all(torch.equal(v, want[k]) for k, v in model.state_dict().items())


def test_trainer_layout_reads_the_ema_and_the_frozen_vae(tiny):
    _, params, ema, port, root = tiny
    trainable, vae = read_weights(root / "trainer")
    module = build_latent_diffusion("tiny", device="cpu", latent_size=(8, 8))
    want = state_dict_from_jax(flatten_tree({**ema, "vae": params["vae"]}),
                               module)
    assert set(trainable) == {k for k in want if not k.startswith("vae.")}
    assert all(torch.equal(v, want[k]) for k, v in trainable.items())
    assert all(torch.equal(v, want[f"vae.{k}"]) for k, v in vae.items())


def test_a_tree_without_a_vae_is_refused(tiny, tmp_path):
    _, params, _, _, _ = tiny
    path = _save({k: params[k] for k in ("unet", "pose")}, tmp_path / "nv")
    with pytest.raises(RuntimeError, match="no VAE"):
        read_weights(path)


def test_port_model_from_orbax_matches_jax_apply(tiny):
    jm, params, _, _, root = tiny
    model = load_checkpoint(build_latent_diffusion(
        "tiny", device="cpu", latent_size=(8, 8)), root / "convert")
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 8, 8, 5)).astype(np.float32)
    t = np.array([3, 777], np.int32)
    ctx = rng.normal(size=(2, 87, 768)).astype(np.float32)
    want = jax.jit(lambda p, *a: jm.unet.apply({"params": p}, *a))(
        params["unet"], x, t, ctx)
    z = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    want_img = jax.jit(jm.decode_first_stage)(params, z)
    with torch.no_grad():
        got = model.unet(torch.from_numpy(x), torch.from_numpy(t),
                         torch.from_numpy(ctx))
        img = model.decode_first_stage(torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(img.numpy(), np.asarray(want_img), atol=1e-4)


@pytest.fixture(scope="module")
def fashion(tmp_path_factory):
    return write_fashion_tree(tmp_path_factory.mktemp("fashion"),
                              {"train": (1, 1), "validation": (2, 0)},
                              image_hw=(16, 16), seed=2)


def _data(tree):
    out = [f"data.{s}.params.{k}={tree[v]}"
           for s in ("train", "validation", "test")
           for k, v in (("folder", "folder"), ("data_file", "data_file"))]
    out += [f"data.{s}.params.{k}={v}" for s in ("train", "validation",
                                                  "test")
            for k, v in (("image_size", "[16,16]"), ("f", 2))]
    out += [f"data.train.params.pair_file=['{tree['train']}']",
            f"data.validation.params.pair_file=['{tree['validation']}']",
            f"data.test.params.pair_file=['{tree['validation']}']"]
    return out


@pytest.fixture(scope="module")
def upscale(tmp_path_factory):
    """JAX's tiny_upscale tree by orbax, its `.pt`, and a config file."""
    root = tmp_path_factory.mktemp("upscale")
    jm = jax_build("tiny_upscale", use_flash_attention=False)
    params = _random_params(
        jax.eval_shape(jm.init_params, jax.random.PRNGKey(1)), seed=1)
    _save(params, root / "orbax")
    save_checkpoint(load_jax_params(build_latent_diffusion(
        "tiny_upscale", device="cpu"), params), root / "same.pt")
    import yaml

    (root / "upscale.yaml").write_text(yaml.safe_dump({"model": {
        "target": "upgpt_torch.zoo.build_latent_diffusion",
        "params": {"variant": "tiny_upscale", "device": "cpu"}}}))
    return root


def _files(out):
    return {f: open(os.path.join(out, f), "rb").read()
            for f in sorted(os.listdir(out))}


def _run_sample(ckpt, fashion, out):
    cli.main(["sample", "--base", CONFIG, "--debug-encoder", "--ckpt",
              str(ckpt), "--batch", "2", "--steps", "4", "--out", str(out)]
             + _data(fashion) + MODEL)
    return _files(out)


def _run_student(ckpt, fashion, out):
    # a distilled student's sidecar beside the checkpoint, as JAX's
    # cmd_distill writes it: eta-0 DDIM on its grid, v-parameterised
    side = str(ckpt) + ".distill.json"
    with open(side, "w") as f:
        json.dump({"parameterization": "v", "timesteps": [249, 999]}, f)
    try:
        return _run_sample(ckpt, fashion, out)
    finally:
        os.remove(side)


def _run_test(ckpt, fashion, out):
    cli.main(["test", "--base", CONFIG, "--debug-encoder", "--ckpt",
              str(ckpt), "--batch", "2", "--steps", "2", "--max-images", "2",
              "--out", str(out)] + _data(fashion) + MODEL)
    return {os.path.relpath(os.path.join(d, f), out): open(
        os.path.join(d, f), "rb").read()
        for d, _, files in os.walk(out) for f in files
        if not f.startswith("metrics")}


def _run_serve(ckpt, up_ckpt, upscale_root):
    args = argparse.Namespace(
        ckpt=str(ckpt), debug_encoder=True, batch=2, max_delay=0.05,
        seed=0, steps=2, sampler="ddim", schedule=None, in_flight=2,
        upscale_base=[str(upscale_root / "upscale.yaml")],
        upscale_ckpt=str(up_ckpt), dp=1, tp=1)
    cfg = {"model": {"target": "upgpt_torch.zoo.build_latent_diffusion",
                     "params": {"variant": "tiny", "device": "cpu",
                                "latent_size": (8, 8)}}}
    engine, _, _ = cli._build_serving(cfg, args)
    pipe = engine.pipeline
    out = {"base": _state(pipe.base.model), "up": _state(pipe.up.model)}
    engine.close() if hasattr(engine, "close") else None
    return out


def _run_distill(ckpt, out):
    result = cli.main(["distill", "--base", CONFIG, "--teacher-ckpt",
                       str(ckpt), "--out", str(out / "student.pt"),
                       "--start-steps", "4", "--end-steps", "2",
                       "--stage-steps", "1", "--adapt-steps", "0",
                       "--batch", "2", "--grid", "karras", "--synthetic"]
                      + MODEL)
    return {"student": _state(result["student"])}


def _run_app(ckpt, up_ckpt, upscale_root):
    from upgpt_torch import app

    args = app.parser().parse_args([
        "--ckpt", str(ckpt), "--device", "cpu", "--upscale-base",
        str(upscale_root / "upscale.yaml"), "--upscale-ckpt", str(up_ckpt),
        "model.params.latent_size=(8,8)"])
    state, _ = app.build_state(args)
    return {"base": _state(state.model),
            "up": _state(state.upscale.inner.model)}


@pytest.mark.parametrize("entry", ["sample", "student", "test", "serve",
                                   "distill", "app"])
def test_entry_points_take_the_orbax_directory(entry, tiny, fashion,
                                               upscale, tmp_path):
    """Each entry point, from the JAX-written orbax directory and from the
    `.pt` of the same weights: the same files, or the same weights in the
    models it builds."""
    root = tiny[-1]
    got = {}
    for kind, ckpt, up in (("orbax", root / "convert", upscale / "orbax"),
                           ("pt", root / "same.pt", upscale / "same.pt")):
        out = tmp_path / kind
        out.mkdir()
        got[kind] = {
            "sample": lambda: _run_sample(ckpt, fashion, out),
            "student": lambda: _run_student(ckpt, fashion, out),
            "test": lambda: _run_test(ckpt, fashion, out),
            "serve": lambda: _run_serve(ckpt, up, upscale),
            "distill": lambda: _run_distill(ckpt, out),
            "app": lambda: _run_app(ckpt, up, upscale),
        }[entry]()
    assert got["orbax"] and set(got["orbax"]) == set(got["pt"])
    for k, v in got["orbax"].items():
        w = got["pt"][k]
        if isinstance(v, dict):
            assert set(v) == set(w)
            assert all(torch.equal(v[n], w[n]) for n in v), k
        else:
            assert v == w, k


def test_fid_weights_directory_matches_jax(tmp_path):
    from upgpt_torch.eval.inception import (
        InceptionFeatureFn, InceptionV3Features,
    )
    from upgpt_tpu.eval.inception import InceptionFeatureFn as JaxFn

    port = InceptionV3Features()
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name, p in port.named_parameters():
            z = torch.randn(p.shape, generator=g)
            p.copy_(z / p[0].numel() ** 0.5 if p.dim() == 4
                    else 1.0 + 0.1 * z if name.endswith("bn_scale")
                    else 0.1 * z)
    tree = {}
    for name, v in port.state_dict().items():
        *path, leaf = name.split(".")
        v = v.numpy()
        if leaf == "weight":
            leaf, v = "kernel", v.transpose(2, 3, 1, 0)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(v)
    path = _save(tree, tmp_path / "inception")
    args = cli.parser().parse_args(["eval", "--dir", str(tmp_path),
                                    "--fid-weights", path])
    fn = cli._fid_fn({}, args, "cpu")
    assert isinstance(fn, InceptionFeatureFn)
    x = np.random.default_rng(6).uniform(-1, 1, (2, 64, 48, 3)).astype(
        np.float32)
    want = np.asarray(JaxFn(_orbax_restore(path))(jnp.asarray(x)))
    got = fn(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 2048)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_clip_towers_from_orbax_match_jax(tmp_path):
    from upgpt_torch.data.tokenizer import CLIPTokenizer
    from upgpt_torch.inference.encoders import CLIPConditioningEncoder
    from upgpt_tpu.data.tokenizer import CLIPTokenizer as JaxTokenizer
    from upgpt_tpu.inference.encoders import (
        CLIPConditioningEncoder as JaxEncoder,
    )
    from upgpt_tpu.models import clip as jclip

    merges = [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o</w>"),
              ("s", "h"), ("i", "r"), ("t", "</w>"), ("sh", "ir"),
              ("shir", "t</w>")]
    bpe = tmp_path / "bpe.txt"
    bpe.write_text("\n".join(" ".join(m) for m in merges) + "\n")
    vocab = CLIPTokenizer(merges=merges).eos_id + 1
    tcfg = jclip.CLIPTextConfig(vocab_size=vocab, hidden_size=128,
                                num_layers=2, num_heads=2, projection_dim=64)
    vcfg = jclip.CLIPVisionConfig(image_size=28, patch_size=14,
                                  hidden_size=128, num_layers=2, num_heads=2,
                                  projection_dim=64)
    rng = np.random.default_rng(8)

    def seeded(module, x):
        shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
        return jax.tree_util.tree_map(
            lambda a: (0.05 * rng.normal(size=a.shape)).astype(np.float32),
            shapes)["params"]

    tparams = seeded(jclip.CLIPTextTower(tcfg), jnp.zeros((1, 77),
                                                          jnp.int32))
    vparams = seeded(jclip.CLIPVisionTower(vcfg),
                     jnp.zeros((1, 28, 28, 3)))
    tdir = _save(tparams, tmp_path / "text")
    vdir = _save(vparams, tmp_path / "vision")
    enc = CLIPConditioningEncoder.from_files(tdir, vdir, str(bpe),
                                             quick_gelu=True, device="cpu")
    jenc = JaxEncoder(_orbax_restore(tdir), _orbax_restore(vdir),
                      JaxTokenizer(bpe_path=str(bpe)), text_config=tcfg,
                      vision_config=vcfg)
    texts = ["hello shirt", "shirt"]
    styles = rng.normal(size=(2, 9, 28, 28, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = [np.asarray(jenc.text_hidden(texts)),
                np.asarray(jenc.text_pooled(texts)),
                np.asarray(jenc.style_embeddings(styles))]
    got = [enc.text_hidden(texts), enc.text_pooled(texts),
           enc.style_embeddings(styles)]
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()


# ------------------------------------------------------- the fixtures


def _flat(tree, prefix=""):
    """{"a/0/b": leaf} over dicts and lists, arrays and scalars only."""
    out = {}
    items = (tree.items() if isinstance(tree, dict) else enumerate(tree))
    for k, v in items:
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, list)):
            out.update(_flat(v, path))
        elif v is not None:
            out[path] = v
    return out


def test_tiny_trainer_fixture_matches_its_manifest():
    path = os.path.join(FIXTURES, "tiny_trainer")
    manifest = json.load(open(os.path.join(path, "MANIFEST.json")))
    got = _flat(restore(path))
    assert set(got) == {leaf["path"] for leaf in manifest["leaves"]}
    dtypes = set()
    for leaf in manifest["leaves"]:
        v = got[leaf["path"]]
        raw = (v.view(torch.int16).numpy().tobytes()
               if isinstance(v, torch.Tensor) else np.asarray(v).tobytes())
        name = ("bfloat16" if isinstance(v, torch.Tensor)
                else np.asarray(v).dtype.name)
        dtypes.add(name)
        assert name == leaf["dtype"] and list(np.shape(v)) == leaf["shape"]
        assert hashlib.sha256(raw).hexdigest() == leaf["sha256"], leaf
    assert {"float32", "bfloat16", "int32"} <= dtypes
    trainable, vae = read_weights(path)
    assert all(k.startswith(("unet.", "pose.")) for k in trainable)
    assert vae and all(v.dtype == torch.float32 for v in vae.values())


def test_full_width_fixture_is_its_pattern():
    sys.path.insert(0, FIXTURES)
    try:
        from pattern import leaf
    finally:
        sys.path.remove(FIXTURES)
    path = os.path.join(FIXTURES, "interp_256_tiled")
    manifest = json.load(open(os.path.join(path, "MANIFEST.json")))
    ckpt = OrbaxCheckpoint(path)
    assert {".".join(k for k, _ in keys) for keys, _ in ckpt.leaves} == {
        m["path"].replace("/", ".") for m in manifest["leaves"]}
    total = 0
    for m in manifest["leaves"]:
        got = ckpt.read_array(m["path"].replace("/", "."))
        assert got.dtype == np.float32 and list(got.shape) == m["shape"]
        assert got.tobytes() == leaf(m["path"], got.shape).tobytes(), m
        total += got.nbytes
    assert total > 2e9
    # the port's interp_256 model takes every leaf by name and shape
    with torch.device("meta"):
        model = build_latent_diffusion("interp_256", device="meta")
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    from upgpt_torch.convert.from_jax import torch_key

    assert {torch_key(m["path"]) for m in manifest["leaves"]} == set(want)
