"""The port's HTTP endpoint on CPU: a server on port 0 over the tiny
engine, mirroring tests/test_http_serve.py (liveness and 404, concurrent
raw-embedding requests, 400 on malformed text, style and mask arrays,
interpolation and its validation, style-text mixing through the debug
encoder).

Then `python -m upgpt_torch.cli serve`'s construction
(`cli._build_serving`) from `configs/deepfashion/pt_256.yaml` with a
dotlist, over a port checkpoint made from JAX parameters through the
bridge; its PNGs decode through PIL to the port reader's array, bit for
bit.
"""

import base64
import io
import json
import os
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers on the cores, and
# a torch pool per worker oversubscribes them
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from upgpt_tpu.zoo import build_latent_diffusion as jax_build  # noqa: E402
from upgpt_torch.checkpoint import (  # noqa: E402
    load_checkpoint, save_checkpoint,
)
from upgpt_torch.cli import _build_serving, parser  # noqa: E402
from upgpt_torch.config import merge_configs  # noqa: E402
from upgpt_torch.convert.from_jax import load_jax_params  # noqa: E402
from upgpt_torch.inference.encoders import (  # noqa: E402
    DebugConditioningEncoder,
)
from upgpt_torch.inference.http_serve import (  # noqa: E402
    RequestBuilder, default_person_mask, serve,
)
from upgpt_torch.inference.pipeline import GenerationPipeline  # noqa: E402
from upgpt_torch.inference.png import decode_png, encode_png  # noqa: E402
from upgpt_torch.inference.serving import ServingEngine  # noqa: E402
from upgpt_torch.zoo import build_latent_diffusion  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 32, 24  # tiny's latent grid; its images are 64x48


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def _image(b64):
    return decode_png(base64.b64decode(b64))


def _start(engine, builder):
    engine.start()
    server = serve(engine, builder, port=0, host="127.0.0.1")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def _stop(server, engine):
    server.shutdown()
    server.server_close()
    engine.stop()


@pytest.fixture(scope="module")
def server_url():
    torch.manual_seed(0)
    model = build_latent_diffusion("tiny", device="cpu")
    pipe = GenerationPipeline(model, num_steps=2, eta=0.0, output_uint8=True)
    engine = ServingEngine(pipe, batch_size=2, max_delay_s=0.05)
    server, url = _start(engine, RequestBuilder(DebugConditioningEncoder(),
                                                mask_hw=(H, W)))
    yield url
    _stop(server, engine)


def test_healthz_and_unknown(server_url):
    with urllib.request.urlopen(server_url + "/healthz", timeout=30) as r:
        assert json.loads(r.read())["ok"] is True
    for method in ("GET", "POST"):
        req = urllib.request.Request(server_url + "/nope", data=(
            b"{}" if method == "POST" else None), method=method)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 404


def test_generate_raw_embeddings_concurrent(server_url):
    """Two concurrent raw-embedding requests pack into one batch; each gets
    a PNG of the tiny model's image size."""
    rng = np.random.default_rng(0)
    results = {}

    def call(i):
        results[i] = _post(server_url + "/v1/generate", {
            "text_emb": rng.normal(size=(77, 768)).tolist(),
            "style_emb": rng.normal(size=(9, 768)).tolist(),
            "smpl": rng.normal(size=(1, 85)).tolist(),
            "person_mask": default_person_mask(H, W).tolist(),
            "seed": i})

    ts = [threading.Thread(target=call, args=(i,)) for i in range(2)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    for i in range(2):
        img = _image(results[i]["image_b64"])
        assert img.shape == (64, 48, 3) and img.dtype == np.uint8
        assert results[i]["latency_s"] > 0
    stats = json.loads(urllib.request.urlopen(
        server_url + "/v1/stats", timeout=30).read())
    assert stats["requests"] >= 2 and stats["batches"] >= 1


@pytest.mark.parametrize("bad", [
    {"text_emb": np.zeros((3, 768)).tolist()},
    {"txt": "x", "style_emb": np.zeros((4, 768)).tolist()},
    {"txt": "x", "person_mask": np.zeros((H, 5, 1)).tolist()},
])
def test_bad_shapes_are_400(server_url, bad):
    """Wrong-shape per-sample arrays are refused per request and never
    reach the engine (they would fail the whole batch they pad into)."""
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server_url + "/v1/generate", bad)
    assert e.value.code == 400


def test_interpolate_endpoint(server_url):
    """N frames in one batch share ONE initial noise. At the default init
    the U-Net's zero-initialised out conv makes eps 0, so a sample depends
    on x_T alone: byte-identical frames show the shared noise, and another
    seed changes the result."""
    rng = np.random.default_rng(0)
    req = {"txt": "red coat", "frames": 2, "seed": 123,
           "smpl_src": rng.normal(size=(1, 85)).tolist(),
           "smpl_dst": rng.normal(size=(1, 85)).tolist()}
    out = _post(server_url + "/v1/interpolate", req)
    frames = [_image(b) for b in out["frames_b64"]]
    assert len(frames) == 2 and frames[0].shape == (64, 48, 3)
    np.testing.assert_array_equal(frames[0], frames[1])
    other = _image(_post(server_url + "/v1/interpolate",
                         dict(req, seed=321))["frames_b64"][0])
    assert np.abs(frames[0].astype(int) - other.astype(int)).max() > 0


@pytest.mark.parametrize("bad", [
    {"txt": "x", "frames": 1},  # too few frames
    {"txt": "x", "frames": 3, "smpl_src": [[0.0] * 85],
     "smpl_dst": [[0.0] * 85]},  # more frames than the engine batch (2)
    {"txt": "x", "frames": 2},  # no smpl endpoints
])
def test_interpolate_validation(server_url, bad):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server_url + "/v1/interpolate", bad)
    assert e.value.code == 400


def test_style_texts_mixing(server_url):
    """Overridden slots carry the pooled text embedding and the rest stay;
    the daemon serves the mixed request; a wrong slot count is a 400."""
    enc = DebugConditioningEncoder()
    texts = [None] * 9
    texts[4] = "blue denim jacket"
    cond = RequestBuilder(enc, mask_hw=(H, W)).build(
        {"txt": "red coat", "style_texts": texts})
    np.testing.assert_array_equal(cond["style_emb"][4],
                                  enc.text_pooled([texts[4]])[0])
    assert not cond["style_emb"][0].any()
    assert "image_b64" in _post(server_url + "/v1/generate",
                                {"txt": "red coat", "style_texts": texts})
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server_url + "/v1/generate",
              {"txt": "x", "style_texts": ["x"] * 4})
    assert e.value.code == 400


# ------------------------------------------- cli serve and the checkpoint


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
def ckpt(tmp_path_factory):
    """A port checkpoint of JAX tiny parameters, through the bridge."""
    jm = jax_build("tiny", use_flash_attention=False)
    params = _random_params(
        jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)), seed=0)
    model = load_jax_params(build_latent_diffusion("tiny", device="cpu"),
                            params)
    path = tmp_path_factory.mktemp("ckpt") / "tiny.pt"
    save_checkpoint(model, path)
    return path, model


def test_checkpoint_round_trip_is_strict(ckpt, tmp_path):
    path, model = ckpt
    fresh = load_checkpoint(build_latent_diffusion("tiny", device="cpu"),
                            path)
    for (name, a), b in zip(model.state_dict().items(),
                            fresh.state_dict().values()):
        assert torch.equal(a, b), name
    payload = torch.load(path, weights_only=True)
    for fault in ("no_vae", "missing"):
        bad = {k: dict(v) for k, v in payload.items()}
        if fault == "no_vae":
            bad["vae"] = {}
        else:
            bad["unet"].pop(next(iter(bad["unet"])))
        torch.save(bad, tmp_path / f"{fault}.pt")
        with pytest.raises(RuntimeError):
            load_checkpoint(build_latent_diffusion("tiny", device="cpu"),
                            tmp_path / f"{fault}.pt")


def test_cli_serve_from_yaml_config(ckpt):
    path, model = ckpt
    args = parser().parse_args([
        "serve", "--config", os.path.join(REPO, "configs/deepfashion/"
                                          "pt_256.yaml"),
        "--ckpt", str(path), "--debug-encoder", "--batch", "2",
        "--steps", "2", "--sampler", "unipc", "--schedule", "karras",
        "--max-delay", "0.05"])
    args.overrides = ["model.params.variant=tiny", "model.params.device=cpu",
                      "sampling.eta=0.0"]
    cfg = merge_configs(args.config, args.overrides)
    engine, builder, label = _build_serving(cfg, args)
    assert label == "unipc-2"
    served = engine.pipeline.model
    assert served.unet.conv_in.weight.dtype == torch.bfloat16  # the yaml's
    torch.testing.assert_close(served.unet.conv_in.weight.float(),
                               model.unet.conv_in.weight.bfloat16().float())
    server, url = _start(engine, builder)
    try:
        out = _post(url + "/v1/generate", {"txt": "red coat", "seed": 5})
    finally:
        _stop(server, engine)
    from PIL import Image

    png = base64.b64decode(out["image_b64"])
    mine = decode_png(png)
    assert mine.shape == (64, 48, 3)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png))),
                                  mine)


def test_a_burst_of_connections_fits_the_listen_backlog():
    """32 clients connect before the accept loop takes any: the port's
    server queues them all. JAX's server keeps the default backlog of 5 and
    drops the 7th connection's SYN, whose client retries a second later
    (ROADMAP §3 R5)."""
    from upgpt_tpu.inference.http_serve import serve as jax_serve

    def connected(server):
        socks = []
        try:
            for _ in range(32):
                socks.append(socket.create_connection(server.server_address,
                                                      timeout=0.5))
        except OSError:
            pass
        finally:
            for s in socks:
                s.close()
            server.server_close()
        return len(socks)

    assert connected(serve(None, None, port=0, host="127.0.0.1")) == 32
    assert connected(jax_serve(None, None, port=0, host="127.0.0.1")) < 32


def test_png_writer_decodes_through_pil():
    from PIL import Image

    img = np.random.default_rng(9).integers(0, 256, size=(37, 29, 3),
                                            dtype=np.uint8)
    png = encode_png(img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png))),
                                  img)
    np.testing.assert_array_equal(decode_png(png), img)
    with pytest.raises(ValueError):
        encode_png(img.astype(np.float32))
