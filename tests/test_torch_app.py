"""The demo app (`upgpt_torch.app`) on the CPU, against the JAX package's
`upgpt_tpu/app.py`.

A `tiny` model (float32, seeded) and a `tiny_upscale` stage serve on
127.0.0.1, port 0: the index page, `/api/generate` with two frames and a
style text override and with each sampler the page offers, `/api/upscale`
on the last sample (R12), and a structured 404. The conditioning batch the
port builds for a request (the caption's hidden states, `mix_style`'s
per-slot text override, the interpolated SMPL vectors and masks from a pose
directory of SMPL pickles and a mask PNG) equals the one JAX's `DemoState`
hands its pipeline, to float32 rounding. R11: two processes with different
`PYTHONHASHSEED` draw the same fallback pose in the port and different ones
in JAX. R12: JAX's app takes no upscale flags and its `/api/upscale`
always answers that no upscale model is configured.
"""

import base64
import json
import os
import pickle
import subprocess
import sys
import threading
import types
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from upgpt_tpu import app as jax_app  # noqa: E402
from upgpt_tpu.inference.encoders import (  # noqa: E402
    DebugConditioningEncoder as JaxDebug,
)
from upgpt_tpu.zoo import build_latent_diffusion as jax_build  # noqa: E402
from upgpt_torch import app  # noqa: E402
from upgpt_torch.inference.encoders import (  # noqa: E402
    DebugConditioningEncoder,
)
from upgpt_torch.inference.png import decode_png  # noqa: E402
from upgpt_torch.zoo import build_latent_diffusion  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REQUEST = {"txt": "a woman in a red dress", "frames": 3, "pose": "0",
           "pose2": "1", "style_texts": {"top": "red shirt",
                                         "shoes": "black boots"}}


@pytest.fixture(scope="module")
def pose_dir(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("pose")
    rng = np.random.default_rng(3)
    for pid in ("0", "1"):
        with open(root / f"{pid}.p", "wb") as f:
            pickle.dump([{"pred_body_pose": rng.normal(size=(24, 3)),
                          "pred_betas": rng.normal(size=(10,)),
                          "pred_camera": rng.normal(size=(3,))}], f)
    mask = np.zeros((64, 48), np.uint8)
    mask[10:50, 12:36] = 255
    Image.fromarray(mask).save(root / "1_mask.png")
    return str(root)


@pytest.fixture(scope="module")
def served(pose_dir):
    torch.manual_seed(0)
    model = build_latent_diffusion("tiny", device="cpu")
    up = build_latent_diffusion("tiny_upscale", device="cpu")
    state = app.DemoState(model, DebugConditioningEncoder(), pose_dir, up,
                          upscale_steps=2)
    server = app.serve(state, "(test)", port=0, host="127.0.0.1")
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", state
    server.shutdown()
    server.server_close()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _images(resp):
    return [decode_png(base64.b64decode(s)) for s in resp["images"]]


def test_index_page(served):
    url, _ = served
    html = urllib.request.urlopen(url, timeout=30).read().decode()
    assert "upgpt-torch" in html and "/api/generate" in html
    assert "(test)" in html


def test_generate_upscale_and_errors(served):
    url, state = served
    code, resp = _post(url + "/api/generate",
                       {"txt": "a woman", "steps": 2, "frames": 2,
                        "style_texts": {"top": "red shirt"}})
    assert code == 200, resp
    imgs = _images(resp)
    assert len(imgs) == 2 and all(i.shape == (64, 48, 3) for i in imgs)
    # R12: the upscale stage is wired; the last sample goes through it
    code, resp = _post(url + "/api/upscale", {})
    assert code == 200, resp
    up = _images(resp)
    assert len(up) == 2 and all(i.shape == (64, 48, 3) for i in up)
    # every sampler the page offers
    html = urllib.request.urlopen(url, timeout=30).read().decode()
    for sampler in ("ddim", "dpm++", "unipc"):
        assert f'value="{sampler}"' in html
        code, resp = _post(url + "/api/generate",
                           {"txt": "a woman", "steps": 2,
                            "sampler": sampler})
        assert code == 200 and len(_images(resp)) == 1, (sampler, resp)
    assert state.counter == 4
    code, resp = _post(url + "/api/nope", {})
    assert code == 404 and resp["error"].startswith("unknown endpoint")
    code, resp = _post(url + "/api/generate", {"sampler": "euler"})
    assert code == 500 and "euler" in resp["error"]


def test_conditioning_equals_jax_demo_state(pose_dir):
    model = build_latent_diffusion("tiny", device="cpu")
    got = app.DemoState(model, DebugConditioningEncoder(),
                        pose_dir).conditioning(REQUEST)
    # JAX's DemoState builds the batch inside `generate`: record what it
    # hands its pipeline
    seen = {}

    class Recorder:
        def generate(self, params, batch, key, shared_x_T=False):
            seen.update(batch, shared_x_T=shared_x_T)
            return np.zeros((len(batch["smpl"]), 64, 48, 3), np.float32)

    jstate = jax_app.DemoState(jax_build("tiny", use_flash_attention=False),
                               None, JaxDebug(), pose_dir)
    jstate.pipe = lambda steps, sampler="ddim": Recorder()
    jstate.generate(REQUEST)
    assert seen.pop("shared_x_T") is True
    assert sorted(got) == sorted(seen)
    for k in seen:
        assert got[k].shape == seen[k].shape, k
        np.testing.assert_allclose(got[k], seen[k], rtol=0, atol=1e-7,
                                   err_msg=k)
    # the mask PNG of pose 1 and the default box of pose 0 at the ends
    assert not np.array_equal(got["person_mask"][0], got["person_mask"][-1])


_R11 = """
import sys, types
import numpy as np
from upgpt_torch import app
from upgpt_tpu import app as jax_app
m = types.SimpleNamespace(config=types.SimpleNamespace(latent_size=(32, 24),
                                                       pose_input_dim=85))
ours = app.DemoState(m, None).load_pose("unknown-pose")[0]
theirs = jax_app.DemoState(m, None, None, None).load_pose("unknown-pose")[0]
print(ours.tobytes().hex()[:64], theirs.tobytes().hex()[:64])
"""


def test_r11_fallback_pose_is_stable_across_processes():
    outs = []
    for seed in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=seed, PYTHONPATH=REPO,
                   JAX_PLATFORMS="cpu")
        proc = subprocess.run([sys.executable, "-c", _R11], cwd=REPO,
                              env=env, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        outs.append(proc.stdout.split())
    assert outs[0][0] == outs[1][0]  # the port: the same pose
    assert outs[0][1] != outs[1][1]  # JAX: salted by the process
    assert app.fallback_pose_seed("unknown-pose") == app.fallback_pose_seed(
        "unknown-pose")


def test_r12_jax_app_has_no_upscale_stage():
    with pytest.raises(SystemExit):
        jax_app.main(["--upscale-base", "x.yaml", "--upscale-ckpt", "y"])
    state = jax_app.DemoState(types.SimpleNamespace(), None, None, None)
    state.last_sample = np.zeros((1, 64, 48, 3), np.float32)
    assert state.upscale is None
    server = ThreadingHTTPServer(("127.0.0.1", 0),
                                 jax_app.make_handler(state, ""))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        code, resp = _post(f"http://127.0.0.1:{server.server_address[1]}"
                           "/api/upscale", {})
    finally:
        server.shutdown()
        server.server_close()
    assert code == 500 and "no upscale model configured" in resp["error"]


# ------------------------------------------- P10 and P11 (ROADMAP §3)

class _Shell:
    """A pickle whose loading would run a shell command."""

    def __init__(self, marker):
        self.marker = marker

    def __reduce__(self):
        return (os.system, (f"touch {self.marker}",))


def test_p10_pose_ids_outside_the_directory_fall_back(pose_dir, tmp_path):
    """`../evil` and an absolute path name a pickle outside the pose
    directory: it is never read (its side effect never runs) and the pose
    is the fallback an unknown id gets; an id in the directory still
    reads its pickle."""
    marker = tmp_path / "ran"
    evil = os.path.join(os.path.dirname(pose_dir), "evil")
    with open(evil + ".p", "wb") as f:
        pickle.dump(_Shell(marker), f)
    state = app.DemoState(build_latent_diffusion("tiny", device="cpu"),
                          DebugConditioningEncoder(), pose_dir)
    for pid in ("../evil", evil, "a/../../evil", "..", ""):
        assert state.pose_file(pid) is None
        smpl, _ = state.load_pose(pid)
        rng = np.random.default_rng(app.fallback_pose_seed(pid))
        np.testing.assert_array_equal(
            smpl, rng.normal(size=(1, 85)).astype(np.float32) * 0.2)
    assert not marker.exists()
    assert state.pose_file("0") == type(state.pose_dir)(pose_dir) / "0.p"
    with open(os.path.join(pose_dir, "0.p"), "rb") as f:
        want = pickle.load(f)[0]
    smpl, _ = state.load_pose("0")
    np.testing.assert_array_equal(
        smpl[0, :72], want["pred_body_pose"].reshape(-1).astype(np.float32))


def test_p10_a_pickle_naming_os_system_is_refused(pose_dir, tmp_path):
    marker = tmp_path / "ran"
    with open(os.path.join(pose_dir, "shell.p"), "wb") as f:
        pickle.dump(_Shell(marker), f)
    try:
        state = app.DemoState(build_latent_diffusion("tiny", device="cpu"),
                              DebugConditioningEncoder(), pose_dir)
        with pytest.raises(pickle.UnpicklingError, match="system"):
            state.load_pose("shell")
        assert not marker.exists()
    finally:
        os.remove(os.path.join(pose_dir, "shell.p"))


def test_p11_too_many_frames_answer_400(served):
    url, state = served
    before = state.counter
    code, resp = _post(url + "/api/generate",
                       {"txt": "a woman", "steps": 2, "frames": 257})
    assert code == 400 and "256" in resp["error"], resp
    assert state.counter == before  # refused before the model ran
    code, resp = _post(url + "/api/generate",
                       {"txt": "a woman", "steps": 2, "frames": 1})
    assert code == 200 and len(_images(resp)) == 1
