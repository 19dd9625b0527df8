"""Interactive demo app: generate, pose interpolation, style text
overrides, upscale.

Counterpart of `upgpt_tpu/app.py` (the reference's Streamlit app,
app.py:99-409, on the stdlib http.server): one page posting JSON to
`/api/generate` and `/api/upscale`, the model run by the port's
`GenerationPipeline` and `UpscalePipeline` on the card. Poses come from
SMPL pickles in a pose directory (`<id>.p`, an optional `<id>_mask.png`);
per-slot text overrides swap the style slots' embeddings for pooled text
embeddings (`mix_style`, generate_utils.py:172-190); a request with
`frames` > 1 interpolates from `pose` to `pose2` (`interpolate_smpl`,
`interpolate_masks`) from one shared x_T.

    python -m upgpt_torch.app --base configs/deepfashion/interp_256.yaml \\
        --ckpt weights/interp_256.pt --pose-dir app_cache/pose --port 7860 \\
        --upscale-base configs/deepfashion/upscale.yaml \\
        --upscale-ckpt weights/upscale.pt

Without `--ckpt` it serves random weights, labelled so, on the debug
encoder; without CLIP weights in the config it falls back to the debug
encoder too. Each request draws from a `torch.Generator` seeded by the
request counter, as JAX seeds `PRNGKey(counter)`; one lock serialises the
model calls and the state they share. Divergences from the JAX app
(ROADMAP §3): the fallback pose of an unknown id is seeded by a stable
digest of the id, not by Python's per-process salted `hash` (R11), and the
upscale stage is wired from `--upscale-base` / `--upscale-ckpt` at
`UpscalePipeline`'s default 200 steps, where JAX never sets it (R12). The
listen backlog is 128, as the serving endpoint's (R5). A pose id names a
pickle only where it names a file directly in the pose directory (no
separator, no `..`), and the pickle is read through the restricted SMPL
unpickler (`data.smpl_pickle`); any other id falls back as an unknown one
does. A request for more than 256 frames (the serving endpoint's bound)
is answered 400 before anything is allocated (ROADMAP §3 P10, P11).
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import zlib
from http.server import BaseHTTPRequestHandler
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from upgpt_torch.data.smpl_pickle import load_smpl_pickle
from upgpt_torch.inference.http_serve import (
    _host, _png_b64, _Server, default_person_mask,
)
from upgpt_torch.inference.pipeline import (
    STYLE_NAMES, GenerationPipeline, UpscalePipeline, interpolate_masks,
    interpolate_smpl, mix_style,
)

_PAGE = """<!doctype html>
<html><head><title>upgpt-torch demo</title><style>
body{font-family:sans-serif;max-width:900px;margin:2em auto}
img{image-rendering:pixelated;border:1px solid #ccc;margin:4px}
textarea,input{width:100%%}button{padding:.5em 1.5em;margin:.5em 0}
.row{display:flex;gap:1em}.col{flex:1}</style></head><body>
<h2>upgpt-torch — person image generation %(mode)s</h2>
<div class=row><div class=col>
<label>Caption</label><textarea id=txt rows=2>a woman wearing a red dress</textarea>
<label>Style text overrides (JSON slot-&gt;text)</label>
<textarea id=styles rows=2>{}</textarea>
<label>Pose id</label><input id=pose value="0">
<label>Frames (pose interpolation; 1 = single)</label><input id=frames value="1">
<label>Steps</label><input id=steps value="50">
<label>Sampler</label><select id=sampler>
<option value="ddim">ddim</option><option value="dpm++">dpm++ (fast, ~20 steps)</option><option value="unipc">unipc (fastest, ~10 steps)</option>
</select>
<button onclick="gen()">Generate</button>
<button onclick="up()">Upscale last</button>
</div><div class=col id=out></div></div>
<script>
async function call(ep, body){
  const r = await fetch(ep,{method:'POST',body:JSON.stringify(body)});
  const j = await r.json();
  if(j.error){alert(j.error);return}
  document.getElementById('out').innerHTML =
    j.images.map(s=>`<img src="data:image/png;base64,${s}">`).join('');
}
function gen(){call('/api/generate',{txt:document.getElementById('txt').value,
  style_texts:JSON.parse(document.getElementById('styles').value||'{}'),
  pose:document.getElementById('pose').value,
  frames:+document.getElementById('frames').value,
  steps:+document.getElementById('steps').value,
  sampler:document.getElementById('sampler').value})}
function up(){call('/api/upscale',{})}
</script></body></html>"""

MAX_FRAMES = 256  # as the serving endpoint bounds /v1/interpolate


class BadRequest(ValueError):
    """A request the app refuses with a 400."""


def fallback_pose_seed(pose_id: str) -> int:
    """The fallback pose's seed: a stable digest of the id, the same in
    every process (JAX's `abs(hash(pose_id))` is salted per process,
    ROADMAP R11)."""
    return zlib.crc32(pose_id.encode("utf-8")) % 2**31


class DemoState:
    """The model, its encoder and the app's shared state, behind one
    lock."""

    def __init__(self, model, encoder, pose_dir: Optional[str] = None,
                 upscale_model=None, upscale_steps: int = 200):
        self.model = model
        self.encoder = encoder
        self.pose_dir = Path(pose_dir) if pose_dir else None
        self.pipes: Dict[tuple, GenerationPipeline] = {}
        self.upscale = (None if upscale_model is None else
                        UpscalePipeline(upscale_model, num_steps=upscale_steps))
        # (images on the card, text_emb, style_emb) of the last generate
        self.last: Optional[Tuple[torch.Tensor, np.ndarray, np.ndarray]] = None
        self.counter = 0
        self.lock = threading.Lock()

    def pipe(self, steps: int, sampler: str = "ddim") -> GenerationPipeline:
        key = (steps, sampler)
        if key not in self.pipes:
            self.pipes[key] = GenerationPipeline(
                self.model, num_steps=steps, eta=1.0, sampler=sampler)
        return self.pipes[key]

    def pose_file(self, pose_id: str) -> Optional[Path]:
        """`<pose_id>.p` where the id names a file directly in the pose
        directory, else None."""
        if (self.pose_dir is None or not pose_id or ".." in pose_id
                or "/" in pose_id or "\\" in pose_id or "\0" in pose_id):
            return None
        path = self.pose_dir / f"{pose_id}.p"
        if (not path.is_file()
                or path.resolve().parent != self.pose_dir.resolve()):
            return None
        return path

    def load_pose(self, pose_id: str) -> Tuple[np.ndarray, np.ndarray]:
        """(smpl (1, 85), person mask (h, w, 1)) of a pose id: the pose
        directory's SMPL pickle and mask, else a seeded fallback pose and
        the default mask."""
        h, w = self.model.config.latent_size
        path = self.pose_file(pose_id)
        if path is not None:
            p = load_smpl_pickle(path)
            smpl = np.concatenate([
                np.asarray(p[0][k], np.float32).reshape(1, -1)
                for k in ("pred_body_pose", "pred_betas", "pred_camera")], 1)
            mask_png = self.pose_dir / f"{pose_id}_mask.png"
            if mask_png.exists():
                from PIL import Image

                from upgpt_torch.data.transforms import (
                    mask_transform_binary, silhouette_bbox,
                )
                m = silhouette_bbox(np.asarray(Image.open(mask_png)))
                return smpl, mask_transform_binary(m, (h, w))
            return smpl, default_person_mask(h, w)
        rng = np.random.default_rng(fallback_pose_seed(pose_id))
        return (rng.normal(size=(1, 85)).astype(np.float32) * 0.2,
                default_person_mask(h, w))

    def conditioning(self, req: Dict) -> Dict[str, np.ndarray]:
        """A request's batch on the host: the caption's hidden states, the
        style slots (zero, or pooled text where `style_texts` overrides a
        slot), and per frame the SMPL vector and the person mask."""
        frames = max(1, int(req.get("frames", 1)))
        if frames > MAX_FRAMES:
            raise BadRequest(f"frames must be at most {MAX_FRAMES}")
        text_emb = _host(self.encoder.text_hidden([req.get("txt", "")]))
        style_emb = np.zeros((1, len(STYLE_NAMES), text_emb.shape[-1]),
                             np.float32)
        overrides = req.get("style_texts") or {}
        if overrides:
            texts = [overrides.get(n, "") for n in STYLE_NAMES]
            pooled = _host(self.encoder.text_pooled(texts))[None]
            flags = [bool(overrides.get(n)) for n in STYLE_NAMES]
            style_emb = mix_style(torch.from_numpy(style_emb),
                                  torch.from_numpy(pooled), flags).numpy()
        smpl, mask = self.load_pose(str(req.get("pose", "0")))
        if frames > 1:
            smpl2, mask2 = self.load_pose(str(req.get("pose2", "1")))
            alphas = np.linspace(1.0, 0.0, frames).astype(np.float32)
            smpl_b = interpolate_smpl(torch.from_numpy(smpl),
                                      torch.from_numpy(smpl2),
                                      torch.from_numpy(alphas)).numpy()
            mask_b = interpolate_masks(mask, mask2, alphas)
        else:
            smpl_b, mask_b = smpl[None], mask[None]
        batch = {"text_emb": np.repeat(text_emb, frames, 0),
                 "style_emb": np.repeat(style_emb, frames, 0),
                 "person_mask": np.asarray(mask_b, np.float32)}
        if self.model.config.pose_input_dim:
            batch["smpl"] = smpl_b.reshape(frames, 1, -1)
        return batch

    def generate(self, req: Dict) -> np.ndarray:
        """Float images in [-1, 1], (frames, H, W, 3)."""
        steps = int(req.get("steps", 50))
        sampler = str(req.get("sampler", "ddim"))
        batch = self.conditioning(req)
        with self.lock:
            self.counter += 1
            gen = torch.Generator(device=self.model.device).manual_seed(
                self.counter)
            imgs = self.pipe(steps, sampler).generate(
                {k: torch.from_numpy(v) for k, v in batch.items()}, gen,
                shared_x_T=len(batch["text_emb"]) > 1)
            self.last = (imgs, batch["text_emb"], batch["style_emb"])
            return imgs.float().cpu().numpy()

    def upscale_last(self) -> np.ndarray:
        """The last sample through the upscale stage, conditioned on the
        same text and style embeddings: float images in [-1, 1]."""
        with self.lock:
            if self.last is None or self.upscale is None:
                raise RuntimeError(
                    "no previous sample or no upscale model configured")
            imgs, text_emb, style_emb = self.last
            gen = torch.Generator(device=self.upscale.inner.model.device
                                  ).manual_seed(self.counter)
            out = self.upscale.upscale(imgs, torch.from_numpy(text_emb),
                                       torch.from_numpy(style_emb), gen)
            return out.float().cpu().numpy()


def make_handler(state: DemoState, mode_label: str):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, payload, code=200):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            body = (_PAGE % {"mode": mode_label}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/api/generate":
                    imgs = state.generate(req)
                elif self.path == "/api/upscale":
                    imgs = state.upscale_last()
                else:
                    self._json({"error": f"unknown endpoint {self.path}"},
                               404)
                    return
                self._json({"images": [_png_b64(i) for i in imgs]})
            except BadRequest as e:
                self._json({"error": f"{type(e).__name__}: {e}"}, 400)
            except Exception as e:  # noqa: BLE001 — surfaces errors to the UI
                self._json({"error": f"{type(e).__name__}: {e}"}, 500)

    return Handler


def build_state(args) -> Tuple[DemoState, str]:
    """(state, mode label) from the command line's arguments."""
    from upgpt_torch.cli import _build_cond_encoder, _load_model
    from upgpt_torch.config import instantiate_from_config, merge_configs

    cfg = merge_configs(args.base, args.overrides) if args.base else {
        "model": {"target": "upgpt_torch.zoo.build_latent_diffusion",
                  "params": {"variant": "tiny"}}}
    model_cfg = dict(cfg["model"])
    # the kernels take bf16 on the card, as the configs set it
    model_cfg["params"] = {
        "dtype": "bfloat16" if torch.device(args.device).type == "cuda"
        else "float32", **(model_cfg.get("params") or {}),
        "device": args.device}
    if args.ckpt:
        model, grid = _load_model(model_cfg, args.ckpt)
        if grid is not None:
            raise SystemExit(
                f"{args.ckpt}: a distilled student; it samples only on its "
                f"own {len(grid)}-step grid, and the app samples at DDIM-50 "
                f"and UniPC-8 (serve it with `cli serve`)")
        mode = ""
    else:
        torch.manual_seed(0)
        model = instantiate_from_config(model_cfg)
        mode = "(RANDOM WEIGHTS — demo plumbing only)"
    encoder = _build_cond_encoder(cfg, model, allow_debug=True)
    upscale = None
    if args.upscale_base:
        if not args.upscale_ckpt:
            raise SystemExit("--upscale-base needs --upscale-ckpt")
        up_cfg = merge_configs(args.upscale_base, [])
        upscale, up_grid = _load_model(up_cfg["model"], args.upscale_ckpt,
                                       device=str(model.device))
        if up_grid is not None:
            raise SystemExit(f"{args.upscale_ckpt}: a distilled student's "
                             f"sidecar; the upscale stage has none")
    return DemoState(model, encoder, args.pose_dir, upscale), mode


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("upgpt_torch.app")
    p.add_argument("--base", nargs="*", default=[])
    p.add_argument("overrides", nargs="*", help="key=value dotlist")
    p.add_argument("--ckpt", default=None,
                   help="the port's checkpoint (either layout) or a "
                        "JAX orbax directory")
    p.add_argument("--pose-dir", default=None)
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--device", default="cuda",
                   help="where the models run (default: the card)")
    p.add_argument("--upscale-base", nargs="*", default=None,
                   help="upscale-stage config: enables /api/upscale")
    p.add_argument("--upscale-ckpt", default=None)
    return p


def serve(state: DemoState, mode: str, port: int = 7860,
          host: str = "0.0.0.0") -> _Server:
    """The threading HTTP server (the caller runs serve_forever)."""
    return _Server((host, port), make_handler(state, mode))


def main(argv=None):
    args = parser().parse_args(argv)
    state, mode = build_state(args)
    server = serve(state, mode, args.port, args.host)
    print(f"upgpt-torch demo on http://{args.host}:"
          f"{server.server_address[1]} {mode}", file=sys.stderr, flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
