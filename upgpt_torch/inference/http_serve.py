"""HTTP endpoint over the batching ServingEngine.

Port of `upgpt_tpu.inference.http_serve`: `python -m upgpt_torch.cli
serve` stands it up as a daemon; concurrent HTTP requests batch into full
static-shape device batches through `inference.serving.ServingEngine`.

Endpoints (JSON in/out):

- `POST /v1/generate` — one request, one image.
  Raw conditioning embeddings
      {"text_emb": [[...77x768]], "style_emb": [[...9x768]],
       "smpl": [[...1x85]], "person_mask": [[[...HxWx1]]]}
  or, with a conditioning encoder, {"txt": "..."} plus any of the raw
  fields; missing fields default to zero style embeddings, zero smpl and
  a centred bbox mask.
  Optional: "style_texts" — num_styles entries (string or null); a string
  replaces that slot's style embedding with the pooled text embedding
  (the app's per-slot style mixing, generate_utils.py:172-190);
  "seed" — int, fixes the request's initial-noise draw within its batch.
  Response: {"image_b64": <png>, "latency_s": ...}.
- `POST /v1/interpolate` — one request, N frames (the app's pose
  interpolation, app.py:280-308): shared text/style conditioning,
  per-frame smpl lerp and person-mask bbox-corner lerp, and ONE shared
  initial noise across frames. The frames are served in one batch
  (`ServingEngine.submit_group`), so "frames" must be <= the engine batch.
      {"txt"|"text_emb", "style_emb"?, "style_texts"?,
       "smpl_src": [1,85], "smpl_dst": [1,85],
       "mask_src"?: HxWx1, "mask_dst"?: HxWx1,
       "frames": N, "seed"?: int}
  Response: {"frames_b64": [<png> x N], "latency_s": ...}.
- `GET /v1/stats` — engine stats (requests, occupancy, p50/p95 latency).
- `GET /healthz` — liveness.

A malformed request is a 400, an unknown path a 404 and a failed batch a
500. Each HTTP worker thread blocks on its request's Future, so
concurrency across clients is the engine's batching window. Images return
as base64 PNG (`inference.png`: 8-bit RGB, written with zlib).
"""

from __future__ import annotations

import base64
import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

import numpy as np

from upgpt_torch.inference.pipeline import MASK_BG, MASK_BOX, interp_mask
from upgpt_torch.inference.png import encode_png


def default_person_mask(h: int, w: int) -> np.ndarray:
    """Centered bbox at the reference's fill constants (app default)."""
    m = np.full((h, w, 1), MASK_BG, np.float32)
    m[h // 8: -h // 8, w // 6: -w // 6] = MASK_BOX
    return m


def _host(emb) -> np.ndarray:
    """An encoder's embeddings as a float32 host array: the debug encoder's
    are host arrays, the CLIP encoder's tensors on its towers' device
    (requests are packed on the host)."""
    if hasattr(emb, "detach"):
        emb = emb.detach().float().cpu().numpy()
    return np.asarray(emb, np.float32)


def _png_b64(img: np.ndarray) -> str:
    if img.dtype != np.uint8:
        img = (np.clip((img.astype(np.float32) + 1) / 2, 0, 1) * 255
               ).astype(np.uint8)
    return base64.b64encode(encode_png(img)).decode()


class RequestBuilder:
    """Turn a JSON payload into the engine's per-sample conditioning."""

    def __init__(
        self,
        encoder,
        mask_hw: Tuple[int, int],
        context_dim: int = 768,
        text_len: int = 77,
        num_styles: int = 9,
        pose_dim: Optional[int] = 85,
    ):
        self.encoder = encoder
        self.mask_hw = mask_hw
        self.context_dim = context_dim
        self.text_len = text_len
        self.num_styles = num_styles
        self.pose_dim = pose_dim

    def build(self, req: Dict) -> Dict[str, np.ndarray]:
        cond: Dict[str, np.ndarray] = {}
        if "text_emb" in req:
            cond["text_emb"] = np.asarray(req["text_emb"], np.float32)
        elif self.encoder is not None:
            cond["text_emb"] = _host(
                self.encoder.text_hidden([req.get("txt", "")]))[0]
        else:
            raise ValueError("text_emb required (no conditioning encoder)")
        if cond["text_emb"].shape != (self.text_len, self.context_dim):
            raise ValueError(
                f"text_emb must be ({self.text_len}, {self.context_dim}), "
                f"got {cond['text_emb'].shape}")
        if "style_emb" in req:
            cond["style_emb"] = np.asarray(req["style_emb"], np.float32)
            if cond["style_emb"].shape != (self.num_styles, self.context_dim):
                raise ValueError(
                    f"style_emb must be ({self.num_styles}, "
                    f"{self.context_dim}), got {cond['style_emb'].shape}")
        else:
            cond["style_emb"] = np.zeros(
                (self.num_styles, self.context_dim), np.float32)
        if self.pose_dim:
            cond["smpl"] = (
                np.asarray(req["smpl"], np.float32).reshape(1, self.pose_dim)
                if "smpl" in req
                else np.zeros((1, self.pose_dim), np.float32))
        if "style_texts" in req:
            cond["style_emb"] = self._mix_style_texts(
                cond["style_emb"], req["style_texts"])
        if "person_mask" in req:
            cond["person_mask"] = self._mask(req["person_mask"])
        else:
            cond["person_mask"] = default_person_mask(*self.mask_hw)
        # per-request initial-noise seed: equal seeds share x_T within one
        # packed batch (pipeline.py); unrelated requests draw random seeds
        cond["x_T_seed"] = np.uint32(
            req["seed"] if "seed" in req
            else np.random.randint(0, 2**32, dtype=np.uint64))
        return cond

    def _mask(self, raw) -> np.ndarray:
        m = np.asarray(raw, np.float32)
        if m.ndim == 2:
            m = m[..., None]
        # a wrong-shape mask must 400 here, not fail the whole device
        # batch it gets padded into
        if m.shape != (*self.mask_hw, 1):
            raise ValueError(
                f"person_mask must be {(*self.mask_hw, 1)}, got {m.shape}")
        return m

    def _mix_style_texts(self, style_emb, style_texts) -> np.ndarray:
        """Per-slot pooled-text override of the style embeddings (the app's
        style mixing, generate_utils.py:172-190)."""
        if self.encoder is None:
            raise ValueError("style_texts requires a conditioning encoder")
        if len(style_texts) != self.num_styles:
            raise ValueError(
                f"style_texts must have {self.num_styles} entries "
                f"(string or null), got {len(style_texts)}")
        out = np.array(style_emb, np.float32)
        slots = [i for i, t in enumerate(style_texts) if t]
        if slots:
            pooled = _host(
                self.encoder.text_pooled([style_texts[i] for i in slots]))
            for j, i in enumerate(slots):
                out[i] = pooled[j]
        return out

    def build_interp(self, req: Dict) -> list:
        """Per-frame conditionings for /v1/interpolate: smpl lerp +
        mask bbox lerp + one shared x_T seed (app.py:296-300)."""
        frames = int(req.get("frames", 0))
        if not 2 <= frames <= 256:
            raise ValueError("frames must be in [2, 256]")
        if self.pose_dim is None:
            raise ValueError("this model variant has no pose conditioning")
        base = self.build({k: v for k, v in req.items()
                           if k not in ("smpl_src", "smpl_dst",
                                        "mask_src", "mask_dst", "frames")})
        smpl_src = np.asarray(req["smpl_src"], np.float32).reshape(
            1, self.pose_dim)
        smpl_dst = np.asarray(req["smpl_dst"], np.float32).reshape(
            1, self.pose_dim)
        mask_src = (self._mask(req["mask_src"]) if "mask_src" in req
                    else default_person_mask(*self.mask_hw))
        mask_dst = (self._mask(req["mask_dst"]) if "mask_dst" in req
                    else default_person_mask(*self.mask_hw))
        conds = []
        # reference alpha ordering: frame 0 = src (alpha 1), last = dst
        for a in np.linspace(1.0, 0.0, frames):
            c = dict(base)
            c["smpl"] = a * smpl_src + (1.0 - a) * smpl_dst
            c["person_mask"] = interp_mask(mask_src, mask_dst, float(a))
            conds.append(c)
        return conds


def make_serve_handler(engine, builder: RequestBuilder,
                       timeout_s: float = 600.0):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet; stats live at /v1/stats
            pass

        def _json(self, payload, code=200):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json({"ok": True})
            elif self.path == "/v1/stats":
                self._json(engine.stats.summary())
            else:
                self._json({"error": f"unknown endpoint {self.path}"}, 404)

        def do_POST(self):
            if self.path not in ("/v1/generate", "/v1/interpolate"):
                self._json({"error": f"unknown endpoint {self.path}"}, 404)
                return
            interp = self.path == "/v1/interpolate"
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                conds = (builder.build_interp(req) if interp
                         else [builder.build(req)])
                if len(conds) > engine.batch_size:
                    raise ValueError(
                        f"frames ({len(conds)}) exceeds the engine batch "
                        f"size ({engine.batch_size})")
            except (ValueError, KeyError, json.JSONDecodeError) as e:
                self._json({"error": f"{type(e).__name__}: {e}"}, 400)
                return
            t0 = time.perf_counter()
            try:
                futs = engine.submit_group(conds)
                imgs = [f.result(timeout=timeout_s) for f in futs]
            except Exception as e:  # noqa: BLE001 — surface batch failures
                self._json({"error": f"{type(e).__name__}: {e}"}, 500)
                return
            latency = round(time.perf_counter() - t0, 4)
            if interp:
                self._json({
                    "frames_b64": [_png_b64(np.asarray(i)) for i in imgs],
                    "latency_s": latency,
                })
            else:
                self._json({
                    "image_b64": _png_b64(np.asarray(imgs[0])),
                    "latency_s": latency,
                })

    return Handler


class _Server(ThreadingHTTPServer):
    # the listen backlog holds a burst of concurrent clients: at the
    # default of 5 the kernel drops the SYNs of the 7th connection on while
    # the accept loop waits for the interpreter, and those clients retry a
    # second later (measured on mm_512's 12-request burst: 5 of 12 requests
    # reached the engine 1.0 s after the others)
    request_queue_size = 128
    daemon_threads = True


def serve(engine, builder: RequestBuilder, port: int = 8000,
          host: str = "0.0.0.0", timeout_s: float = 600.0
          ) -> ThreadingHTTPServer:
    """Build the threading HTTP server (caller runs serve_forever)."""
    return _Server(
        (host, port), make_serve_handler(engine, builder, timeout_s=timeout_s))
