"""Write the orbax fixtures of the port's checkpoint reader with the JAX
package's own `StandardCheckpointer` (run where JAX and orbax are
installed; the fixtures are committed, since the card's machine has
neither):

    JAX_PLATFORMS=cpu python tests/torch_fixtures/orbax/make_fixtures.py \
        [NAME ...]

(every fixture where no NAME is given; rewriting one changes its bytes,
uuids and timestamps, not its leaves)

- `tiny_trainer/`: the payload `upgpt_tpu.training.trainer.Trainer`
  checkpoints (`Trainer._payload`: `step`, `params`, `opt_state` of the
  optax chain, `ema`, `ema_updates`, `frozen.vae`) of a reduced tiny
  interp-style model (one 32-channel level, a 64-d context and the pose
  stage; a one-level VAE): the weights, the EMA shadow and the VAE seeded
  random (`frozen.vae` in bfloat16), Adam's moments zero as `tx.init`
  makes them, the counters 3; with `MANIFEST.json`: each leaf's path, dtype, shape and
  the sha256 of its bytes, from JAX's arrays.
- `interp_256_tiled/`: `cli convert`'s tree (`unet`, `pose`, `vae`) of the
  full-width interp_256 model, shaped by `jax.eval_shape` of its init,
  each leaf `pattern.leaf(path, shape)`; `MANIFEST.json` lists each leaf's
  path, dtype and shape.
- `interp_256_trainer_tiled/`: the JAX trainer's `checkpoints/last` of
  the full-width interp_256 run at step 7 (`Trainer._payload` of
  `create_train_state`'s optax.adamw state, shaped by `jax.eval_shape`):
  `params`, Adam's `mu`, the `ema` shadow and `frozen.vae` each
  `pattern.leaf(path, shape)` under its own path, Adam's `nu` the square
  of its leaf (a second moment is not negative), `step`, both optax
  counts and `ema_updates` 7; `interp_256_trainer_tiled.meta.json`
  beside it is `last.meta.json` (epoch 1, as the JAX trainer writes it);
  `MANIFEST.json` lists each leaf's path, dtype and shape. ~7 GB decoded,
  ~8 GB of host memory to write.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import orbax.checkpoint as ocp  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))
sys.path.insert(0, str(HERE))

from pattern import (  # noqa: E402
    TRAINER_EPOCH, TRAINER_STEP, leaf, trainer_leaf,
)
from upgpt_tpu.training.train_state import create_train_state  # noqa: E402
from upgpt_tpu.training.trainer import Trainer  # noqa: E402
from upgpt_tpu.zoo import build_latent_diffusion  # noqa: E402

# the reduced tiny geometry of `tiny_trainer` (zoo overrides)
TINY_UNET = dict(model_channels=32, channel_mult=(1,), num_res_blocks=1,
                 attention_resolutions=(1,), num_heads=4, context_dim=64)
TINY_VAE = dict(ch=32, ch_mult=(1,), num_res_blocks=1)


def _path(keys) -> str:
    parts = []
    for k in keys:
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                parts.append(str(getattr(k, attr)))
                break
    return "/".join(parts)


def _leaves(tree):
    """(path, numpy array) of every array leaf, JAX's paths joined by
    '/' (dict keys, sequence indices, named-tuple fields)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(_path(keys), np.asarray(v)) for keys, v in flat]


def _save(tree, out: Path) -> None:
    shutil.rmtree(out, ignore_errors=True)
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(out.absolute(), tree)
    ckptr.wait_until_finished()


def _raw(a: np.ndarray) -> bytes:
    return (a.view(np.uint16) if a.dtype.name == "bfloat16" else a).tobytes()


def tiny_trainer(out: Path) -> None:
    base = build_latent_diffusion("tiny")
    jm = build_latent_diffusion(
        "tiny", unet=dataclasses.replace(base.config.unet, **TINY_UNET),
        vae=dataclasses.replace(base.config.vae, **TINY_VAE),
        context_dim=TINY_UNET["context_dim"])
    rng = np.random.default_rng(16)

    def seeded(shapes, dtype=None):
        return jax.tree_util.tree_map(
            lambda a: jnp.asarray(0.05 * rng.standard_normal(a.shape),
                                  dtype or a.dtype), shapes)

    shapes = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    params = seeded({k: shapes[k] for k in ("unet", "pose")})
    state = create_train_state(params, learning_rate=1e-4)
    state = state.replace(
        step=jnp.asarray(3, jnp.int32),
        opt_state=jax.tree_util.tree_map(  # the moments stay zero
            lambda a: jnp.asarray(3, a.dtype) if a.ndim == 0 else a,
            state.opt_state),
        ema=state.ema._replace(
            shadow=jax.tree_util.tree_map(
                lambda p: p + jnp.asarray(
                    1e-3 * rng.standard_normal(p.shape), p.dtype), params),
            num_updates=jnp.asarray(3, jnp.int32)))
    payload = Trainer._payload(state, {"vae": seeded(shapes["vae"],
                                                     jnp.bfloat16)})
    _save(payload, out)
    manifest = {"geometry": {"variant": "tiny", "unet": TINY_UNET,
                             "vae": TINY_VAE,
                             "context_dim": TINY_UNET["context_dim"]},
                "leaves": [{"path": p, "dtype": a.dtype.name,
                            "shape": list(a.shape),
                            "sha256": hashlib.sha256(_raw(a)).hexdigest()}
                           for p, a in _leaves(payload)]}
    (out / "MANIFEST.json").write_text(json.dumps(manifest) + "\n")


def interp_256_tiled(out: Path) -> None:
    jm = build_latent_diffusion("interp_256")
    shapes = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    tree = jax.tree_util.tree_unflatten(
        treedef, [leaf(_path(keys), a.shape) for keys, a in flat])
    _save(tree, out)
    manifest = {"leaves": [{"path": _path(keys), "dtype": a.dtype.name,
                            "shape": list(a.shape)} for keys, a in flat]}
    (out / "MANIFEST.json").write_text(json.dumps(manifest) + "\n")


def interp_256_trainer_tiled(out: Path) -> None:
    jm = build_latent_diffusion("interp_256")
    shapes = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    trainable = {k: shapes[k] for k in ("unet", "pose")}
    state = jax.eval_shape(
        lambda p: create_train_state(p, learning_rate=1e-4), trainable)
    flat, treedef = jax.tree_util.tree_flatten_with_path(
        Trainer._payload(state, {"vae": shapes["vae"]}))

    def value(path, a):
        if a.shape == ():  # step, both optax counts, ema_updates
            return np.asarray(TRAINER_STEP, a.dtype)
        return trainer_leaf(path, a.shape)

    _save(jax.tree_util.tree_unflatten(
        treedef, [value(_path(keys), a) for keys, a in flat]), out)
    manifest = {"step": TRAINER_STEP, "epoch": TRAINER_EPOCH,
                "leaves": [{"path": _path(keys), "dtype": a.dtype.name,
                            "shape": list(a.shape)} for keys, a in flat]}
    (out / "MANIFEST.json").write_text(json.dumps(manifest) + "\n")
    (out.parent / f"{out.name}.meta.json").write_text(
        json.dumps({"epoch": TRAINER_EPOCH}))


FIXTURES = {"tiny_trainer": tiny_trainer,
            "interp_256_tiled": interp_256_tiled,
            "interp_256_trainer_tiled": interp_256_trainer_tiled}


if __name__ == "__main__":
    names = sys.argv[1:] or list(FIXTURES)
    for name in names:
        FIXTURES[name](HERE / name)
        size = sum(f.stat().st_size for f in (HERE / name).rglob("*")
                   if f.is_file())
        print(f"{name}: {size} bytes on disk")
