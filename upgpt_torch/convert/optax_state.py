"""The JAX trainer's checkpoints, mapped onto the port's train states.

`upgpt_tpu.training.trainer.Trainer` checkpoints `step`, `params`,
`opt_state`, `ema`, `ema_updates` and `frozen` (`Trainer._payload`) as an
orbax directory, `<logdir>/checkpoints/last`. `convert.orbax` restores it
without JAX: tuples as lists, named tuples' fields as dict keys. The
`opt_state` takes one of the three layouts of
`upgpt_tpu/training/train_state.py`:

- `optax.adamw` (`make_optimizer`, no accumulation): `[{count, mu, nu},
  None, {count}]`, Adam's state, the decay's empty state and
  `scale_by_schedule`'s count. Onto `TrainState`: `torch.optim.AdamW`'s
  state per parameter, `step` = count (a float32 tensor on the host, as
  torch keeps it), `exp_avg` = mu, `exp_avg_sq` = nu; `updates` = the
  schedule's count, `mini_step` = 0, no accumulator.
- `optax.MultiSteps` (accumulate_grad_batches k > 1): `{mini_step,
  gradient_step, inner_opt_state, acc_grads, skip_state}`, the inner state
  the adamw list above. `mini_step` onto `TrainState.mini_step`, the
  running mean `acc_grads` onto `.acc` where mini_step > 0 (None at 0,
  where optax holds zeros). `gradient_step`, the inner Adam count and the
  schedule's count are one count; `step` = gradient_step * k + mini_step.
  The state does not record k: a tree of another k shows only where those
  counts disagree, or where mini_step >= k.
- `FusedTrainState`: `{mu, nu}` in the run's `moment_dtype`, onto the
  port's `.mu` / `.nu` in the same dtype, bit for bit.

Every moment and accumulator leaf crosses by the bridge of its parameter
(`from_jax.torch_key` / `permutation`). The bridge only permutes axes, and
a permutation commutes with AdamW's elementwise update: each leaf is
permuted by its parameter's axis order on the run's device, in its own
dtype and bits, and held to its parameter's shape.

A tree of another layout than the run's optimizer (fused against optax,
another k, moments of another dtype, a parameter missing or surplus)
raises ValueError naming both sides, before anything of the run is
written, as JAX's restore refuses a reference tree of another structure.

`trainer_payload` reads a whole JAX trainer checkpoint into the payload
of the port's own trainer files (`training.trainer`), which
`Trainer.load_checkpoint` applies. The EMA shadow crosses in its own
dtype; JAX's is bfloat16 beside bf16 fused moments, and the port's
float32 shadow takes it widened (the reference fault R1, ROADMAP.md §3).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from upgpt_torch.convert.from_jax import (
    jax_state_dict, permutation, torch_key,
)

PathLike = Union[str, os.PathLike]
_ADAM_KEYS = {"count", "mu", "nu"}
_MULTISTEPS_KEYS = {"mini_step", "gradient_step", "inner_opt_state",
                    "acc_grads"}


def _dtype_name(value) -> str:
    if isinstance(value, torch.Tensor):
        return str(value.dtype).replace("torch.", "")
    return np.asarray(value).dtype.name


def _flatten(tree, prefix: str = "") -> Dict[str, object]:
    """{"a/b/c": leaf} of a nested dict, leaves as restored (numpy, or
    torch for bfloat16)."""
    out: Dict[str, object] = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            out.update(_flatten(value, path))
        else:
            out[path] = value
    return out


def _port_leaf(jax_key: str, value, device=None) -> torch.Tensor:
    """One leaf on `device` in the port's layout (the bridge's permutation
    of its axes, applied there), in its own dtype and bits."""
    t = value if isinstance(value, torch.Tensor) else torch.from_numpy(
        np.require(value, requirements="C"))
    perm = permutation(jax_key, t.dim())
    if device is not None:
        t = t.to(device)
    if perm != tuple(range(t.dim())):
        t = t.permute(perm).contiguous()
    return t


def _mapped(tree, names: Sequence[str], shapes: Sequence[torch.Size],
            what: str, dtype: Optional[str] = None,
            device=None) -> List[torch.Tensor]:
    """The leaves of a params-shaped `tree` on `device` in the port's
    layout, in `names` order; raises ValueError where a parameter is
    missing or surplus, a shape disagrees, or a leaf is not of `dtype`."""
    if not isinstance(tree, dict):
        raise ValueError(f"{what}: {type(tree).__name__}, a tree of the "
                         f"trainable parameters expected")
    flat = {torch_key(jk): (jk, v) for jk, v in _flatten(tree).items()}
    missing = [n for n in names if n not in flat]
    surplus = sorted(set(flat) - set(names))
    if missing or surplus:
        raise ValueError(
            f"{what}: the checkpoint's parameters and the run's disagree: "
            f"the run's {missing[:4]} ({len(missing)}) missing from the "
            f"checkpoint, the checkpoint's {surplus[:4]} ({len(surplus)}) "
            f"not in the run")
    out = []
    for name, shape in zip(names, shapes):
        jk, value = flat[name]
        if dtype is not None and _dtype_name(value) != dtype:
            raise ValueError(f"{what}: {jk} is {_dtype_name(value)} in the "
                             f"checkpoint, the run keeps {dtype}")
        t = _port_leaf(jk, value, device)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {jk} -> {name}: shape "
                             f"{tuple(t.shape)}, the run's is {tuple(shape)}")
        out.append(t)
    return out


def layout(opt_tree) -> str:
    """"adamw", "multisteps" or "fused": which of the JAX trainer's
    optimizers wrote `opt_tree`; raises ValueError for none."""
    if isinstance(opt_tree, dict) and set(opt_tree) == {"mu", "nu"}:
        return "fused"
    if isinstance(opt_tree, dict) and _MULTISTEPS_KEYS <= set(opt_tree):
        return "multisteps"
    if (isinstance(opt_tree, list) and len(opt_tree) == 3
            and isinstance(opt_tree[0], dict)
            and set(opt_tree[0]) == _ADAM_KEYS and not opt_tree[1]
            and isinstance(opt_tree[2], dict)
            and set(opt_tree[2]) == {"count"}):
        return "adamw"
    top = sorted(opt_tree) if isinstance(opt_tree, dict) else (
        f"a {type(opt_tree).__name__} of {len(opt_tree)}"
        if isinstance(opt_tree, list) else type(opt_tree).__name__)
    raise ValueError(f"opt_state ({top}) is none of the JAX trainer's "
                     f"layouts: optax.adamw's [adam, None, schedule], "
                     f"optax.MultiSteps' {sorted(_MULTISTEPS_KEYS)} or "
                     f"FusedTrainState's ['mu', 'nu']")


_LAYOUT_NAMES = {"adamw": "optax.adamw", "multisteps": "optax.MultiSteps",
                 "fused": "FusedTrainState"}


def _configured(state) -> Tuple[str, int, Optional[str]]:
    """(layout, k, moment dtype) the run's state keeps."""
    if hasattr(state, "mu"):
        return "fused", 1, _dtype_name(state.mu[0]) if state.mu else None
    k = int(getattr(state, "accumulate", 1))
    return ("multisteps" if k > 1 else "adamw"), k, None


def _count(value, what: str) -> int:
    arr = np.asarray(value)
    if arr.shape != () or arr.dtype.kind not in "iu":
        raise ValueError(f"{what}: {arr.dtype} of shape {arr.shape}, an "
                         f"integer count expected")
    return int(arr)


def opt_state_payload(state, opt_tree, step: int, device=None) -> dict:
    """What `state.load_opt_state` takes (`TrainState` or
    `FusedTrainState`), from JAX's `opt_state` of a run at `step`; the
    tensors on `device` (AdamW's step counts on the host, where torch
    keeps them). Raises ValueError where the layout is not the run's."""
    got = layout(opt_tree)
    want, k, moment_dtype = _configured(state)
    if got != want:
        side = {"adamw": "optax.adamw (accumulate_grad_batches 1)",
                "multisteps": "optax.MultiSteps (accumulate_grad_batches "
                              f"{k})",
                "fused": f"FusedTrainState ({moment_dtype} moments)"}
        raise ValueError(f"the checkpoint's optimizer state is "
                         f"{_LAYOUT_NAMES[got]}'s, the run configures "
                         f"{side[want]}")
    names = list(state.names)
    shapes = [p.shape for p in state.params]
    if got == "fused":
        return {m: _mapped(opt_tree[m], names, shapes, f"opt_state/{m}",
                           moment_dtype, device) for m in ("mu", "nu")}
    inner = opt_tree if got == "adamw" else opt_tree["inner_opt_state"]
    if layout(inner) != "adamw":
        raise ValueError("opt_state/inner_opt_state is not optax.adamw's "
                         "state")
    adam = _count(inner[0]["count"], "Adam's count")
    sched = _count(inner[2]["count"], "the schedule's count")
    mini = 0
    counts = {"Adam's count": adam, "the schedule's count": sched}
    if got == "multisteps":
        mini = _count(opt_tree["mini_step"], "mini_step")
        counts["gradient_step"] = _count(opt_tree["gradient_step"],
                                         "gradient_step")
        if not 0 <= mini < k:
            raise ValueError(f"the checkpoint's MultiSteps stopped at "
                             f"mini_step {mini}; the run accumulates k = "
                             f"{k} batches")
    if len(set(counts.values())) != 1:
        raise ValueError(f"the checkpoint's optimizer counts disagree: "
                         f"{counts}")
    if step != adam * k + mini:
        raise ValueError(
            f"the checkpoint's step {step} is not {adam} updates of k = {k} "
            f"calls plus mini_step {mini}: the run accumulates another k "
            f"than the checkpoint's")
    dtype = _dtype_name(state.params[0]) if state.params else None
    mu = _mapped(inner[0]["mu"], names, shapes, "opt_state mu", dtype,
                 device)
    nu = _mapped(inner[0]["nu"], names, shapes, "opt_state nu", dtype,
                 device)
    acc = None
    if mini > 0:
        acc = _mapped(opt_tree["acc_grads"], names, shapes,
                      "opt_state/acc_grads", dtype, device)
    sd = state.optimizer.state_dict()
    if [g["params"] for g in sd["param_groups"]] != [list(range(len(names)))]:
        raise ValueError("the run's optimizer is not one group over the "
                         "trainable parameters in order")
    sd["state"] = {i: {"step": torch.tensor(float(adam),
                                            dtype=torch.float32),
                       "exp_avg": m, "exp_avg_sq": v}
                   for i, (m, v) in enumerate(zip(mu, nu))}
    return {"optimizer": sd, "updates": sched, "mini_step": mini, "acc": acc}


def trainer_payload(path: PathLike, state, device=None) -> dict:
    """A JAX trainer checkpoint (an orbax directory) as the payload of the
    port's trainer files: `step`, `names`, `params` by name, `opt_state`
    (`opt_state_payload`), `ema` and `ema_updates` where the run keeps an
    EMA, `frozen` = {"vae": state dict} where the checkpoint has one;
    tensors on `device`. Raises ValueError where the checkpoint does not
    map onto `state`, before anything is written."""
    from upgpt_torch.convert.orbax import OrbaxCheckpoint

    tree = OrbaxCheckpoint(path).restore()
    if "params" not in tree or "opt_state" not in tree:
        raise ValueError(f"{path}: top entries {sorted(tree)}: not a JAX "
                         f"trainer checkpoint with its optimizer state "
                         f"(params and opt_state)")
    names = list(state.names)
    shapes = [p.shape for p in state.params]
    step = _count(tree["step"], "step")
    if state.ema is not None and not tree.get("ema"):
        raise ValueError(f"{path}: the run keeps an EMA shadow, the "
                         f"checkpoint has none")
    # the optimizer's layout first: a refusal moves no weights
    opt = opt_state_payload(state, tree["opt_state"], step, device)
    params = _mapped(tree["params"], names, shapes, "params", None, device)
    payload = {"step": step, "names": names,
               "params": dict(zip(names, params)), "opt_state": opt}
    if state.ema is not None:
        payload["ema"] = dict(zip(names, _mapped(
            tree["ema"], names, shapes, "ema", None, device)))
        payload["ema_updates"] = _count(tree["ema_updates"], "ema_updates")
    vae = (tree.get("frozen") or {}).get("vae")
    payload["frozen"] = None if not vae else {"vae": {
        k: v.to(device) for k, v in jax_state_dict(vae).items()}}
    return payload
