"""Continuing the JAX trainer's runs in the port, on the CPU:
`convert.optax_state`, `Trainer.load_checkpoint` over the JAX trainer's
orbax `checkpoints/last`, and `cli train --resume`.

- At `make_fixtures.py`'s reduced tiny geometry (parameter trees from
  `jax.eval_shape` and seeded numpy; no U-Net forward in JAX), each of
  the JAX trainer's four optimizer layouts takes three updates on seeded
  gradients (optax.adamw; optax.MultiSteps at k = 2, stopped at
  mini_step 1; the fused update with float32 and with bfloat16 moments)
  and is written by the JAX package's `Trainer._payload` and orbax into
  `logdir/checkpoints/last` with its `last.meta.json`. Right after the
  port loads it, every parameter, moment, accumulator, shadow, count and
  the frozen VAE equal JAX's leaf in the port's layout, bit for bit (a
  bf16 shadow widened to the port's float32 one, R1). Three more updates
  on the same gradients agree with JAX's within the tolerances of
  tests/test_torch_trainer.py: float32 at rtol 1e-6 with an absolute
  floor of 1e-6 of the leaf's largest value
  (`test_fused_train_state_matches_jax`), MultiSteps at atol 1e-6
  (`test_accumulation_matches_optax_multisteps`), bf16 moments within one
  bf16 step, the parameters beside them within 3 * lr * 2^-7, the port's
  float32 shadow against a float32 recomputation where JAX keeps bf16.
- A tree of another layout than the run's optimizer raises ValueError
  and leaves the run's state untouched.
- `cli train --resume` over a JAX-written logdir continues
  metrics.jsonl at JAX's step + 1 and epoch, with the schedule at JAX's
  count and the EMA at its count, puts the port's file where `last` was,
  and a second `--resume` continues from that file; a tree that does not
  map fails the run and leaves `last` as it was. JAX's directory moves
  aside while the port's file takes its name, and the loader reads it
  there until the file is in place.
- `from_jax.permutation`, the axis order by which the moments cross,
  inverts the JAX package's torch_to_jax for conv, Dense, norm and
  embedding leaves.
- The committed full-width fixture `interp_256_trainer_tiled` matches its
  MANIFEST.json, and its small leaves their pattern.
"""

import dataclasses
import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
ocp = pytest.importorskip("orbax.checkpoint")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from upgpt_tpu.convert import torch_to_jax as tconv  # noqa: E402
from upgpt_tpu.training import lr as jlr  # noqa: E402
from upgpt_tpu.training import train_state as jts  # noqa: E402
from upgpt_tpu.training.trainer import Trainer as JaxTrainer  # noqa: E402
from upgpt_tpu.zoo import build_latent_diffusion as jax_build  # noqa: E402
from upgpt_torch import cli  # noqa: E402
from upgpt_torch.convert.from_jax import (  # noqa: E402
    jax_state_dict, permutation, torch_array, torch_key,
)
from upgpt_torch.convert.orbax import OrbaxCheckpoint  # noqa: E402
from upgpt_torch.data.tree import write_fashion_tree  # noqa: E402
from upgpt_torch.inference.encoders import (  # noqa: E402
    DebugConditioningEncoder,
)
from upgpt_torch.training import ema as tema  # noqa: E402
from upgpt_torch.training.trainer import Trainer, TrainerConfig  # noqa: E402
from upgpt_torch.zoo import build_latent_diffusion  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "torch_fixtures", "orbax")
CONFIG = os.path.join(REPO, "configs", "deepfashion", "interp_256.yaml")


def _fixture_module(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(FIXTURES, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


MAKE = _fixture_module("make_fixtures")
LR = 1e-3
# a warm-up over five updates: every count from 0 to 5 has its own LR
SCHED = ([5], [1.0], [1.0], [0.1], [10**13])
LAYOUTS = {"adamw": {}, "multisteps": {"accumulate_grad_batches": 2},
           "fused_float32": {"fused_optimizer": True,
                             "moment_dtype": "float32"},
           "fused_bfloat16": {"fused_optimizer": True,
                              "moment_dtype": "bfloat16"}}


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    # its import pulls in TensorFlow here (~17 s a process)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _seeded(shapes, rng, scale=0.05):
    return jax.tree.map(lambda a: np.asarray(
        scale * rng.standard_normal(a.shape), np.float32), shapes)


def _save_run(logdir, payload, epoch) -> None:
    """A JAX trainer's `checkpoints/last` and its meta, as
    `upgpt_tpu.training.trainer.Trainer.save_checkpoint` writes them."""
    ckpts = logdir / "checkpoints"
    ckpts.mkdir(parents=True, exist_ok=True)
    ckptr = ocp.StandardCheckpointer()
    ckptr.save((ckpts / "last").absolute(), jax.device_get(payload))
    ckptr.wait_until_finished()
    (ckpts / "last.meta.json").write_text(json.dumps({"epoch": epoch}))


def _jax_state(kind, trainable):
    sched = jlr.lambda_linear_schedule(*SCHED)
    if kind.startswith("fused"):
        return jts.create_fused_train_state(
            trainable, LR, scheduler=sched,
            moment_dtype=getattr(jnp, LAYOUTS[kind]["moment_dtype"]))
    return jts.create_train_state(
        trainable, LR, scheduler=sched,
        accumulate_grad_batches=LAYOUTS[kind].get(
            "accumulate_grad_batches", 1))


@pytest.fixture(scope="module")
def geometry():
    """The reduced tiny model's trees: trainable (unet, pose) and the VAE,
    seeded."""
    base = jax_build("tiny")
    jm = jax_build("tiny", unet=dataclasses.replace(
        base.config.unet, **MAKE.TINY_UNET), vae=dataclasses.replace(
        base.config.vae, **MAKE.TINY_VAE),
        context_dim=MAKE.TINY_UNET["context_dim"])
    shapes = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    rng = np.random.default_rng(18)
    trainable = _seeded({k: shapes[k] for k in ("unet", "pose")}, rng)
    return trainable, _seeded(shapes["vae"], rng)


@pytest.fixture(scope="module")
def written(geometry, tmp_path_factory):
    """Per layout: three JAX updates written as a run at step 3, epoch 1,
    then three more; (logdir, the written payload, the six gradients,
    the state after six)."""
    trainable, vae = geometry
    rng = np.random.default_rng(19)
    grads = [jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
        np.float32), trainable) for _ in range(6)]
    out = {}
    for kind in LAYOUTS:
        state = _jax_state(kind, trainable)
        apply = jax.jit(lambda s, g: s.apply_gradients(g))
        for g in grads[:3]:
            state = apply(state, g)
        payload = jax.device_get(JaxTrainer._payload(state, {"vae": vae}))
        logdir = tmp_path_factory.mktemp(kind)
        _save_run(logdir, payload, epoch=1)
        for g in grads[3:]:
            state = apply(state, g)
        out[kind] = (logdir, payload, grads, jax.device_get(state))
    return out


def _port_model():
    base = build_latent_diffusion("tiny", device="cpu")
    return build_latent_diffusion(
        "tiny", device="cpu", param_dtype="float32",
        unet=dataclasses.replace(base.config.unet, **MAKE.TINY_UNET),
        vae=dataclasses.replace(base.config.vae, **MAKE.TINY_VAE),
        context_dim=MAKE.TINY_UNET["context_dim"])


def _port(kind, logdir):
    """The port's trainer over `logdir` with `kind`'s optimizer, and its
    fresh state."""
    cfg = TrainerConfig(base_learning_rate=LR, scale_lr=False,
                        warm_up_steps=SCHED[0][0],
                        scheduler_f_start=SCHED[3][0], logdir=str(logdir),
                        log_images_every=None, **LAYOUTS[kind])
    trainer = Trainer(_port_model(), cfg, DebugConditioningEncoder(
        context_dim=MAKE.TINY_UNET["context_dim"]))
    return trainer, trainer._create_state()


def _flat(tree, prefix=""):
    """{"a/b": leaf} of a nested dict, leaves as JAX gave them."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flat(v, path))
        else:
            out[path] = v
    return out


def _as_port(jk, a) -> torch.Tensor:
    """A JAX leaf in the port's layout and its own dtype, bit for bit."""
    a = np.asarray(a)
    bf16 = a.dtype.name == "bfloat16"
    t = torch.from_numpy(np.array(torch_array(jk, a.view(np.int16)
                                              if bf16 else a)))
    return t.view(torch.bfloat16) if bf16 else t


def _by_name(tree):
    return {torch_key(jk): _as_port(jk, a) for jk, a in _flat(tree).items()}


def _moments(kind, state):
    """(mu, nu, acc) of the port's state as lists in `state.names` order."""
    if kind.startswith("fused"):
        return state.mu, state.nu, None
    opt = state.optimizer.state
    return ([opt[p]["exp_avg"] for p in state.params],
            [opt[p]["exp_avg_sq"] for p in state.params], state.acc)


def _jax_moments(kind, opt_state):
    if kind.startswith("fused"):
        return opt_state["mu"], opt_state["nu"], None
    if kind == "multisteps":
        return (opt_state.inner_opt_state[0].mu,
                opt_state.inner_opt_state[0].nu, opt_state.acc_grads)
    return opt_state[0].mu, opt_state[0].nu, None


def _feed(state, g) -> None:
    by_name = dict(zip(state.names, state.params))
    for jk, a in _flat(g).items():
        by_name[torch_key(jk)].grad = torch.from_numpy(
            np.array(torch_array(jk, a)))


@pytest.mark.parametrize("kind", list(LAYOUTS))
def test_load_maps_every_leaf_bit_for_bit(written, kind):
    logdir, payload, _, _ = written[kind]
    trainer, state = _port(kind, logdir)
    state, frozen = trainer.load_checkpoint(state)
    want_mu, want_nu, want_acc = _jax_moments(kind, payload["opt_state"])
    mu, nu, acc = _moments(kind, state)
    trees = [(payload["params"], state.params),
             (want_mu, mu), (want_nu, nu)]
    if kind == "multisteps":
        assert acc is not None and state.mini_step == 1
        trees.append((want_acc, acc))
    else:
        assert acc is None and getattr(state, "mini_step", 0) == 0
    for tree, port in trees:
        want = _by_name(tree)
        assert set(want) == set(state.names)
        for name, got in zip(state.names, port):
            assert got.dtype == want[name].dtype, name
            assert torch.equal(got, want[name]), name
    # the shadow in its own bits, widened where JAX's is bf16 (R1)
    want = _by_name(payload["ema"])
    assert {str(t.dtype) for t in want.values()} == {
        "torch.bfloat16" if kind == "fused_bfloat16" else "torch.float32"}
    for name, got in zip(state.names, state.ema.shadow):
        assert got.dtype == torch.float32
        assert torch.equal(got, want[name].float()), name
    step = int(payload["step"])
    assert state.step == step == 3
    assert state.ema.num_updates == int(payload["ema_updates"]) == 3
    if kind == "adamw":
        assert state.updates == 3
    if kind == "multisteps":
        assert state.updates == int(payload["opt_state"].gradient_step) == 1
    if not kind.startswith("fused"):
        steps = {float(s["step"]) for s in state.optimizer.state.values()}
        assert steps == {float(state.updates)}
    vae = jax_state_dict(payload["frozen"]["vae"])
    assert frozen is not None and set(frozen["vae"]) == set(vae)
    got = trainer.model.vae.state_dict()
    assert all(torch.equal(got[k], v) for k, v in vae.items())
    assert trainer._load_epoch_meta() == 1


def _close(kind, got, want, what, lr=LR):
    got, want = got.float().numpy(), want.float().numpy()
    if kind == "multisteps":
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=what)
    elif kind == "fused_bfloat16" and what == "params":
        # float32 masters moved by updates of bf16 moments: one bf16 step
        # of the normalised update (~1) a step, times lr
        np.testing.assert_allclose(got, want, rtol=0, atol=3 * lr * 2.0**-7,
                                   err_msg=what)
    elif kind == "fused_bfloat16":
        mag = np.maximum(np.abs(want), np.finfo(np.float32).tiny)
        assert (np.abs(got - want) <= 2.0 ** (np.floor(np.log2(mag)) - 7)
                ).all(), what
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=what)


@pytest.mark.parametrize("kind", list(LAYOUTS))
def test_three_more_updates_agree_with_jax(written, kind):
    logdir, payload, grads, final = written[kind]
    trainer, state = _port(kind, logdir)
    state, _ = trainer.load_checkpoint(state)
    # the float32 shadow recomputed from the port's parameters, from the
    # loaded one: s <- s - (1 - decay_n) * (s - p)
    shadow = [s.clone() for s in state.ema.shadow]
    for n, g in zip(range(4, 7), grads[3:]):
        _feed(state, g)
        state.apply_gradients()
        w = np.float32(1.0) - np.float32(tema.ema_decay(n, 0.9999))
        shadow = [s - float(w) * (s - p.detach()) for s, p in
                  zip(shadow, state.params)]
    want_mu, want_nu, _ = _jax_moments(kind, final.opt_state)
    mu, nu, _ = _moments(kind, state)
    pairs = [("params", final.params, state.params), ("mu", want_mu, mu),
             ("nu", want_nu, nu)]
    if kind != "fused_bfloat16":
        pairs.append(("ema", final.ema.shadow, state.ema.shadow))
    else:
        # JAX's bf16 shadow against the port's float32 one (R1): the port's
        # held to the float32 recomputation
        for got, want in zip(state.ema.shadow, shadow):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                       atol=1e-6 * want.abs().max().item())
    for what, tree, port in pairs:
        want = _by_name(tree)
        for name, got in zip(state.names, port):
            _close(kind, got.detach(), want[name], f"{what} {name}")
    assert state.step == int(final.step) == 6
    assert state.ema.num_updates == int(final.ema.num_updates) == 6
    if kind == "adamw":
        assert state.updates == int(final.opt_state[2].count) == 6
    if kind == "multisteps":
        assert state.updates == int(final.opt_state.gradient_step) == 3
        assert state.mini_step == int(final.opt_state.mini_step) == 0


def _snapshot(trainer, state):
    out = [p.detach().clone() for p in state.params]
    out += [s.clone() for s in state.ema.shadow]
    out += [v.detach().clone() for v in trainer.model.vae.state_dict()
            .values()]
    return out


def _drop_leaf(tree, path):
    """A copy of the nested dict `tree` without the leaf at `path`."""
    head, _, rest = path.partition("/")
    out = dict(tree)
    if rest:
        out[head] = _drop_leaf(tree[head], rest)
    else:
        del out[head]
    return out


def _mismatch(written, case, tmp_path):
    """(the run's layout, the logdir of a tree that does not map, the
    message)."""
    pairs = {"fused_into_adamw": ("adamw", "fused_float32",
                                  "FusedTrainState's, the run configures "
                                  "optax.adamw"),
             "adamw_into_fused": ("fused_float32", "adamw",
                                  "optax.adamw's, the run configures "
                                  "FusedTrainState"),
             "adamw_into_k2": ("multisteps", "adamw",
                               "the run configures optax.MultiSteps"),
             "k2_into_adamw": ("adamw", "multisteps",
                               "optax.MultiSteps's, the run configures "
                               "optax.adamw"),
             "bf16_into_float32": ("fused_float32", "fused_bfloat16",
                                   "is bfloat16 in the checkpoint, the run "
                                   "keeps float32")}
    if case in pairs:
        run, tree, message = pairs[case]
        return run, written[tree][0], message
    logdir, payload, _, _ = written["adamw"]
    if case == "missing_moment":
        opt = list(payload["opt_state"])
        opt[0] = opt[0]._replace(mu=_drop_leaf(opt[0].mu,
                                               "unet/out_conv/bias"))
        changed = {**payload, "opt_state": tuple(opt)}
        message = "unet.out_conv.bias'] (1) missing from the checkpoint"
    else:  # a surplus parameter
        params = dict(payload["params"])
        params["unet"] = {**params["unet"], "extra": {"kernel": np.zeros(
            (3, 4), np.float32)}}
        changed = {**payload, "params": params}
        message = "the checkpoint's ['unet.extra.weight'] (1) not in the run"
    _save_run(tmp_path / case, changed, epoch=1)
    return "adamw", tmp_path / case, message


MISMATCHES = ["fused_into_adamw", "adamw_into_fused", "adamw_into_k2",
              "k2_into_adamw", "bf16_into_float32", "missing_moment",
              "surplus_parameter"]


@pytest.mark.parametrize("case", MISMATCHES)
def test_a_tree_of_another_layout_is_refused(written, case, tmp_path):
    run, logdir, message = _mismatch(written, case, tmp_path)
    trainer, state = _port(run, tmp_path / "port")
    trainer.logdir = logdir
    before = _snapshot(trainer, state)
    with pytest.raises(ValueError) as err:
        trainer.load_checkpoint(state)
    assert message in str(err.value)
    assert state.step == 0 and state.ema.num_updates == 0
    assert all(torch.equal(a, b) for a, b in zip(
        before, _snapshot(trainer, state)))
    if run.startswith("fused"):
        assert all(not m.any() for m in state.mu + state.nu)
    else:
        assert not state.optimizer.state and state.updates == 0


# ------------------------------------------------ the bridge's axis order

def _conv_leaves(w):
    return tconv._conv({"c.weight": w, "c.bias": w[:, 0, 0, 0]}, "c")


def _dense_leaves(w):
    return tconv._dense({"d.weight": w, "d.bias": w[:, 0]}, "d")


def _norm_leaves(w):
    return tconv._norm({"n.weight": w, "n.bias": w}, "n")


@pytest.mark.parametrize("case", [
    ("conv", (5, 3, 2, 7), _conv_leaves),
    ("dense", (5, 3), _dense_leaves),
    ("norm", (5,), _norm_leaves),
    ("embedding", (5, 3), lambda w: {"embedding": w}),
], ids=lambda c: c[0])
def test_the_axis_order_inverts_the_reference_converter(case):
    """`from_jax.permutation`, by which the moments cross, takes each leaf
    that the JAX package's torch_to_jax makes from a port weight back to
    that weight, and `torch_array` re-lays a leaf by it."""
    name, shape, convert = case
    w = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    for leaf, value in convert(w).items():
        jk = f"{name}/{leaf}"
        want = w if leaf in ("kernel", "scale", "embedding") else value
        perm = permutation(jk, value.ndim)
        np.testing.assert_array_equal(value.transpose(perm), want)
        np.testing.assert_array_equal(torch_array(jk, value), want)


# ------------------------------------------------ cli train --resume

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_fashion_tree(tmp_path_factory.mktemp("fashion"),
                              {"train": (1, 1), "validation": (2, 0)},
                              image_hw=(16, 16), seed=3)


def _dotlist(tree, logdir):
    out = [f"data.{s}.params.{k}={tree[v]}"
           for s in ("train", "validation", "test")
           for k, v in (("folder", "folder"), ("data_file", "data_file"))]
    out += [f"data.{s}.params.{k}={v}" for s in ("train", "validation",
                                                  "test")
            for k, v in (("image_size", "[16,16]"), ("f", 2))]
    out += [f"data.train.params.pair_file=['{tree['train']}']",
            f"data.validation.params.pair_file=['{tree['validation']}']",
            f"data.test.params.pair_file=['{tree['validation']}']",
            "model.params.variant=tiny", "model.params.device=cpu",
            "model.params.latent_size=(8,8)",
            "trainer.batch_size=2", "trainer.log_every=1",
            "trainer.warm_up_steps=10", "trainer.log_images_every=0",
            f"trainer.logdir={logdir}"]
    return out


def _jax_run(logdir, fused=False):
    """A JAX run of the tiny model at step 3 of epoch 1 (its three
    metrics lines too), seeded weights, moments, shadow and VAE."""
    jm = jax_build("tiny", latent_size=(8, 8))
    shapes = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    rng = np.random.default_rng(20)
    trainable = _seeded({k: shapes[k] for k in ("unet", "pose")}, rng)
    state = (jts.create_fused_train_state(trainable, 1e-4) if fused
             else jts.create_train_state(trainable, 1e-4))
    opt = jax.tree.map(lambda a: np.asarray(3, a.dtype) if a.ndim == 0
                       else np.abs(_seeded(a, rng, 1e-3)), state.opt_state)
    state = state.replace(
        step=np.asarray(3, np.int32), opt_state=opt,
        ema=state.ema._replace(shadow=_seeded(trainable, rng),
                               num_updates=np.asarray(3, np.int32)))
    vae = _seeded(shapes["vae"], rng)
    _save_run(logdir, JaxTrainer._payload(state, {"vae": vae}), epoch=1)
    with open(logdir / "metrics.jsonl", "w") as f:
        for step in (1, 2, 3):
            f.write(json.dumps({"step": step, "epoch": (step - 1) // 3,
                                "loss": 0.5}) + "\n")
    return vae


def _records(logdir):
    return [json.loads(x) for x in open(logdir / "metrics.jsonl")]


def test_cli_train_resume_continues_a_jax_run(tree, tmp_path):
    logdir = tmp_path / "run"
    vae = _jax_run(logdir)
    argv = ["train", "--resume", "--base", CONFIG, "--debug-encoder"
            ] + _dotlist(tree, logdir)
    # (1 + 1 * 5 men_factor) pairs at batch 2: three steps an epoch
    state = cli.main(argv + ["trainer.max_epochs=2"])
    assert state.step == 6 and state.updates == 6
    assert state.ema.num_updates == 6
    # the last update ran at the schedule's count 5, JAX's 3 + 2
    assert state.optimizer.param_groups[0]["lr"] == (
        state.learning_rate * state.scheduler(5))
    assert {float(s["step"]) for s in state.optimizer.state.values()} == {6.0}
    records = [r for r in _records(logdir) if "loss" in r]
    assert [r["step"] for r in records] == [1, 2, 3, 4, 5, 6]
    assert [r["epoch"] for r in records[3:]] == [1, 1, 1]
    assert all(np.isfinite(r["loss"]) for r in records)
    last = logdir / "checkpoints" / "last"
    assert last.is_file()
    assert sorted(os.listdir(logdir / "checkpoints")) == [
        "best", "best.meta.json", "last", "last.meta.json"]
    payload = torch.load(last, weights_only=True)
    assert payload["step"] == 6
    # the frozen VAE is the tree's: the model was built from the seed
    want = jax_state_dict(vae)
    assert all(torch.equal(payload["frozen"]["vae"][k], v)
               for k, v in want.items())
    # a second --resume continues from the port's own file
    state = cli.main(argv + ["trainer.max_epochs=3"])
    assert state.step == 9 and state.ema.num_updates == 9
    assert [r["step"] for r in _records(logdir) if "loss" in r] == list(
        range(1, 10))


def test_cli_train_resume_refuses_a_tree_that_does_not_map(tree, tmp_path):
    logdir = tmp_path / "run"
    _jax_run(logdir, fused=True)
    argv = ["train", "--resume", "--base", CONFIG, "--debug-encoder"
            ] + _dotlist(tree, logdir) + ["trainer.max_epochs=2"]
    with pytest.raises(ValueError, match="FusedTrainState's, the run "
                                         "configures optax.adamw"):
        cli.main(argv)
    # nothing ran and nothing was written over JAX's checkpoint
    assert len(_records(logdir)) == 3
    assert OrbaxCheckpoint(logdir / "checkpoints" / "last").leaves
    assert sorted(os.listdir(logdir / "checkpoints")) == [
        "last", "last.meta.json"]


def test_without_an_exchange_the_directory_moves_aside(written, tmp_path):
    logdir = tmp_path / "run"
    shutil.copytree(written["adamw"][0], logdir)
    last = logdir / "checkpoints" / "last"
    aside = last.with_name("last.orbax")
    trainer, state = _port("adamw", logdir)
    # a save cut after the directory moved aside: the loader reads it
    # there, and the next save removes it
    os.rename(last, aside)
    assert trainer._checkpoint("last") == aside
    state, _ = trainer.load_checkpoint(state)
    assert state.step == 3
    trainer.save_checkpoint(state, "last", epoch=1)
    assert last.is_file() and not aside.exists()
    # a save over JAX's directory: it moves aside, the file takes its
    # name, the directory goes
    last.unlink()
    shutil.copytree(written["adamw"][0] / "checkpoints" / "last", last)
    trainer.save_checkpoint(state, "last", epoch=1)
    assert last.is_file() and not aside.exists()
    assert not last.with_name("last.tmp").exists()
    assert torch.load(last, weights_only=True)["step"] == 3
    # a directory orbax did not write is not written over
    (logdir / "checkpoints" / "best").mkdir()
    with pytest.raises(RuntimeError, match="orbax did not write"):
        trainer.save_checkpoint(state, "best")


# ------------------------------------------------ the full-width fixture

def test_interp_256_trainer_fixture_matches_its_manifest():
    path = os.path.join(FIXTURES, "interp_256_trainer_tiled")
    manifest = json.load(open(os.path.join(path, "MANIFEST.json")))
    meta = json.load(open(f"{path}.meta.json"))
    assert meta == {"epoch": manifest["epoch"]} == {
        "epoch": MAKE.TRAINER_EPOCH}
    ckpt = OrbaxCheckpoint(path)
    arrays = {".".join(k for k, _ in keys): v["value_type"]
              for keys, v in ckpt.leaves}
    # optax.adamw's middle state is empty: orbax records None there
    assert arrays.pop("opt_state.1") == "None"
    assert set(arrays) == {m["path"].replace("/", ".")
                           for m in manifest["leaves"]}
    tops = {m["path"].split("/")[0] for m in manifest["leaves"]}
    assert tops == {"step", "params", "opt_state", "ema", "ema_updates",
                    "frozen"}
    small = 0
    for m in manifest["leaves"]:
        name = m["path"].replace("/", ".")
        zarray = json.loads(ckpt.store.read(f"{name}/.zarray"))
        assert np.dtype(zarray["dtype"]).name == m["dtype"]
        assert zarray["shape"] == m["shape"], m
        if np.prod(m["shape"]) <= 4096:  # the counts, biases and norms
            got = ckpt.read_array(name)
            want = (np.asarray(MAKE.TRAINER_STEP, m["dtype"])
                    if m["shape"] == [] else
                    MAKE.trainer_leaf(m["path"], m["shape"]))
            assert got.dtype == want.dtype and got.tobytes() == (
                want.tobytes()), m
            small += 1
    assert small > 1000
    counts = [m["path"] for m in manifest["leaves"] if m["shape"] == []]
    assert sorted(counts) == ["ema_updates", "opt_state/0/count",
                              "opt_state/2/count", "step"]
    # the port's interp_256 trainer takes every leaf by name and shape
    with torch.device("meta"):
        model = build_latent_diffusion("interp_256", device="meta")
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()
            if k.startswith(("unet.", "pose."))}
    for top in ("params", "opt_state/0/mu", "opt_state/0/nu", "ema"):
        got = {torch_key(m["path"][len(top) + 1:]): m["shape"]
               for m in manifest["leaves"]
               if m["path"].startswith(top + "/")}
        assert set(got) == set(want), top
