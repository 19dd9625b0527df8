"""The port's trainer against the JAX package's, and against itself, on
the CPU.

- `FusedTrainState` against JAX's `create_fused_train_state`, and
  accumulation (k = 2) against `optax.MultiSteps`, on the same parameters
  (through the bridge) and the same numpy gradients: float32 moments,
  parameters and shadow at rtol 1e-6 with an absolute floor of 1e-6 of the
  leaf's largest value (b * m + (1 - b) * g and p - lr * update cancel
  where their terms are close, and there the two sides' last bits, one
  contracting a multiply and an add, show relatively larger);
  bf16 moments within one bf16 step of JAX's, and with them a float32
  shadow against a float32 recomputation where JAX keeps a bf16 one (the
  reference fault R1); the EMA and the LR schedule's count pinned; the
  shadow moving at decay 0.9999 with either moment dtype.
- The transport, the LR rule and `TrainerConfig` against JAX's.
- `Trainer.fit` on the `tiny` model over a DeepFashion-shaped tree at
  16x16 (an 8x8 latent): equal to a hand loop of `train_step` on the same
  batches and draws, bit for bit; a run interrupted at an epoch and
  resumed equal to the uninterrupted run, bit for bit; and the JAX
  trainer tests' behaviour (async save failures surface on the next join,
  weights-only snapshots, SIGUSR2, image grids, wandb and TensorBoard
  streams, the frozen VAE in every checkpoint).

TensorBoard is blocked in every test but its own: its import pulls in
TensorFlow here (~17 s a process).
"""

import dataclasses
import json
import signal
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from upgpt_tpu.training import lr as jlr  # noqa: E402
from upgpt_tpu.training import train_state as jts  # noqa: E402
from upgpt_tpu.training import trainer as jtrainer  # noqa: E402
from upgpt_tpu.zoo import build_latent_diffusion as jax_build  # noqa: E402
from upgpt_torch.checkpoint import load_checkpoint, read_weights  # noqa: E402
from upgpt_torch.convert.from_jax import (  # noqa: E402
    flatten_tree, load_jax_params, torch_array, torch_key,
)
from upgpt_torch.data.deepfashion import (  # noqa: E402
    DataLoader, DeepFashionPair,
)
from upgpt_torch.data.tree import write_fashion_tree  # noqa: E402
from upgpt_torch.inference.encoders import (  # noqa: E402
    DebugConditioningEncoder,
)
from upgpt_torch.models.unet import UNetConfig  # noqa: E402
from upgpt_torch.training import ema as tema  # noqa: E402
from upgpt_torch.training import lr as tlr  # noqa: E402
from upgpt_torch.training import trainer as ttrainer  # noqa: E402
from upgpt_torch.training.train_state import (  # noqa: E402
    create_fused_train_state, create_train_state, train_step,
)
from upgpt_torch.training.trainer import (  # noqa: E402
    Trainer, TrainerConfig, decode_transport, encode_transport, step_seed,
)
from upgpt_torch.zoo import build_latent_diffusion  # noqa: E402


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


# ------------------------------------------------ optimizer against JAX

SMALL = dict(in_channels=5, model_channels=32, out_channels=4,
             num_res_blocks=1, attention_resolutions=(), channel_mult=(1,),
             num_heads=4, context_dim=768)
SCHED = ([2], [1.0], [1.0], [0.1], [10**13])


def _random_params(shapes, seed):
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            return rng.normal(size=leaf.shape) / np.sqrt(
                int(np.prod(leaf.shape[:-1])))
        return (1.0 if "scale" in name else 0.0) + 0.1 * rng.normal(
            size=leaf.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(draw(p, a), jnp.float32), shapes)


@pytest.fixture(scope="module")
def small():
    """A one-level U-Net's parameters on both sides (the update is per
    leaf, so the width does not matter)."""
    from upgpt_tpu.models.unet import UNetConfig as JaxUNetConfig

    jm = jax_build("tiny", use_flash_attention=False,
                   unet=JaxUNetConfig(**SMALL))
    params = _random_params(
        jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)), seed=4)
    return {k: v for k, v in params.items() if k != "vae"}, params


def _port(params):
    return load_jax_params(build_latent_diffusion(
        "tiny", device="cpu", unet=UNetConfig(**SMALL)), params)


def _feed(state, g) -> None:
    by_name = dict(zip(state.names, state.params))
    for jk, a in flatten_tree(g).items():
        by_name[torch_key(jk)].grad = torch.from_numpy(
            np.array(torch_array(jk, a)))


def _pairs(tree, port: dict):
    """(port tensor as numpy, JAX array in the port's layout) per leaf."""
    return [(port[torch_key(jk)].detach().float().numpy(),
             np.asarray(torch_array(jk, a), np.float32))
            for jk, a in flatten_tree(tree).items()]


def _bf16_step(x: np.ndarray) -> np.ndarray:
    """One bf16 step (ulp) at each value's magnitude."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("moments,use_ema", [("float32", True),
                                             ("bfloat16", True),
                                             ("float32", False)])
def test_fused_train_state_matches_jax(small, moments, use_ema):
    trainable, params = small
    jstate = jts.create_fused_train_state(
        trainable, 1e-3, scheduler=jlr.lambda_linear_schedule(*SCHED),
        use_ema=use_ema, ema_decay=0.999,
        moment_dtype=getattr(jnp, moments))
    state = create_fused_train_state(
        _port(params), 1e-3, scheduler=tlr.lambda_linear_schedule(*SCHED),
        use_ema=use_ema, ema_decay=0.999, moment_dtype=moments)
    assert state.mu[0].dtype == getattr(torch, moments)
    rng = np.random.default_rng(5)
    apply = jax.jit(lambda s, g: s.apply_gradients(g))
    # the shadow recomputed in float32 from the port's parameters after
    # each update: s <- s - (1 - decay_n) * (s - p)
    shadow = [p.detach().float().numpy().copy() for p in state.params]
    for n in range(1, 4):
        g = jax.tree.map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), trainable)
        _feed(state, g)
        jstate = apply(jstate, g)
        state.apply_gradients()
        w = np.float32(1.0) - np.float32(tema.ema_decay(n, 0.999))
        shadow = [s - w * (s - p.detach().float().numpy())
                  for s, p in zip(shadow, state.params)]
    trees = [(jstate.params, state.params),
             (jstate.opt_state["mu"], state.mu),
             (jstate.opt_state["nu"], state.nu)]
    if use_ema and moments == "float32":
        trees.append((jstate.ema.shadow, state.ema.shadow))
    elif use_ema:
        # the divergence from JAX (the reference fault R1): JAX keeps the
        # shadow in bf16 beside bf16 moments, where it freezes at decay
        # 0.9999; the port keeps it in float32, held to the recomputation
        assert {s.dtype for s in state.ema.shadow} == {torch.float32}
        assert {str(a.dtype) for a in jax.tree.leaves(jstate.ema.shadow)
                } == {"bfloat16"}
        for got, want in zip(state.ema.shadow, shadow):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())
    for i, (tree, port) in enumerate(trees):
        for got, want in _pairs(tree, dict(zip(state.names, port))):
            if moments == "float32":
                # b * m + (1 - b) * g and p - lr * update cancel where their
                # terms are close: the last bit of the operands, not of the
                # result, shows there
                np.testing.assert_allclose(
                    got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
            elif i == 0:
                # float32 masters moved by updates of bf16 moments: one
                # bf16 step of the normalised update (~1) a step, times lr
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=3 * 1e-3 * 2.0 ** -7)
            else:
                assert (np.abs(got - want) <= _bf16_step(want)).all()
    assert state.step == int(jstate.step) == 3
    if use_ema:
        assert state.ema.num_updates == int(jstate.ema.num_updates) == 3
    else:
        assert state.ema is None and jstate.ema is None


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_fused_ema_shadow_moves_at_decay_0_9999(moments):
    """A shadow at 1.0 behind a parameter held at 1.05 (zero gradients, no
    weight decay) moves toward it at decay 0.9999: 1.05 - 0.05 * 0.9999^n
    after n updates. A bf16 shadow stays at 1.0, since each update (5e-6)
    is below half a bf16 step at 1.0 (R1)."""
    model = torch.nn.Module()
    model.vae = torch.nn.Linear(1, 1)
    model.unet = torch.nn.Linear(1, 1, bias=False)
    with torch.no_grad():
        model.unet.weight.fill_(1.05)
    state = create_fused_train_state(model, 1e-3, scheduler=lambda s: 1.0,
                                     ema_decay=0.9999, weight_decay=0.0,
                                     moment_dtype=moments)
    state.ema.shadow[0].fill_(1.0)
    state.ema.num_updates = 10**6  # past the warm-up: the decay is 0.9999
    for _ in range(10_000):
        state.apply_gradients()
    got = state.ema.shadow[0].item()
    want = 1.05 - 0.05 * 0.9999 ** 10_000
    assert state.ema.shadow[0].dtype == torch.float32
    assert model.unet.weight.item() == np.float32(1.05)
    assert abs(got - want) < 1e-4, (got, want)


def test_accumulation_matches_optax_multisteps(small):
    trainable, params = small
    jstate = jts.create_train_state(
        trainable, learning_rate=1e-3,
        scheduler=jlr.lambda_linear_schedule(*SCHED),
        accumulate_grad_batches=2)
    state = create_train_state(
        _port(params), learning_rate=1e-3,
        scheduler=tlr.lambda_linear_schedule(*SCHED),
        accumulate_grad_batches=2)
    shadow = dict(zip(state.names, state.ema.shadow))
    rng = np.random.default_rng(6)
    apply = jax.jit(lambda s, g: s.apply_gradients(g))
    for call in range(4):
        g = jax.tree.map(
            lambda a: rng.normal(size=a.shape).astype(np.float32), trainable)
        _feed(state, g)
        jstate = apply(jstate, g)
        state.apply_gradients()
        # parameters move on every second call; the EMA on every call
        for tree, port in ((jstate.params,
                            dict(zip(state.names, state.params))),
                           (jstate.ema.shadow, shadow)):
            for got, want in _pairs(tree, port):
                np.testing.assert_allclose(got, want, atol=1e-6)
        assert state.step == int(jstate.step) == call + 1
        assert state.ema.num_updates == int(jstate.ema.num_updates)
        # the LR schedule's count: optimizer updates applied
        assert state.updates == int(jstate.opt_state.gradient_step) == (
            (call + 1) // 2)
        assert state.mini_step == int(jstate.opt_state.mini_step)


def test_fused_optimizer_refuses_accumulation(tmp_path):
    cfg = TrainerConfig(fused_optimizer=True, accumulate_grad_batches=2,
                        logdir=str(tmp_path))
    trainer = Trainer(build_latent_diffusion("tiny", device="cpu"), cfg,
                      DebugConditioningEncoder())
    with pytest.raises(ValueError, match="does not compose"):
        trainer.fit([], None)


# ------------------------------------------------ transport, rules, config


def test_transport_round_trip_is_exact_and_matches_jax():
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, (2, 16, 12, 3)).astype(np.float32) / 255.0
    image = image * 2.0 - 1.0  # the dataset's arithmetic
    bbox = rng.choice(np.float32([-1.0, -0.99215686]), (2, 4, 3, 1))
    smpl_rpm = rng.uniform(-1, 1, (2, 4, 3, 1)).astype(np.float32)
    emb = rng.normal(size=(2, 77, 768)).astype(np.float32)
    batch = {"image": image, "person_mask": bbox, "text_emb": emb,
             "smpl": rng.normal(size=(2, 1, 85)).astype(np.float32)}
    memo, jmemo = {}, {}
    ours, theirs = (encode_transport(batch, memo),
                    jtrainer.encode_transport(batch, jmemo))
    assert memo == jmemo == {"image": True, "person_mask": True}
    for k in ("image", "person_mask", "smpl"):
        assert ours[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(ours[k], theirs[k])
    assert ours["text_emb"].dtype == torch.bfloat16
    np.testing.assert_array_equal(ours["text_emb"].float().numpy(),
                                  np.asarray(theirs["text_emb"], np.float32))
    back = decode_transport({k: torch.as_tensor(v) for k, v in ours.items()})
    for k in ("image", "person_mask", "smpl"):
        assert back[k].dtype == torch.float32
        np.testing.assert_array_equal(back[k].numpy(), batch[k])
    np.testing.assert_array_equal(back["text_emb"].numpy(), np.asarray(
        jtrainer.decode_transport(theirs)["text_emb"]))
    # a continuous mask ships float32, and the memo keeps that decision
    memo = {}
    out = encode_transport({"person_mask": smpl_rpm}, memo)
    assert memo == {"person_mask": False}
    assert out["person_mask"].dtype == np.float32
    assert encode_transport({"person_mask": bbox}, memo)[
        "person_mask"].dtype == np.float32


def test_rules_and_config_match_jax():
    from upgpt_torch.training.train_state import scaled_learning_rate

    for args in ((2e-6, 12, 4, 2, True), (2e-6, 12, 4, 2, False),
                 (1e-4, 3, 1, 1, True)):
        assert scaled_learning_rate(*args) == jts.scaled_learning_rate(*args)
    ours = [(f.name, f.default) for f in dataclasses.fields(TrainerConfig)]
    theirs = [(f.name, f.default)
              for f in dataclasses.fields(jtrainer.TrainerConfig)]
    assert ours == theirs
    assert step_seed(43, 0) != step_seed(43, 1) != step_seed(44, 1)


def test_transfer_prefetch_early_break_stops_producer():
    import threading
    import time

    closed = {"flag": False}

    def src():
        try:
            i = 0
            while True:
                yield i
                i += 1
        finally:
            closed["flag"] = True

    before = threading.active_count()
    it = ttrainer.transfer_prefetch(src(), lambda d: d * 10, depth=2)
    assert [next(it), next(it)] == [0, 10]
    it.close()
    deadline = time.time() + 5
    while time.time() < deadline and (threading.active_count() > before
                                      or not closed["flag"]):
        time.sleep(0.05)
    assert closed["flag"] and threading.active_count() <= before

    def bad():
        yield 1
        raise OSError("disk")

    with pytest.raises(OSError, match="disk"):
        list(ttrainer.transfer_prefetch(bad(), lambda d: d))


# ------------------------------------------------ Trainer.fit, tiny, CPU


@pytest.fixture(scope="module")
def loaders(tmp_path_factory):
    tree = write_fashion_tree(tmp_path_factory.mktemp("fashion"),
                              {"train": (1, 1), "validation": (2, 0)},
                              image_hw=(16, 16), seed=1)

    def ds(split, **kw):
        return DeepFashionPair(
            folder=tree["folder"], image_dir="img_256",
            pair_file=[tree[split]], data_file=tree["data_file"],
            image_size=(16, 16), f=2, input_mask_type="bbox",
            loss_weight={"face": 5.0}, **kw)

    train = DataLoader(ds("train", men_factor=4, compact=True), 2,
                       shuffle=True)
    val = DataLoader(ds("validation"), 2, shuffle=False)
    assert len(train) == 3 and len(val) == 1
    return train, val


def _model(seed: int = 0):
    torch.manual_seed(seed)
    return build_latent_diffusion("tiny", device="cpu", latent_size=(8, 8),
                                  param_dtype="float32")


def _config(tmp_path, **kw):
    base = dict(base_learning_rate=1e-4, scale_lr=False, batch_size=2,
                max_epochs=2, log_every=1, log_images_every=None,
                logdir=str(tmp_path / "run"), early_stop_patience=None,
                warm_up_steps=2, compact_transport=True)
    base.update(kw)
    return TrainerConfig(**base)


def _snapshot(state):
    out = [p.detach().clone() for p in state.params]
    if state.ema is not None:
        out += [s.clone() for s in state.ema.shadow]
    return out


def test_fit_equals_a_hand_loop_of_train_step(tmp_path, loaders):
    train, val = loaders
    cfg = _config(tmp_path)
    trainer = Trainer(_model(), cfg, DebugConditioningEncoder())
    fitted = _snapshot(trainer.fit(train, val))

    model = _model()
    hand = Trainer(model, _config(tmp_path / "hand"),
                   DebugConditioningEncoder())
    state = create_train_state(model, hand.learning_rate, hand.scheduler,
                               ema_decay=cfg.ema_decay)
    for epoch in range(cfg.max_epochs):
        for raw in train.epoch(epoch):
            batch = {k: torch.as_tensor(v) if isinstance(v, np.ndarray)
                     else v for k, v in hand.host_encode(raw).items()}
            gen = torch.Generator().manual_seed(step_seed(cfg.seed + 1,
                                                          state.step))
            state, _ = train_step(model, state, decode_transport(batch), gen)
    assert state.step == 2 * len(train)
    assert all(torch.equal(a, b) for a, b in zip(fitted, _snapshot(state)))


@pytest.mark.parametrize("optimizer", ["adamw", "fused_bf16", "accumulate"])
def test_resumed_fit_equals_uninterrupted(tmp_path, loaders, optimizer):
    train, val = loaders
    kw = {"adamw": {}, "accumulate": {"accumulate_grad_batches": 2},
          "fused_bf16": {"fused_optimizer": True,
                         "moment_dtype": "bfloat16"}}[optimizer]
    # validation (which must not move the state) in one case, for time
    val = val if optimizer == "adamw" else None
    whole = Trainer(_model(), _config(tmp_path / "whole", **kw),
                    DebugConditioningEncoder()).fit(train, val)
    Trainer(_model(), _config(tmp_path / "cut", max_epochs=1, **kw),
            DebugConditioningEncoder()).fit(train, val)
    # another start: every weight, the VAE too, must come from `last`
    resumed = Trainer(_model(seed=9), _config(tmp_path / "cut", **kw),
                      DebugConditioningEncoder()).fit(train, val,
                                                      resume=True)
    assert resumed.step == whole.step == 2 * len(train)
    assert all(torch.equal(a, b)
               for a, b in zip(_snapshot(whole), _snapshot(resumed)))
    opt_w, opt_r = whole.opt_state(), resumed.opt_state()
    if optimizer == "fused_bf16":
        assert all(torch.equal(a, b) for a, b in zip(
            opt_w["mu"] + opt_w["nu"], opt_r["mu"] + opt_r["nu"]))
    else:
        sw, sr = opt_w["optimizer"]["state"], opt_r["optimizer"]["state"]
        assert all(torch.equal(sw[i][k], sr[i][k])
                   for i in sw for k in sw[i])
        assert whole.updates == resumed.updates
    lines = [json.loads(x) for x in open(tmp_path / "cut" / "run"
                                         / "metrics.jsonl")]
    assert [r["step"] for r in lines if "loss" in r] == list(range(1, 7))


def test_checkpoints_carry_the_vae_and_serve_the_ema(tmp_path, loaders):
    train, val = loaders
    model = _model()
    trainer = Trainer(model, _config(tmp_path, max_epochs=1),
                      DebugConditioningEncoder())
    state = trainer.fit(train, val)
    last = tmp_path / "run" / "checkpoints" / "last"
    meta = json.loads((tmp_path / "run" / "checkpoints"
                       / "last.meta.json").read_text())
    assert meta == {"epoch": 1}
    weights, vae = read_weights(last)
    assert all(torch.equal(weights[n], s)
               for n, s in zip(state.names, state.ema.shadow))
    assert all(torch.equal(v, model.vae.state_dict()[k])
               for k, v in vae.items())
    # cli sample's loader: the EMA weights, strictly, into a bf16 model
    served = load_checkpoint(build_latent_diffusion(
        "tiny", device="cpu", latent_size=(8, 8), dtype="bfloat16"), last)
    name = state.names[0]
    assert torch.equal(dict(served.named_parameters())[name],
                       weights[name].bfloat16())
    # a trainer checkpoint without its VAE is refused, as JAX refuses it
    payload = torch.load(last, weights_only=True)
    payload.pop("frozen")
    torch.save(payload, tmp_path / "no_vae")
    with pytest.raises(RuntimeError, match="no VAE"):
        load_checkpoint(_model(), tmp_path / "no_vae")
    # ... and so is a resume from it with no VAE passed
    torch.save(payload, last)
    with pytest.raises(RuntimeError, match="frozen first-stage"):
        Trainer(_model(), _config(tmp_path, max_epochs=2),
                DebugConditioningEncoder()).fit(train, None, resume=True)


def test_async_save_failure_surfaces_on_next_join(tmp_path):
    model = _model()
    trainer = Trainer(model, _config(tmp_path), DebugConditioningEncoder())
    state = create_train_state(model, 1e-4)

    def boom(payload, path):
        raise OSError("disk full")

    trainer._write = boom
    trainer.save_checkpoint(state, "last", epoch=1, wait=False)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        trainer._join_pending_save()
    trainer._join_pending_save()  # reported once, then cleared


def test_snapshots_sigusr2_and_image_grids(tmp_path, loaders, capfd):
    train, val = loaders
    cfg = _config(tmp_path, max_epochs=1, ckpt_every_steps=1,
                  log_images_every=3, image_log_ddim_steps=4,
                  image_log_progressive_frames=3)
    trainer = Trainer(_model(), cfg, DebugConditioningEncoder())
    orig = signal.getsignal(signal.SIGUSR2)
    try:
        state = trainer.fit(train, val)
        handler = signal.getsignal(signal.SIGUSR2)
        assert callable(handler) and handler is not orig
        handler(signal.SIGUSR2, None)
    finally:
        signal.signal(signal.SIGUSR2, orig)
        signal.signal(signal.SIGUSR1, signal.SIG_DFL)
    assert "SIGUSR2: dumping thread stacks" in capfd.readouterr().err
    ckpts = tmp_path / "run" / "checkpoints"
    snaps = sorted(p.name for p in ckpts.iterdir()
                   if p.name.startswith("trainstep_")
                   and not p.name.endswith(".json"))
    assert snaps == [f"trainstep_{s:09d}" for s in range(1, state.step + 1)]
    raw = torch.load(ckpts / snaps[-1], weights_only=True)
    assert "params" in raw and "frozen" in raw and "opt_state" not in raw
    from PIL import Image

    images = tmp_path / "run" / "images"
    for kind in ("samples", "progressive", "src_image", "smpl_image",
                 "styles"):
        assert (images / f"{kind}_00000003.png").exists(), kind
    w, h = Image.open(images / "progressive_00000003.png").size
    assert (w, h) == (3 * 16, 2 * 16)  # 3 frames a row, a row per sample


def test_wandb_and_tensorboard_streams(tmp_path, loaders, monkeypatch):
    calls = {"init": [], "log": [], "finish": 0, "scalar": [], "image": []}

    class _Run:
        def log(self, scalars, step=None):
            calls["log"].append((dict(scalars), step))

        def finish(self):
            calls["finish"] += 1

    class _Writer:
        def __init__(self, logdir):
            pass

        def add_scalar(self, tag, value, step):
            calls["scalar"].append((tag, step))

        def add_image(self, tag, img, step, dataformats):
            calls["image"].append((tag, img.shape, dataformats))

        def flush(self):
            pass

    wandb = types.ModuleType("wandb")
    wandb.init = lambda **kw: (calls["init"].append(kw), _Run())[1]
    tb = types.ModuleType("torch.utils.tensorboard")
    tb.SummaryWriter = _Writer
    monkeypatch.setitem(sys.modules, "wandb", wandb)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", tb)
    train, val = loaders
    cfg = _config(tmp_path, max_epochs=1, wandb=True, log_images_every=3,
                  image_log_ddim_steps=2, image_log_progressive_frames=0)
    Trainer(_model(), cfg, DebugConditioningEncoder()).fit(train, val)
    assert calls["init"][0]["project"] == "upgpt-tpu"
    assert calls["init"][0]["config"]["batch_size"] == 2
    assert calls["finish"] == 1
    logged = set().union(*(set(s) for s, _ in calls["log"]))
    assert "loss_simple" in logged and "val/loss_simple_ema" in logged
    assert all(isinstance(st, int) for _, st in calls["log"])
    assert ("loss", 1) in calls["scalar"]
    assert ("images/samples", (16, 64, 3), "HWC") in calls["image"]

    # without the package, wandb degrades to the jsonl log
    monkeypatch.setitem(sys.modules, "wandb", None)
    trainer = Trainer(_model(), _config(tmp_path / "b", max_epochs=1,
                                        wandb=True),
                      DebugConditioningEncoder())
    assert trainer._wandb is None
    assert trainer.fit(train, None).step == len(train)
