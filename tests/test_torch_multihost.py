"""Data-parallel training in real processes: two gloo ranks on the CPU.

The test starts its workers by running this file as a script (`python
tests/test_torch_multihost.py MODE RANK WORLD PORT DIR`), as
`tests/multihost_worker.py` does for JAX; each worker joins a two-rank
gloo group through `upgpt_torch.parallel.multihost` (torchrun's
environment variables) and imports no JAX. The parent computes JAX's side
and hands its inputs over as files:

- one train step at global batch 4, 2 rows a rank, from JAX's parameters
  through the bridge, with JAX's draws injected: the loss, `grad_norm`
  and every gradient against JAX's `train_step` at batch 4, at
  tests/test_torch_training.py's tolerances, and against the port's own
  single process (rtol 1e-5); the parameters after the AdamW update as
  moves (see `_moves_agree`), also after an update accumulated over two
  micro-batches (the micro-steps skip DDP's exchange);
- `cli train --multihost` for two epochs of two steps with validation on
  `data/tree.py`'s tree: rank 0 alone writes (rank 1's own logdir is never
  created), `last` equals single-process `cli train`'s, both ranks read
  the same validation means and stop at the same step;
- an exception on rank 1 ends both processes within the group's timeout.

Each subprocess carries its own time limit.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "deepfashion", "interp_256.yaml")
# a worker's wall: torch's import, a tiny model and a few CPU steps
WORKER_TIMEOUT_S = 120
# the failing-rank test's group timeout (multihost.DEFAULT_TIMEOUT_S)
FAIL_TIMEOUT_S = 20
STEP_LR = 1e-3


# ------------------------------------------------------------ the workers


def _dotlist(tree, logdir):
    """`cli train` on the tiny model over a 16x16 tree: global batch 4,
    two steps an epoch, validation every epoch, image logs and weights-only
    snapshots every 2 steps, early stopping after one epoch without gain.
    float32 compute: in the config's bf16 a weight gradient sums two rows'
    bf16 products on a rank and four on one process, which moves it by
    ~1e-5 relative. A learning rate that keeps every AdamW move below
    1e-7: a gradient at rounding level (a one-channel GroupNorm group's
    shift) moves its entry by lr either way on the two sides."""
    splits = ("train", "validation", "test")
    out = [f"data.{s}.params.{k}={tree[v]}" for s in splits
           for k, v in (("folder", "folder"), ("data_file", "data_file"))]
    out += [f"data.{s}.params.{k}={v}" for s in splits
            for k, v in (("image_size", "[16,16]"), ("f", 2))]
    out += [f"data.train.params.pair_file=['{tree['train']}']",
            f"data.validation.params.pair_file=['{tree['validation']}']",
            f"data.test.params.pair_file=['{tree['validation']}']",
            "model.params.variant=tiny", "model.params.device=cpu",
            "model.params.latent_size=(8,8)", "model.params.use_fused_"
            "groupnorm=True", "model.params.dtype=float32",
            "trainer.batch_size=4", "trainer.log_every=1",
            "trainer.max_epochs=3", "trainer.early_stop_patience=0",
            "trainer.base_learning_rate=1e-8",
            "trainer.log_images_every=2", "trainer.image_log_ddim_steps=2",
            "trainer.image_log_progressive_frames=2",
            "trainer.ckpt_every_steps=2", f"trainer.logdir={logdir}"]
    return out


def _worker(mode, rank, world, port, io_dir):
    """One rank: joins the group from torchrun's environment and runs
    `mode`, writing what it saw under `io_dir`."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    sys.path.insert(0, REPO)
    # its import pulls in TensorFlow here (~17 s a process)
    sys.modules["torch.utils.tensorboard"] = None
    import torch

    torch.set_num_threads(1)
    from upgpt_torch.parallel import mesh, multihost

    if mode == "step":
        from upgpt_torch.training.train_state import (
            create_train_state, data_parallel, train_step,
        )
        from upgpt_torch.zoo import build_latent_diffusion

        inputs = torch.load(os.path.join(io_dir, "inputs.pt"),
                            weights_only=True)
        group = multihost.initialize(device="cpu")
        model = build_latent_diffusion("tiny", device="cpu",
                                       use_fused_groupnorm=True)
        model.load_state_dict(inputs["state_dict"])
        state = create_train_state(model, STEP_LR,
                                   scheduler=lambda step: 1.0)
        state.ddp = data_parallel(model)
        batch = mesh.local_rows(inputs["batch"])
        assert batch["image"].shape[0] == 4 // world
        state, metrics = train_step(model, state, batch,
                                    draws=mesh.local_rows(inputs["draws"]))
        # MultiSteps over two micro-batches: the micro-steps skip DDP's
        # exchange and the update averages the ranks' running means
        acc_model = build_latent_diffusion("tiny", device="cpu",
                                           use_fused_groupnorm=True)
        acc_model.load_state_dict(inputs["state_dict"])
        acc = create_train_state(acc_model, STEP_LR,
                                 scheduler=lambda step: 1.0,
                                 accumulate_grad_batches=2)
        acc.ddp = data_parallel(acc_model)
        for draws in (inputs["draws"], inputs["draws2"]):
            acc, _ = train_step(acc_model, acc, batch,
                                draws=mesh.local_rows(draws))
        torch.save({"metrics": {k: v.item() for k, v in metrics.items()},
                    "acc_params": dict(zip(acc.names, (
                        p.detach() for p in acc.params))),
                    "acc_exchanges": acc.ddp.exchange_log.steps,
                    "params": dict(zip(state.names,
                                       (p.detach() for p in state.params))),
                    "grads": dict(zip(state.names,
                                      (p.grad for p in state.params))),
                    "exchanges": state.ddp.exchange_log.steps,
                    "backend": group.backend},
                   os.path.join(io_dir, f"out_{rank}.pt"))
    elif mode == "cli":
        from upgpt_torch import cli
        from upgpt_torch.training import trainer as trainer_mod

        with open(os.path.join(io_dir, "tree.json")) as f:
            tree = json.load(f)
        seen = []
        group_mean = trainer_mod.Trainer._group_mean

        def record(self, metrics):
            out = group_mean(self, metrics)
            seen.append(out)
            return out

        trainer_mod.Trainer._group_mean = record
        logdir = os.path.join(io_dir, f"logdir_{rank}")
        state = cli.main(["train", "--multihost", "--base", CONFIG,
                          "--debug-encoder"] + _dotlist(tree, logdir))
        with open(os.path.join(io_dir, f"out_{rank}.json"), "w") as f:
            json.dump({"step": state.step, "val": seen}, f)
    elif mode == "fail":
        from upgpt_torch import cli
        from upgpt_torch.training import trainer as trainer_mod

        with open(os.path.join(io_dir, "tree.json")) as f:
            tree = json.load(f)
        multihost.DEFAULT_TIMEOUT_S = FAIL_TIMEOUT_S
        train_step = trainer_mod.Trainer._train_step

        def failing(self, state, batch):
            if rank == 1 and state.step == 1:
                raise RuntimeError("rank 1 fails at step 2")
            return train_step(self, state, batch)

        trainer_mod.Trainer._train_step = failing
        cli.main(["train", "--multihost", "--base", CONFIG,
                  "--debug-encoder"] + _dotlist(
                      tree, os.path.join(io_dir, f"logdir_{rank}")))
    assert "jax" not in sys.modules and "upgpt_tpu" not in sys.modules


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
            int(sys.argv[4]), sys.argv[5])
    sys.exit(0)


# ------------------------------------------------------------ the parent

import pytest  # noqa: E402

torch = pytest.importorskip("torch")
torch.set_num_threads(1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(mode, io_dir, world=2):
    """Start `world` workers and wait for them: [(exit code, stderr)],
    and the wall seconds until the last one ended."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(r),
         str(world), str(port), str(io_dir)], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    t0 = time.perf_counter()
    out = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=WORKER_TIMEOUT_S)
            out.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out, time.perf_counter() - t0


def _ok(results):
    for rank, (code, err) in enumerate(results):
        assert code == 0, f"rank {rank} exited {code}:\n{err[-3000:]}"


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    # its import pulls in TensorFlow here (~17 s a process)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _jax_draws(jm, params, batch, key, b):
    """The draws of JAX's `training_loss` on a batch of `b`
    (latent_diffusion.py:342-346)."""
    import jax
    import jax.numpy as jnp

    k_enc, k_t, k_noise = jax.random.split(key, 3)
    post = jm.vae.apply({"params": params["vae"]}, batch["image"],
                        method="encode")
    shape = post.mean.shape
    return {
        "posterior_noise": torch.from_numpy(np.array(
            jax.random.normal(k_enc, shape, post.mean.dtype))),
        "t": torch.from_numpy(np.array(jax.random.randint(
            k_t, (b,), 0, jm.schedule.num_timesteps))).long(),
        "noise": torch.from_numpy(np.array(
            jax.random.normal(k_noise, shape, jnp.float32))),
    }


def _moves_agree(after, want, before, lr, noise):
    """Parameters after one AdamW update, compared as moves from
    `before`. Adam's first update is about lr * sign(g), so an entry whose
    gradient is at rounding level moves by up to lr either way on two
    sides that sum in different orders. The leaves in
    `noise` have a gradient that is zero up to rounding (at this width a
    per-channel shift before a one-channel GroupNorm group moves nothing):
    their moves are noise and are not compared. Elsewhere at most 1e-3 of
    the entries may differ past 1e-3 * lr, none past 2 * lr."""
    n = off = 0
    for name, b in before.items():
        if name in noise:
            continue
        d = ((after[name] - b) - (want[name] - b)).abs()
        assert d.max() <= 2 * lr, (name, d.max().item())
        n += d.numel()
        off += int((d > 1e-3 * lr).sum())
    assert off <= 1e-3 * n, (off, n)
    return off


def test_two_ranks_step_as_jax_and_as_one_process(tmp_path):
    import jax
    from test_torch_training import _random_params

    from upgpt_tpu.training import train_state as jts
    from upgpt_tpu.zoo import build_latent_diffusion as jax_build
    from upgpt_torch.convert.from_jax import (
        flatten_tree, load_jax_params, torch_array, torch_key,
    )
    from upgpt_torch.training.train_state import (
        create_train_state, train_step,
    )
    from upgpt_torch.zoo import build_latent_diffusion

    b = 4
    jm = jax_build("tiny", use_flash_attention=False)
    params = _random_params(
        jax.eval_shape(jm.init_params, jax.random.PRNGKey(0)), seed=0)
    rng = np.random.default_rng(1)
    h, w = jm.config.latent_size
    batch = {
        "image": rng.uniform(-1.0, 1.0, size=(b, 2 * h, 2 * w, 3)),
        "person_mask": rng.choice([-1.0, -0.99215686], size=(b, h, w, 1)),
        "text_emb": rng.normal(size=(b, 77, 768)),
        "style_emb": rng.normal(size=(b, 9, 768)),
        "smpl": rng.normal(size=(b, 1, 85)),
        "loss_w": rng.uniform(0.5, 1.5, size=(b, h, w, 1)),
    }
    batch = {k: v.astype(np.float32) for k, v in batch.items()}
    trainable = {k: v for k, v in params.items() if k != "vae"}
    frozen = {"vae": params["vae"]}
    key = jax.random.PRNGKey(3)
    jstate = jts.create_train_state(trainable, learning_rate=STEP_LR,
                                    scheduler=lambda step: 1.0)
    jstate, jmetrics = jax.jit(jts.train_step, static_argnums=0)(
        jm, jstate, frozen, batch, key)
    # the step's draws: train_step folds the step (0) into the key
    draws = _jax_draws(jm, params, batch, jax.random.fold_in(key, 0), b)
    adam = [s for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(s, "mu")]
    jgrads = {torch_key(k): torch_array(k, np.asarray(m) / 0.1)
              for k, m in flatten_tree(adam[0].mu).items()}
    jparams = {torch_key(k): torch_array(k, np.asarray(a))
               for k, a in flatten_tree(jstate.params).items()}

    model = load_jax_params(build_latent_diffusion(
        "tiny", device="cpu", use_fused_groupnorm=True), params)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    # a second micro-batch's draws for the accumulation case
    draws2 = {"posterior_noise": -draws["posterior_noise"],
              "t": draws["t"].flip(0), "noise": draws["noise"].flip(0)}
    torch.save({"state_dict": model.state_dict(), "batch": tbatch,
                "draws": draws, "draws2": draws2}, tmp_path / "inputs.pt")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    acc_model = load_jax_params(build_latent_diffusion(
        "tiny", device="cpu", use_fused_groupnorm=True), params)
    results, _ = _run_ranks("step", tmp_path)
    _ok(results)
    # the port's single process on the same weights, batch and draws
    state = create_train_state(model, STEP_LR, scheduler=lambda step: 1.0)
    state, single = train_step(model, state, tbatch, draws=draws)
    one = {"params": dict(zip(state.names, state.params)),
           "grads": dict(zip(state.names, (p.grad for p in state.params)))}
    before = {n: before[n] for n in state.names}
    total = float(jmetrics["grad_norm"])
    noise = {n for n, g in jgrads.items() if np.linalg.norm(g) < 1e-6 * total}
    outs = [torch.load(tmp_path / f"out_{r}.pt", weights_only=True)
            for r in range(2)]
    for out in outs:
        assert out["backend"] == "gloo"
        # DDP's buckets carry every trainable float32 gradient once
        (step,) = out["exchanges"]
        assert sum(step) == 4 * sum(p.numel() for p in state.params)
        for k in ("loss", "loss_simple", "loss_vlb", "grad_norm"):
            np.testing.assert_allclose(out["metrics"][k], float(jmetrics[k]),
                                       rtol=1e-5, err_msg=k)
            np.testing.assert_allclose(out["metrics"][k], single[k].item(),
                                       rtol=1e-5, err_msg=k)
        for name, want in jgrads.items():
            got = out["grads"][name].numpy()
            if name in noise:
                # a one-channel GroupNorm group's shift: zero up to noise
                assert np.linalg.norm(got) < 1e-6 * total, name
                continue
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel <= 1e-4, (name, rel)
            np.testing.assert_allclose(
                got, one["grads"][name].detach().numpy(), rtol=1e-5,
                atol=1e-5 * np.abs(want).max(), err_msg=name)
        _moves_agree(out["params"], {k: torch.from_numpy(np.array(v))
                                     for k, v in jparams.items()},
                     before, STEP_LR, noise)
        _moves_agree(out["params"], {k: v.detach() for k, v in
                                     one["params"].items()},
                     before, STEP_LR, noise)
    # the two ranks hold one state
    for name in state.names:
        assert torch.equal(outs[0]["params"][name], outs[1]["params"][name])
        assert torch.equal(outs[0]["acc_params"][name],
                           outs[1]["acc_params"][name])
    # accumulation: one process at batch 4 over the same two micro-batches
    acc = create_train_state(acc_model, STEP_LR, scheduler=lambda step: 1.0,
                             accumulate_grad_batches=2)
    for d in (draws, draws2):
        acc, _ = train_step(acc_model, acc, tbatch, draws=d)
    assert outs[0]["acc_exchanges"] == []  # DDP's exchange never ran
    _moves_agree(outs[0]["acc_params"],
                 {n: p.detach() for n, p in zip(acc.names, acc.params)},
                 before, STEP_LR, noise)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from upgpt_torch.data.tree import write_fashion_tree

    # 3 + 1 * 5 (men_factor) = 8 training pairs: two global batches of 4
    return write_fashion_tree(tmp_path_factory.mktemp("fashion"),
                              {"train": (3, 1), "validation": (8, 0)},
                              image_hw=(16, 16), seed=2)


def test_cli_train_multihost_writes_from_rank_0_and_matches_one_process(
        tree, tmp_path):
    from upgpt_torch import cli
    from upgpt_torch.checkpoint import read_weights
    from upgpt_torch.training import trainer as trainer_mod

    (tmp_path / "tree.json").write_text(json.dumps(tree))
    results, _ = _run_ranks("cli", tmp_path)
    _ok(results)
    outs = [json.loads((tmp_path / f"out_{r}.json").read_text())
            for r in range(2)]
    # every rank read the same averaged validation means, so both took
    # the same best and early-stopping decisions and stopped together
    assert outs[0] == outs[1]
    for rank, (_, err) in enumerate(results):
        assert f"rank {rank}/2 (local {rank}/2) on cpu, backend gloo" in err
        summary = json.loads(err.split("multihost summary ")[1].split(
            "\n")[0])
        assert summary["rank"] == rank and summary["global_batch"] == 4
        assert summary["exchanges_per_step"] >= 1
    # rank 1 wrote nothing: its logdir was never created
    assert not (tmp_path / "logdir_1").exists()
    run = tmp_path / "logdir_0"
    snaps = [f"trainstep_{s:09d}" for s in range(2, outs[0]["step"] + 1, 2)]
    assert sorted(os.listdir(run / "checkpoints")) == sorted(
        ["best", "best.meta.json", "last", "last.meta.json"] + snaps
        + [f"{s}.meta.json" for s in snaps])
    assert (run / "configs" / "merged.json").exists()
    assert {p.split("_")[0] for p in os.listdir(run / "images")} >= {
        "samples", "progressive"}
    records = [json.loads(x) for x in open(run / "metrics.jsonl")]
    steps = [r["step"] for r in records if "loss" in r]
    assert steps == list(range(1, outs[0]["step"] + 1))

    # one process at the same global batch: the same run
    seen = []
    group_mean = trainer_mod.Trainer._group_mean

    def record(self, metrics):
        out = group_mean(self, metrics)
        seen.append(out)
        return out

    ref = tmp_path / "single"
    trainer_mod.Trainer._group_mean = record
    try:
        state = cli.main(["train", "--base", CONFIG, "--debug-encoder"]
                         + _dotlist(tree, ref))
    finally:
        trainer_mod.Trainer._group_mean = group_mean
    assert state.step == outs[0]["step"] and len(seen) == len(outs[0]["val"])
    for got, want in zip(outs[0]["val"], seen):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=k)
    single = [json.loads(x) for x in open(ref / "metrics.jsonl")]
    for a, b in zip(records, single):
        for k in ("loss", "loss_simple", "grad_norm"):
            if k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
    got, got_vae = read_weights(str(run / "checkpoints" / "last"), "cpu")
    want, want_vae = read_weights(str(ref / "checkpoints" / "last"), "cpu")
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    for name in want_vae:
        assert torch.equal(got_vae[name], want_vae[name]), name


def test_a_failing_rank_ends_both_within_the_group_timeout(tree, tmp_path):
    (tmp_path / "tree.json").write_text(json.dumps(tree))
    results, seconds = _run_ranks("fail", tmp_path)
    assert results[1][0] != 0 and "rank 1 fails at step 2" in results[1][1]
    # rank 0 was waiting in the exchange of step 2: it raises, saves
    # `last` (rank 0's save on exception) and exits
    assert results[0][0] != 0, results[0][1][-2000:]
    assert seconds < FAIL_TIMEOUT_S + 60, seconds
    assert (tmp_path / "logdir_0" / "checkpoints" / "last").exists()
    assert not (tmp_path / "logdir_1").exists()


def test_multihost_without_a_cluster_trains_as_one_process(tree, tmp_path,
                                                           monkeypatch):
    from upgpt_torch import cli
    from upgpt_torch.checkpoint import read_weights
    from upgpt_torch.parallel import multihost

    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    runs = {}
    for tag, flags in (("multihost", ["--multihost"]), ("plain", [])):
        args = ["train"] + flags + ["--base", CONFIG, "--debug-encoder"] + \
            _dotlist(tree, tmp_path / tag) + ["trainer.max_epochs=1"]
        state = cli.main(args)
        assert state.ddp is None and multihost.group() is None
        runs[tag] = read_weights(str(tmp_path / tag / "checkpoints" / "last"),
                                 "cpu")[0]
    for name, want in runs["plain"].items():
        assert torch.equal(runs["multihost"][name], want), name
