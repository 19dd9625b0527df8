"""`upgpt_torch.parallel` in one process, on the CPU, tiny geometry.

- `host_local_slice` against JAX's for every (index, count) up to 4, and
  R16: JAX checks an uneven split with a bare `assert`, which `python -O`
  drops; the port raises `ValueError` under -O too;
- `local_rows` over a tree of batches and draws;
- each rank's batches of the port's loaders against JAX's
  `DataLoader(process_index=...)` over one tree, the same permutation per
  epoch on every rank and the short tail wrap-padded, bit for bit;
- `multihost.initialize`: a no-op without a cluster environment, the
  backend choice (NCCL with a card per local rank, gloo on the CPU and for
  ranks sharing a card), its refusals;
- a one-rank gloo group in this process: DDP's train step equals the plain
  step bit for bit, through the wrapper's forward (the exchange runs and
  carries every trainable gradient once), with MultiSteps accumulation
  skipping the exchange between updates; every trainable parameter gets a
  gradient, so DDP runs without the unused-parameter search.
"""

import ast
import inspect
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from upgpt_tpu.data import deepfashion as jdf  # noqa: E402
from upgpt_tpu.parallel import mesh as jmesh  # noqa: E402
from upgpt_torch.data import deepfashion as tdf  # noqa: E402
from upgpt_torch.data.tree import write_fashion_tree  # noqa: E402
from upgpt_torch.parallel import mesh, multihost  # noqa: E402
from upgpt_torch.training.train_state import (  # noqa: E402
    create_train_state, data_parallel, train_step, trainable_parameters,
)
from upgpt_torch.zoo import build_latent_diffusion  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (16, 16)


@pytest.mark.parametrize("count", [1, 2, 3, 4])
def test_host_local_slice_matches_jax(count):
    for index in range(count):
        for batch in (count, 2 * count, 12 * count):
            assert (mesh.host_local_slice(batch, index, count)
                    == jmesh.host_local_slice(batch, index, count))


def test_r16_uneven_split_raises_value_error_where_jax_asserts():
    with pytest.raises(ValueError, match="does not split over 2"):
        mesh.host_local_slice(5, 0, 2)
    with pytest.raises(ValueError, match=r"process_index 2 outside"):
        mesh.host_local_slice(4, 2, 2)
    with pytest.raises(AssertionError):
        jmesh.host_local_slice(5, 0, 2)
    # JAX's check is an `assert` statement, which `python -O` drops
    tree = ast.parse(textwrap.dedent(inspect.getsource(
        jmesh.host_local_slice)))
    assert any(isinstance(node, ast.Assert) for node in ast.walk(tree))
    # the port's holds under -O
    code = ("from upgpt_torch.parallel.mesh import host_local_slice as t\n"
            "try:\n"
            "    t(5, 1, 2)\n"
            "except ValueError:\n"
            "    print('ValueError')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-O", "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ValueError"]


def test_local_rows_takes_each_ranks_rows():
    tree = {"image": torch.arange(24.0).reshape(6, 4),
            "t": np.arange(6),
            "pair": [torch.ones(6, 2), (torch.zeros(6),)],
            "name": "kept", "scalar": torch.tensor(3.0)}
    parts = [mesh.local_rows(tree, i, 3) for i in range(3)]
    assert torch.equal(torch.cat([p["image"] for p in parts]), tree["image"])
    np.testing.assert_array_equal(parts[1]["t"], [2, 3])
    assert parts[2]["pair"][1][0].shape == (2,)
    assert parts[0]["name"] == "kept" and parts[0]["scalar"].item() == 3.0
    # one process: the tree itself
    assert mesh.local_rows(tree) is tree


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    # 3 + 1 * 4 (men_factor) = 7 training pairs: batches of 4 and 3
    return write_fashion_tree(tmp_path_factory.mktemp("fashion"),
                              {"train": (3, 1)}, image_hw=HW, seed=4)


def _pair(module, tree):
    return module.DeepFashionPair(
        folder=tree["folder"], image_dir="img_256",
        pair_file=[tree["train"]], data_file=tree["data_file"],
        image_size=HW, f=8, input_mask_type="bbox", men_factor=4)


@pytest.mark.parametrize("kind", ["DataLoader", "PrefetchDataLoader"])
@pytest.mark.parametrize("count", [2, 4])
def test_rank_batches_equal_jax(tree, kind, count):
    """Every rank's batches over two epochs equal JAX's rank's, the tail
    of 3 wrap-padded to divide over the ranks; the ranks' rows of a full
    batch are the single process's batch."""
    kw = {} if kind == "DataLoader" else {"num_workers": 2}

    def make(module, index, n):
        return getattr(module, kind)(_pair(module, tree), 4, shuffle=True,
                                     seed=5, drop_last=False,
                                     process_index=index, process_count=n,
                                     **kw)

    loaders = []
    try:
        whole = make(tdf, 0, 1)
        loaders.append(whole)
        for epoch in (0, 1):
            full = list(whole.epoch(epoch))
            ranks = []
            for index in range(count):
                ours, theirs = make(tdf, index, count), make(jdf, index,
                                                             count)
                loaders += [ours, theirs]
                got, want = list(ours.epoch(epoch)), list(theirs.epoch(epoch))
                assert len(got) == len(want) == 2
                for a, b in zip(got, want):
                    assert list(a) == list(b)
                    for k in a:
                        if isinstance(a[k], list):
                            assert a[k] == b[k], k
                        else:
                            np.testing.assert_array_equal(a[k], b[k], k)
                ranks.append(got)
            first = np.concatenate([r[0]["image"] for r in ranks])
            np.testing.assert_array_equal(first, full[0]["image"])
            # the tail: 3 rows padded with its own leading rows
            tail = np.concatenate([r[1]["image"] for r in ranks])
            n = len(tail)
            np.testing.assert_array_equal(
                tail, np.resize(full[1]["image"], (n,) + tail.shape[1:]))
    finally:
        for loader in loaders:
            if hasattr(loader, "close"):
                loader.close()


def test_initialize_is_a_no_op_without_a_cluster(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                 "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize() is None
    assert multihost.group() is None and multihost.device() is None
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)
    assert multihost.is_primary()
    multihost.barrier()  # nothing to wait for
    metrics = {"loss": torch.tensor(2.0)}
    assert mesh.mean_over_group(metrics) is metrics
    assert mesh.time_all_reduce([64], torch.device("cpu")) is None


@pytest.mark.parametrize("device,local_ranks,cards,backend", [
    ("cuda", 1, 1, "nccl"), ("cuda", 8, 8, "nccl"), ("cuda", 2, 8, "nccl"),
    ("cuda", 2, 1, "gloo"), ("cuda", 4, 2, "gloo"), ("cpu", 1, 0, "gloo"),
    ("cpu", 4, 0, "gloo")])
def test_backend_choice(device, local_ranks, cards, backend):
    assert multihost.choose_backend(device, local_ranks, cards) == backend


def test_initialize_refuses_what_it_cannot_join(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="RANK and WORLD_SIZE"):
        multihost.initialize(rank=0)
    with pytest.raises(ValueError, match=r"rank 2 outside \[0, 2\)"):
        multihost.initialize(rank=2, world_size=2, master_port=1)
    with pytest.raises(ValueError, match="MASTER_PORT"):
        multihost.initialize(rank=0, world_size=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize(rank=0, world_size=1, master_port=1)
    assert multihost.group() is None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def one_rank_group():
    """A one-rank gloo group in this process, torn down after the test."""
    group = multihost.initialize(rank=0, world_size=1, local_rank=0,
                                 master_addr="127.0.0.1",
                                 master_port=_free_port(), device="cpu")
    try:
        yield group
    finally:
        multihost.shutdown()
    assert multihost.group() is None


def _redrawn(seed=0, **kw):
    model = build_latent_diffusion("tiny", device="cpu",
                                   use_fused_groupnorm=True, **kw)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            z = torch.randn(p.shape, generator=g)
            p.copy_(z / p[0].numel() ** 0.5 if p.dim() >= 2 else
                    (1.0 if name.endswith("weight") else 0.0) + 0.1 * z)
    return model


def _batch(b, seed=1):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in {
        "image": rng.uniform(-1, 1, size=(b, 64, 48, 3)),
        "person_mask": rng.choice([-1.0, -0.99215686], size=(b, 32, 24, 1)),
        "text_emb": rng.normal(size=(b, 77, 768)),
        "style_emb": rng.normal(size=(b, 9, 768)),
        "smpl": rng.normal(size=(b, 1, 85))}.items()}


def test_one_rank_group_and_ddp_step(one_rank_group):
    assert one_rank_group.backend == "gloo"
    assert multihost.initialize() is one_rank_group  # idempotent
    assert multihost.device() == torch.device("cpu")
    multihost.barrier()
    plain, model = _redrawn(), _redrawn()
    batch = _batch(2)
    states = []
    for m, ddp in ((plain, False), (model, True)):
        st = create_train_state(m, 1e-3, scheduler=lambda step: 1.0)
        if ddp:
            st.ddp = data_parallel(m)
        for step in range(2):
            gen = torch.Generator().manual_seed(step)
            st, metrics = train_step(m, st, batch, gen)
        states.append((st, metrics))
    (ps, pm), (ds, dm) = states
    for k in pm:
        assert torch.equal(pm[k], dm[k]), k
    for a, b in zip(ps.params, ds.params):
        assert torch.equal(a, b)
    # DDP's exchange ran through the wrapper: every trainable float32
    # gradient once a step
    steps = ds.ddp.exchange_log.steps
    assert len(steps) == 2
    assert all(sum(step) == 4 * sum(p.numel() for p in ds.params)
               for step in steps)
    assert mesh.time_all_reduce(steps[-1], torch.device("cpu")) > 0


def test_accumulation_skips_the_exchange_between_updates(one_rank_group):
    plain, model = _redrawn(), _redrawn()
    states = []
    for m, ddp in ((plain, False), (model, True)):
        st = create_train_state(m, 1e-3, scheduler=lambda step: 1.0,
                                accumulate_grad_batches=2)
        if ddp:
            st.ddp = data_parallel(m)
        norms = []
        for step in range(4):
            gen = torch.Generator().manual_seed(step)
            st, metrics = train_step(m, st, _batch(2, seed=step), gen)
            norms.append(metrics["grad_norm"].item())
        states.append((st, norms))
    (ps, pnorms), (ds, dnorms) = states
    for a, b in zip(ps.params, ds.params):
        assert torch.equal(a, b)
    # no DDP exchange on any call: the update averages the ranks' means
    # itself (a no-op for one rank; two ranks in test_torch_multihost.py)
    assert ds.ddp.exchange_log.steps == []
    assert np.isnan(dnorms[0]) and np.isnan(dnorms[2])
    assert np.isfinite(dnorms[1]) and np.isfinite(dnorms[3])
    assert ps.updates == ds.updates == 2


@pytest.mark.parametrize("kw", [{}, {"use_checkpoint": True},
                                {"cond_fusion": True}],
                         ids=["tiny", "tiny-remat", "tiny-fusion"])
def test_every_trainable_parameter_gets_a_gradient(kw):
    """DDP runs with `find_unused_parameters=False`: a trainable parameter
    that a step leaves without a gradient would stall its exchange."""
    model = _redrawn(**kw)
    named = trainable_parameters(model)
    model.vae.requires_grad_(False)
    batch = _batch(2)
    loss, _ = model.training_loss(batch, torch.Generator().manual_seed(0))
    loss.backward()
    missing = [n for n, p in named if p.grad is None]
    assert not missing, missing
