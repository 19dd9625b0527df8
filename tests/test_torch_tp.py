"""Tensor parallelism in the port (`upgpt_torch.parallel.tp`) on the CPU.

JAX's `parallel/tp.py` shards the U-Net's transformer matmuls over the
`model` axis of a (data x model) mesh, and tests/test_tensor_parallel.py
holds it on the 2 x 4 virtual CPU mesh. Here, on the tiny geometry:

- the port's spec table against JAX's `unet_param_specs` for every leaf,
  through the bridge's key map, with and without `shard_convs`, and
  `validate_divisibility`'s two errors;
- the grid's collectives (float32 sums in shard order, bitwise equal on
  every shard, gradients through them, counts and bytes), and a kernel
  launching with its tensors' card current;
- the shard form of the SpatialTransformer against its twin, and GEGLU's
  paired halves against a contiguous split with its exchange;
- eta-0 DDIM-4 latents of the port's 2 x 4 grid on eight CPU shards
  against JAX's `pipe.generate` on `create_mesh((2, 4))` with
  `shard_params` (JAX's weights through the bridge, JAX's x_T injected);
- tp 2 and tp 4 and 2 x 2 grids, one with uneven rows, against the
  port's single device, DDIM, UniPC and DPM++;
- a tp loss and its gradients against the single device, as JAX's
  `test_tp_training_step_matches_single_device`, with and without
  rematerialisation;
- `cli sample --tp 2` and `cli test --tp 2` from a distilled student
  against `--tp 1`, and the exits where tp or the batch does not divide.

Tolerances are JAX's own (latents 2e-4, loss 1e-5, gradients 5e-4); the
measured maxima stand beside each.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from test_torch_training import _random_params  # noqa: E402
from upgpt_tpu.inference.pipeline import (  # noqa: E402
    GenerationPipeline as JaxPipeline,
)
from upgpt_tpu.parallel import tp as jax_tp  # noqa: E402
from upgpt_tpu.parallel.mesh import batch_sharding, create_mesh  # noqa: E402
from upgpt_tpu.zoo import build_latent_diffusion as jax_build  # noqa: E402
from upgpt_torch import cli  # noqa: E402
from upgpt_torch.checkpoint import save_checkpoint  # noqa: E402
from upgpt_torch.convert.from_jax import torch_key  # noqa: E402
from upgpt_torch.data.tree import write_fashion_tree  # noqa: E402
from upgpt_torch.inference.pipeline import GenerationPipeline  # noqa: E402
from upgpt_torch.ops.fused_transformer import (  # noqa: E402
    transformer_block_reference, transformer_block_shards,
)
from upgpt_torch.parallel.tp import (  # noqa: E402
    TPGrid, TPLatentDiffusion, from_jax_params, shard_slice, spec_for,
    unet_param_specs, unshard, validate_divisibility,
)
from upgpt_torch.zoo import build_latent_diffusion  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "deepfashion", "interp_256.yaml")
H, W = 32, 24  # tiny's latent grid
BLOCKS = 7     # tiny's SpatialTransformers (ds 1 and 2, mid)
CONVS = 24     # tiny's U-Net convs with outputs a multiple of 8: all but
               # the out conv's 4


def _redraw(model, seed):
    """Every parameter drawn (the zero-initialised projections too):
    weights N(0, 1/fan_in), norm scales 1 + 0.1 N, biases 0.1 N."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            z = torch.randn(p.shape, generator=g)
            if p.dim() >= 2:
                z = z / p[0].numel() ** 0.5
            elif name.endswith("weight"):
                z = 1.0 + 0.1 * z
            else:
                z = 0.1 * z
            p.copy_(z)
    return model


def _batch(b, seed, image=False):
    rng = np.random.default_rng(seed)
    out = {"text_emb": rng.normal(size=(b, 77, 768)),
           "style_emb": rng.normal(size=(b, 9, 768)),
           "smpl": rng.normal(size=(b, 1, 85)),
           "person_mask": rng.choice([-1.0, -0.99215686], size=(b, H, W, 1))}
    if image:
        out["image"] = 0.3 * rng.normal(size=(b, 2 * H, 2 * W, 3))
    return {k: v.astype(np.float32) for k, v in out.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_tiny():
    jm = jax_build("tiny", use_flash_attention=False)
    return jm, jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def model():
    return _redraw(build_latent_diffusion("tiny", device="cpu"), seed=1)


# ------------------------------------------------------ the spec table


@pytest.mark.parametrize("shard_convs", [False, True])
def test_spec_table_matches_jax_leaf_for_leaf(jax_tiny, shard_convs):
    _, shapes = jax_tiny
    specs = jax.tree_util.tree_flatten_with_path(
        jax_tp.unet_param_specs(shapes, shard_convs=shard_convs),
        is_leaf=lambda x: isinstance(x, P))[0]
    named = dict(build_latent_diffusion("tiny", device="cpu")
                 .named_parameters())
    got = unet_param_specs(named, shard_convs=shard_convs)
    flat_shapes = {"/".join(k.key for k in path): leaf.shape for path, leaf
                   in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert len(specs) == len(got) == len(named)
    for path, spec in specs:
        jk = "/".join(k.key for k in path if hasattr(k, "key"))
        jdim = next((i for i, a in enumerate(spec) if a == "model"), None)
        rank = len(flat_shapes[jk])
        # (in, out) -> (out, in); HWIO -> OIHW
        want = None if jdim is None else {
            1: jdim, 2: 1 - jdim, 4: (3, 2, 0, 1).index(jdim)}[rank]
        assert got[torch_key(jk)] == want, jk
    n_sharded = sum(d is not None for d in got.values())
    # 7 transformers x 14 sharded leaves (to_q/k/v and to_out of both
    # attentions, both proj_in's weight and bias, ff.proj_out, proj_out);
    # with shard_convs the CONVS whose outputs are a multiple of 8
    assert n_sharded == 98 + (CONVS if shard_convs else 0)


def test_validate_divisibility_raises_jaxs_errors(jax_tiny):
    _, shapes = jax_tiny
    named = dict(build_latent_diffusion("tiny", device="cpu")
                 .named_parameters())
    validate_divisibility(named, tp=4, num_heads=4)  # inner 32: ok
    for check, tree in ((validate_divisibility, named),
                        (jax_tp.validate_divisibility, shapes)):
        with pytest.raises(ValueError,
                           match="num_heads 4 not divisible by tp=3"):
            check(tree, tp=3, num_heads=4)
        with pytest.raises(ValueError,
                           match=r"dim \d \(\d+\) not divisible by tp=3"):
            check(tree, tp=3)
    with pytest.raises(ValueError, match="num_heads 4 not divisible"):
        TPLatentDiffusion(build_latent_diffusion("tiny", device="cpu"),
                          ["cpu"] * 3, 3)


# ------------------------------------------------------ the collectives


def test_grid_collectives_sum_in_shard_order_on_every_shard():
    grid = TPGrid(["cpu"] * 6, 3)
    assert [len(g) for g in grid.groups] == [3, 3]
    assert grid.row_slices(7) == [(0, slice(0, 4)), (1, slice(4, 7))]
    assert grid.row_slices(1) == [(0, slice(0, 1))]
    g = torch.Generator().manual_seed(0)
    parts = [torch.randn(5, 7, generator=g).bfloat16().requires_grad_()
             for _ in range(3)]
    sums = grid.all_reduce_sum(parts)
    want = (parts[0].float() + parts[1].float()) + parts[2].float()
    assert all(s.dtype == torch.float32 for s in sums)
    assert all(torch.equal(s, want) for s in sums)
    gathered = grid.all_gather([p[:, :2] for p in parts], dim=-1)
    assert all(torch.equal(x, torch.cat([p[:, :2] for p in parts], -1))
               for x in gathered)
    # each shard counts its collective; a part crosses to the 2 others
    assert (grid.all_reduces, grid.all_gathers) == (3, 3)
    assert grid.bytes == 2 * 3 * 5 * 7 * 2 + 2 * 3 * 5 * 2 * 2
    (sums[1].sum() + gathered[2].sum()).backward()
    for p in parts:
        assert torch.equal(p.grad[:, :2], torch.full((5, 2), 2.0).bfloat16())
        assert torch.equal(p.grad[:, 2:], torch.ones(5, 5).bfloat16())
    grid.reset_counts()
    assert (grid.all_reduces, grid.all_gathers, grid.bytes) == (0, 0, 0)
    with pytest.raises(ValueError, match="tp=4 does not divide 6"):
        TPGrid(["cpu"] * 6, 4)


def test_kernels_launch_with_their_tensors_card_current(monkeypatch):
    """A shard on cuda:1 launches while cuda:0 is current. Every wrapper
    goes through `_build.launch`, which makes the tensors' device current
    around the C call (a kernel launches into the current device's
    context, which refuses another card's stream). Here the flash
    wrapper's launch path with the library and CUDA's device calls
    stubbed, and no wrapper reaching the library another way."""
    import pathlib

    from upgpt_torch.ops import _build
    from upgpt_torch.ops import flash_attention as fa

    events = []

    class Device:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            events.append(("current", self.device))

        def __exit__(self, *exc):
            events.append(("restored", self.device))

    class Library:
        def upgpt_flash_attention(self, *args):
            events.append(("launch", args[-1]))
            return 0

    class Stream:
        cuda_stream = 7

    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())
    monkeypatch.setattr(_build, "library", Library)
    monkeypatch.setattr(fa.flash_attention, "launches",
                        fa.flash_attention.launches)
    q = torch.zeros(1, 2, 8, 16, dtype=torch.bfloat16)
    fa._launch(q, q.clone(), q.clone())
    assert events == [("current", q.device), ("launch", 7),
                      ("restored", q.device)]
    ops = pathlib.Path(_build.__file__).parent
    for path in sorted(ops.glob("*.py")):
        if path.name != "_build.py":
            assert "library()" not in path.read_text(), path.name


# ------------------------------------------------------ the shard form


def _block_tree(seed):
    """tiny's mid SpatialTransformer (64 channels, 4 heads), re-drawn, as
    a parameter tree without gradients."""
    st = _redraw(build_latent_diffusion("tiny", device="cpu").unet.mid_attn,
                 seed)
    st.requires_grad_(False)
    return st.cast_params(torch.float32)


def _slice_tree(tree, r, tp, prefix="mid_attn"):
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + [k]) for k, v in node.items()}
        name = ".".join([prefix] + path)
        dim = spec_for(name, tuple(node.shape))
        return node if dim is None else shard_slice(name, node, dim, r, tp)

    return walk(tree, [])


@pytest.mark.parametrize("tp,variant", [(2, "kv"), (4, "kv"), (2, "ctx"),
                                        (4, "ctx")])
def test_shard_form_matches_the_twin(tp, variant):
    tree = _block_tree(seed=2)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 192, 64, generator=g)
    ctx = torch.randn(2, 87, 768, generator=g)
    kv = (ctx @ tree["block_0"]["attn2"]["to_k"]["weight"].T,
          ctx @ tree["block_0"]["attn2"]["to_v"]["weight"].T)
    want = transformer_block_reference(
        x, tree, 4, context=ctx if variant == "ctx" else None,
        kv=kv if variant == "kv" else None)
    grid = TPGrid(["cpu"] * tp, tp)
    trees = [_slice_tree(tree, r, tp) for r in range(tp)]
    kvs = [{"block_0": (k, v)} for k, v in zip(
        *(torch.chunk(t, tp, dim=-1) for t in kv))]
    outs = transformer_block_shards(
        grid, trees, [x] * tp, 4 // tp,
        contexts=[ctx] * tp if variant == "ctx" else None,
        kvs=kvs if variant == "kv" else None)
    assert all(torch.equal(o, outs[0]) for o in outs)
    # float32, sums in other orders: 1.9e-6 measured on outputs up to 7.1
    np.testing.assert_allclose(outs[0].numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)
    assert (grid.all_reduces, grid.all_gathers) == (4 * tp, tp)


def test_geglu_paired_halves_match_a_contiguous_split():
    """Shard r takes the r-th run of the value rows and the same run of
    the gate rows, so its GEGLU needs no exchange; JAX's contiguous split
    of the 8C columns has to gather the FF activation first. Both give
    the unsharded FF."""
    import math

    from upgpt_torch.ops.fused_transformer import _gelu_exact

    tp, c = 4, 64
    g = torch.Generator().manual_seed(4)
    w_in = torch.randn(8 * c, c, generator=g) / math.sqrt(c)
    b_in = 0.1 * torch.randn(8 * c, generator=g)
    w_out = torch.randn(c, 4 * c, generator=g) / math.sqrt(4 * c)
    z = torch.randn(2, 50, c, generator=g)
    grid = TPGrid(["cpu"] * tp, tp)

    def geglu(gg):
        xh, gate = gg.chunk(2, dim=-1)
        return xh * _gelu_exact(gate)

    name = "mid_attn.block_0.ff.proj_in.weight"
    paired = grid.all_reduce_sum([
        geglu(z @ shard_slice(name, w_in, 0, r, tp).T
              + shard_slice(name, b_in, 0, r, tp))
        @ w_out.chunk(tp, dim=1)[r].T for r in range(tp)])
    gathers = grid.all_gather([z @ w.T + b for w, b in zip(
        w_in.chunk(tp), b_in.chunk(tp))], dim=-1)
    contiguous = grid.all_reduce_sum([
        geglu(gathers[r]).chunk(tp, dim=-1)[r] @ w_out.chunk(tp, dim=1)[r].T
        for r in range(tp)])
    want = geglu(z @ w_in.T + b_in) @ w_out.T
    # 2.0e-6 measured on values up to 3.5
    for got in (paired[0], contiguous[0]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert torch.equal(unshard(name, [shard_slice(name, w_in, 0, r, tp)
                                      for r in range(tp)], 0), w_in)
    assert (grid.all_gathers, grid.all_reduces) == (tp, 2 * tp)


# ------------------------------------------------------ sampling


def test_2x4_grid_matches_jaxs_tp_mesh(eight_devices, jax_tiny):
    """The port's 2 x 4 grid on eight CPU shards against JAX's sampling on
    its (data 2, model 4) mesh with `shard_params` (its XLA path, the
    Pallas kernels off): eta-0 DDIM-4 latents at batch 8."""
    jm, shapes = jax_tiny
    params = _random_params(shapes, seed=3)
    batch = _batch(8, seed=4)
    mesh = create_mesh((2, 4))
    jax_tp.validate_divisibility(params, tp=4, num_heads=4)
    bsh = batch_sharding(mesh)
    key = jax.random.PRNGKey(5)
    want = np.asarray(JaxPipeline(jm, num_steps=4, eta=0.0, decode=False)
                      .generate(jax_tp.shard_params(mesh, params),
                                {k: jax.device_put(jnp.asarray(v), bsh)
                                 for k, v in batch.items()}, key))
    _, k_noise = jax.random.split(key)
    x_T = np.array(jax.random.normal(k_noise, (8, H, W, 4)))
    tpm = from_jax_params(build_latent_diffusion("tiny", device="cpu"),
                          params, ["cpu"] * 8, tp=4)
    got = GenerationPipeline(tpm, num_steps=4, eta=0.0, decode=False
                             ).generate(_torch(batch),
                                        x_T=torch.from_numpy(x_T))
    # float32 on both sides, summed in other orders: 1.1e-5 measured on
    # latents up to 22
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    # per eval: 4 all-reduces and 1 all-gather a block, on every shard
    # of both groups
    assert tpm.grid.all_reduces == 4 * BLOCKS * 4 * 2 * 4
    assert tpm.grid.all_gathers == BLOCKS * 4 * 2 * 4


@pytest.mark.parametrize("sampler,n_dev,tp,b", [
    ("ddim", 2, 2, 4), ("unipc", 2, 2, 4), ("ddim", 4, 4, 4),
    ("unipc", 4, 4, 4), ("dpm++", 4, 2, 3), ("ddim", 4, 2, 4)])
def test_tp_matches_the_single_device(model, sampler, n_dev, tp, b):
    """tp 2 and tp 4 on one data group, and 2 x 2 grids with 3 rows (2 +
    1) and with 4, against the unsharded model: 4-step eta-0 latents, and
    the decoded images of the 2 x 2 grids (the VAE per group)."""
    batch = _torch(_batch(b, seed=6))
    x_T = torch.randn(b, H, W, 4, generator=torch.Generator().manual_seed(7))
    decode = n_dev // tp > 1
    tpm = TPLatentDiffusion(model, ["cpu"] * n_dev, tp)
    got, want = (GenerationPipeline(m, num_steps=4, eta=0.0, decode=decode,
                                    sampler=sampler).generate(batch, x_T=x_T)
                 for m in (tpm, model))
    # float32, sums in other orders: 1.3e-5 measured on latents up to 22
    # and 2.4e-6 on images
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)
    if sampler == "ddim":
        groups = min(b, n_dev // tp)
        assert tpm.grid.all_reduces == 4 * BLOCKS * tp * groups * 4
        assert tpm.grid.all_gathers == BLOCKS * tp * groups * 4
        # the 2 x 2 grid's groups share their devices, so one U-Net
        assert len(tpm.unet.replicas) == 1


@pytest.mark.parametrize("remat", [False, True])
def test_tp_training_loss_and_gradients_match_the_single_device(remat):
    """A loss and its gradients over the 2 x 4 grid against the unsharded
    model on the same batch and draws: each sliced leaf's slices put back
    together, each replicated leaf's copies summed (JAX's
    test_tp_training_step_matches_single_device)."""
    model = _redraw(build_latent_diffusion("tiny", device="cpu",
                                           use_checkpoint=remat), seed=8)
    tpm = TPLatentDiffusion(model, ["cpu"] * 8, 4)
    batch = _torch(_batch(8, seed=9, image=True))
    draws = model.training_draws(8, torch.Generator().manual_seed(10))
    loss, _ = model.training_loss(batch, draws=draws)
    loss.backward()
    want = {n: p.grad for n, p in model.named_parameters()
            if p.grad is not None}
    loss_tp, _ = tpm.training_loss(batch, draws=draws)
    loss_tp.backward()
    got = tpm.gradients()
    # equal (0 measured) on a loss of 1.25
    np.testing.assert_allclose(loss_tp.item(), loss.item(), rtol=1e-5,
                               atol=1e-5)
    assert set(got) == set(want)
    for name, g in want.items():
        # 3.7e-8 measured on gradients up to 0.11
        np.testing.assert_allclose(got[name].numpy(), g.numpy(), rtol=5e-4,
                                   atol=5e-4, err_msg=name)


# ------------------------------------------------------ the CLI


@pytest.fixture(scope="module")
def student(tmp_path_factory):
    """A v-parameterised student on a 2-step grid, its sidecar beside it,
    and a DeepFashion-shaped tree of 64x48 images."""
    root = tmp_path_factory.mktemp("tp")
    tree = write_fashion_tree(root / "tree", {"train": (2, 0),
                                              "validation": (4, 0)},
                              image_hw=(64, 48), seed=11)
    tree["ckpt"] = str(root / "student.pt")
    save_checkpoint(_redraw(build_latent_diffusion(
        "tiny", device="cpu", parameterization="v"), seed=12), tree["ckpt"])
    (root / "student.pt.distill.json").write_text(json.dumps(
        {"parameterization": "v", "timesteps": [237, 999]}))
    return tree


def _dotlist(tree):
    splits = ("train", "validation", "test")
    out = [f"data.{s}.params.{k}={tree[v]}" for s in splits
           for k, v in (("folder", "folder"), ("data_file", "data_file"))]
    out += [f"data.{s}.params.{k}={v}" for s in splits
            for k, v in (("image_size", "[64,48]"), ("f", 2))]
    out += [f"data.train.params.pair_file=['{tree['train']}']",
            f"data.validation.params.pair_file=['{tree['validation']}']",
            f"data.test.params.pair_file=['{tree['validation']}']",
            "model.params.variant=tiny", "model.params.device=cpu",
            "model.params.dtype=float32"]
    return out


def _run(cmd, tree, out, tp):
    return cli.main([cmd, "--base", CONFIG, "--debug-encoder", "--ckpt",
                     tree["ckpt"], "--batch", "2", "--out", str(out),
                     "--tp", str(tp)] + _dotlist(tree))


def test_cli_sample_and_test_from_a_student_at_tp_2(student, tmp_path):
    """`cli sample --tp 2` and `cli test --tp 2` from a distilled student
    (eta-0 DDIM on its sidecar's grid, sharded after the sidecar is read,
    as JAX's `cmd_sample`) against --tp 1."""
    one = _run("sample", student, tmp_path / "s1", 1)
    two = _run("sample", student, tmp_path / "s2", 2)
    # float32 images: 4.5e-6 measured
    np.testing.assert_allclose(two, one, rtol=0, atol=2e-4)
    one = _run("test", student, tmp_path / "t1", 1)
    two = _run("test", student, tmp_path / "t2", 2)
    for group in ("samples", "recon"):
        names = sorted(os.listdir(tmp_path / "t1" / group))
        assert names and names == sorted(os.listdir(tmp_path / "t2" / group))
        for name in names:
            assert ((tmp_path / "t1" / group / name).read_bytes()
                    == (tmp_path / "t2" / group / name).read_bytes())
    # the same JPEGs, so the same scores (MS-SSIM is NaN at 64x48)
    assert json.dumps(one["metrics"]) == json.dumps(two["metrics"])


def test_cli_exits_where_tp_or_the_batch_does_not_divide(student, model):
    with pytest.raises(SystemExit, match="--tp 3 does not divide 4 devices"):
        cli._tp_shard(model, 3, 4, devices=["cpu"] * 4)
    with pytest.raises(SystemExit, match=(
            r"--batch 3 does not divide the data axis \(4 devices / tp 2 "
            r"= 2 shards\)")):
        cli._tp_shard(model, 2, 3, devices=["cpu"] * 4)
    assert cli._tp_shard(model, 1, 3) is model
    # on the CPU one group of 3 shards: the heads do not divide
    with pytest.raises(ValueError, match="num_heads 4 not divisible by "
                                         "tp=3"):
        _run("sample", student, "unused", 3)
