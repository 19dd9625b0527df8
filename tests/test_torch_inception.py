"""The port's FID InceptionV3 against the JAX package's, on the CPU in
float32.

- Each block type at its full width and a small spatial size, batch 2:
  InceptionA, B, C, D and E with the average pool (Mixed_7b) and the max
  pool (Mixed_7c), on seeded weights with perturbed folded BatchNorms in
  both (the bridge's key names: `bn_scale` / `bn_bias` keep theirs, and
  it maps the trunk's tree back onto the port's module): within 1e-4 of
  max|ref|. Then the whole trunk at 75x75
  (the smallest input it takes), batch 1, to pool3: 1e-4.
- The pools against JAX's `_avg_pool_3x3_nopad_count` and `_max_pool`
  (1e-6).
- `preprocess_fid` against JAX's, upscaling (256x176) and downscaling
  (512x352, the 512px stages' crop; no antialiasing): 1e-5.
- `convert_inception_state_dict` on a seeded pt_inception-layout state
  dict against JAX's converter: every tensor equal, the BatchNorm fold
  with eps 1e-3; a missing key raises.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from upgpt_torch.convert.from_jax import (  # noqa: E402
    flatten_tree, load_jax_params, torch_array, torch_key,
)
from upgpt_torch.eval import inception as ti  # noqa: E402
from upgpt_tpu.eval import inception as ji  # noqa: E402

TOL = 1e-4
# (JAX block, port block, input channels, spatial side)
BLOCKS = {
    "A": (lambda: ji.InceptionA(32), lambda: ti.InceptionA(192, 32), 192, 7),
    "B": (ji.InceptionB, lambda: ti.InceptionB(288), 288, 9),
    "C": (lambda: ji.InceptionC(128), lambda: ti.InceptionC(768, 128), 768,
          7),
    "D": (ji.InceptionD, lambda: ti.InceptionD(768), 768, 9),
    "E_avg": (lambda: ji.InceptionE("avg"), lambda: ti.InceptionE(1280),
              1280, 5),
    "E_max": (lambda: ji.InceptionE("max"),
              lambda: ti.InceptionE(2048, "max"), 2048, 5),
}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _seeded(port, seed):
    """The port's module with seeded weights (folded BatchNorms away from
    1 and 0) and the same weights as JAX's tree: OIHW kernels to HWIO,
    `bn_scale` / `bn_bias` as they are (the bridge's inverse; building the
    tree here spares a flax init of each module)."""
    g = torch.Generator().manual_seed(seed)
    tree = {}
    for name, p in port.named_parameters():
        with torch.no_grad():
            if name.endswith("bn_scale"):
                p.uniform_(0.5, 1.5, generator=g)
            elif name.endswith("bn_bias"):
                p.normal_(0, 0.1, generator=g)
        *path, leaf = name.split(".")
        arr = p.detach().numpy()
        if leaf == "weight":
            leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(arr)
    return port.eval(), tree


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_matches_jax(kind):
    jax_block, port_block, cin, side = BLOCKS[kind]
    x = np.random.default_rng(1).normal(
        size=(2, side, side, cin)).astype(np.float32)
    port, tree = _seeded(port_block(), 0)
    want = np.asarray(jax.jit(jax_block().apply)({"params": tree},
                                                 jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert _rel(got, want) < TOL


def test_trunk_to_pool3_matches_jax():
    x = np.random.default_rng(3).uniform(-1, 1, (1, 75, 75, 3)).astype(
        np.float32)
    port, tree = _seeded(ti.InceptionV3Features(), 4)
    want = np.asarray(jax.jit(ji.InceptionV3Features().apply)(
        {"params": tree}, jnp.asarray(x)))
    # the bridge maps JAX's tree back onto the port's module
    other = load_jax_params(ti.InceptionV3Features(), tree)
    assert all(torch.equal(a, b) for a, b in zip(
        other.state_dict().values(), port.state_dict().values()))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (1, ti.FID_FEATURE_DIM)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("shape", [(1, 5, 5, 2), (2, 8, 7, 3)])
def test_pools_match_jax(shape):
    x = np.random.default_rng(6).normal(size=shape).astype(np.float32)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(
        ti.avg_pool_3x3_nopad_count(xt).numpy(),
        np.asarray(ji._avg_pool_3x3_nopad_count(jnp.asarray(x))), atol=1e-6)
    for window, stride, pad in ((3, 2, 0), (3, 1, 1)):
        np.testing.assert_array_equal(
            ti.max_pool(xt, window, stride, pad).numpy(),
            np.asarray(ji._max_pool(jnp.asarray(x), window, stride, pad)))
    # count_include_pad=False: a constant stays constant at the borders
    const = torch.full((1, 5, 5, 2), 3.0)
    assert torch.allclose(ti.avg_pool_3x3_nopad_count(const), const)


@pytest.mark.parametrize("hw", [(256, 176), (512, 352)])
def test_preprocess_fid_matches_jax(hw):
    img = np.random.default_rng(7).uniform(size=(2, *hw, 3)).astype(
        np.float32)
    want = np.asarray(ji.preprocess_fid(jnp.asarray(img)))
    got = ti.preprocess_fid(torch.from_numpy(img)).numpy()
    assert got.shape == (2, 299, 299, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)


def _pt_inception_state_dict(seed):
    """Random weights in pt_inception's layout (torchvision's names, BN
    running statistics, the 1008-way fc)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, mod in ti.InceptionV3Features().named_modules():
        if not isinstance(mod, ti.BasicConv2d):
            continue
        shape = tuple(mod.conv.weight.shape)
        o = shape[0]
        sd[f"{name}.conv.weight"] = rng.normal(0, 0.05, shape).astype(
            np.float32)
        sd[f"{name}.bn.weight"] = rng.uniform(0.5, 1.5, o).astype(np.float32)
        sd[f"{name}.bn.bias"] = rng.normal(0, 0.1, o).astype(np.float32)
        sd[f"{name}.bn.running_mean"] = rng.normal(0, 0.1, o).astype(
            np.float32)
        sd[f"{name}.bn.running_var"] = rng.uniform(0.5, 1.5, o).astype(
            np.float32)
        sd[f"{name}.bn.num_batches_tracked"] = np.zeros((), np.int64)
    sd["fc.weight"] = rng.normal(size=(1008, 2048)).astype(np.float32)
    sd["fc.bias"] = np.zeros(1008, np.float32)
    return sd


def test_converter_matches_jax(tmp_path):
    sd = _pt_inception_state_dict(8)
    want = flatten_tree(ji.convert_inception_state_dict(sd))
    got = ti.convert_inception_state_dict(sd)
    assert len(got) == len(want) == 3 * 94
    for k, v in want.items():
        assert torch.equal(got[torch_key(k)],
                           torch.from_numpy(torch_array(k, np.asarray(v)))), k
    g, v = sd["Mixed_7c.branch_pool.bn.weight"], sd[
        "Mixed_7c.branch_pool.bn.running_var"]
    np.testing.assert_allclose(got["Mixed_7c.branch_pool.bn_scale"].numpy(),
                               g / np.sqrt(v + 1e-3), rtol=1e-6)
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
               tmp_path / "pt_inception.pth")
    loaded = ti.load_pt_inception(str(tmp_path / "pt_inception.pth"))
    assert all(torch.equal(loaded[k], got[k]) for k in got)
    fn = ti.InceptionFeatureFn(loaded, device="cpu")
    assert fn.fid_name == "inception"
    del sd["Mixed_6b.branch7x7_2.bn.running_var"]
    with pytest.raises(KeyError, match="Mixed_6b.branch7x7_2"):
        ti.convert_inception_state_dict(sd)
