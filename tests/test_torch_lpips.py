"""The port's LPIPS (VGG16) against the JAX package's, on the CPU in
float32.

- The VGG16 taps and the distance at 32x32, batch 2, on JAX's random
  weights (its `init`) carried across by the bridge: within 1e-4 of
  max|ref| (13 float32 convs in other summation orders).
- `convert_lpips_weights` on a seeded state dict in the
  `lpips.LPIPS(net='vgg')` key layout, through JAX's converter into JAX's
  LPIPS and through the port's into the port's: the same distances
  (1e-4), and `load_lpips_fn` reads the same file as .pt and .npz.
- The rehearsal function: zero on identical inputs, non-negative, growing
  with the perturbation, fixed by its seed and changed by another.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from upgpt_torch.convert.from_jax import load_jax_params  # noqa: E402
from upgpt_torch.eval import lpips as tl  # noqa: E402
from upgpt_tpu.eval import lpips as jl  # noqa: E402

TOL = 1e-4
_SLICE_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
_SLICES = ["net.slice1"] * 2 + ["net.slice2"] * 2 + ["net.slice3"] * 3 + [
    "net.slice4"] * 3 + ["net.slice5"] * 3


@pytest.fixture(scope="module")
def jax_lpips():
    mod = jl.LPIPS()
    x = jnp.zeros((1, 32, 32, 3))
    params = jax.jit(mod.init)(jax.random.PRNGKey(0), x, x)["params"]
    # unit-scale lin heads (flax inits a 1x1 kernel small), positive as
    # the published heads are
    params = {k: (jax.tree.map(jnp.abs, v) if k.startswith("lin_") else v)
              for k, v in dict(params).items()}
    apply = jax.jit(lambda p, a, b: mod.apply({"params": p}, a, b))
    taps = jax.jit(lambda p, x: jl.VGG16Features().apply({"params": p}, x))
    return params, apply, taps


def _images(seed, shape=(2, 32, 32, 3)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.3, shape), -1, 1).astype(np.float32)
    return a, b


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _lpips_state_dict(seed):
    """Random weights in the lpips package's key layout."""
    rng = np.random.default_rng(seed)
    sd, cin = {}, 3
    for (ch, _), prefix, idx in zip(tl._VGG16_PLAN, _SLICES, _SLICE_IDX):
        sd[f"{prefix}.{idx}.weight"] = (rng.normal(size=(ch, cin, 3, 3))
                                        / np.sqrt(9 * cin)).astype(np.float32)
        sd[f"{prefix}.{idx}.bias"] = rng.normal(0, 0.1, ch).astype(np.float32)
        cin = ch
    for i, ch in enumerate(tl.LPIPS_CHANNELS):
        sd[f"lin{i}.model.1.weight"] = rng.uniform(
            0, 1, (1, ch, 1, 1)).astype(np.float32)
    return sd


def test_vgg_taps_and_distance_match_jax(jax_lpips):
    params, apply, taps = jax_lpips
    port = load_jax_params(tl.LPIPS(), params).eval()
    a, b = _images(0)
    x = (a - np.asarray(tl._SHIFT, np.float32)) / np.asarray(tl._SCALE,
                                                             np.float32)
    want_taps = taps(params["vgg"], jnp.asarray(x))
    with torch.no_grad():
        got_taps = port.vgg(torch.from_numpy(x))
        got = port(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert [t.shape for t in got_taps] == [
        (2, 32 // 2 ** i, 32 // 2 ** i, c)
        for i, c in enumerate(tl.LPIPS_CHANNELS)]
    for g, w in zip(got_taps, want_taps):
        assert _rel(g.numpy(), w) < TOL
    want = np.asarray(apply(params, jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == (2,) and _rel(got, want) < TOL


def test_converter_on_lpips_layout_matches_jax(tmp_path):
    sd = _lpips_state_dict(1)
    jmod = jl.LPIPS()
    jparams = jl.convert_lpips_weights(sd)
    port = tl.LPIPS()
    port.load_state_dict(tl.convert_lpips_weights(sd), strict=True)
    a, b = _images(2)
    want = np.asarray(jax.jit(jmod.apply)({"params": jparams},
                                          jnp.asarray(a), jnp.asarray(b)))
    with torch.no_grad():
        got = port(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert _rel(got, want) < TOL
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
               tmp_path / "vgg.pth")
    np.savez(tmp_path / "vgg.npz", **sd)
    for name in ("vgg.pth", "vgg.npz"):
        fn = tl.load_lpips_fn(str(tmp_path / name), device="cpu")
        assert _rel(fn(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                    want) < TOL


def test_converter_names_a_missing_key():
    sd = _lpips_state_dict(1)
    del sd["lin4.model.1.weight"]
    with pytest.raises(KeyError, match="lin4"):
        tl.convert_lpips_weights(sd)


def test_rehearsal_is_a_seeded_nonnegative_distance():
    f = tl.rehearsal_lpips_fn(0, device="cpu")
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.uniform(-1, 1, (2, 32, 24, 3)).astype(
        np.float32))
    small = (a + 0.05 * torch.randn(a.shape, generator=torch.Generator()
                                    .manual_seed(1))).clamp(-1, 1)
    big = (a + 0.5 * torch.randn(a.shape, generator=torch.Generator()
                                 .manual_seed(2))).clamp(-1, 1)
    with torch.no_grad():
        d0, ds, db = f(a, a), f(a, small), f(a, big)
        assert torch.all(d0.abs() < 1e-6)
        assert torch.all(ds > 0) and torch.all(db > ds)
        assert torch.equal(tl.rehearsal_lpips_fn(0, device="cpu")(a, big),
                           db)
        assert not torch.equal(tl.rehearsal_lpips_fn(1, device="cpu")(a, big),
                               db)
    lin = [p for n, p in f.named_parameters() if n.startswith("lin_")]
    assert len(lin) == 5 and all(bool((p >= 0).all()) for p in lin)
