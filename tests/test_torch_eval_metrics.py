"""The port's SSIM, MS-SSIM and Fréchet distance against the JAX
package's, on the CPU in float32 (numpy float64 for the FID).

- `ssim` per image at the protocol's crop, 256x176, batch 2: within 1e-5
  of JAX's (both float32; the two sum the map in other orders).
- `ms_ssim`, ROADMAP R7: the port keeps (level, batch, channel) and
  averages the channels after the product over the levels, as
  pytorch_msssim does; JAX averages each level's terms over the channels
  first. The port equals a per-channel composition of JAX's own `_ssim_cs`
  and `_avg_pool2` on each channel slice (1e-5); it equals JAX's
  `ms_ssim` on grey images (every channel the same); on a pair whose
  channels differ in structure the two differ by far more than that.
- `frechet_distance` and `fid_from_features` equal JAX's on float64
  inputs (both numpy + scipy, to 1e-9 relative).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from upgpt_torch.eval import metrics as tm  # noqa: E402
from upgpt_tpu.eval import metrics as jm  # noqa: E402

TOL = 1e-5


@pytest.fixture(scope="module")
def jax_fns():
    ssim = jax.jit(lambda a, b: jm.ssim(a, b, size_average=False))
    ms_ssim = jax.jit(lambda a, b: jm.ms_ssim(a, b, size_average=False))
    ssim_cs = jax.jit(lambda a, b: jm._ssim_cs(a, b, 1.0))
    pool = jax.jit(jm._avg_pool2)
    return {"ssim": ssim, "ms_ssim": ms_ssim, "ssim_cs": ssim_cs,
            "pool": pool}


def _pair(seed, hw=(256, 176), noise=0.1):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, noise, a.shape), 0, 1).astype(np.float32)
    return a, b


def _coloured_pair(seed, hw=(256, 176)):
    """Channels of unlike structure: R heavily noised, G untouched, B
    smoothed, so each channel's MS-SSIM differs from the others'."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    b = a.copy()
    b[..., 0] = np.clip(a[..., 0] + rng.normal(0, 0.5, hw), 0, 1)
    b[..., 2] = 0.5 * a[..., 2] + 0.25
    return a, b


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("seed,noise", [(0, 0.1), (1, 0.3)])
def test_ssim_per_image_matches_jax(jax_fns, seed, noise):
    a, b = _pair(seed, noise=noise)
    want = np.asarray(jax_fns["ssim"](jnp.asarray(a), jnp.asarray(b)))
    got = tm.ssim(_t(a), _t(b), size_average=False).numpy()
    assert got.shape == (2,)
    assert _rel(got, want) < TOL
    assert float(tm.ssim(_t(a), _t(b))) == pytest.approx(float(want.mean()),
                                                         rel=TOL)
    assert float(tm.ssim(_t(a), _t(a))) == pytest.approx(1.0, abs=1e-5)


def _per_channel_jax_ms_ssim(jax_fns, a, b):
    """pytorch_msssim's composition from JAX's own pieces: each channel
    alone through `_ssim_cs` and `_avg_pool2` (every pooled size is even
    at 256x176), the weighted product over the levels per channel, then
    the channel mean."""
    w = np.asarray(jm._MSSSIM_WEIGHTS, np.float64)
    out = []
    for c in range(a.shape[-1]):
        x, y = jnp.asarray(a[..., c:c + 1]), jnp.asarray(b[..., c:c + 1])
        vals = []
        for i in range(len(w)):
            s, cs = jax_fns["ssim_cs"](x, y)
            if i < len(w) - 1:
                vals.append(np.maximum(np.asarray(cs, np.float64), 0))
                x, y = jax_fns["pool"](x), jax_fns["pool"](y)
        vals.append(np.maximum(np.asarray(s, np.float64), 0))
        out.append(np.prod(np.stack(vals) ** w[:, None], axis=0))
    return np.mean(out, axis=0)


@pytest.mark.parametrize("pair", ["noise", "coloured"])
def test_ms_ssim_is_pytorch_msssims_per_channel_product(jax_fns, pair):
    a, b = _pair(2) if pair == "noise" else _coloured_pair(3)
    want = _per_channel_jax_ms_ssim(jax_fns, a, b)
    got = tm.ms_ssim(_t(a), _t(b), size_average=False).numpy()
    assert _rel(got, want) < TOL


def test_ms_ssim_equals_jax_on_grey_images(jax_fns):
    a, b = _pair(4)
    a, b = (np.repeat(x.mean(-1, keepdims=True), 3, -1) for x in (a, b))
    want = np.asarray(jax_fns["ms_ssim"](jnp.asarray(a), jnp.asarray(b)))
    got = tm.ms_ssim(_t(a), _t(b), size_average=False).numpy()
    assert _rel(got, want) < TOL
    assert float(tm.ms_ssim(_t(a), _t(a))) == pytest.approx(1.0, abs=1e-4)


def test_r7_ms_ssim_departs_from_jax_on_coloured_images(jax_fns):
    """R7: JAX's channel mean before the product of scales is not
    pytorch_msssim's number; on channels of unlike structure the two
    differ by more than 100x the parity tolerance."""
    a, b = _coloured_pair(3)
    jax_v = np.asarray(jax_fns["ms_ssim"](jnp.asarray(a), jnp.asarray(b)))
    got = tm.ms_ssim(_t(a), _t(b), size_average=False).numpy()
    assert _rel(got, jax_v) > 100 * TOL


def test_ms_ssim_refuses_images_without_five_scales():
    # pytorch_msssim's bound: the smaller side above (11 - 1) * 2**4
    assert tm.ms_ssim_fits((256, 176)) and tm.ms_ssim_fits((161, 300))
    assert not tm.ms_ssim_fits((160, 300))
    a = torch.zeros(1, 160, 200, 3)
    with pytest.raises(ValueError):
        tm.ms_ssim(a, a)


def test_float32_exact_restores_the_flags():
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    with tm.float32_exact():
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == before


def test_frechet_distance_matches_jax():
    rng = np.random.default_rng(5)
    d = 16
    mu1, mu2 = rng.normal(size=d), rng.normal(size=d)
    m1, m2 = rng.normal(size=(d, d)), rng.normal(size=(d, d))
    s1, s2 = m1 @ m1.T / d, m2 @ m2.T / d
    want = jm.frechet_distance(mu1, s1, mu2, s2)
    assert tm.frechet_distance(mu1, s1, mu2, s2) == pytest.approx(want,
                                                                  rel=1e-9)
    assert tm.frechet_distance(mu1, s1, mu1, s1) == pytest.approx(0.0,
                                                                  abs=1e-6)


@pytest.mark.parametrize("n,dim", [(200, 8), (24, 64)])
def test_fid_from_features_matches_jax(n, dim):
    """Float64 features, the full-rank case and the protocol's shape
    (fewer samples than dimensions: a singular covariance product)."""
    rng = np.random.default_rng(6)
    a = rng.normal(0, 1, (n, dim))
    b = rng.normal(0.5, 1.5, (n, dim))
    want = jm.fid_from_features(a, b)
    assert tm.fid_from_features(a, b) == pytest.approx(want, rel=1e-9)
