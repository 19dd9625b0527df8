"""The port's evaluation harness against the JAX package's, on the CPU.

- `dump_test_results` from the same arrays writes the same files, byte
  for byte, in every group: samples, gt, recon (smaller than the crop, so
  `concats` resizes it), src, smpl, concats and styles (the reference's
  0.226862954 for R kept).
- `evaluate_dirs` over those files: the same CSV rows; SSIM within 1e-5
  of JAX's; MS-SSIM each side's own metric (the port's pytorch_msssim's,
  ROADMAP R7); LPIPS through the bridge within 1e-4; the FID equal (to
  1e-12) with one deterministic numpy feature function on both sides; the
  `fid` alias only for `fid_name == "inception"`; NaN MS-SSIM on crops
  without five scales, as JAX's.
"""

import csv
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from upgpt_torch.convert.from_jax import load_jax_params  # noqa: E402
from upgpt_torch.eval import harness as th  # noqa: E402
from upgpt_torch.eval import lpips as tl  # noqa: E402
from upgpt_torch.eval import metrics as tm  # noqa: E402
from upgpt_tpu.eval import harness as jh  # noqa: E402
from upgpt_tpu.eval import lpips as jl  # noqa: E402
from upgpt_tpu.eval import metrics as jm  # noqa: E402

GROUPS = ("samples", "gt", "recon", "src", "smpl", "concats", "styles")


def _arrays(seed, n=2, hw=(256, 192)):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-1, 1, (n, *hw, 3)).astype(np.float32)
    samples = np.clip(gt + rng.normal(0, 0.2, gt.shape), -1.2, 1.2).astype(
        np.float32)
    extra = {
        # smaller than the crop: concats resizes it to the sample's size
        "recon": rng.uniform(-1, 1, (n, 128, 96, 3)).astype(np.float32),
        "src": rng.uniform(-1, 1, (n, *hw, 3)).astype(np.float32),
        "smpl": rng.uniform(-1, 1, (n, *hw, 3)).astype(np.float32),
    }
    styles = rng.normal(0, 1, (n, 9, 224, 224, 3)).astype(np.float32)
    return [f"pair{i}___x" for i in range(n)], samples, gt, extra, styles


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    names, samples, gt, extra, styles = _arrays(0)
    out = {}
    for side, dump in (("jax", jh.dump_test_results),
                       ("port", th.dump_test_results)):
        root = tmp_path_factory.mktemp(side)
        dump(str(root), names, samples, gt=gt, extra=extra, styles=styles,
             make_concats=True)
        out[side] = root
    return out


def test_dump_is_byte_identical_to_jax(dumps):
    for group in GROUPS:
        files = sorted(os.listdir(dumps["jax"] / group))
        assert files == sorted(os.listdir(dumps["port"] / group)), group
        assert len(files) == 2
        for f in files:
            assert ((dumps["port"] / group / f).read_bytes()
                    == (dumps["jax"] / group / f).read_bytes()), (group, f)
    assert Image.open(dumps["port"] / "samples" / "pair0___x.jpg").size == (
        176, 256)
    assert Image.open(dumps["port"] / "concats" / "pair0___x.jpg").size == (
        4 * 176, 256)
    assert Image.open(dumps["port"] / "styles" / "pair0___x.jpg").size == (
        9 * 224, 224)


def _features(x):
    """A deterministic embedding both harnesses can call: float64 pixels."""
    return np.asarray(x, np.float64).reshape(x.shape[0], -1)[:, :96:3]


def _rows(root):
    with open(root / "metrics.csv", newline="") as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def lpips_pair():
    mod = jl.LPIPS()
    x = jnp.zeros((1, 32, 32, 3))
    params = jax.jit(mod.init)(jax.random.PRNGKey(1), x, x)["params"]
    params = {k: (jax.tree.map(jnp.abs, v) if k.startswith("lin_") else v)
              for k, v in dict(params).items()}
    jfn = jax.jit(lambda a, b: mod.apply({"params": params}, a, b))
    return jfn, load_jax_params(tl.LPIPS(), params).eval()


@pytest.mark.parametrize("fid_name", ["clip", "inception"])
def test_evaluate_dirs_matches_jax(dumps, lpips_pair, fid_name):
    jfn, pfn = lpips_pair
    _features.fid_name = fid_name
    try:
        want = jh.evaluate_dirs(str(dumps["jax"]), lpips_fn=jfn,
                                fid_feature_fn=_features)
        got = th.evaluate_dirs(str(dumps["port"]), lpips_fn=pfn,
                               fid_feature_fn=_features, device="cpu")
    finally:
        del _features.fid_name
    key = f"fid_{fid_name}"
    assert set(got) == set(want)
    assert ("fid" in got) == (fid_name == "inception")
    assert got[key] == pytest.approx(want[key], rel=1e-12)
    if fid_name == "inception":
        assert got["fid"] == got[key]
    assert got["n_images"] == want["n_images"] == 2
    assert got["ssim"] == pytest.approx(want["ssim"], rel=1e-5)
    assert got["lpips"] == pytest.approx(want["lpips"], rel=1e-4)
    want_rows, got_rows = _rows(dumps["jax"]), _rows(dumps["port"])
    assert [r["file"] for r in got_rows] == [r["file"] for r in want_rows]
    assert list(got_rows[0]) == ["file", "ssim", "ms_ssim", "lpips"]
    # MS-SSIM: each harness scores with its own metric (R7)
    crop = lambda d, n: th._read(d / n, (256, 176))  # noqa: E731
    for side, mod, rows in (("port", tm, got_rows),
                            ("jax", jm, want_rows)):
        for r, w in zip(rows, want_rows):
            s = crop(dumps[side] / "samples", r["file"])[None]
            g = crop(dumps[side] / "gt", r["file"])[None]
            if side == "port":
                ref = tm.ms_ssim(torch.from_numpy(s), torch.from_numpy(g))
            else:
                ref = jm.ms_ssim(jnp.asarray(s), jnp.asarray(g))
            assert float(r["ms_ssim"]) == pytest.approx(float(ref),
                                                        rel=1e-6)
            assert float(r["ssim"]) == pytest.approx(float(w["ssim"]),
                                                     rel=1e-5)
    txt = (dumps["port"] / "metrics.txt").read_text()
    assert f"{key}: " in txt and "ms_ssim: " in txt


def test_small_crops_score_nan_ms_ssim_as_jax(tmp_path):
    names, samples, gt, _, _ = _arrays(1, hw=(64, 48))
    for side, h in (("jax", jh), ("port", th)):
        h.dump_test_results(str(tmp_path / side), names, samples, gt=gt)
    want = jh.evaluate_dirs(str(tmp_path / "jax"))
    got = th.evaluate_dirs(str(tmp_path / "port"), device="cpu")
    assert np.isnan(want["ms_ssim"]) and np.isnan(got["ms_ssim"])
    assert got["ssim"] == pytest.approx(want["ssim"], rel=1e-5)


def test_evaluate_dirs_needs_pairs(tmp_path):
    (tmp_path / "samples").mkdir()
    (tmp_path / "gt").mkdir()
    with pytest.raises(FileNotFoundError):
        th.evaluate_dirs(str(tmp_path), device="cpu")
