"""upgpt_torch basics against the JAX package, on CPU in float32.

Schedules must be bit-equal (same numpy code). The ops are held to 1e-5
absolute: both sides compute the same float32 formulas and differ only in
summation order inside reductions and matrix products.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers on the cores, and
# a torch pool per worker oversubscribes them
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from upgpt_tpu.diffusion import schedule as jsched  # noqa: E402
from upgpt_tpu.ops import attention as jattn  # noqa: E402
from upgpt_tpu.ops import basic as jbasic  # noqa: E402
from upgpt_torch.convert import from_jax  # noqa: E402
from upgpt_torch.diffusion import schedule as tsched  # noqa: E402
from upgpt_torch.ops import attention as tattn  # noqa: E402
from upgpt_torch.ops import basic as tbasic  # noqa: E402

ATOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------- schedule

SCHEDULES = [
    dict(),
    dict(linear_start=1e-4, linear_end=2e-2),
    dict(beta_schedule="cosine"),
    dict(parameterization="v"),
]


@pytest.mark.parametrize("kw", SCHEDULES)
def test_diffusion_schedule_bit_equal(kw):
    kw = {"linear_start": 0.00085, "linear_end": 0.012, **kw}
    a = jsched.DiffusionSchedule.create(**kw)
    b = tsched.DiffusionSchedule.create(**kw)
    for field in a.__dataclass_fields__:
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and np.array_equal(x, y), field


@pytest.mark.parametrize("steps,eta,method", [
    (50, 1.0, "uniform"), (4, 0.0, "uniform"), (20, 0.5, "quad"),
    (8, 0.0, "karras"),
])
def test_ddim_schedule_bit_equal(steps, eta, method):
    s = jsched.DiffusionSchedule.create(linear_start=0.00085,
                                        linear_end=0.012)
    a = jsched.make_ddim_schedule(s, steps, eta=eta, method=method)
    b = tsched.make_ddim_schedule(s, steps, eta=eta, method=method)
    for field in a.__dataclass_fields__:
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and np.array_equal(x, y), field
    if method == "uniform":  # the reference's +1 shift
        assert b.timesteps[-1] == 1


@pytest.mark.parametrize("grid", [[5, 3, 9], [0, 10, 20], [10, 20, 1000]])
def test_ddim_schedule_rejects_bad_grid_with_value_error(grid):
    s = tsched.DiffusionSchedule.create()
    with pytest.raises(ValueError):
        tsched.make_ddim_schedule(s, 3, timesteps=np.asarray(grid))


# ---------------------------------------------------------------- basic ops


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_group_norm_matches_jax(eps):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 8, 6, 64)) * 3 + 1).astype(np.float32)
    s = rng.normal(size=(64,)).astype(np.float32)
    b = rng.normal(size=(64,)).astype(np.float32)
    want = jbasic.group_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                             32, eps)
    got = tbasic.group_norm(_t(x), _t(s), _t(b), 32, eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_group_norm_bf16_keeps_dtype_with_fp32_stats():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(1, 4, 4, 64)).astype(np.float32))
    got = tbasic.group_norm(x.bfloat16(), torch.ones(64), torch.zeros(64))
    assert got.dtype == torch.bfloat16
    want = tbasic.group_norm(x.bfloat16().float(), torch.ones(64),
                             torch.zeros(64))
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=2e-2)


@pytest.mark.parametrize("dim", [224, 33])
def test_timestep_embedding_matches_jax(dim):
    t = np.array([0, 1, 17, 999], np.int32)
    want = jbasic.timestep_embedding(jnp.asarray(t), dim)
    got = tbasic.timestep_embedding(_t(t), dim)
    # sin/cos of arguments up to 999 rad: float32 libm results differ by
    # a few ulp of the argument's magnitude
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("dim", [128, 33])
def test_timestep_embedding_ddpm_matches_jax(dim):
    t = np.array([0, 1, 17, 999], np.int32)
    want = jbasic.timestep_embedding_ddpm(jnp.asarray(t), dim)
    got = tbasic.timestep_embedding_ddpm(_t(t), dim)
    assert got.shape == (4, dim) and got.dtype == torch.float32
    # the same float32 formula; libm's sin/cos of arguments up to 999 rad
    # differ by a few ulp of the argument
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
    # sin first, then cos, and a zero pad column for an odd width
    np.testing.assert_array_equal(got[0, :dim // 2].numpy(), 0.0)
    np.testing.assert_array_equal(got[0, dim // 2:2 * (dim // 2)].numpy(),
                                  1.0)
    if dim % 2:
        np.testing.assert_array_equal(got[:, -1].numpy(), 0.0)


def test_silu_and_upsample_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 5, 4)).astype(np.float32)
    np.testing.assert_allclose(tbasic.silu(_t(x)).numpy(),
                               np.asarray(jbasic.silu(jnp.asarray(x))),
                               atol=1e-6)
    np.testing.assert_array_equal(
        tbasic.nearest_upsample_2x(_t(x)).numpy(),
        np.asarray(jbasic.nearest_upsample_2x(jnp.asarray(x))))


# ---------------------------------------------------------------- attention


@pytest.mark.parametrize("masked", [False, True])
def test_multi_head_attention_matches_jax(masked):
    rng = np.random.default_rng(3)
    b, tq, tk, heads, d = 2, 12, 9, 4, 8
    q = rng.normal(size=(b, tq, heads * d)).astype(np.float32)
    k = rng.normal(size=(b, tk, heads * d)).astype(np.float32)
    v = rng.normal(size=(b, tk, heads * d)).astype(np.float32)
    mask = rng.random(size=(b, tk)) > 0.3 if masked else None
    if masked:
        mask[:, 0] = True
    want = jattn.multi_head_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
        None if mask is None else jnp.asarray(mask))
    got = tattn.multi_head_attention(_t(q), _t(k), _t(v), heads,
                                     None if mask is None else _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("precomputed", [False, True])
def test_attention_weight_split_matches_jax(precomputed):
    rng = np.random.default_rng(4)
    b, t, tk, c, cd, heads = 2, 10, 7, 32, 24, 4
    w = lambda i, o: (rng.normal(size=(i, o)) / np.sqrt(i)).astype(np.float32)
    jp = {"to_q": {"kernel": w(c, c)}, "to_k": {"kernel": w(cd, c)},
          "to_v": {"kernel": w(cd, c)},
          "to_out": {"kernel": w(c, c),
                     "bias": rng.normal(size=(c,)).astype(np.float32)}}
    tp = {name: {("weight" if leaf == "kernel" else leaf):
                 _t(arr.T.copy() if leaf == "kernel" else arr)
                 for leaf, arr in sub.items()} for name, sub in jp.items()}
    z = rng.normal(size=(b, t, c)).astype(np.float32)
    src = rng.normal(size=(b, tk, cd)).astype(np.float32)
    jtree = jax.tree.map(jnp.asarray, jp)
    if precomputed:
        kv = (src @ jp["to_k"]["kernel"], src @ jp["to_v"]["kernel"])
        want = jattn.attention_weight_split(
            jnp.asarray(z), None, jtree, heads,
            kv=tuple(jnp.asarray(a) for a in kv))
        got = tattn.attention_weight_split(_t(z), None, tp, heads,
                                           kv=tuple(_t(a) for a in kv))
    else:
        want = jattn.attention_weight_split(jnp.asarray(z), jnp.asarray(src),
                                            jtree, heads)
        got = tattn.attention_weight_split(_t(z), _t(src), tp, heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# ---------------------------------------------------------------- bridge


def _bridge_target():
    from upgpt_torch.models.unet import ResBlock

    mod = ResBlock(32, 64, 16)
    rng = np.random.default_rng(5)
    flat = {
        "norm_in/scale": rng.normal(size=(32,)), "norm_in/bias": rng.normal(size=(32,)),
        "conv_in/kernel": rng.normal(size=(3, 3, 32, 64)),
        "conv_in/bias": rng.normal(size=(64,)),
        "emb_proj/kernel": rng.normal(size=(16, 64)),
        "emb_proj/bias": rng.normal(size=(64,)),
        "norm_out/scale": rng.normal(size=(64,)),
        "norm_out/bias": rng.normal(size=(64,)),
        "conv_out/kernel": rng.normal(size=(3, 3, 64, 64)),
        "conv_out/bias": rng.normal(size=(64,)),
        "skip/kernel": rng.normal(size=(1, 1, 32, 64)),
        "skip/bias": rng.normal(size=(64,)),
    }
    return mod, {k: v.astype(np.float32) for k, v in flat.items()}


def test_bridge_relays_conv_dense_and_norm():
    mod, flat = _bridge_target()
    from_jax.load_jax_params(mod, flat)
    sd = mod.state_dict()
    np.testing.assert_array_equal(
        sd["conv_in.weight"].numpy(), flat["conv_in/kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["emb_proj.weight"].numpy(),
                                  flat["emb_proj/kernel"].T)
    np.testing.assert_array_equal(sd["norm_in.weight"].numpy(),
                                  flat["norm_in/scale"])


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_bridge_is_strict(fault):
    mod, flat = _bridge_target()
    if fault == "missing":
        del flat["skip/bias"]
    elif fault == "extra":
        flat["skip/extra/kernel"] = np.zeros((2, 2), np.float32)
    else:
        flat["emb_proj/kernel"] = np.zeros((16, 65), np.float32)
    with pytest.raises(ValueError):
        from_jax.load_jax_params(mod, flat)


def test_port_never_imports_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('jax', 'jaxlib', 'flax', 'upgpt_tpu', 'orbax', 'yaml',\n"
        "             'PIL'):\n"
        "    sys.modules[name] = None\n"
        "import upgpt_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    upgpt_torch.__path__, 'upgpt_torch.')]\n"
        "for m in mods + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "assert len(mods) >= 15, mods\n"
        "for m in ('upgpt_torch.cli', 'upgpt_torch.config',\n"
        "          'upgpt_torch.checkpoint', 'upgpt_torch.inference.serving',\n"
        "          'upgpt_torch.inference.http_serve',\n"
        "          'upgpt_torch.inference.encoders',\n"
        "          'upgpt_torch.inference.png', 'upgpt_torch.models.clip',\n"
        "          'upgpt_torch.models.cond_fusion',\n"
        "          'upgpt_torch.convert.clip_weights',\n"
        "          'upgpt_torch.data.tokenizer',\n"
        "          'upgpt_torch.eval.metrics', 'upgpt_torch.eval.lpips',\n"
        "          'upgpt_torch.eval.inception', 'upgpt_torch.eval.harness',\n"
        "          'upgpt_torch.training.vae_loss',\n"
        "          'upgpt_torch.training.vae_trainer',\n"
        "          'upgpt_torch.convert.lightning', 'upgpt_torch.bringup',\n"
        "          'upgpt_torch.app', 'upgpt_torch.data.prep',\n"
        "          'upgpt_torch.training.distill',\n"
        "          'upgpt_torch.data.synthetic',\n"
        "          'upgpt_torch.parallel.multihost',\n"
        "          'upgpt_torch.parallel.mesh'):\n"
        "    assert m in mods, m\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
