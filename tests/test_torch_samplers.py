"""The port's samplers against the JAX package's, on the CPU in float32.

Both sides run the same cheap analytic eps model (seeded numpy weights, one
closure written for both frameworks), so no U-Net is compiled. x_T and
every per-step draw are made by JAX's own key splits and injected into the
port, whose generators draw other numbers. Tables are bit-equal (the same
float64 numpy code); sampled latents agree to atol 2e-5 / rtol 1e-5, the
tolerance `tests/test_unipc.py` holds the JAX samplers to: both sides
compute the same float32 formulas and differ only where XLA fuses
multiply-adds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers on the cores, and
# a torch pool per worker oversubscribes them
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from upgpt_tpu.diffusion import ddim as jddim  # noqa: E402
from upgpt_tpu.diffusion import dpm_solver as jdpm  # noqa: E402
from upgpt_tpu.diffusion import plms as jplms  # noqa: E402
from upgpt_tpu.diffusion import schedule as jsched  # noqa: E402
from upgpt_tpu.diffusion import unipc as junipc  # noqa: E402
from upgpt_torch.diffusion import ddim as tddim  # noqa: E402
from upgpt_torch.diffusion import dpm_solver as tdpm  # noqa: E402
from upgpt_torch.diffusion import plms as tplms  # noqa: E402
from upgpt_torch.diffusion import schedule as tsched  # noqa: E402
from upgpt_torch.diffusion import unipc as tunipc  # noqa: E402

SHAPE = (2, 4, 3, 4)
TOL = dict(atol=2e-5, rtol=1e-5)
KW = dict(linear_start=0.00085, linear_end=0.012)
JS = jsched.DiffusionSchedule.create(**KW)
TS = tsched.DiffusionSchedule.create(**KW)
GRIDS = [("uniform", 10), ("quad", 8), ("karras", 8)]

_rng = np.random.default_rng(0)
W = (_rng.normal(size=(4, 4)) / 2.0).astype(np.float32)
BIAS = (0.1 * _rng.normal(size=(4,))).astype(np.float32)
X_T = _rng.normal(size=SHAPE).astype(np.float32)
X0 = np.tanh(_rng.normal(size=SHAPE)).astype(np.float32)
COND = (0.5 * _rng.normal(size=(2, 4))).astype(np.float32)
UNCOND = (0.5 * _rng.normal(size=(2, 4))).astype(np.float32)
MASK = (_rng.random(size=SHAPE[:3] + (1,)) < 0.5).astype(np.float32)


def _model(asarray, to_float, tanh):
    """eps(x, t, c) = tanh(x W + b + c) * (1 + t / 1000): smooth, and
    different at every timestep; one closure for both frameworks."""
    w, b = asarray(W), asarray(BIAS)

    def eps(x, t, cond):
        c = cond["c"].reshape(x.shape[0], 1, 1, -1)
        scale = 1.0 + to_float(t.reshape(-1, 1, 1, 1)) / 1000.0
        return tanh(x @ w + b + c) * scale

    return eps


JAX_EPS = _model(jnp.asarray, lambda t: t.astype(jnp.float32), jnp.tanh)
TORCH_EPS = _model(torch.from_numpy, lambda t: t.float(), torch.tanh)


def _jcond(c=COND):
    return {"c": jnp.asarray(c)}


def _tcond(c=COND):
    return {"c": torch.from_numpy(c)}


def _split_draws(key, n, per_step=1):
    """The normal draws JAX's DDIM scan takes from `key` over n steps,
    `per_step` splits a step, in split order: (n, per_step, *SHAPE)."""
    out = []
    k = key
    for _ in range(n):
        row = []
        for _ in range(per_step):
            k, kn = jax.random.split(k)
            row.append(np.asarray(jax.random.normal(kn, SHAPE, jnp.float32)))
        out.append(row)
    return np.asarray(out, np.float32)


def _fields_equal(a, b):
    for field in a.__dataclass_fields__:
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and np.array_equal(x, y), field


@pytest.mark.parametrize("method,steps", GRIDS)
def test_solver_tables_bit_equal(method, steps):
    _fields_equal(junipc.make_unipc_schedule(JS, steps, method),
                  tunipc.make_unipc_schedule(TS, steps, method))
    _fields_equal(jdpm.make_dpm_solver_schedule(JS, steps, method),
                  tdpm.make_dpm_solver_schedule(TS, steps, method))


@pytest.mark.parametrize("method,steps", GRIDS)
@pytest.mark.parametrize("guidance", [1.0, 3.0])
def test_unipc_matches_jax(method, steps, guidance):
    uj = _jcond(UNCOND) if guidance != 1.0 else None
    ut = _tcond(UNCOND) if guidance != 1.0 else None
    want = junipc.unipc_sample(
        JAX_EPS, junipc.make_unipc_schedule(JS, steps, method), SHAPE,
        _jcond(), jax.random.PRNGKey(0), x_T=jnp.asarray(X_T),
        guidance_scale=guidance, uncond=uj)
    got = tunipc.unipc_sample(
        TORCH_EPS, tunipc.make_unipc_schedule(TS, steps, method), SHAPE,
        _tcond(), x_T=torch.from_numpy(X_T), guidance_scale=guidance,
        uncond=ut)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("method,steps", GRIDS)
def test_dpm_solver_matches_jax(method, steps):
    want = jdpm.dpm_solver_pp_sample(
        JAX_EPS, jdpm.make_dpm_solver_schedule(JS, steps, method), SHAPE,
        _jcond(), jax.random.PRNGKey(0), x_T=jnp.asarray(X_T))
    got = tdpm.dpm_solver_pp_sample(
        TORCH_EPS, tdpm.make_dpm_solver_schedule(TS, steps, method), SHAPE,
        _tcond(), x_T=torch.from_numpy(X_T))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("sampler", ["unipc", "dpm++"])
def test_single_step_is_ddim_eta0(sampler):
    # no history and no corrector: one step is the DDIM eta-0 update
    ddim = tddim.ddim_sample(TORCH_EPS, tsched.make_ddim_schedule(TS, 1),
                             SHAPE, _tcond(), x_T=torch.from_numpy(X_T))
    if sampler == "unipc":
        got = tunipc.unipc_sample(TORCH_EPS, tunipc.make_unipc_schedule(
            TS, 1), SHAPE, _tcond(), x_T=torch.from_numpy(X_T))
    else:
        got = tdpm.dpm_solver_pp_sample(
            TORCH_EPS, tdpm.make_dpm_solver_schedule(TS, 1), SHAPE, _tcond(),
            x_T=torch.from_numpy(X_T))
    np.testing.assert_allclose(got.numpy(), ddim.numpy(), **TOL)


@pytest.mark.parametrize("method,steps", [("uniform", 5), ("quad", 6)])
def test_plms_matches_jax(method, steps):
    want = jplms.plms_sample(
        JAX_EPS, JS, jsched.make_ddim_schedule(JS, steps, 0.0, method),
        SHAPE, _jcond(), jax.random.PRNGKey(0), x_T=jnp.asarray(X_T))
    got = tplms.plms_sample(
        TORCH_EPS, tsched.make_ddim_schedule(TS, steps, 0.0, method), SHAPE,
        _tcond(), x_T=torch.from_numpy(X_T))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plms_rejects_eta_with_value_error():
    with pytest.raises(ValueError, match="eta=0"):
        tplms.plms_sample(TORCH_EPS, tsched.make_ddim_schedule(TS, 5, 1.0),
                          SHAPE, _tcond(), x_T=torch.from_numpy(X_T))


@pytest.mark.parametrize("temperature", [1.0, 0.5])
def test_ddim_temperature_matches_jax(temperature):
    steps, key = 4, jax.random.PRNGKey(3)
    ddim_j = jsched.make_ddim_schedule(JS, steps, eta=1.0)
    want = jddim.ddim_sample(JAX_EPS, JS, ddim_j, SHAPE, _jcond(), key,
                             x_T=jnp.asarray(X_T), temperature=temperature)
    noise = torch.from_numpy(_split_draws(key, steps)[:, 0])
    got = tddim.ddim_sample(TORCH_EPS, tsched.make_ddim_schedule(
        TS, steps, eta=1.0), SHAPE, _tcond(), x_T=torch.from_numpy(X_T),
        noise=noise, temperature=temperature)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_ddim_inpaint_matches_jax(eta):
    # each step splits the q-sample noise first, then (eta > 0) its own
    steps, key = 4, jax.random.PRNGKey(4)
    want = jddim.ddim_sample(
        JAX_EPS, JS, jsched.make_ddim_schedule(JS, steps, eta=eta), SHAPE,
        _jcond(), key, x_T=jnp.asarray(X_T), inpaint_mask=jnp.asarray(MASK),
        x0=jnp.asarray(X0))
    draws = torch.from_numpy(_split_draws(key, steps, 2 if eta else 1))
    got = tddim.ddim_sample(
        TORCH_EPS, tsched.make_ddim_schedule(TS, steps, eta=eta), SHAPE,
        _tcond(), x_T=torch.from_numpy(X_T), schedule=TS,
        inpaint_mask=torch.from_numpy(MASK), x0=torch.from_numpy(X0),
        inpaint_noise=draws[:, 0], noise=draws[:, 1] if eta else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ddim_return_pred_x0_matches_jax():
    ddim_j = jsched.make_ddim_schedule(JS, 5, eta=0.0, method="karras")
    z_want, x0_want = jddim.ddim_sample(
        JAX_EPS, JS, ddim_j, SHAPE, _jcond(), jax.random.PRNGKey(0),
        x_T=jnp.asarray(X_T), return_pred_x0=True)
    z, x0 = tddim.ddim_sample(
        TORCH_EPS, tsched.make_ddim_schedule(TS, 5, eta=0.0, method="karras"),
        SHAPE, _tcond(), x_T=torch.from_numpy(X_T), return_pred_x0=True)
    assert tuple(x0.shape) == (ddim_j.num_steps,) + SHAPE
    np.testing.assert_allclose(z.numpy(), np.asarray(z_want), **TOL)
    np.testing.assert_allclose(x0.numpy(), np.asarray(x0_want), **TOL)


@pytest.mark.parametrize("strength", [0.5, 1.0])
def test_ddim_img2img_matches_jax(strength):
    steps, key = 4, jax.random.PRNGKey(5)
    want = jddim.ddim_img2img(
        JAX_EPS, JS, jsched.make_ddim_schedule(JS, steps, eta=1.0),
        jnp.asarray(X0), _jcond(), key, strength=strength)
    key, k_enc = jax.random.split(key)
    enc = np.array(jax.random.normal(k_enc, SHAPE, jnp.float32))
    t_enc = max(1, min(int(strength * steps), steps))
    got = tddim.ddim_img2img(
        TORCH_EPS, tsched.make_ddim_schedule(TS, steps, eta=1.0),
        torch.from_numpy(X0), _tcond(), strength=strength,
        encode_noise=torch.from_numpy(enc),
        noise=torch.from_numpy(_split_draws(key, t_enc)[:, 0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ddim_stochastic_encode_matches_jax():
    noise = np.random.default_rng(6).normal(size=SHAPE).astype(np.float32)
    t_index = np.array([0, 3], np.int32)
    want = jddim.ddim_stochastic_encode(
        JS, jsched.make_ddim_schedule(JS, 4), jnp.asarray(X0),
        jnp.asarray(t_index), jax.random.PRNGKey(0), noise=jnp.asarray(noise))
    got = tddim.ddim_stochastic_encode(
        tsched.make_ddim_schedule(TS, 4), torch.from_numpy(X0),
        torch.from_numpy(t_index), noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
