"""The port's progressive distillation against the JAX package's, CPU.

A small geometry (the JAX tests' own: a 32-channel two-level U-Net with
attention at ds 1 over a 64-wide context, a two-level VAE, 16x16 images
to an 8x8 latent, 100 timesteps) on both sides, with the same random
weights through the bridge (N(0, 1/fan_in) weights, nothing left at zero,
so the teachers' two sub-steps differ), batches from the synthetic rig
(bit-equal on both sides) and JAX's draws injected into the port. The
port runs every kernel switch on; on CPU tensors the wrappers take their
plain versions inside the same autograd.Functions the card uses. float32
throughout, so the two differ by summation order only: 1e-5 relative on
the losses and metrics, 1e-4 of max|grad| on every gradient entry, and
the updates and ladders at the bounds stated in each test.

JAX compiles dominate the time (~13 s for a jitted distillation gradient
on this CPU), so each JAX program is compiled once in a module fixture.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from upgpt_tpu.data.synthetic import SyntheticPairs as JaxPairs  # noqa: E402
from upgpt_tpu.diffusion import latent_diffusion as jld  # noqa: E402
from upgpt_tpu.models.unet import UNetConfig as JaxUNetConfig  # noqa: E402
from upgpt_tpu.models.vae import (  # noqa: E402
    AutoencoderConfig as JaxAutoencoderConfig,
)
from upgpt_tpu.training import distill as jd  # noqa: E402
from upgpt_torch.convert.from_jax import (  # noqa: E402
    flatten_tree, load_jax_params, torch_array, torch_key,
)
from upgpt_torch.data.synthetic import SyntheticPairs  # noqa: E402
from upgpt_torch.diffusion import latent_diffusion as tld  # noqa: E402
from upgpt_torch.models.unet import UNetConfig  # noqa: E402
from upgpt_torch.models.vae import AutoencoderConfig  # noqa: E402
from upgpt_torch.training import distill as td  # noqa: E402
from upgpt_torch.training.train_state import (  # noqa: E402
    create_train_state, trainable_parameters,
)

B = 2
CTX = 64
GEOMETRY = dict(timesteps=100, latent_size=(8, 8), latent_channels=4,
                pose_input_dim=85, context_dim=CTX)
UNET = dict(in_channels=5, model_channels=64, out_channels=4,
            num_res_blocks=1, attention_resolutions=(1,), channel_mult=(1, 2),
            num_heads=4, context_dim=CTX)
VAE = dict(embed_dim=4, z_channels=4, ch=32, ch_mult=(1, 2), num_res_blocks=1,
           resolution=16)
LADDER = dict(start_steps=4, end_steps=2, steps_per_stage=2,
              learning_rate=1e-3, use_ema=True, ema_decay=0.9, adapt_steps=1)


def jax_config(**over):
    return jld.LatentDiffusionConfig(
        unet=JaxUNetConfig(use_flash_attention=False, **UNET),
        vae=JaxAutoencoderConfig(**VAE), **{**GEOMETRY, **over})


def port_model(params, **over):
    cfg = tld.LatentDiffusionConfig(
        unet=UNetConfig(use_flash_attention=True, use_fused_transformer=True,
                        use_fused_groupnorm=True, **UNET),
        vae=AutoencoderConfig(use_flash_attention=True, **VAE),
        **{**GEOMETRY, **over})
    return load_jax_params(tld.LatentDiffusion(cfg).eval(), params)


def _random_params(shapes, seed):
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            fan_in = int(np.prod(leaf.shape[:-1]))
            return rng.normal(size=leaf.shape) / np.sqrt(fan_in)
        base = 1.0 if "scale" in name else 0.0
        return base + 0.1 * rng.normal(size=leaf.shape)

    return jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(draw(p, a), jnp.float32), shapes)


def _params(cfg, seed):
    model = jld.LatentDiffusion(cfg)
    return _random_params(
        jax.eval_shape(model.init_params, jax.random.PRNGKey(0)), seed)


def _split(params):
    return ({k: v for k, v in params.items() if k != "vae"},
            {"vae": params["vae"]})


def _data():
    return dict(img_hw=(16, 16), latent_hw=(8, 8), ctx_dim=CTX,
                n_samples=16)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _normal(key, shape):
    return torch.from_numpy(np.array(jax.random.normal(key, shape,
                                                       jnp.float32)))


def _randint(key, hi):
    return torch.from_numpy(np.array(jax.random.randint(
        key, (B,), 0, hi))).long()


def jax_distill_draws(key, num_steps):
    """The draws of JAX's `distill_loss` (distill.py:185): posterior
    noise, the student-grid index, the diffusion noise."""
    k_enc, k_i, k_noise = jax.random.split(key, 3)
    shape = (B, 8, 8, 4)
    return {"posterior_noise": _normal(k_enc, shape),
            "i": _randint(k_i, num_steps), "noise": _normal(k_noise, shape)}


def jax_adapt_draws(key):
    """The draws of JAX's `adapt_loss` (distill.py:297): posterior noise,
    t, the diffusion noise."""
    k_enc, k_t, k_noise = jax.random.split(key, 3)
    shape = (B, 8, 8, 4)
    return {"posterior_noise": _normal(k_enc, shape),
            "t": _randint(k_t, GEOMETRY["timesteps"]),
            "noise": _normal(k_noise, shape)}


def ladder_draws(rng, grids):
    """JAX's ladder keys as the port's draws hook: the adapt phase from
    fold_in(rng, 777), stage s from fold_in(rng, s), each step folding in
    the state's step count (distill.py:249, 422, 453)."""
    def draws(stage, step):
        if stage < 0:
            return jax_adapt_draws(jax.random.fold_in(
                jax.random.fold_in(rng, 777), step))
        return jax_distill_draws(jax.random.fold_in(
            jax.random.fold_in(rng, stage), step), len(grids[stage + 1]))
    return draws


def _assert_grads(student, grads, tol=1e-4):
    """Every gradient entry within `tol` of JAX's largest."""
    by_name = dict(trainable_parameters(student))
    flat = flatten_tree(grads)
    assert len(flat) == len(by_name)
    top = max(np.abs(g).max() for g in flat.values())
    for jk, g in flat.items():
        got = by_name[torch_key(jk)].grad
        assert got is not None, jk
        err = np.abs(got.numpy() - torch_array(jk, g)).max()
        assert err <= tol * top, (jk, err, top)


def _assert_moves_agree(got, want, updates):
    """Weight moves after `updates` AdamW updates at LADDER's rate. Adam
    divides each gradient entry by its own magnitude, lr * g / (|g| +
    1e-8) on the first step, so an entry whose gradient lies within the
    two sides' float noise of zero (1e-4 of max|grad|, above) may move
    anywhere in [-lr, lr] on each side. Measured on this CPU: 1.5e-4 of
    the 3.16 M entries off by more than 1e-3 lr after one update (at most
    0.79 lr), 2.5e-3 after the ladder's three (at most 1.64 lr), so the
    bounds are 1e-3 and 1e-2 of the entries, and no entry past 2 lr a
    step."""
    lr = LADDER["learning_rate"]
    diff = np.abs(got - want)
    off = np.mean(diff > 1e-3 * lr)
    share = 1e-3 if updates == 1 else 1e-2
    assert off <= share and diff.max() <= 2 * lr * updates, (
        off, diff.max())


# ------------------------------------------------------------ grids


@pytest.mark.parametrize("timesteps,start,end,method", [
    (1000, 64, 4, "uniform"), (1000, 64, 4, "karras"),
    (1000, 64, 1, "karras"), (1000, 16, 2, "uniform"),
    (1000, 8, 8, "karras"), (100, 8, 2, "uniform"), (100, 8, 1, "karras"),
    (100, 64, 4, "karras"), (1000, 12, 5, "uniform")])
def test_grids_and_stage_tables_equal_jax(timesteps, start, end, method):
    """Bit for bit, both schedules; a karras grid that collapses at 100
    timesteps and a ladder that is not end * 2^k raise on both sides."""
    jsched = jld.LatentDiffusion(jax_config(timesteps=timesteps)).schedule
    tsched = tld.make_schedule(tld.LatentDiffusionConfig(
        timesteps=timesteps))
    np.testing.assert_array_equal(tsched.alphas_cumprod,
                                  jsched.alphas_cumprod)
    try:
        want = jd.make_distill_grids(jsched, start, end, method=method)
    except ValueError:
        with pytest.raises(ValueError):
            td.make_distill_grids(tsched, start, end, method=method)
        return
    got = td.make_distill_grids(tsched, start, end, method=method)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for parent in got[:-1]:
        gt = td.make_stage_tables(tsched, parent)
        wt = jd.make_stage_tables(jsched, parent)
        for f in dataclasses.fields(wt):
            a, b = getattr(gt, f.name), getattr(wt, f.name)
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        assert gt.num_steps == len(parent) // 2


def test_r3_odd_parent_grid_raises_value_error():
    sched = tld.make_schedule(tld.LatentDiffusionConfig(timesteps=100))
    with pytest.raises(ValueError, match="even length"):
        td.make_stage_tables(sched, np.asarray([3, 40, 90]))
    # JAX's is a bare assert (distill.py:115), gone under `python -O`
    with pytest.raises(AssertionError):
        jd.make_stage_tables(
            jld.LatentDiffusion(jax_config()).schedule,
            np.asarray([3, 40, 90]))


@pytest.mark.parametrize("field,value", [("steps_per_stage", 0),
                                         ("adapt_steps", -1),
                                         ("end_steps", 0)])
def test_r4_config_refused_before_any_update(field, value):
    with pytest.raises(ValueError, match=field):
        td.DistillConfig(**{field: value})


def test_r4_jax_ladder_reads_metrics_of_a_loop_that_never_ran():
    """JAX's ladder with steps_per_stage=0 and no adapt phase raises
    NameError after the empty stage loop (distill.py:470-476). No update
    runs, so a one-leaf tree stands in for the weights."""
    with pytest.raises(NameError):
        jd.progressive_distill(
            jld.LatentDiffusion(jax_config()), {"unet": {"w": jnp.zeros(2)}},
            {}, iter(()),
            jd.DistillConfig(start_steps=4, end_steps=2, steps_per_stage=0,
                             adapt_steps=0))


def test_pred_to_x_eps_equals_jax():
    rng = np.random.default_rng(3)
    out, x = (rng.normal(size=(2, 4, 4, 4)).astype(np.float32)
              for _ in range(2))
    a = np.float32([[0.9], [0.3]]).reshape(2, 1, 1, 1)
    sg = np.sqrt(1 - a * a)
    for param in ("eps", "v"):
        got = td._pred_to_x_eps(*(torch.from_numpy(v) for v in
                                  (out, x, a, sg)), param)
        want = jd._pred_to_x_eps(out, x, a, sg, param)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)


@pytest.fixture(scope="module")
def jax_ladder():
    """JAX's ladder 4 -> 2 (one adapt update, two updates a stage, EMA),
    each jitted step's inputs and outputs recorded (no donation)."""
    cfg = jax_config()
    teacher = _params(cfg, 0)
    t_tr, frozen = _split(teacher)
    calls = []

    def jit_fn(fn):
        jitted = jax.jit(fn)

        def run(state, tp, bt):
            out = jitted(state, tp, bt)
            calls.append((state, bt, out))
            return out
        return run

    rng = jax.random.PRNGKey(5)
    data = JaxPairs(**_data()).iterator(B, seed=1, as_jnp=True)
    _, s_params, grid, history = jd.progressive_distill(
        jld.LatentDiffusion(cfg), t_tr, frozen, data,
        jd.DistillConfig(**LADDER), rng=rng, jit_fn=jit_fn)
    grids = jd.make_distill_grids(jld.LatentDiffusion(cfg).schedule, 4, 2)
    return {"teacher": teacher, "params": s_params, "grid": grid,
            "history": history, "calls": calls, "rng": rng, "grids": grids}


# ------------------------------------------------- losses and gradients


def _modules(teacher, student, **over):
    """The port's teacher (eps) and v student, the student on its own
    bridged weights, sharing the teacher's VAE module."""
    t = port_model(teacher, **over).requires_grad_(False)
    s = port_model(student, parameterization="v", **over)
    s.vae = t.vae
    return t, s


def _first_gradient(state):
    """The gradient of a JAX train state's first update, read from
    AdamW's first moment: mu = (1 - b1) g after one step from zero."""
    adam = [s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(s, "mu")]
    assert len(adam) == 1
    return jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, adam[0].mu)


def _check_metrics(got, metrics):
    assert set(got) == set(metrics)
    for k in metrics:
        np.testing.assert_allclose(got[k].item(), float(metrics[k]),
                                   rtol=1e-5, err_msg=k)


def test_distill_loss_and_gradients_match_jax(jax_ladder):
    """An eps teacher: JAX's loss, metrics and gradient at stage 0's first
    update of the ladder (the adapted student, the original teacher)."""
    state, bt, (new, metrics) = jax_ladder["calls"][1]
    teacher, student = _modules(
        jax_ladder["teacher"], dict(state.params,
                                    vae=jax_ladder["teacher"]["vae"]))
    tables = td.make_stage_tables(student.schedule, jax_ladder["grids"][0])
    draws = ladder_draws(jax_ladder["rng"], jax_ladder["grids"])(0, 0)
    loss, got = td.distill_loss(student, teacher, "eps", _torch_batch(bt),
                                tables, draws=draws)
    loss.backward()
    assert set(got) == {"loss", "loss_x", "teacher_gap"}
    _check_metrics(got, metrics)
    assert float(metrics["teacher_gap"]) > 1e-6  # the two sub-steps differ
    _assert_grads(student, _first_gradient(new))
    # the teacher and the shared VAE take no gradient
    assert all(p.grad is None for p in teacher.parameters())


def test_adapt_loss_and_gradients_match_jax(jax_ladder):
    """The eps->v adaptation: JAX's loss and gradient at the ladder's
    adapt update (the student a copy of the teacher)."""
    state, bt, (new, metrics) = jax_ladder["calls"][0]
    teacher, student = _modules(jax_ladder["teacher"], jax_ladder["teacher"])
    loss, got = td.adapt_loss(
        student, teacher, "eps", _torch_batch(bt),
        draws=ladder_draws(jax_ladder["rng"], jax_ladder["grids"])(-1, 0))
    loss.backward()
    _check_metrics(got, metrics)
    _assert_grads(student, _first_gradient(new))


@pytest.fixture(scope="module")
def fusion_v():
    """A v teacher (a later stage's) on the inshop_laion route, on
    independent teacher and student weights: JAX's `distill_loss` and
    `adapt_loss` with their gradients, in one jitted program."""
    cfg = jax_config(cond_fusion="image")
    teacher, student = _params(cfg, 0), _params(cfg, 1)
    t_tr, frozen = _split(teacher)
    s_tr, _ = _split(student)
    jm = jld.LatentDiffusion(dataclasses.replace(cfg, parameterization="v"))
    sched = jm.schedule
    tables = jd.make_stage_tables(
        sched, jd.make_distill_grids(sched, 8, 4, method="karras")[0])
    batch = {k: jnp.asarray(v) for k, v in JaxPairs(**_data()).batch(
        [0, 5]).items()}
    key = jax.random.PRNGKey(2)

    def both(q):
        grad = lambda fn, *extra: jax.value_and_grad(  # noqa: E731
            lambda p: fn(jm, p, t_tr, "v", frozen, batch, key, *extra),
            has_aux=True)(q)
        return {"distill": grad(jd.distill_loss, tables),
                "adapt": grad(jd.adapt_loss)}

    return {"teacher": teacher, "student": student, "tables": tables,
            "batch": batch, "key": key, "jax": jax.jit(both)(s_tr)}


def test_distill_loss_with_cond_fusion_and_a_v_teacher_matches_jax(
        fusion_v):
    """Each model fuses the styles into the text with its own trainable
    CrossAttention, whose gradient reaches the student's; the teacher's
    outputs are read as v."""
    (_, metrics), grads = fusion_v["jax"]["distill"]
    tables = fusion_v["tables"]
    t, s = _modules(fusion_v["teacher"], fusion_v["student"],
                    cond_fusion="image")
    got_loss, got = td.distill_loss(
        s, t, "v", _torch_batch(fusion_v["batch"]), tables,
        draws=jax_distill_draws(fusion_v["key"], tables.num_steps))
    got_loss.backward()
    _check_metrics(got, metrics)
    assert float(metrics["teacher_gap"]) > 1e-6
    _assert_grads(s, grads)
    assert s.cond_fusion.cross_att.to_q.weight.grad.abs().max() > 0


def test_adapt_loss_with_a_v_teacher_matches_jax(fusion_v):
    """The adaptation loss reads a v teacher's outputs as v (the ladder
    runs it for eps teachers only; the function takes either)."""
    (_, metrics), grads = fusion_v["jax"]["adapt"]
    t, s = _modules(fusion_v["teacher"], fusion_v["student"],
                    cond_fusion="image")
    got_loss, got = td.adapt_loss(
        s, t, "v", _torch_batch(fusion_v["batch"]),
        draws=jax_adapt_draws(fusion_v["key"]))
    got_loss.backward()
    _check_metrics(got, metrics)
    _assert_grads(s, grads)


# ------------------------------------------------------------- ladders


def _run_port_ladder(jl, **kw):
    teacher = port_model(jl["teacher"])
    data = SyntheticPairs(**_data()).iterator(B, seed=1)
    return teacher, td.progressive_distill(
        teacher, data, td.DistillConfig(**LADDER),
        draws=ladder_draws(jl["rng"], jl["grids"]), **kw)


def test_one_distill_step_update_matches_jax(jax_ladder):
    """Stage 0's first update, from the state JAX's ladder handed its
    step, compared as updates (`_assert_moves_agree`), the EMA shadow's
    move too; the metrics within 1e-5."""
    state, bt, (new, metrics) = jax_ladder["calls"][1]
    assert int(state.step) == 0 and int(new.step) == 1
    full = dict(state.params, vae=jax_ladder["teacher"]["vae"])
    teacher = port_model(jax_ladder["teacher"]).requires_grad_(False)
    student = port_model(full, parameterization="v")
    student.vae = teacher.vae
    tstate = create_train_state(
        student, LADDER["learning_rate"], scheduler=td._anneal(2),
        use_ema=True, ema_decay=LADDER["ema_decay"], weight_decay=0.0)
    before = [p.detach().clone() for p in tstate.params]
    tables = td.make_stage_tables(student.schedule, jax_ladder["grids"][0])
    draws = ladder_draws(jax_ladder["rng"], jax_ladder["grids"])(0, 0)
    tstate, got = td.distill_step(student, tstate, teacher, "eps",
                                  _torch_batch(bt), tables, draws=draws)
    for k in metrics:
        np.testing.assert_allclose(got[k].item(), float(metrics[k]),
                                   rtol=1e-5, err_msg=k)
    by_name = dict(zip(tstate.names, zip(before, tstate.params,
                                         tstate.ema.shadow)))
    flat_old, flat_new = flatten_tree(state.params), flatten_tree(new.params)
    flat_ema = flatten_tree(new.ema.shadow)
    moves = {"update": ([], []), "shadow": ([], [])}
    for jk, old in flat_old.items():
        b, p, s = by_name[torch_key(jk)]
        # the update, and the shadow's move (1 - min(0.9, 2/11) of it)
        for what, got, want in (("update", p - b, flat_new[jk] - old),
                                ("shadow", s - b, flat_ema[jk] - old)):
            moves[what][0].append(got.detach().numpy().ravel())
            moves[what][1].append(torch_array(jk, want).ravel())
    for what, (got, want) in moves.items():
        _assert_moves_agree(np.concatenate(got), np.concatenate(want), 1)


def test_ladder_matches_jax(jax_ladder):
    """The whole one-stage ladder with JAX's keys: the same grid, the same
    history keys and stages, metrics within 1e-4 relative (the first
    updates' sign flips reach the later steps' losses), and the final
    student's move from the teacher as `_assert_moves_agree` bounds it."""
    teacher, (student, grid, history) = _run_port_ladder(jax_ladder)
    np.testing.assert_array_equal(grid, jax_ladder["grid"])
    want = jax_ladder["history"]
    assert [(h["stage"], h["steps"], sorted(h)) for h in history] == [
        (h["stage"], h["steps"], sorted(h)) for h in want]
    assert history[0]["adapt"] is True and history[0]["steps"] == 4
    for got, ref in zip(history, want):
        for k, v in ref.items():
            if k not in ("stage", "steps", "adapt"):
                np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=k)
    by_name = dict(trainable_parameters(student))
    start = flatten_tree(_split(jax_ladder["teacher"])[0])
    got, want = [], []
    for jk, w in flatten_tree(jax_ladder["params"]).items():
        want.append(torch_array(jk, w - start[jk]).ravel())
        got.append((by_name[torch_key(jk)].detach().numpy()
                    - torch_array(jk, start[jk])).ravel())
    _assert_moves_agree(np.concatenate(got), np.concatenate(want), 3)
    assert student.config.parameterization == "v"


def test_ladder_equals_a_hand_loop_bit_for_bit(jax_ladder):
    """progressive_distill against the port's own steps in a loop: the
    adapt update, the EMA handed to stage 0 as its init, stage 0 against
    the ORIGINAL teacher; and the two-module contract: one VAE module, no
    storage shared between teacher and student, the teacher frozen and in
    eval mode throughout."""
    rungs = []
    teacher, (student, grid, history) = _run_port_ladder(
        jax_ladder, stage_cb=lambda n, g, s: rungs.append((n, g.tolist())))
    assert rungs == [(2, grid.tolist())]
    assert student.vae is teacher.vae
    t_ptrs = {p.data_ptr() for p in teacher.parameters()}
    assert not t_ptrs & {p.data_ptr() for _, p in
                         trainable_parameters(student)}
    assert not any(p.requires_grad for p in teacher.parameters())
    assert not teacher.training

    draws = ladder_draws(jax_ladder["rng"], jax_ladder["grids"])
    ref_t = port_model(jax_ladder["teacher"]).requires_grad_(False)
    ref_s = port_model(jax_ladder["teacher"], parameterization="v")
    ref_s.vae = ref_t.vae
    data = SyntheticPairs(**_data()).iterator(B, seed=1)
    kw = dict(use_ema=True, ema_decay=LADDER["ema_decay"], weight_decay=0.0)
    lr = LADDER["learning_rate"]
    state = create_train_state(ref_s, lr, scheduler=td._anneal(1), **kw)
    state, m = td.adapt_step(ref_s, state, ref_t, "eps", next(data),
                             draws=draws(-1, 0))
    hand = [m["loss"].item()]
    with torch.no_grad():
        for p, s in zip(state.params, state.ema.shadow):
            p.copy_(s)
    tables = td.make_stage_tables(ref_s.schedule, jax_ladder["grids"][0])
    state = create_train_state(ref_s, lr, scheduler=td._anneal(2), **kw)
    for k in range(2):
        state, m = td.distill_step(ref_s, state, ref_t, "eps", next(data),
                                   tables, draws=draws(0, k))
    with torch.no_grad():
        for p, s in zip(state.params, state.ema.shadow):
            p.copy_(s)
    hand.append({k: v.item() for k, v in m.items()})
    assert history[0]["loss"] == hand[0]
    assert {k: history[1][k] for k in hand[1]} == hand[1]
    for (n, p), (n2, q) in zip(trainable_parameters(student),
                               trainable_parameters(ref_s)):
        assert n == n2 and torch.equal(p, q), n


def test_chained_start_grid_continues_a_students_grid():
    """A v teacher (a student) with its own grid: no adapt phase, the grid
    halved from its own points, every rung handed out; a grid that cannot
    halve to end_steps raises before any update."""
    params = _params(jax_config(), 0)
    teacher = port_model(params, parameterization="v")
    data = SyntheticPairs(**_data()).iterator(B, seed=0)
    custom = np.asarray([7, 23, 61, 97], np.int64)
    rungs = []
    student, grid, history = td.progressive_distill(
        teacher, data,
        td.DistillConfig(start_steps=64, end_steps=1, steps_per_stage=1,
                         learning_rate=1e-4, use_ema=False, adapt_steps=5),
        generator=torch.Generator().manual_seed(0), start_grid=custom,
        stage_cb=lambda n, g, s: rungs.append((n, g.tolist())))
    np.testing.assert_array_equal(grid, [97])
    assert rungs == [(2, [23, 97]), (1, [97])]
    assert [(h["stage"], h["steps"]) for h in history] == [(0, 2), (1, 1)]
    assert all(np.isfinite(h["loss"]) for h in history)
    with pytest.raises(ValueError, match="cannot halve"):
        td.progressive_distill(
            teacher, data,
            td.DistillConfig(end_steps=4, steps_per_stage=1, adapt_steps=0),
            start_grid=np.asarray([1, 5, 9, 13, 17, 21], np.int64))
