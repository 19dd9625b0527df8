"""Progressive distillation: few-step students below the 8-step wall.

Port of `upgpt_tpu.training.distill` (Salimans & Ho, "Progressive
Distillation for Fast Sampling of Diffusion Models", arXiv:2202.00512): a
student takes ONE step where its teacher takes TWO, and the ladder halves
repeatedly (64 -> 32 -> ... -> 4 sampling steps). Students are
v-parameterised (well conditioned at the few-step grids' high-t points,
where an eps model's x0 estimate blows up by 1/alpha_t) and sample through
`LatentDiffusion.to_eps` on their own nested grid: `cli sample`, `test`
and `serve` read the grid from the checkpoint's `.distill.json` sidecar.

JAX distils two parameter trees over one stateless model. Here the teacher
and the student are two `LatentDiffusion` modules that share one frozen
VAE module (one copy of it on the card). The teacher runs in eval mode
with `requires_grad` off and under `torch.no_grad()`, so its fused blocks
save nothing for a backward and no recompute runs; the student runs one
forward and backward per update, AdamW + EMA through
`train_state.create_train_state`. Losses are float32, as JAX's.

Randomness comes from one `torch.Generator` in JAX's split order
(`distill_draws`; the adapt phase draws as `LatentDiffusion.
training_draws`), or from explicit `draws`, which is how the tests replay
JAX's keys.

CFG note: guidance distillation is out of scope, as in JAX: the released
eval protocol never builds an unconditional batch (reference
ddpm.py:1380-1444), so the students match the guidance-off serving path.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from upgpt_torch.diffusion.latent_diffusion import (
    LatentDiffusion, make_schedule,
)
from upgpt_torch.diffusion.schedule import (
    DiffusionSchedule, make_karras_timesteps,
)
from upgpt_torch.training.train_state import (
    TrainState, create_train_state, trainable_parameters,
)

Draws = Dict[str, torch.Tensor]


# ---------------- nested halving grids ----------------


def make_distill_grids(
    schedule: DiffusionSchedule,
    start_steps: int = 64,
    end_steps: int = 1,
    method: str = "uniform",
    rho: float = 7.0,
) -> List[np.ndarray]:
    """[g_N, g_N/2, ..., g_end]: ascending int t-grids, each the odd-index
    subset of its parent so a student step spans exactly two teacher steps.

    With an ascending parent grid h of length 2N, the child is h[1::2]: it
    keeps t_max, and its final update g[0] -> clean has teacher midpoint
    h[0], the two sub-steps the parent's own DDIM sampler takes.
    start_steps must be end_steps * 2^k so every stage halves evenly.
    """
    if start_steps % end_steps or (start_steps // end_steps) & (
            start_steps // end_steps - 1):
        raise ValueError(
            f"start_steps={start_steps} must be end_steps={end_steps} * 2^k")
    T = schedule.num_timesteps
    if method == "karras":
        ts = make_karras_timesteps(schedule, start_steps, rho)
    else:
        ts = np.unique(
            np.round(np.linspace(1, T - 1, start_steps)).astype(np.int64))
    if len(ts) != start_steps:
        raise ValueError(
            f"grid collapsed to {len(ts)} unique points (wanted "
            f"{start_steps}); use a coarser start grid")
    grids = [ts]
    while len(ts) > end_steps:
        ts = ts[1::2]
        grids.append(ts)
    return grids


@dataclasses.dataclass(frozen=True)
class StageTables:
    """Static per-stage tables for one halving stage (all shape (N,)).

    Index i is the student step FROM t=ts[i]; its target point is the
    parent grid's next-lower point (parent[2i-1], or the DDIM terminal
    acp[0] point for i=0: the terminal the student's own sampler uses,
    diffusion/schedule.make_ddim_schedule's alphas_prev[0]).
    """

    ts: np.ndarray       # (N,) int32 student grid, ascending
    a_t: np.ndarray      # sqrt(acp) at ts
    s_t: np.ndarray      # sqrt(1-acp) at ts
    t_mid: np.ndarray    # (N,) int32 teacher midpoint
    a_mid: np.ndarray
    s_mid: np.ndarray
    a_next: np.ndarray   # student-step target point
    s_next: np.ndarray

    @property
    def num_steps(self) -> int:
        return int(self.ts.shape[0])


def make_stage_tables(schedule: DiffusionSchedule, parent: np.ndarray
                      ) -> StageTables:
    """Tables for distilling a parent-grid teacher into a child-grid
    student. An odd-length parent raises ValueError (JAX asserts, which
    `python -O` drops: ROADMAP R3)."""
    if len(parent) % 2:
        raise ValueError(f"parent grid must have even length, got "
                         f"{len(parent)}")
    acp = schedule.alphas_cumprod.astype(np.float64)
    child = parent[1::2]
    mid = parent[0::2]
    # target of student step i: parent[2i-1]; for i=0 the DDIM terminal
    # point acp[0] (make_ddim_schedule's alphas_prev for the last update)
    nxt_acp = np.concatenate([[acp[0]], acp[parent[1:-1:2]]])
    a = lambda x: np.sqrt(x).astype(np.float32)  # noqa: E731
    s = lambda x: np.sqrt(1.0 - x).astype(np.float32)  # noqa: E731
    return StageTables(
        ts=child.astype(np.int32),
        a_t=a(acp[child]), s_t=s(acp[child]),
        t_mid=mid.astype(np.int32),
        a_mid=a(acp[mid]), s_mid=s(acp[mid]),
        a_next=a(nxt_acp), s_next=s(nxt_acp),
    )


# ---------------- the losses ----------------


def _pred_to_x_eps(out: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
                   sg: torch.Tensor, param: str
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x0_hat, eps_hat) in float32 from a model output under `param` at
    (a, sg)."""
    out = out.float()
    x = x.float()
    if param == "eps":
        return (x - sg * out) / a, out
    if param == "v":
        return a * x - sg * out, sg * x + a * out
    raise NotImplementedError(param)


def _get(batch: Dict[str, torch.Tensor], key: str, dev
         ) -> Optional[torch.Tensor]:
    return None if batch.get(key) is None else batch[key].to(
        dev, torch.float32)


def _cond(model: LatentDiffusion, batch: Dict[str, torch.Tensor], dev
          ) -> Dict[str, Any]:
    """The model's own conditioning of a batch: its pose stage, and its
    text-style fusion where it has one."""
    return {"c_crossattn": model.build_context(
                _get(batch, "text_emb", dev), _get(batch, "style_emb", dev),
                _get(batch, "smpl", dev)),
            "c_concat": _get(batch, "person_mask", dev)}


def distill_draws(student: LatentDiffusion, batch_size: int, num_steps: int,
                  generator: Optional[torch.Generator] = None) -> Draws:
    """The random tensors of one distillation loss, drawn from `generator`
    in JAX's split order: the posterior noise, the student-grid index
    i ~ U{0, ..., num_steps-1}, then the diffusion noise."""
    cfg = student.config
    shape = (batch_size,) + tuple(cfg.latent_size) + (cfg.vae.embed_dim,)
    dev = student.device
    posterior_noise = torch.randn(shape, generator=generator, device=dev)
    i = torch.randint(0, num_steps, (batch_size,), generator=generator,
                      device=dev)
    noise = torch.randn(shape, generator=generator, device=dev)
    return {"posterior_noise": posterior_noise, "i": i, "noise": noise}


def _gather(tables: StageTables, i: torch.Tensor):
    """The stage tables at the drawn indices: the six coefficients as
    (B, 1, 1, 1) float32 and (t, t_mid) as int64."""
    coef = torch.from_numpy(np.stack([
        tables.a_t, tables.s_t, tables.a_mid, tables.s_mid, tables.a_next,
        tables.s_next])).to(i.device)[:, i].reshape(6, -1, 1, 1, 1)
    ts = torch.from_numpy(np.stack([tables.ts, tables.t_mid]).astype(
        np.int64)).to(i.device)[:, i]
    return coef.unbind(0), ts.unbind(0)


def distill_loss(student: LatentDiffusion, teacher: LatentDiffusion,
                 teacher_param_type: str, batch: Dict[str, torch.Tensor],
                 tables: StageTables,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[Draws] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One progressive-distillation loss (arXiv:2202.00512 alg. 2).

    Draw t from the STUDENT grid, noise the data latent to z_t, run the
    teacher two eta-0 DDIM sub-steps (t -> t_mid -> t_next) on the parent
    grid without gradient, and regress the student's one-step x0
    prediction onto the x target whose single DDIM update lands exactly on
    the teacher's two-step result. The loss is in x-space with the
    truncated-SNR weight max(SNR, 1) (§4 eq. 13) and `loss_w` where the
    batch has it. `teacher_param_type` is how the teacher's outputs are
    read: its config's for stage 0, "v" once the teacher is a student.
    """
    dev = student.device
    image = _get(batch, "image", dev)
    if draws is None:
        draws = distill_draws(student, image.shape[0], tables.num_steps,
                              generator)
    z0 = student.encode_first_stage(image, noise=draws["posterior_noise"])
    (a_t, s_t, a_mid, s_mid, a_next, s_next), (t, t_mid) = _gather(
        tables, draws["i"].to(dev).long())
    z_t = a_t * z0 + s_t * draws["noise"].to(dev, torch.float32)

    with torch.no_grad():
        # the teacher: two eta-0 DDIM sub-steps on the parent grid
        cond_t = _cond(teacher, batch, dev)
        x1, e1 = _pred_to_x_eps(teacher.apply_model(z_t, t, cond_t), z_t,
                                a_t, s_t, teacher_param_type)
        z_mid = a_mid * x1 + s_mid * e1
        x2, e2 = _pred_to_x_eps(teacher.apply_model(z_mid, t_mid, cond_t),
                                z_mid, a_mid, s_mid, teacher_param_type)
        z_next = a_next * x2 + s_next * e2
        # the x whose single student DDIM step from (z_t, t) lands on
        # z_next: z_next = a_next*x + s_next*(z_t - a_t*x)/s_t, so
        # x = (z_next - (s_next/s_t) z_t) / (a_next - (s_next/s_t) a_t);
        # the denominator is positive on a descending-sigma grid
        ratio = s_next / s_t
        x_tgt = (z_next - ratio * z_t) / (a_next - ratio * a_t)

    out_s = student.apply_model(z_t, t, _cond(student, batch, dev))
    x_hat, _ = _pred_to_x_eps(out_s, z_t, a_t, s_t,
                              student.config.parameterization)
    w = torch.clamp((a_t / s_t) ** 2, min=1.0)
    sq = (x_hat - x_tgt).square()
    loss_w = _get(batch, "loss_w", dev)
    if loss_w is not None:
        sq = sq * loss_w
    loss = (w * sq).mean()
    return loss, {"loss": loss.detach(), "loss_x": sq.detach().mean(),
                  "teacher_gap": (x2 - x1).square().mean()}


def adapt_loss(student: LatentDiffusion, teacher: LatentDiffusion,
               teacher_param_type: str, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               draws: Optional[Draws] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """eps->v adaptation loss: regress the student's v output onto the
    teacher's own one-step prediction at the SAME t (uniform over the full
    trained range), a pure re-parameterisation fit with no halving.
    `draws` are `training_draws`' (posterior noise, t, noise)."""
    dev = student.device
    image = _get(batch, "image", dev)
    if draws is None:
        draws = student.training_draws(image.shape[0], generator)
    z0 = student.encode_first_stage(image, noise=draws["posterior_noise"])
    t = draws["t"].to(dev).long()
    a = student._table("sqrt_alphas_cumprod", t, z0.dim())
    sg = student._table("sqrt_one_minus_alphas_cumprod", t, z0.dim())
    z_t = a * z0 + sg * draws["noise"].to(dev, torch.float32)
    with torch.no_grad():
        x_hat, e_hat = _pred_to_x_eps(
            teacher.apply_model(z_t, t, _cond(teacher, batch, dev)), z_t, a,
            sg, teacher_param_type)
        v_tgt = a * e_hat - sg * x_hat
    out_s = student.apply_model(z_t, t, _cond(student, batch, dev))
    loss = (out_s.float() - v_tgt).square().mean()
    return loss, {"loss": loss.detach()}


def _update(state: TrainState, loss_fn, *args
            ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    for p in state.params:
        p.grad = None
    loss, metrics = loss_fn(*args)
    loss.backward()
    state.apply_gradients()
    return state, metrics


def distill_step(student: LatentDiffusion, state: TrainState,
                 teacher: LatentDiffusion, teacher_param_type: str,
                 batch: Dict[str, torch.Tensor], tables: StageTables,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[Draws] = None
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One distillation update of the student: loss, backward, AdamW, EMA."""
    return _update(state, distill_loss, student, teacher, teacher_param_type,
                   batch, tables, generator, draws)


def adapt_step(student: LatentDiffusion, state: TrainState,
               teacher: LatentDiffusion, teacher_param_type: str,
               batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               draws: Optional[Draws] = None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One eps->v adaptation update of the student."""
    return _update(state, adapt_loss, student, teacher, teacher_param_type,
                   batch, generator, draws)


# ---------------- the halving ladder ----------------


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    start_steps: int = 64       # top teacher sampling grid
    end_steps: int = 4          # final student step count
    steps_per_stage: int = 2000  # optimizer steps per halving
    learning_rate: float = 1e-4  # paper: (much) lower than base training
    weight_decay: float = 0.0
    grid_method: str = "uniform"  # or "karras" (nested halving keeps shape)
    use_ema: bool = True          # hand each stage's EMA to the next stage
    ema_decay: float = 0.999      # shorter horizon than base training
    # anneal the learning rate linearly to zero over each stage (constant-
    # lr Adam leaves a parameter-noise floor around the optimum)
    anneal: bool = True
    # eps->v adaptation: N updates regressing a v copy's output onto the
    # teacher's own one-step prediction at the same t. The result is ONLY
    # the stage-0 student's init; the stage-0 teacher stays the original
    # eps model
    adapt_steps: int = 400

    def __post_init__(self):
        # JAX's ladder reads a stage's metrics after a loop that may not
        # have run (ROADMAP R4): refuse such a config before any update
        if self.steps_per_stage < 1:
            raise ValueError(f"steps_per_stage must be at least 1, got "
                             f"{self.steps_per_stage}")
        if self.adapt_steps < 0:
            raise ValueError(f"adapt_steps must be at least 0, got "
                             f"{self.adapt_steps}")
        if self.end_steps < 1:
            raise ValueError(f"end_steps must be at least 1, got "
                             f"{self.end_steps}")


def _anneal(n_steps: int) -> Callable[[int], float]:
    # the linear-to-zero multiplier over a stage, in float32 as JAX's
    f32 = np.float32
    return lambda s: float(max(f32(0.0), f32(1.0) - f32(s) / f32(n_steps)))


def _copy_weights(dst: List[torch.Tensor], src: List[torch.Tensor]) -> None:
    with torch.no_grad():
        torch._foreach_copy_(dst, src)


def v_student(teacher: LatentDiffusion) -> LatentDiffusion:
    """The teacher's config with parameterization="v", a separate module
    whose trainable weights are copies of the teacher's (no storage
    shared) and whose VAE is the teacher's module (one copy on the card).
    """
    student = copy.deepcopy(teacher, {id(teacher.vae): teacher.vae})
    student.config = dataclasses.replace(teacher.config,
                                         parameterization="v")
    student.schedule = make_schedule(student.config)
    for _, p in trainable_parameters(student):
        p.requires_grad_(True)
    return student


def progressive_distill(
    teacher: LatentDiffusion,
    data_iter: Iterator[Dict[str, torch.Tensor]],
    config: DistillConfig = DistillConfig(),
    generator: Optional[torch.Generator] = None,
    log_fn: Optional[Callable[[str], None]] = None,
    stage_cb: Optional[Callable[[int, np.ndarray, LatentDiffusion],
                                None]] = None,
    start_grid: Optional[np.ndarray] = None,
    draws: Optional[Callable[[int, int], Optional[Draws]]] = None,
) -> Tuple[LatentDiffusion, np.ndarray, List[Dict[str, Any]]]:
    """Run the whole halving ladder; returns (student, student_grid,
    per_stage_history).

    JAX's signature with the weights in the modules: `teacher` carries
    JAX's `teacher_params` and `frozen_params`, `generator` takes `rng`'s
    place, and `jit_fn` has no counterpart. The student is
    `v_student(teacher)`. After an
    adapt phase (a teacher that is not v, `adapt_steps` > 0) stage 0
    starts from the adapted EMA weights while its teacher stays the
    original model. Each later stage's teacher is the previous student's
    EMA shadow, copied into `teacher` (the ladder overwrites the teacher's
    trainable weights from stage 1 on and leaves it frozen: one copy of
    the weights less on the card). `start_grid` continues a saved
    student's grid, read by its config's parameterization; `stage_cb(n,
    grid, student)` sees every rung with the rung's weights in `student`.
    `draws(stage, step)` supplies a step's explicit draws (stage -1 is the
    adapt phase), or None to draw from `generator`.
    """
    log = log_fn or (lambda s: None)
    student = v_student(teacher)
    teacher.requires_grad_(False).eval()

    if start_grid is not None:
        # a chained ladder continues halving a student's OWN saved grid (a
        # nested child grid is not the fresh karras/uniform grid of its
        # size)
        g = np.asarray(start_grid, dtype=np.int64)
        ratio = len(g) // config.end_steps
        if len(g) % config.end_steps or ratio & (ratio - 1):
            raise ValueError(
                f"start_grid of {len(g)} cannot halve to {config.end_steps}")
        grids = [g]
        while len(g) > config.end_steps:
            g = g[1::2]
            grids.append(g)
    else:
        grids = make_distill_grids(
            teacher.schedule, config.start_steps, config.end_steps,
            method=config.grid_method)
    t_type = teacher.config.parameterization
    history: List[Dict[str, Any]] = []

    def new_state(n_steps: int) -> TrainState:
        return create_train_state(
            student, config.learning_rate,
            scheduler=_anneal(n_steps) if config.anneal else None,
            use_ema=config.use_ema, ema_decay=config.ema_decay,
            weight_decay=config.weight_decay)

    def step_draws(stage: int, k: int) -> Optional[Draws]:
        return None if draws is None else draws(stage, k)

    def keep_shadow(state: TrainState) -> None:
        # the student takes its EMA weights (the next stage's init)
        if state.ema is not None:
            _copy_weights(state.params, state.ema.shadow)

    if t_type != "v" and config.adapt_steps > 0:
        log(f"adapt: {t_type} -> v, {config.adapt_steps} updates")
        state = new_state(config.adapt_steps)
        for k in range(config.adapt_steps):
            state, metrics = adapt_step(student, state, teacher, t_type,
                                        next(data_iter), generator,
                                        step_draws(-1, k))
            if log_fn is not None and k % max(1, config.adapt_steps // 5) == 0:
                log(f"  adapt step {k}: loss {float(metrics['loss']):.5f}")
        # INIT ONLY: stage 0 starts from the adapted weights; its teacher
        # stays the original model
        keep_shadow(state)
        history.append({"stage": -1, "steps": len(grids[0]),
                        "loss": float(metrics["loss"]), "adapt": True})
        del state

    for stage, parent in enumerate(grids[:-1]):
        tables = make_stage_tables(teacher.schedule, parent)
        n = tables.num_steps
        log(f"stage {stage}: {len(parent)} -> {n} steps, "
            f"{config.steps_per_stage} updates")
        state = new_state(config.steps_per_stage)
        for k in range(config.steps_per_stage):
            state, metrics = distill_step(student, state, teacher, t_type,
                                          next(data_iter), tables, generator,
                                          step_draws(stage, k))
            if (log_fn is not None
                    and k % max(1, config.steps_per_stage // 10) == 0):
                last = {m: float(v) for m, v in metrics.items()}
                log(f"  stage {stage} step {k}: loss {last['loss']:.5f} "
                    f"(x-mse {last['loss_x']:.5f})")
        last = {m: float(v) for m, v in metrics.items()}
        history.append({"stage": stage, "steps": n, **last})
        keep_shadow(state)
        del state
        if stage + 2 < len(grids):
            # the next stage's teacher is this rung's student
            _copy_weights([p for _, p in trainable_parameters(teacher)],
                          [p.detach() for _, p in
                           trainable_parameters(student)])
            t_type = "v"
        if stage_cb is not None:
            stage_cb(n, grids[stage + 1], student)

    return student, grids[-1], history
