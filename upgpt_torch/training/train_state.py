"""Train state and the train/eval steps of the latent diffusion model.

Port of `upgpt_tpu.training.train_state` (reference ddpm.py:1501-1538):
AdamW with betas 0.9/0.999, eps 1e-8 and weight decay 0.01 on every
trainable parameter, the base LR times a per-step multiplier, and a LitEma
shadow, over the trainable set {U-Net, pose LinearProject, and the
text-style fusion where the model has one}. The VAE is
frozen and stays out of the optimizer.

AdamW is `torch.optim.AdamW` with its LR set before every step to
`learning_rate * scheduler(step)`, the step count before the update, as
optax's `scale_by_schedule` sees it. Its update equals optax.adamw's: the
same bias corrections (1 - b^t with t = step + 1), eps added to
sqrt(v_hat), and the decay applied to the pre-update parameter
(tests/test_torch_training.py pins three updates to optax). Gradients of
parameters a loss does not reach count as zero, as in JAX, so weight decay
still applies to them.

Gradient accumulation follows `optax.MultiSteps` (main.py:753-758
accumulate_grad_batches): every call folds its gradient into a running mean
(acc + (g - acc) / (n + 1)) and every k-th call applies the mean. The EMA
updates on every call and `step` counts calls, as JAX's
`TrainState.apply_gradients` does; the LR schedule sees the count of
applied updates, the inner optimizer's count under MultiSteps.

`FusedTrainState` is JAX's hand-fused AdamW + bias correction + decoupled
weight decay + LitEma update (`create_fused_train_state`): the same
arithmetic, float32 math over float32 or bfloat16 moments and shadow
(`moment_dtype`), cast on store, here as a chain of foreach ops over all
parameters (XLA fuses JAX's into one pass per leaf). It does not compose
with accumulation, as in JAX. Its EMA shadow is float32 whatever
`moment_dtype` is: JAX's takes bfloat16 with bf16 moments, and a bf16
shadow freezes at decay 0.9999 (the reference fault R1, ROADMAP.md §3).

The steps run where the model lies. Randomness comes from one
`torch.Generator` (the draws of `LatentDiffusion.training_draws`), or from
explicit draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from upgpt_torch.diffusion.latent_diffusion import LatentDiffusion
from upgpt_torch.training.ema import EmaState, ema_decay, ema_init, ema_update
from upgpt_torch.training.lr import lambda_linear_schedule


@dataclasses.dataclass
class TrainState:
    step: int  # calls of apply_gradients
    names: List[str]  # the trainable parameters' names in the model
    params: List[torch.nn.Parameter]
    optimizer: torch.optim.Optimizer
    ema: Optional[EmaState]
    learning_rate: float
    scheduler: Callable[[int], float]
    accumulate: int = 1  # MultiSteps' k
    updates: int = 0  # optimizer updates applied: the schedule's count
    mini_step: int = 0  # calls folded into `acc` since the last update
    acc: Optional[List[torch.Tensor]] = None  # the running mean gradient

    @torch.no_grad()
    def apply_gradients(self) -> "TrainState":
        """Fold the parameters' `.grad` into the accumulator and, on every
        `accumulate`-th call (every call without accumulation), take one
        AdamW step; then the EMA."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.accumulate > 1:
            grads = [p.grad for p in self.params]
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            delta = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(delta, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, delta)
            del delta
            self.mini_step = (self.mini_step + 1) % self.accumulate
            if self.mini_step == 0:
                for p, a in zip(self.params, self.acc):
                    p.grad = a
                self.acc = None
                self._update()
        else:
            self._update()
        if self.ema is not None:
            ema_update(self.ema, self.params)
        self.step += 1
        return self

    def _update(self) -> None:
        lr = self.learning_rate * self.scheduler(self.updates)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.updates += 1

    def opt_state(self) -> dict:
        """What a checkpoint keeps of the optimizer: AdamW's moments and
        count, and the accumulator."""
        return {"optimizer": self.optimizer.state_dict(),
                "updates": self.updates, "mini_step": self.mini_step,
                "acc": self.acc}

    def load_opt_state(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.updates = int(state["updates"])
        self.mini_step = int(state["mini_step"])
        self.acc = (None if state["acc"] is None else
                    [a.to(p.device) for a, p in zip(state["acc"],
                                                    self.params)])


@dataclasses.dataclass
class FusedTrainState:
    """AdamW + bias correction + decoupled weight decay + the LitEma shadow
    as JAX's `FusedTrainState` computes them, in float32 math stored in
    the moments' dtype, as foreach ops over all parameters. The shadow is
    float32 for every `moment_dtype`, as `training/ema.py` keeps it."""

    step: int
    names: List[str]
    params: List[torch.nn.Parameter]
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    ema: Optional[EmaState]
    learning_rate: float
    scheduler: Callable[[int], float]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01

    @torch.no_grad()
    def apply_gradients(self) -> "FusedTrainState":
        f32 = np.float32
        t = f32(self.step + 1)
        # the schedule sees the pre-update count (0 on the first step)
        lr_t = float(f32(self.learning_rate) * f32(self.scheduler(self.step)))
        bc1 = float(f32(1.0) - np.power(f32(self.b1), t))
        bc2 = float(f32(1.0) - np.power(f32(self.b2), t))
        g = [torch.zeros_like(p, dtype=torch.float32) if p.grad is None
             else p.grad.float() for p in self.params]
        p32 = [p.float() for p in self.params]
        m2 = torch._foreach_mul([m.float() for m in self.mu], self.b1)
        torch._foreach_add_(m2, torch._foreach_mul(g, 1.0 - self.b1))
        v2 = torch._foreach_mul([v.float() for v in self.nu], self.b2)
        gg = torch._foreach_mul(g, 1.0 - self.b2)
        torch._foreach_mul_(gg, g)
        torch._foreach_add_(v2, gg)
        del g, gg
        # (m2 / bc1) / (sqrt(v2 / bc2) + eps) + wd * p, times lr
        den = torch._foreach_div(v2, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(m2, bc1)
        torch._foreach_div_(upd, den)
        del den
        torch._foreach_add_(upd, torch._foreach_mul(p32, self.weight_decay))
        torch._foreach_mul_(upd, lr_t)
        p2 = torch._foreach_sub(p32, upd)
        del upd, p32
        torch._foreach_copy_(self.mu, m2)
        torch._foreach_copy_(self.nu, v2)
        del m2, v2
        if self.ema is not None:
            self.ema.num_updates += 1
            one_minus = float(f32(1.0) - f32(ema_decay(self.ema.num_updates,
                                                       self.ema.decay)))
            s32 = [s.float() for s in self.ema.shadow]
            d = torch._foreach_sub(s32, p2)
            torch._foreach_mul_(d, one_minus)
            torch._foreach_copy_(self.ema.shadow, torch._foreach_sub(s32, d))
        torch._foreach_copy_(self.params, p2)
        self.step += 1
        return self

    def opt_state(self) -> dict:
        return {"mu": self.mu, "nu": self.nu}

    def load_opt_state(self, state: dict) -> None:
        torch._foreach_copy_(self.mu + self.nu, state["mu"] + state["nu"])


def scaled_learning_rate(base_lr: float, batch_size: int, n_devices: int,
                         accumulate_grad_batches: int = 1,
                         scale_lr: bool = True) -> float:
    """Reference LR scaling rule (main.py:748-767)."""
    if not scale_lr:
        return base_lr
    return accumulate_grad_batches * n_devices * batch_size * base_lr


def trainable_parameters(model: LatentDiffusion):
    """(name, parameter) of the U-Net, the pose stage and the text-style
    fusion (`cond_fusion`, reference ddpm.py:1501-1509 with
    cond_stage_trainable), in model order."""
    return [(n, p) for n, p in model.named_parameters()
            if n.startswith(("unet.", "pose.", "cond_fusion."))]


def _default_schedule():
    # warms up over one step from 1e-6, as the JAX package's default does
    return lambda_linear_schedule([1], [1.0], [1.0], [1e-6], [10**13])


def create_train_state(model: LatentDiffusion, learning_rate: float,
                       scheduler: Optional[Callable[[int], float]] = None,
                       use_ema: bool = True, ema_decay: float = 0.9999,
                       weight_decay: float = 0.01,
                       accumulate_grad_batches: int = 1) -> TrainState:
    """AdamW + EMA over the model's trainable parameters, with optax
    MultiSteps accumulation over `accumulate_grad_batches` calls; freezes
    the VAE."""
    model.vae.requires_grad_(False)
    named = trainable_parameters(model)
    params = [p for _, p in named]
    optimizer = torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999),
                                  eps=1e-8, weight_decay=weight_decay)
    return TrainState(
        step=0, names=[n for n, _ in named], params=params,
        optimizer=optimizer,
        ema=ema_init(params, ema_decay) if use_ema else None,
        learning_rate=learning_rate,
        scheduler=scheduler or _default_schedule(),
        accumulate=accumulate_grad_batches)


def create_fused_train_state(
        model: LatentDiffusion, learning_rate: float,
        scheduler: Optional[Callable[[int], float]] = None,
        use_ema: bool = True, ema_decay: float = 0.9999,
        weight_decay: float = 0.01,
        moment_dtype: Union[str, torch.dtype] = torch.float32
) -> FusedTrainState:
    """The fused twin of `create_train_state` (no accumulation); freezes
    the VAE."""
    if isinstance(moment_dtype, str):
        moment_dtype = getattr(torch, moment_dtype)
    model.vae.requires_grad_(False)
    named = trainable_parameters(model)
    params = [p for _, p in named]
    zeros = [torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
             for p in params]
    return FusedTrainState(
        step=0, names=[n for n, _ in named], params=params, mu=zeros,
        nu=[z.clone() for z in zeros],
        ema=ema_init(params, ema_decay) if use_ema else None,
        learning_rate=learning_rate,
        scheduler=scheduler or _default_schedule(),
        weight_decay=weight_decay)


def train_step(model: LatentDiffusion, state: TrainState,
               batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               draws: Optional[Dict[str, torch.Tensor]] = None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimisation step. Metrics (0-d tensors on the model's device):
    loss, loss_simple, loss_vlb and grad_norm, the global L2 norm of the
    gradients before the update."""
    for p in state.params:
        p.grad = None
    loss, metrics = model.training_loss(batch, generator, draws)
    loss.backward()
    grad_norm = torch.nn.utils.get_total_norm(
        [p.grad for p in state.params if p.grad is not None])
    state.apply_gradients()
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["grad_norm"] = grad_norm
    return state, metrics


@torch.no_grad()
def eval_step(model: LatentDiffusion, state: TrainState,
              batch: Dict[str, torch.Tensor],
              generator: Optional[torch.Generator] = None,
              draws: Optional[Dict[str, torch.Tensor]] = None
              ) -> Dict[str, torch.Tensor]:
    """Validation losses with the raw weights and, under `<key>_ema`, with
    the EMA shadow (reference ddpm.py:365-372); both on the same draws."""
    if draws is None:
        draws = model.training_draws(batch["image"].shape[0], generator)
    _, metrics = model.training_loss(batch, draws=draws)
    out = dict(metrics)
    if state.ema is not None:
        backup = [p.detach().clone() for p in state.params]
        try:
            for p, s in zip(state.params, state.ema.shadow):
                p.copy_(s)
            _, ema_metrics = model.training_loss(batch, draws=draws)
        finally:
            for p, b in zip(state.params, backup):
                p.copy_(b)
        out.update({f"{k}_ema": v for k, v in ema_metrics.items()})
    return out
