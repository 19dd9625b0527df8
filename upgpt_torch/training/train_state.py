"""Train state and the train/eval steps of the latent diffusion model.

Port of `upgpt_tpu.training.train_state` (reference ddpm.py:1501-1538):
AdamW with betas 0.9/0.999, eps 1e-8 and weight decay 0.01 on every
trainable parameter, the base LR times a per-step multiplier, and a LitEma
shadow, over the trainable set {U-Net, pose LinearProject}. The VAE is
frozen and stays out of the optimizer.

AdamW is `torch.optim.AdamW` with its LR set before every step to
`learning_rate * scheduler(step)`, the step count before the update, as
optax's `scale_by_schedule` sees it. Its update equals optax.adamw's: the
same bias corrections (1 - b^t with t = step + 1), eps added to
sqrt(v_hat), and the decay applied to the pre-update parameter
(tests/test_torch_training.py pins three updates to optax). Gradients of
parameters a loss does not reach count as zero, as in JAX, so weight decay
still applies to them.

The steps run where the model lies. Randomness comes from one
`torch.Generator` (the draws of `LatentDiffusion.training_draws`), or from
explicit draws. Not ported: `FusedTrainState`, gradient accumulation
(`optax.MultiSteps`) and the trainer loop (`training/trainer.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from upgpt_torch.diffusion.latent_diffusion import LatentDiffusion
from upgpt_torch.training.ema import EmaState, ema_init, ema_update
from upgpt_torch.training.lr import lambda_linear_schedule


@dataclasses.dataclass
class TrainState:
    step: int
    names: List[str]  # the trainable parameters' names in the model
    params: List[torch.nn.Parameter]
    optimizer: torch.optim.Optimizer
    ema: Optional[EmaState]
    learning_rate: float
    scheduler: Callable[[int], float]

    def apply_gradients(self) -> "TrainState":
        """One AdamW step on the parameters' `.grad`, then the EMA."""
        lr = self.learning_rate * self.scheduler(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.optimizer.step()
        if self.ema is not None:
            ema_update(self.ema, self.params)
        self.step += 1
        return self


def scaled_learning_rate(base_lr: float, batch_size: int, n_devices: int,
                         accumulate_grad_batches: int = 1,
                         scale_lr: bool = True) -> float:
    """Reference LR scaling rule (main.py:748-767)."""
    if not scale_lr:
        return base_lr
    return accumulate_grad_batches * n_devices * batch_size * base_lr


def trainable_parameters(model: LatentDiffusion):
    """(name, parameter) of the U-Net and the pose stage, in model order."""
    return [(n, p) for n, p in model.named_parameters()
            if n.startswith(("unet.", "pose."))]


def create_train_state(model: LatentDiffusion, learning_rate: float,
                       scheduler: Optional[Callable[[int], float]] = None,
                       use_ema: bool = True, ema_decay: float = 0.9999,
                       weight_decay: float = 0.01) -> TrainState:
    """AdamW + EMA over the model's trainable parameters; freezes the VAE.
    The default schedule warms up over one step from 1e-6, as the JAX
    package's does."""
    if scheduler is None:
        scheduler = lambda_linear_schedule([1], [1.0], [1.0], [1e-6],
                                           [10**13])
    model.vae.requires_grad_(False)
    named = trainable_parameters(model)
    params = [p for _, p in named]
    optimizer = torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999),
                                  eps=1e-8, weight_decay=weight_decay)
    return TrainState(
        step=0, names=[n for n, _ in named], params=params,
        optimizer=optimizer,
        ema=ema_init(params, ema_decay) if use_ema else None,
        learning_rate=learning_rate, scheduler=scheduler)


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
