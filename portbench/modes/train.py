"""Training: `training/train_state.py`'s `train_step` over AdamW + EMA, on
float32 masters under the configuration's compute dtype, as `cli train`
sets them up (`Trainer`'s learning rate and LambdaLinear schedule).

Set-up builds the one train state and drives it through its first three
steps, each on a batch of its own, through the window's own call and feed:
a batch from a pool of seeded batches in pinned host memory, copied to the
card on a side stream as the trainer's prefetch does, and the step's draws
from the seed. It reads each step's loss, each leaf's first gradient as
AdamW holds it after step 1 (its first moment over 1 - beta1), and each
leaf's change and its EMA shadow's change after step 3, then hands the
same state to the window. The
window runs steps until its length has passed and ends at the last step's
completion. `train_img_per_s` is the window's images over its length.

The check: the reference follows the same three steps from the same
weights, batches and draws (`reference.ldm.train_steps`).
"""

from __future__ import annotations

import time

import torch

from portbench import flops, inputs, judge
from portbench.modes import common
from portbench.reference import ldm

CHECKED_STEPS = 3


class Mode:
    def __init__(self, run):
        self.run = run
        self.t = run.traffic
        self.b = int(self.t["batch"])

    def _draws(self, i: int):
        return inputs.train_draws(self.run.cfg, self.b,
                                  inputs.sub_seed(self.run.seed, 6, i),
                                  self.run.device)

    def _feed(self, i: int):
        """Pool batch i mod P on the card, ordered after its copy."""
        batch = self.pool[i % len(self.pool)]
        dev = self.run.device
        if dev.type != "cuda":
            return dict(batch)
        with torch.cuda.stream(self.copy_stream):
            out = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
            event = torch.cuda.Event()
            event.record()
        stream = torch.cuda.current_stream(dev)
        stream.wait_event(event)
        for v in out.values():
            v.record_stream(stream)
        return out

    def _step(self, i: int):
        from upgpt_torch.training.train_state import train_step

        self.state, metrics = train_step(self.model, self.state, self._feed(i),
                                         draws=self._draws(i))
        return metrics

    def setup(self) -> None:
        from upgpt_torch.training.lr import lambda_linear_schedule
        from upgpt_torch.training.train_state import create_train_state

        run, t = self.run, self.t
        self.model, self.weights = common.build_model(
            run, "float32", **t.get("kernels", {}))
        self.run.mark("model and weights")
        self.model.train()
        self.state = create_train_state(
            self.model, t["learning_rate"], lambda_linear_schedule(
                [t["warm_up_steps"]], [1.0], [1.0], [t["scheduler_f_start"]],
                [10**13]), use_ema=True, ema_decay=t["ema_decay"])
        self.pool = []
        for p in range(int(t["pool"])):
            batch = inputs.train_batch(run.cfg, self.b,
                                       inputs.sub_seed(run.seed, 5, p),
                                       run.device)
            self.pool.append({k: (v.cpu().pin_memory()
                                  if run.device.type == "cuda" else v)
                              for k, v in batch.items()})
        self.copy_stream = (torch.cuda.Stream(run.device)
                            if run.device.type == "cuda" else None)
        losses, grads = [], None
        for i in range(CHECKED_STEPS):
            metrics = self._step(i)
            losses.append(float(metrics["loss"]))
            if grads is None:
                opt = self.state.optimizer
                b1 = opt.defaults["betas"][0]
                # a leaf the step left without a first moment reads inf
                grads = {n: (float(opt.state[p]["exp_avg"].norm()) / (1 - b1)
                             if "exp_avg" in opt.state.get(p, {})
                             else float("inf"))
                         for n, p in zip(self.state.names, self.state.params)}
        w0, names = self.weights.views, self.state.names
        with torch.no_grad():
            change = {n: float((p.detach() - w0[n]).norm())
                      for n, p in zip(names, self.state.params)}
            ema = {n: float((s - w0[n]).norm())
                   for n, s in zip(names, self.state.ema.shadow)}
        self.readings = {"losses": losses, "grad_norms": grads,
                         "change_norms": change, "ema_change_norms": ema}
        self.steps_done = CHECKED_STEPS
        common.sync(run.device)
        run.mark("three checked steps")

    def hook(self, ranges):
        return set()

    def window(self) -> None:
        run = self.run
        before = common.launches()
        i0 = self.steps_done
        t_start = time.perf_counter()
        i = i0
        while time.perf_counter() - t_start < run.seconds:
            if run.ranges is not None:
                run.ranges.enter("step")
            self._step(i)
            if run.ranges is not None:
                run.ranges.leave()
            i += 1
        common.sync(run.device)
        wall = time.perf_counter() - t_start
        after = common.launches()
        steps = i - i0
        self.steps_done = i
        n = steps * self.b
        run.facts.update(
            train_img_per_s=n / wall, wall_s=wall, attempted=steps, failed=0,
            flops_done=n * flops.train_flops(run.cfg))
        run.say(f"train: {steps} steps of {self.b} in {wall:.4f} s; kernel "
                f"launches in the window "
                f"{ {k: after[k] - before.get(k, 0) for k in after} }")

    def check(self) -> dict:
        run, t = self.run, self.t
        w0 = common.reference_weights(self.weights)
        del self.state, self.model, self.weights
        common.release(run.device)
        batches = [{k: v.to(run.device) for k, v in self.pool[i].items()}
                   for i in range(CHECKED_STEPS)]
        draws = [self._draws(i) for i in range(CHECKED_STEPS)]
        opt = {k: t[k] for k in ("learning_rate", "beta1", "beta2", "eps",
                                 "weight_decay", "warm_up_steps",
                                 "scheduler_f_start", "ema_decay")}
        rows = int(t["reference_rows"])
        with ldm.float32_exact():
            ref = judge.reference_norms(ldm.train_steps(
                w0, batches, draws, run.cfg, opt, rows_per_block=rows))
            if run.control:
                ctl = judge.reference_norms(ldm.train_steps(
                    w0, batches, draws, run.cfg, opt, ldm.FP8,
                    rows_per_block=rows))
                run.facts["control"] = judge.train_numbers(ctl, ref)
                # the half-batch fault, planted in the reference put in
                # the program's place: the mean over the first half's rows
                half = self.b // 2
                cut = [{k: v[:half] for k, v in x.items()} for x in batches]
                cut_draws = [{k: v[:half] for k, v in x.items()}
                             for x in draws]
                run.facts["fault_half_batch"] = judge.train_numbers(
                    judge.reference_norms(ldm.train_steps(
                        w0, cut, cut_draws, run.cfg, opt,
                        rows_per_block=rows)), ref)
        run.say(f"train check: losses {self.readings['losses']} against "
                f"{ref['losses']}")
        return judge.train_numbers(self.readings, ref)
