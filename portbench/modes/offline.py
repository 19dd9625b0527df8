"""Offline batch generation: whole batches back to back, as `cli sample` /
`cli test` run them.

Each batch draws new conditioning, x_T and the sampler's per-step noise
from the seed and the batch's index, runs
`GenerationPipeline(..., output_uint8=True).generate` and copies the
images to the host. No batch starts after the window's length; the window
ends when the last batch's images are on the host. `img_per_s` is the
window's images over its length.

The check: `check_images` images of the window, drawn from the seed, made
again by the reference from the same conditioning and draws.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import flops, inputs, judge
from portbench.modes import common
from portbench.reference import ldm


class Mode:
    def __init__(self, run):
        self.run = run
        self.t = run.traffic
        self.b = int(self.t["batch"])

    def _pipe(self, steps: int):
        from upgpt_torch.inference.pipeline import GenerationPipeline

        return GenerationPipeline(
            self.model, num_steps=steps, eta=self.t["eta"],
            sampler=self.t["sampler"], schedule_method=self.t["schedule"],
            output_uint8=True)

    def _batch(self, i: int, steps: int):
        run = self.run
        cond = inputs.conditioning(run.cfg, self.b,
                                   inputs.sub_seed(run.seed, 1, i), run.device)
        draws = inputs.sampler_draws(
            run.cfg, self.b, steps,
            self.t["sampler"] == "ddim" and self.t["eta"] > 0,
            inputs.sub_seed(run.seed, 2, i), run.device)
        return cond, draws

    def setup(self) -> None:
        self.model, self.weights = common.build_model(
            self.run, self.run.cfg["compute_dtype"])
        self.run.mark("model and weights")
        self.pipe = self._pipe(int(self.t["steps"]))
        self.steps = self.pipe.num_steps
        warm = self._pipe(int(self.t["warm_steps"]))
        cond, draws = self._batch(-1, warm.num_steps)
        warm.generate(cond, **draws).cpu()
        common.sync(self.run.device)
        self.run.mark("warm-up")

    def hook(self, ranges):
        return common.sampling_hooks(ranges, self.model, self.run.cfg)

    def window(self) -> None:
        run, steps = self.run, self.pipe.num_steps
        before = common.launches()
        self.images = []
        t_start = time.perf_counter()
        ends = [t_start]
        while ends[-1] - t_start < run.seconds:
            i = len(self.images)
            if run.ranges is not None:
                run.ranges.enter("batch")
            cond, draws = self._batch(i, steps)
            self.images.append(self.pipe.generate(cond, **draws).cpu())
            if run.ranges is not None:
                run.ranges.leave()
            ends.append(time.perf_counter())
        wall = ends[-1] - t_start
        after = common.launches()
        n = len(self.images) * self.b
        run.facts.update(
            img_per_s=n / wall, wall_s=wall, attempted=n, failed=0,
            flops_done=n * flops.sample_flops(run.cfg, steps))
        run.say(f"offline: {len(self.images)} batches of {self.b}, {n} "
                f"images in {wall:.4f} s (each batch "
                f"{[round(b - a, 4) for a, b in zip(ends, ends[1:])]} s); "
                f"kernel launches in the window "
                f"{ {k: after[k] - before.get(k, 0) for k in after} }")

    def check(self) -> dict:
        run = self.run
        w_ref = common.reference_weights(self.weights)
        del self.model, self.pipe, self.weights
        common.release(run.device)
        n = len(self.images) * self.b
        k = min(int(self.t["check_images"]), n)
        picks = sorted(np.random.default_rng(inputs.sub_seed(run.seed, 9))
                       .choice(n, size=k, replace=False).tolist())
        parts, got = [], []
        for idx in picks:
            i, r = divmod(idx, self.b)
            cond, draws = self._batch(i, self.steps)
            rows = {key: v[r:r + 1] for key, v in cond.items()}
            rows["x_T"] = draws["x_T"][r:r + 1]
            if "noise" in draws:
                rows["noise"] = draws["noise"][:, r:r + 1]
            parts.append(rows)
            got.append(self.images[i][r:r + 1])
        ref_in = {key: torch.cat([p[key] for p in parts],
                                 dim=1 if key == "noise" else 0)
                  for key in parts[0]}
        with torch.no_grad(), ldm.float32_exact():
            ref = ldm.generate(ref_in, w_ref, run.cfg, self.t)
        gaps = judge.image_gaps(torch.cat(got), ref.cpu())
        run.say(f"offline check: images {picks}, rel L2 each "
                f"{[round(float(g), 6) for g in gaps]}")
        if run.control:
            with torch.no_grad(), ldm.float32_exact():
                ctl = ldm.generate(ref_in, w_ref, run.cfg, self.t, ldm.FP8)
            run.facts["control"] = judge.image_numbers(
                judge.image_gaps(ldm.to_uint8(ctl).cpu(), ref.cpu()))
        return judge.image_numbers(gaps)
