"""Served requests: an open loop of arrivals into `ServingEngine`, as
`cli serve` runs it in process.

Requests are due at the mix's fixed rate (`inputs.arrival_offsets`); each
carries its own seeded conditioning and `x_T_seed`. The engine batches
them (`batch`, `max_delay_s`, `in_flight`: `cli serve`'s defaults) over a
`GenerationPipeline` with uint8 output. A request's latency runs from its
due time to its image on the host (the future's completion); a request
that fails or never completes counts as infinitely late. The run drains
what is in flight at the window's end, up to `drain_s` more.
`latency_p95_s` is the 95th percentile (nearest rank) of every request
due in the window.

The check: `check_images` completed requests, drawn from the seed, made
again by the reference from their conditioning and the x_T the engine's
recipe gives for the batch each was served in.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque

import numpy as np
import torch

from portbench import flops, inputs, judge, trace
from portbench.modes import common
from portbench.reference import ldm
from portbench.reference.serving import row_x_T


def p95(values) -> float:
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


class Mode:
    def __init__(self, run):
        self.run = run
        self.t = run.traffic
        self.b = int(self.t["batch"])

    def setup(self) -> None:
        from upgpt_torch.inference.pipeline import GenerationPipeline
        from upgpt_torch.inference.serving import ServingEngine

        run, t = self.run, self.t
        self.model, self.weights = common.build_model(
            run, run.cfg["compute_dtype"])
        self.run.mark("model and weights")
        pipe = GenerationPipeline(
            self.model, num_steps=int(t["steps"]), eta=t["eta"],
            sampler=t["sampler"], schedule_method=t["schedule"],
            output_uint8=True)
        self.evals = pipe.num_steps
        self.base_seed = inputs.sub_seed(run.seed, 3) % 2**31
        self.engine = ServingEngine(
            pipe, batch_size=self.b, max_delay_s=t["max_delay_s"],
            base_seed=self.base_seed, max_in_flight=t["in_flight"])
        self.due = inputs.arrival_offsets(t["rate_per_s"], run.seconds,
                                          run.seed)
        n = len(self.due)
        cond = inputs.conditioning(run.cfg, n + self.b,
                                   inputs.sub_seed(run.seed, 4), run.device)
        self.cond = {k: v.cpu().numpy() for k, v in cond.items()}
        self._observe()
        self.engine.start()
        warm = [self.engine.submit(self._request(n + k))
                for k in range(self.b)]
        for f in warm:
            f.result()
        common.sync(run.device)
        run.mark("warm-up")

    def _request(self, k: int) -> dict:
        req = {key: v[k] for key, v in self.cond.items()}
        req["x_T_seed"] = k + 1
        return req

    def _observe(self) -> None:
        """Which batch served each x_T_seed, and each batch's interval
        from dispatch to its images on the host, read by wrapping the
        engine's `dispatch` and `fetch` on the instance."""
        eng = self.engine
        self.served, self.spans, order = {}, {}, deque()
        dispatch, fetch = eng.dispatch, eng.fetch
        lock = threading.Lock()

        def on_dispatch(batch, index):
            t0 = time.perf_counter()
            for s in np.asarray(batch["x_T_seed"]).reshape(-1).tolist():
                self.served.setdefault(int(s), int(index))
            out = dispatch(batch, index)
            with lock:
                order.append(index)
                self.spans[index] = [t0, None]
            return out

        def on_fetch(out, event):
            host = fetch(out, event)
            with lock:
                self.spans[order.popleft()][1] = time.perf_counter()
            return host

        eng.dispatch, eng.fetch = on_dispatch, on_fetch

    def hook(self, ranges: trace.Ranges):
        layers = common.sampling_hooks(ranges, self.model, self.run.cfg)
        ranges.wrap(self.engine, "dispatch", "dispatch")
        ranges.wrap(self.engine, "fetch", "fetch")
        return layers

    def window(self) -> None:
        run, eng = self.run, self.engine
        n = len(self.due)
        done = [None] * n
        self.futures = []
        late = []
        stats0 = (eng.stats.requests, eng.stats.images, eng.stats.batches)
        before = common.launches()
        t_start = time.perf_counter()
        for k, d in enumerate(self.due):
            wait = t_start + d - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late.append(time.perf_counter() - t_start - d)
            fut = eng.submit(self._request(k))
            fut.add_done_callback(
                lambda f, k=k: done.__setitem__(k, time.perf_counter()))
            self.futures.append(fut)
        deadline = t_start + run.seconds + float(self.t["drain_s"])
        for fut in self.futures:
            try:
                fut.result(timeout=max(0.0, deadline - time.perf_counter()))
            except Exception:  # noqa: BLE001 - failed: infinitely late
                pass
        t_end = time.perf_counter()
        after = common.launches()
        ok = [k for k, f in enumerate(self.futures)
              if f.done() and f.exception() is None and done[k] is not None]
        lat = [math.inf] * n
        for k in ok:
            lat[k] = done[k] - (t_start + self.due[k])
        self.ok = ok
        stats1 = (eng.stats.requests, eng.stats.images, eng.stats.batches)
        batches = range(stats0[2], stats1[2])
        spans = [tuple(self.spans[i]) for i in batches
                 if self.spans.get(i, [None, None])[1] is not None]
        run.facts.update(
            latency_p95_s=p95(lat), attempted=n, failed=n - len(ok),
            wall_s=t_end - t_start,
            occupancy=((stats1[0] - stats0[0]) / (stats1[1] - stats0[1])
                       if stats1[1] > stats0[1] else None),
            batch_flops=(len(batches) * self.b
                         * flops.sample_flops(run.cfg, self.evals)),
            batch_busy_s=trace.union_s(
                (int(a * 1e9), int(b * 1e9)) for a, b in spans))
        finite = sorted(x for x in lat if math.isfinite(x))
        fifth = max(1, n // 5)
        # a backlog that grows over the window shows as later requests
        # waiting longer than early ones
        run.facts["latency_first_fifth_s"] = sum(lat[:fifth]) / fifth
        run.facts["latency_last_fifth_s"] = sum(lat[-fifth:]) / fifth
        run.say(f"serve backlog: mean latency of the first fifth "
                f"{run.facts['latency_first_fifth_s']:.4f} s, of the last "
                f"fifth {run.facts['latency_last_fifth_s']:.4f} s")
        run.say(f"serve: {n} requests due at {self.t['rate_per_s']}/s over "
                f"{run.seconds} s, {len(ok)} completed, {n - len(ok)} failed"
                f", {len(batches)} batches; latency p50 "
                f"{finite[len(finite) // 2] if finite else math.inf:.4f} s, "
                f"p95 {run.facts['latency_p95_s']:.4f} s, max "
                f"{finite[-1] if finite else math.inf:.4f} s; generator "
                f"lateness mean {sum(late) / n:.6f} s, max {max(late):.6f} s;"
                f" occupancy {run.facts['occupancy']}; kernel launches "
                f"{ {k: after[k] - before.get(k, 0) for k in after} }")

    def check(self) -> dict:
        run = self.run
        self.engine.stop()
        w_ref = common.reference_weights(self.weights)
        del self.engine, self.model, self.weights
        common.release(run.device)
        k = min(int(self.t["check_images"]), len(self.ok))
        if k == 0:
            return judge.image_numbers([])
        picks = sorted(np.random.default_rng(inputs.sub_seed(run.seed, 9))
                       .choice(self.ok, size=k, replace=False).tolist())
        h, w = run.cfg["latent_size"]
        shape = (h, w, run.cfg["latent_channels"])
        ref_in = {key: torch.from_numpy(np.stack([v[i] for i in picks])).to(
            run.device) for key, v in self.cond.items()}
        ref_in["x_T"] = torch.stack([
            row_x_T(self.base_seed, self.served[i + 1], i + 1, shape,
                    run.device) for i in picks])
        got = torch.from_numpy(np.stack([self.futures[i].result()
                                         for i in picks]))
        with torch.no_grad(), ldm.float32_exact():
            ref = ldm.generate(ref_in, w_ref, run.cfg, self.t)
        gaps = judge.image_gaps(got, ref.cpu())
        run.say(f"serve check: requests {picks} (batches "
                f"{[self.served[i + 1] for i in picks]}), rel L2 each "
                f"{[round(float(g), 6) for g in gaps]}")
        if run.control:
            with torch.no_grad(), ldm.float32_exact():
                ctl = ldm.generate(ref_in, w_ref, run.cfg, self.t, ldm.FP8)
            run.facts["control"] = judge.image_numbers(
                judge.image_gaps(ldm.to_uint8(ctl).cpu(), ref.cpu()))
        return judge.image_numbers(gaps)
