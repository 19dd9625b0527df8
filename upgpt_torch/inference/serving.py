"""Serving engine: request batching over the generation pipeline, on one
device or on replicas of it.

Port of `upgpt_tpu.inference.serving`. The pipeline's throughput comes from
batch occupancy, so concurrent requests are packed into fixed-size
batches:

- requests (conditioning embeddings + mask) enter a queue and are packed
  into batches of `batch_size`; a batching window (`max_delay_s`) trades
  tail latency for occupancy, and the tail batch is padded to the static
  batch shape by repeating its last row, so every batch has one shape;
- a group of requests (`submit_group`) is served in one batch: a group
  that does not fit the batch being packed leads the next one;
- up to `max_in_flight` batches stay dispatched but unfenced (default 2):
  `generate` returns a device tensor and a CUDA event is recorded after
  it, so batch i+1 is packed and dispatched while batch i still runs, and
  the fence waits on batch i's event before copying its uint8 images to
  the host;
- per-request futures deliver their rows; a failed batch fails only its
  own requests and the engine keeps serving; `stop()` serves what is
  queued, then joins.

Determinism: batch i (counting dispatched batches from 0) draws on the
model's device from a `torch.Generator` seeded `base_seed * 2**32 + i`,
and the base of its `x_T_seed` rows on the host from a CPU generator of
the same seed (`GenerationPipeline.generate(seed_generator=...)`). The
batch's arrays reach the device through pinned memory without blocking,
and `x_T_seed` stays on the host, so a dispatch makes no device sync. A
result is reproducible given (`base_seed`, the batch's composition and
its index), as the JAX engine's `fold_in(base_key, i)` is.

Data parallelism (`devices`, `cli serve --dp N`; JAX shards each batch
over its mesh's data axis, :83-115): one replica of the pipeline per
device, each packed batch split by rows into equal parts, each part run
on its replica under that device's own fence event, the images gathered
in request order. The batch's randomness is drawn as one device would
draw it (`pipeline.draws`, from batch i's generators on the first
replica's device) and each replica takes its rows, so N replicas give the
one-device engine's images for the same requests and seeds. The replicas
run the hand-written kernels as one device does (JAX turns its Pallas
kernels off under --dp, because GSPMD cannot partition them; ROADMAP §3
P9).

Spans (`utils/diagnostics.py`, recorded while its recorder is on): each
request's `engine.queue` from its submit to the start of the dispatch of
the batch that serves it; per batch `engine.collect`, `engine.pack`,
`engine.dispatch`, and `engine.deliver` around `fetch`'s event wait
(`engine.fence`) and copy to the host (`engine.copy`) and the futures it
sets. Each carries the batch's index, and a request's wait its own id and
its batch's, so a request's latency splits into queue, dispatch, the wait
behind later dispatches, fence and copy.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import math
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from upgpt_torch.utils.diagnostics import begin, end, span


def _indexed(device: torch.device) -> torch.device:
    """`cuda` as the current card's `cuda:i`, as a model's device reads."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@dataclass
class ServingStats:
    requests: int = 0
    images: int = 0          # includes padding
    batches: int = 0
    padded_slots: int = 0
    # bounded window: a long-running server must not grow without limit
    latencies_s: deque = field(default_factory=lambda: deque(maxlen=10000))

    def summary(self) -> Dict[str, float]:
        """Counts, occupancy and latency percentiles (nearest rank,
        `ceil(q n) - 1`, as the benchmark takes them)."""
        lat = sorted(self.latencies_s)

        def pick(q):
            return lat[max(0, math.ceil(q * len(lat)) - 1)] if lat else 0.0

        occ = (self.requests / self.images) if self.images else 0.0
        return {
            "requests": self.requests,
            "batches": self.batches,
            "occupancy": round(occ, 4),
            "p50_latency_s": round(pick(0.50), 4),
            "p95_latency_s": round(pick(0.95), 4),
        }


class ServingEngine:
    """Batch-packing serving loop around a GenerationPipeline (or a
    ChainedUpscalePipeline).

    >>> eng = ServingEngine(pipe, batch_size=32)
    >>> eng.start()
    >>> fut = eng.submit({"text_emb": ..., "style_emb": ..., "smpl": ...,
    ...                   "person_mask": ...})
    >>> image = fut.result()          # (H, W, C) numpy
    >>> eng.stop()
    """

    def __init__(
        self,
        pipeline,
        batch_size: int = 32,
        max_delay_s: float = 0.25,
        base_seed: int = 0,
        max_in_flight: int = 2,
        devices: Optional[List] = None,
    ):
        """`max_in_flight`: dispatched-but-unfenced batch depth. 1 overlaps
        only the copy to the host with compute; 2 (default) also overlaps
        the host's pack and dispatch of the next batch, which matter at low
        step counts.

        `devices`: one replica of the pipeline per entry (a device may
        repeat); the first is the pipeline itself where it already lies
        there, every other a copy moved to its device. `batch_size` must
        divide over them, as JAX's over its mesh's data axis."""
        self.pipeline = pipeline
        # where the model (a chain's first stage) lives
        stage = pipeline.base if hasattr(pipeline, "base") else pipeline
        self.device = stage.model.device
        self.replicas = [pipeline]
        self.devices = [self.device]
        if devices is not None:
            if not devices:
                raise ValueError("devices: at least one")
            if int(batch_size) % len(devices):
                raise ValueError(f"batch_size {batch_size} not divisible by "
                                 f"the {len(devices)} replicas")
            self.devices = [_indexed(torch.device(d)) for d in devices]
            self.replicas = [
                pipeline if i == 0 and d == self.device
                else copy.deepcopy(pipeline).to(d)
                for i, d in enumerate(self.devices)]
            self.pipeline = self.replicas[0]
            self.device = self.devices[0]
        self.batch_size = int(batch_size)
        self.max_delay_s = float(max_delay_s)
        self.base_seed = int(base_seed)
        self.max_in_flight = max(1, int(max_in_flight))
        self.stats = ServingStats()
        self._queue: "queue.Queue" = queue.Queue()
        self._pushback = None  # group that didn't fit the batch being packed
        self._request_ids = itertools.count()
        self._thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()

    # ------------------------------------------------------------- client

    def submit(self, cond: Dict[str, Any]) -> Future:
        """Enqueue one request; returns a Future of the (H, W, C) image.

        `cond` carries per-sample conditioning WITHOUT the batch dim:
        text_emb (77, 768), optional style_emb (9, 768), smpl (1, 85),
        person_mask (h, w, 1), optional x_T_seed. Shapes must match the
        engine's model: every request in a batch shares one shape.
        """
        return self.submit_group([cond])[0]

    def submit_group(self, conds: List[Dict[str, Any]]) -> List[Future]:
        """Enqueue a group that is served in ONE batch.

        Needed wherever samples must share a batch's randomness, e.g.
        interpolation sweeps whose frames carry equal `x_T_seed`s: equal
        seeds yield equal initial noise within one packed batch.
        """
        if self._thread is None:
            raise RuntimeError("engine not started")
        if not conds:
            return []
        if len(conds) > self.batch_size:
            raise ValueError(
                f"group of {len(conds)} exceeds batch_size {self.batch_size}")
        futs: List[Future] = [Future() for _ in conds]
        # each request's wait, closed when its batch's dispatch begins
        waits = [begin("engine.queue", request=next(self._request_ids))
                 for _ in conds]
        self._queue.put((list(conds), futs, time.perf_counter(), waits))
        return futs

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stopping.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ServingEngine")
        self._thread.start()

    def stop(self) -> None:
        """Drain the queue, serve what remains, and join the loop."""
        if self._thread is None:
            return
        self._stopping.set()
        self._queue.put(None)  # wake the dispatcher
        self._thread.join()
        self._thread = None

    # ------------------------------------------------------ batch recipe

    def generators(self, index: int
                   ) -> Tuple[torch.Generator, torch.Generator]:
        """(device generator, host generator) of batch `index`."""
        seed = self.base_seed * 2**32 + int(index)
        return (torch.Generator(device=self.device).manual_seed(seed),
                torch.Generator().manual_seed(seed))

    def _pack(self, items: List) -> Dict[str, np.ndarray]:
        """Pad request conditionings to the static batch shape."""
        conds = [c for it in items for c in it[0]]
        n_pad = self.batch_size - len(conds)
        keys = conds[0].keys()
        batch = {}
        for k in keys:
            rows = [np.asarray(c[k]) for c in conds]
            rows += [rows[-1]] * n_pad  # padded slots recompute the last row
            batch[k] = np.stack(rows)
        return batch

    def to_device(self, batch: Dict[str, np.ndarray]
                  ) -> Dict[str, torch.Tensor]:
        """A packed batch as the pipeline takes it: float arrays on the
        device (through pinned memory, without blocking the host),
        `x_T_seed` as int64 on the host."""
        out = {}
        for k, v in batch.items():
            if k == "x_T_seed":
                out[k] = torch.from_numpy(np.asarray(v, np.int64))
                continue
            t = torch.from_numpy(np.ascontiguousarray(v, np.float32))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def dispatch(self, batch: Dict[str, np.ndarray], index: int):
        """Launch the generation of packed batch `index`: (images on the
        device, a CUDA event recorded after them, or None on the CPU);
        with replicas, a list of each replica's part and a list of their
        events. Nothing here waits on the device."""
        with span("engine.dispatch", batch=index):
            gen, host_gen = self.generators(index)
            full = self.to_device(batch)
            if len(self.replicas) == 1:
                out = self.pipeline.generate(full, gen,
                                             seed_generator=host_gen)
                return out, self._record(out)
            draws = self.pipeline.draws(full, gen, seed_generator=host_gen)
            per = self.batch_size // len(self.replicas)
            outs, events = [], []
            for r, (pipe, dev) in enumerate(zip(self.replicas, self.devices)):
                rows = slice(r * per, (r + 1) * per)
                on_dev = (torch.cuda.device(dev) if dev.type == "cuda"
                          else contextlib.nullcontext())
                with on_dev:
                    part = {k: (v[rows] if k == "x_T_seed" else
                                v[rows].to(dev, non_blocking=True))
                            for k, v in full.items()}
                    kw = {k: (v[:, rows] if k.endswith("noise") else v[rows]
                              ).to(dev, non_blocking=True)
                          for k, v in draws.items()}
                    out = pipe.generate(part, **kw)
                    outs.append(out)
                    events.append(self._record(out))
            return outs, events

    @staticmethod
    def _record(out: torch.Tensor):
        """A CUDA event after `out` on its device's current stream; None
        on the CPU."""
        if not out.is_cuda:
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(out.device))
        return event

    @staticmethod
    def fetch(out, event) -> np.ndarray:
        """Wait for a dispatched batch and copy its images to the host;
        with replicas, each part after its own event, in request order."""
        if isinstance(out, list):
            return np.concatenate([ServingEngine.fetch(o, e)
                                   for o, e in zip(out, event)])
        with span("engine.fence"):
            if event is not None:
                event.synchronize()
        with span("engine.copy"):
            return out.cpu().numpy()

    # ---------------------------------------------------------- dispatcher

    def _collect(self, wait: bool) -> List:
        """One batch worth of request groups; [] when none are available.

        `wait=False` (a batch is in flight): return immediately on an empty
        queue so the caller can fence the in-flight batch instead of
        blocking — otherwise a lone request's future would hang until the
        NEXT request arrived. `wait=True`: block for the first request, then
        fill up to batch_size within the batching window. Groups are atomic:
        one that doesn't fit the remaining space is held in `_pushback` and
        leads the next batch. The shutdown sentinel (None) stops collection;
        a collected tail is still served.
        """
        items: List = []
        count = 0

        def take(item) -> bool:
            nonlocal count
            if count + len(item[0]) > self.batch_size:
                self._pushback = item
                return False
            items.append(item)
            count += len(item[0])
            return True

        if self._pushback is not None:
            item, self._pushback = self._pushback, None
            take(item)  # always fits: group <= batch_size, batch empty
        if not items:
            try:
                if wait and not self._stopping.is_set():
                    first = self._queue.get()
                else:
                    first = self._queue.get_nowait()
            except queue.Empty:
                return items
            if first is not None:
                take(first)
        deadline = time.perf_counter() + self.max_delay_s
        while count < self.batch_size:
            remaining = deadline - time.perf_counter()
            if self._stopping.is_set():
                # no window at shutdown: just drain whatever is queued
                remaining = 0.0
            try:
                nxt = self._queue.get(timeout=max(remaining, 0.0))
            except queue.Empty:
                break
            if nxt is None:
                break
            if not take(nxt):  # held in _pushback for the next batch
                break
        return items

    def _run(self) -> None:
        inflight: deque = deque()  # (out, event, items, index), oldest first

        def fence(entry):
            out, event, items, index = entry
            # the batch's fence and copy (inside `fetch`) take its id
            with span("engine.deliver", batch=index):
                try:
                    host = self.fetch(out, event)
                except Exception as exc:  # noqa: BLE001 — fail that batch
                    for _, futs, _, _ in items:
                        for fut in futs:
                            fut.set_exception(exc)
                    return
                t_done = time.perf_counter()
                i = 0
                for _, futs, t_in, _ in items:
                    for fut in futs:
                        self.stats.latencies_s.append(t_done - t_in)
                        fut.set_result(host[i])
                        i += 1

        while True:
            with span("engine.collect", batch=self.stats.batches):
                items = self._collect(wait=not inflight)
            if not items:
                if inflight:
                    fence(inflight.popleft())
                if (not inflight and self._stopping.is_set()
                        and self._queue.empty() and self._pushback is None):
                    return
                continue
            index = self.stats.batches
            n_samples = sum(len(futs) for _, futs, _, _ in items)
            try:
                with span("engine.pack", batch=index):
                    packed = self._pack(items)
                for _, _, _, waits in items:
                    for wait in waits:
                        end(wait, batch=index)
                out, event = self.dispatch(packed, index)
            except Exception as exc:  # noqa: BLE001 — shape errors
                for _, futs, _, _ in items:
                    for fut in futs:
                        fut.set_exception(exc)
                continue
            self.stats.batches += 1
            self.stats.requests += n_samples
            self.stats.images += self.batch_size
            self.stats.padded_slots += self.batch_size - n_samples
            # later batches' pack and dispatch run while the oldest one
            # computes; its copy to the host waits on its own event only
            inflight.append((out, event, items, index))
            while len(inflight) >= self.max_in_flight + 1:
                fence(inflight.popleft())
