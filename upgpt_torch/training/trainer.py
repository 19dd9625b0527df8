"""The training loop: the main.py/Lightning-Trainer equivalent.

Port of `upgpt_tpu.training.trainer` (reference main.py:518-801 and its
callbacks):
- the LR scaling rule lr = accumulate * n_devices * bs * base_lr
  (main.py:748-767) and the per-step LambdaLinear multiplier
  (ddpm.py:1527-1536);
- EMA updates on every optimizer call (ddpm.py:374-376);
- validation with raw and EMA losses (ddpm.py:365-372); the monitored
  `val/loss_simple_ema` drives best-checkpointing and early stopping
  (bbox.yaml:152-185);
- checkpoints (last, best, weights-only `trainstep_*`), resume, save on
  exception and SIGUSR1 -> save (main.py:771-796);
- image logs: short-DDIM EMA sample grids, the progressive denoise rows and
  the conditioning strips under logdir/images (ImageLogger,
  main.py:302-450), sampled eagerly (no CUDA graph, `models/graphed.py`).

Checkpoints are one `torch.save` file each, `<logdir>/checkpoints/<name>`:
step, the trainable parameters by name, the optimizer's state, the EMA
shadow and its count, and the frozen VAE (`frozen`), written on a thread
from a synchronous host snapshot, with `<name>.meta.json` holding the
epoch. `upgpt_torch.checkpoint.load_checkpoint` reads them for inference,
EMA first.

A run the JAX trainer wrote continues here: where `checkpoints/last` is
its orbax directory, `--resume` reads the step, the weights, the
optimizer state (optax.adamw, MultiSteps or the fused moments), the EMA
and its count, and the frozen VAE through `convert.optax_state`, and the
epoch from `last.meta.json`, which both trainers write alike. A tree that
does not map onto the run's optimizer fails the run with the reason;
nothing starts afresh. The first save then puts the port's file where the
directory was, the two names exchanged in one rename, so `last` names a
readable checkpoint at every moment.

Every step's draws come from a generator seeded by (seed, step), JAX's
`fold_in(rng, step)`: a run is a pure function of its seed and data, and a
resumed run continues the uninterrupted one bit for bit. The step count
lives on the host, so the loop makes no per-step sync; metrics are read
(`.item()`) on log steps only. Host batches cross to the card through
pinned memory on a side stream, one batch ahead (`transfer_prefetch`), and
the compute stream waits on the copy's event.

With a CLIP encoder the conditioning encode is split: the loader's
producer thread tokenises (`host_encode`), the token ids and the style
crops (uint8 in the compact transport) cross to the card, and the towers
run there on the same side stream, ahead of the step, whose stream waits
on the event recorded after them. The embeddings never return to the host.
The debug encoder's embeddings are made on the host, as before.

Data parallelism (`cli train --multihost`): in a process group
(`upgpt_torch.parallel.multihost`) each rank trains on its rows of every
global batch, the loaders slicing it, and exchanges gradients through DDP
(`train_state.data_parallel`). Every rank draws the global batch's
randomness and keeps its rows, so N ranks step as one process would on
the global batch. The validation means are averaged over the group before
`monitored`, best and early stopping read them, so every rank takes the
same decisions. Rank 0 alone writes: metrics.jsonl, TensorBoard, wandb,
every checkpoint and the image grids (sampled from its own rows, as JAX's
grid covers its host's slice). Resume and `--finetune-from` read the same
file on every rank.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import shutil
import signal
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from upgpt_torch.data.transforms import CLIP_MEAN, CLIP_STD
from upgpt_torch.diffusion.latent_diffusion import LatentDiffusion
from upgpt_torch.models import graphed
from upgpt_torch.parallel import mesh, multihost
from upgpt_torch.training.lr import lambda_linear_schedule
from upgpt_torch.training.train_state import (
    TrainState, create_fused_train_state, create_train_state, data_parallel,
    eval_step, scaled_learning_rate, train_step,
)


def decode_transport(batch: Dict) -> Dict:
    """Undo compact transport on the card: uint8 images -> float32 in
    [-1, 1] (v / 127.5 - 1, the exact inverse of `encode_transport` for
    uint8-sourced pixels), bfloat16 embeddings -> float32; other tensors
    pass through. The divisor is a tensor on the batch's device: CUDA's
    division by a host scalar multiplies by its reciprocal, which would
    round differently from the host's exactness audit."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor) and v.dtype == torch.uint8:
            out[k] = v.float().div_(
                torch.full((), 127.5, device=v.device)).sub_(1.0)
        elif isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16:
            out[k] = v.float()
        else:
            out[k] = v
    return out


def encode_transport(batch: Dict, memo: Optional[Dict[str, bool]] = None
                     ) -> Dict:
    """Host-side half of compact transport (see decode_transport): float32
    `image` / `person_mask` ship as uint8 where that is exact, float32
    `*_emb` as bfloat16 tensors (round to nearest even, as ml_dtypes
    rounds). Whether a key is exact is invariant per dataset config (the
    'smpl' RPM mask is continuous, the others uint8-sourced): with a
    `memo` the full-array audit runs once per key; memo=None audits every
    call."""
    out = {}
    for k, v in batch.items():
        if k in ("image", "person_mask") and np.asarray(v).dtype == np.float32:
            v = np.asarray(v)
            if memo is not None and memo.get(k) is False:
                out[k] = v  # known-lossy key (smpl RPM): ship f32
                continue
            q = np.round(
                np.clip((v + 1.0) * 127.5, 0.0, 255.0)).astype(np.uint8)
            if memo is not None and memo.get(k) is True:
                out[k] = q  # known-exact key: skip the audit
                continue
            exact = bool(
                np.array_equal(q.astype(np.float32) / 127.5 - 1.0, v))
            if memo is not None:
                memo[k] = exact
            out[k] = q if exact else v
        elif k.endswith("_emb") and np.asarray(v).dtype == np.float32:
            out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(
                torch.bfloat16)
        else:
            out[k] = v
    return out


def transfer_prefetch(raw_iter, to_device, depth: int = 2):
    """Run `to_device(raw)` on a helper thread `depth` batches ahead of the
    consumer, so host-to-card copies overlap the step (they release the
    GIL). An abandoned consumer (break, exception) stops the thread and
    closes `raw_iter`; a producer error is raised in the consumer."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    _END = object()
    stop = threading.Event()

    def put(item) -> bool:
        # a bounded put that gives up when the consumer is gone, so an
        # abandoned consumer never leaves this thread parked on a full queue
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for raw in raw_iter:
                if not put(to_device(raw)):
                    return  # consumer gone; dropping raw_iter closes it
            put(_END)
        except BaseException as e:  # noqa: BLE001 — raised in the consumer
            put(e)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:  # pragma: no cover
                break


def to_device(batch: Dict, keys, device) -> Dict[str, torch.Tensor]:
    """The `keys` of a batch (host arrays or tensors anywhere) as tensors
    on `device`."""
    return {k: (batch[k] if isinstance(batch[k], torch.Tensor)
                else torch.as_tensor(np.asarray(batch[k]))).to(device)
            for k in keys if k in batch}


# the JAX trainer's directory while the port's file takes its name;
# `Trainer._checkpoint` reads it where that name is missing
_ASIDE = ".orbax"


def replace_directory(tmp: Path, path: Path) -> None:
    """Put the file `tmp` where the JAX trainer's orbax directory `path`
    is, so that a readable checkpoint, old or new, is on disk at every
    moment: the directory moves aside to `<path>.orbax` (where
    `Trainer._checkpoint` finds it until the file is in place), the file
    takes its name, then the directory is removed. Refuses a directory
    orbax did not write."""
    from upgpt_torch.convert.orbax import is_orbax_dir

    if not is_orbax_dir(path):
        raise RuntimeError(f"{path} is a directory orbax did not write; "
                           f"the checkpoint is not written over it")
    aside = path.with_name(path.name + _ASIDE)
    os.rename(path, aside)
    os.replace(tmp, path)
    shutil.rmtree(aside)


def step_seed(seed: int, step: int) -> int:
    """The seed of step `step`'s draws (JAX's fold_in(PRNGKey(seed), step))."""
    return (seed * 0x9E3779B97F4A7C15 + step) % 2**63


@dataclasses.dataclass
class TrainerConfig:
    base_learning_rate: float = 2e-6
    scale_lr: bool = True
    batch_size: int = 12
    max_epochs: int = 100
    max_steps: Optional[int] = None
    accumulate_grad_batches: int = 1
    use_ema: bool = True
    ema_decay: float = 0.9999
    monitor: str = "loss_simple_ema"
    early_stop_patience: Optional[int] = 5
    log_every: int = 50
    log_images_every: Optional[int] = 1000
    # periodic weight-only snapshots under checkpoints/trainstep_<step>
    # (ModelCheckpoint every_n_train_steps + save_weights_only=True,
    # reference main.py:707-723; default off there too)
    ckpt_every_steps: Optional[int] = None
    image_log_ddim_steps: int = 20
    # progressive denoise rows (reference ddpm.py:1395-1431): frames per
    # sample in the `progressive_*.png` grid; 0 disables the extra decode
    image_log_progressive_frames: int = 6
    logdir: str = "logs/run"
    seed: int = 42
    warm_up_steps: int = 1
    scheduler_f_start: float = 1e-6
    # W&B stream of the same scalars (reference main.py:615-639);
    # import-guarded: without wandb the trainer logs to jsonl/TB and warns
    wandb: bool = False
    wandb_project: str = "upgpt-tpu"
    # uint8 image + bf16 embedding host->card transport, dequantized on the
    # card; exact for uint8-sourced images, ~4x fewer bytes per batch
    compact_transport: bool = False
    # the one-pass AdamW+EMA update (train_state.FusedTrainState);
    # moment_dtype "bfloat16" halves the moment and shadow traffic. Does
    # not compose with accumulate_grad_batches > 1
    fused_optimizer: bool = False
    moment_dtype: str = "float32"


class Trainer:
    # the batch keys the train and eval steps read
    _KEEP = ("image", "person_mask", "text_emb", "style_emb", "smpl",
             "loss_w")
    # the keys a sampling pipeline reads
    _GENERATE = ("text_emb", "style_emb", "smpl", "person_mask")
    # what a CLIP encoder's towers read on the card
    _TO_ENCODE = ("token_ids", "styles")

    def __init__(self, model: LatentDiffusion, config: TrainerConfig,
                 cond_encoder):
        self.model = model
        self.config = config
        self.cond_encoder = cond_encoder
        self.logdir = Path(config.logdir)
        # rank 0 writes every file under the logdir (Lightning's rank-zero
        # semantics); the others hold the same replicated state
        self._primary = multihost.is_primary()
        self._metrics_log = None
        self._tb = None
        self._wandb = None
        self._pending_save = None  # (thread, errors) of the writer in flight
        self._transport_memo: Dict[str, bool] = {}
        self._copy_stream = None
        self._fit_epoch = 0
        # host clock after each of the last 1,000 train steps of `fit`
        # (the multihost summary's ms between steps)
        self.step_ends = collections.deque(maxlen=1000)
        if self._primary:
            self._open_logs()
        # config.batch_size is the global batch, so the rule scales with
        # accumulate * batch_size (main.py:748-767's ngpu * bs)
        self.learning_rate = scaled_learning_rate(
            config.base_learning_rate, config.batch_size, 1,
            config.accumulate_grad_batches, config.scale_lr)
        self.scheduler = lambda_linear_schedule(
            [config.warm_up_steps], [1.0], [1.0],
            [config.scheduler_f_start], [10**13])

    def _open_logs(self) -> None:
        """The logdir, metrics.jsonl, TensorBoard and wandb (rank 0)."""
        config = self.config
        (self.logdir / "checkpoints").mkdir(parents=True, exist_ok=True)
        (self.logdir / "images").mkdir(parents=True, exist_ok=True)
        self._metrics_log = open(self.logdir / "metrics.jsonl", "a")
        # optional TensorBoard stream (the TestTube logger equivalent,
        # main.py:615-639); jsonl only where tensorboard is absent
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(str(self.logdir / "tb"))
        except Exception:  # noqa: BLE001 — tensorboard is optional
            self._tb = None
        if config.wandb:
            try:
                import wandb

                self._wandb = wandb.init(
                    project=config.wandb_project, name=self.logdir.name,
                    dir=str(self.logdir), config=dataclasses.asdict(config),
                    resume="allow")
            except Exception as e:  # noqa: BLE001 — absent or offline
                print(f"wandb disabled ({e!r}); logging to jsonl/tb only",
                      file=sys.stderr)
                self._wandb = None

    # ------------- steps -------------

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.model.device).manual_seed(seed)

    def _train_step(self, state, batch: Dict[str, torch.Tensor]):
        """One optimizer call on a batch on the card; the draws from
        (seed + 1, step), as JAX folds the step into PRNGKey(seed + 1)."""
        gen = self._generator(step_seed(self.config.seed + 1, state.step))
        return train_step(self.model, state, decode_transport(batch), gen)

    def _eval_step(self, state, batch: Dict[str, torch.Tensor]):
        # every validation batch on the same draws, as JAX's eval reuses
        # PRNGKey(seed + 1)
        return eval_step(self.model, state, decode_transport(batch),
                         self._generator(self.config.seed + 1))

    # ------------- checkpointing -------------

    @staticmethod
    def _host(tree):
        """A host copy of every tensor in a tree of dicts and lists."""
        if isinstance(tree, torch.Tensor):
            return tree.detach().to("cpu", copy=True)
        if isinstance(tree, dict):
            return {k: Trainer._host(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(Trainer._host(v) for v in tree)
        return tree

    def _payload(self, state, weights_only: bool = False) -> Dict:
        payload = {"step": state.step, "names": list(state.names),
                   "params": dict(zip(state.names, state.params))}
        if not weights_only:
            payload["opt_state"] = state.opt_state()
        if state.ema is not None:
            payload["ema"] = dict(zip(state.names, state.ema.shadow))
            payload["ema_updates"] = state.ema.num_updates
        # the frozen first stage travels with the checkpoint, so a resumed
        # or sampled run never falls back to a random VAE
        payload["frozen"] = {"vae": self.model.vae.state_dict()}
        return self._host(payload)

    def _write(self, payload: Dict, path: Path) -> None:
        tmp = path.with_name(path.name + ".tmp")
        torch.save(payload, tmp)
        if path.is_dir():  # the JAX trainer's orbax checkpoint
            replace_directory(tmp, path)
        else:
            os.replace(tmp, path)
            # a JAX directory left aside by a save cut before its rename
            shutil.rmtree(path.with_name(path.name + _ASIDE),
                          ignore_errors=True)

    def _join_pending_save(self) -> None:
        if self._pending_save is not None:
            thread, err = self._pending_save
            thread.join()
            self._pending_save = None
            # a swallowed write failure would leave the trainer believing
            # the checkpoint exists: surface it at the next join point
            if err:
                raise RuntimeError(
                    f"async checkpoint save failed: {err[0]!r}") from err[0]

    def save_checkpoint(self, state, name: str = "last",
                        epoch: Optional[int] = None, wait: bool = True,
                        weights_only: bool = False) -> None:
        """Snapshot the state to the host now (the saved state is exactly
        the one at the call), then write it, on a thread when wait=False.
        At most one write is in flight: a new save or a restore joins the
        previous one first and raises its error. `weights_only` (the
        trainstep snapshots, main.py:718) leaves the optimizer out."""
        if not self._primary:
            return  # rank 0 saves; every rank holds the same state
        self._join_pending_save()
        path = self.logdir / "checkpoints" / name
        payload = self._payload(state, weights_only)

        def write():
            self._write(payload, path)
            if epoch is not None:
                # the epoch travels beside the checkpoint: step //
                # len(loader) breaks after a batch-size or dataset change
                meta = self.logdir / "checkpoints" / f"{name}.meta.json"
                meta.write_text(json.dumps({"epoch": int(epoch)}))

        if wait:
            write()
            return
        import threading

        err: list = []

        def guarded():
            try:
                write()
            except BaseException as exc:  # noqa: BLE001 — raised on join
                err.append(exc)

        thread = threading.Thread(target=guarded, daemon=True)
        self._pending_save = (thread, err)
        thread.start()

    def _load_epoch_meta(self, name: str = "last") -> Optional[int]:
        meta = self.logdir / "checkpoints" / f"{name}.meta.json"
        if meta.exists():
            return int(json.loads(meta.read_text()).get("epoch"))
        return None

    def _checkpoint(self, name: str) -> Path:
        """`checkpoints/<name>`, or the JAX directory moved aside from it
        where a save was cut before its file took the name."""
        path = self.logdir / "checkpoints" / name
        aside = path.with_name(name + _ASIDE)
        return aside if not path.exists() and aside.is_dir() else path

    @torch.no_grad()
    def load_checkpoint(self, state, name: str = "last"):
        """Restore `name`, the port's file or the JAX trainer's orbax
        directory, into the live state and model in place (after joining
        any write in flight). Returns (state, frozen): `frozen` is the
        checkpoint's stored VAE state dict, loaded into the model, or None
        where the checkpoint has none. A JAX tree that does not map onto
        the state raises ValueError before anything is written."""
        from upgpt_torch.convert.optax_state import trainer_payload
        from upgpt_torch.convert.orbax import is_orbax_dir

        self._join_pending_save()
        path = self._checkpoint(name)
        if is_orbax_dir(path):
            payload = trainer_payload(path, state, self.model.device)
        else:
            payload = torch.load(path, map_location=self.model.device,
                                 weights_only=True)
        if list(payload["names"]) != list(state.names):
            raise RuntimeError(f"checkpoint {path} holds other parameters "
                               f"than the model trains")
        torch._foreach_copy_(state.params,
                             [payload["params"][n] for n in state.names])
        state.load_opt_state(payload["opt_state"])
        state.step = int(payload["step"])
        if state.ema is not None and "ema" in payload:
            torch._foreach_copy_(state.ema.shadow,
                                 [payload["ema"][n] for n in state.names])
            state.ema.num_updates = int(payload["ema_updates"])
        frozen = payload.get("frozen")
        if frozen is not None:
            self.model.vae.load_state_dict(frozen["vae"], strict=True)
        return state, frozen

    # ------------- logging -------------

    def _log(self, record: Dict[str, Any]) -> None:
        if self._metrics_log is None:
            return  # not rank 0
        rec = {k: (float(v) if hasattr(v, "item") else v)
               for k, v in record.items()}
        self._metrics_log.write(json.dumps(rec) + "\n")
        self._metrics_log.flush()
        scalars = {k: v for k, v in rec.items()
                   if isinstance(v, float) and k not in ("step", "epoch")}
        if self._tb is not None and "step" in rec:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, rec["step"])
        if self._wandb is not None and "step" in rec and scalars:
            self._wandb.log(scalars, step=int(rec["step"]))

    @contextlib.contextmanager
    def _ema_weights(self, state):
        """The EMA shadow in the model's trainable parameters for the
        block (ema_scope, ddpm.py:179-192); the raw weights after it."""
        if state.ema is None:
            yield
            return
        with torch.no_grad():
            backup = [p.detach().clone() for p in state.params]
            torch._foreach_copy_(state.params, state.ema.shadow)
        try:
            yield
        finally:
            with torch.no_grad():
                torch._foreach_copy_(state.params, backup)

    def log_images(self, state, batch: Dict, step: int) -> None:
        """Short-DDIM EMA sample grid, the progressive rows and the
        conditioning strips of an encoded host batch (ImageLogger,
        main.py:302-450). Rank 0 samples its rows and writes them; the
        other ranks skip it (no collective runs inside)."""
        from upgpt_torch.inference.pipeline import GenerationPipeline

        if not self._primary:
            return

        strips = {k: np.asarray(batch[k])
                  for k in ("src_image", "smpl_image", "styles")
                  if k in batch}
        gen_batch = to_device(batch, self._GENERATE, self.model.device)
        pipe = GenerationPipeline(
            self.model, num_steps=self.config.image_log_ddim_steps, eta=1.0)
        n_prog = self.config.image_log_progressive_frames
        prog = None
        # eagerly: graphs captured here would hold their memory pools
        # through the rest of the run
        with self._ema_weights(state), graphed.eager():
            if n_prog > 0:
                # the denoise rows (progressive_denoising, ddpm.py:1395-
                # 1431): x0 predictions decoded at n_prog evenly spaced steps
                imgs, prog = pipe.generate_progressive(
                    gen_batch, self._generator(step), n_frames=n_prog)
            else:
                imgs = pipe.generate(gen_batch, self._generator(step))
        imgs = imgs.float().cpu().numpy()
        images = self.logdir / "images"
        self._save_grid(imgs, images / f"samples_{step:08d}.png",
                        tag="samples", step=step)
        if prog is not None:
            # one row per sample: frames left->right down the reverse process
            prog = prog.float().cpu().numpy()
            b, f, hh, ww, cc = prog.shape
            rows = prog.transpose(0, 2, 1, 3, 4).reshape(b, hh, f * ww, cc)
            self._save_grid(rows, images / f"progressive_{step:08d}.png",
                            nrow=1, tag="progressive", step=step)
        for key in ("src_image", "smpl_image"):
            if key in strips:
                self._save_grid(strips[key], images / f"{key}_{step:08d}.png",
                                tag=key, step=step)
        if "styles" in strips:
            # denormalized per-slot style strips (save_styles, main.py:355-388)
            styles = strips["styles"]  # (B, 9, 224, 224, 3)
            strip = styles.transpose(0, 2, 1, 3, 4).reshape(
                styles.shape[0], styles.shape[2], -1, 3)
            strip = np.clip(strip * CLIP_STD + CLIP_MEAN, 0, 1) * 2.0 - 1.0
            self._save_grid(strip, images / f"styles_{step:08d}.png",
                            nrow=1, tag="styles", step=step)

    def _save_grid(self, imgs: np.ndarray, path: Path, nrow: int = 4,
                   tag: Optional[str] = None,
                   step: Optional[int] = None) -> None:
        """A PNG grid of [-1, 1] NHWC images, and the same grid into the
        TensorBoard stream where there is one."""
        from PIL import Image

        imgs = np.clip((imgs + 1.0) / 2.0, 0, 1)
        n, h, w, c = imgs.shape
        rows = int(np.ceil(n / nrow))
        grid = np.zeros((rows * h, nrow * w, c), np.float32)
        for i in range(n):
            r, col = divmod(i, nrow)
            grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = imgs[i]
        grid8 = (grid * 255).astype(np.uint8)
        Image.fromarray(grid8).save(path)
        if self._tb is not None and tag is not None:
            try:
                self._tb.add_image(f"images/{tag}", grid8, step,
                                   dataformats="HWC")
                self._tb.flush()
            except Exception:  # noqa: BLE001 — PNGs are the artifact
                pass

    # ------------- the loop -------------

    def host_encode(self, raw: Dict) -> Dict:
        """Host-side batch post-processing: the conditioning encode's host
        half (a CLIP encoder tokenises; the debug encoder makes the
        embeddings) and the transport pack. The train loader runs it as its
        `batch_transform`, in its producer thread, so it overlaps the
        step."""
        enc = self.cond_encoder
        keep = self._KEEP
        if hasattr(enc, "encode_device"):
            batch = enc.tokenize_batch(raw)
            keep = keep + self._TO_ENCODE
        else:
            batch = enc.encode_batch(raw)
        batch = {k: v for k, v in batch.items() if k in keep}
        if self.config.compact_transport:
            batch = encode_transport(batch, self._transport_memo)
        return batch

    def _device_batch(self, raw: Dict):
        """An encoded batch on the card: (tensors, event). On a CUDA card
        each array crosses from pinned memory on a side stream, where a
        CLIP encoder's towers then run on it."""
        if "text_emb" not in raw and "token_ids" not in raw:
            raw = self.host_encode(raw)  # not pre-encoded by the loader
        host = {k: torch.as_tensor(np.asarray(v)) if not isinstance(
                    v, torch.Tensor) else v
                for k, v in raw.items() if k in self._KEEP + self._TO_ENCODE}
        dev = self.model.device
        if dev.type != "cuda":
            return self._encode({k: v.to(dev) for k, v in host.items()}), None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(dev)
        with torch.cuda.stream(self._copy_stream):
            out = self._encode({k: v.pin_memory().to(dev, non_blocking=True)
                                for k, v in host.items()})
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return out, event

    def _encode(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """The device half of the conditioning encode, where the batch
        carries token ids (a CLIP encoder), on the current stream."""
        if "token_ids" in batch:
            batch = self.cond_encoder.encode_device(batch)
        return {k: v for k, v in batch.items() if k in self._KEEP}

    @staticmethod
    def _ready(item) -> Dict[str, torch.Tensor]:
        """The batch of `_device_batch`, ordered after its copy on the
        current stream."""
        batch, event = item
        if event is not None:
            stream = torch.cuda.current_stream()
            stream.wait_event(event)
            for v in batch.values():
                v.record_stream(stream)
        return batch

    def _create_state(self):
        """The train state; in a process group, with DDP's exchange."""
        cfg = self.config
        use_ema = cfg.use_ema and getattr(self.model.config, "use_ema", True)
        if cfg.fused_optimizer:
            if cfg.accumulate_grad_batches > 1:
                raise ValueError(
                    "fused_optimizer does not compose with "
                    "accumulate_grad_batches>1 (optax.MultiSteps); pick one")
            state = create_fused_train_state(
                self.model, self.learning_rate, self.scheduler,
                use_ema=use_ema, ema_decay=cfg.ema_decay,
                moment_dtype=cfg.moment_dtype)
        else:
            state = create_train_state(
                self.model, self.learning_rate, self.scheduler,
                use_ema=use_ema, ema_decay=cfg.ema_decay,
                accumulate_grad_batches=cfg.accumulate_grad_batches)
        if multihost.group() is not None:
            state.ddp = data_parallel(self.model)
        return state

    def _group_mean(self, metrics: Dict[str, torch.Tensor]
                    ) -> Dict[str, float]:
        """Validation metrics averaged over the group, as floats: every
        rank reads the same numbers."""
        return {k: float(v) for k, v in mesh.mean_over_group(metrics).items()}

    def fit(self, train_loader, val_loader=None,
            params: Optional[Dict[str, torch.Tensor]] = None,
            frozen_params: Optional[Dict] = None,
            resume: bool = False) -> TrainState:
        """Train on the model's current weights, or on `params` (trainable
        parameters by name) and `frozen_params` ({"vae": state dict})
        loaded into it; `resume` continues from checkpoints/last."""
        cfg = self.config
        with torch.no_grad():
            if params is not None:
                named = dict(self.model.named_parameters())
                for n, v in params.items():
                    named[n].copy_(v)
            if frozen_params is not None:
                self.model.vae.load_state_dict(frozen_params["vae"],
                                               strict=True)
        state = self._create_state()
        if resume and self._checkpoint("last").exists():
            state, restored = self.load_checkpoint(state)
            if restored is None and frozen_params is None:
                raise RuntimeError(
                    "resume: checkpoint has no frozen first-stage (VAE) "
                    "payload and none was passed — refusing to resume "
                    "against a randomly initialized VAE. Pass frozen_params "
                    "(e.g. via --finetune-from).")
            print(f"resumed from step {state.step}")

        # SIGUSR1 -> checkpoint (main.py:771-782 'Summoning checkpoint'),
        # with the CURRENT epoch, so a preemption-resume redoes it
        def _usr1(signum, frame):
            print("Summoning checkpoint.")
            self.save_checkpoint(state, "last", epoch=self._fit_epoch)

        # SIGUSR2 -> live introspection (the reference drops into pudb,
        # main.py:784-788): every thread's stack and the card's memory
        def _usr2(signum, frame):
            import faulthandler

            from upgpt_torch.utils.diagnostics import device_memory_stats

            print("SIGUSR2: dumping thread stacks + device memory",
                  file=sys.stderr)
            faulthandler.dump_traceback(file=sys.stderr)
            print(device_memory_stats(), file=sys.stderr)

        try:
            signal.signal(signal.SIGUSR1, _usr1)
            signal.signal(signal.SIGUSR2, _usr2)
        except ValueError:
            pass  # not in the main thread

        best = np.inf
        bad_epochs = 0
        stop = False
        # sanity val: one batch before training (num_sanity_val_steps=1,
        # reference bbox.yaml:189)
        if val_loader is not None and state.step == 0:
            sb = self._ready(self._device_batch(next(val_loader.epoch(0))))
            sanity = self._group_mean(self._eval_step(state, sb))
            self._log({"step": 0, "sanity": 1,
                       **{f"val/{k}": v for k, v in sanity.items()}})
        # the epoch counter travels with the checkpoint (meta sidecar);
        # step // len(loader) is the fallback
        start_epoch = 0
        if resume:
            meta_epoch = self._load_epoch_meta()
            start_epoch = (meta_epoch if meta_epoch is not None
                           else state.step // max(len(train_loader), 1))
        self._fit_epoch = start_epoch
        epoch = start_epoch
        try:
            for epoch in range(start_epoch, cfg.max_epochs):
                self._fit_epoch = epoch
                t_epoch = time.time()
                for item in transfer_prefetch(train_loader.epoch(epoch),
                                              self._device_batch):
                    state, metrics = self._train_step(state, self._ready(item))
                    self.step_ends.append(time.perf_counter())
                    step = state.step
                    if step % cfg.log_every == 0:
                        self._log({"step": step, "epoch": epoch,
                                   "lr": self.learning_rate
                                   * float(self.scheduler(step)),
                                   **metrics})
                    if (cfg.log_images_every and val_loader is not None
                            and step % cfg.log_images_every == 0):
                        raw_vb = next(val_loader.epoch(epoch))
                        self.log_images(
                            state, self.cond_encoder.encode_batch(raw_vb),
                            step)
                    if (cfg.ckpt_every_steps
                            and step % cfg.ckpt_every_steps == 0):
                        self.save_checkpoint(
                            state, f"trainstep_{step:09d}", epoch=epoch,
                            wait=False, weights_only=True)
                    if cfg.max_steps and step >= cfg.max_steps:
                        stop = True
                        break

                # ---- validation ----
                if val_loader is not None:
                    vals: Dict[str, list] = {}
                    for raw in val_loader.epoch(epoch):
                        out = self._group_mean(self._eval_step(
                            state, self._ready(self._device_batch(raw))))
                        for k, v in out.items():
                            vals.setdefault(k, []).append(v)
                    val_metrics = {f"val/{k}": float(np.mean(v))
                                   for k, v in vals.items()}
                    self._log({"step": state.step, "epoch": epoch,
                               "epoch_time": time.time() - t_epoch,
                               **val_metrics})
                    monitored = val_metrics.get(f"val/{cfg.monitor}", np.inf)
                    if monitored < best:
                        best = monitored
                        bad_epochs = 0
                        self.save_checkpoint(state, "best", epoch=epoch + 1,
                                             wait=False)
                    else:
                        bad_epochs += 1
                self.save_checkpoint(state, "last", epoch=epoch + 1,
                                     wait=False)
                if stop:
                    break
                if (cfg.early_stop_patience is not None
                        and val_loader is not None
                        and bad_epochs > cfg.early_stop_patience):
                    print(f"early stopping at epoch {epoch} (no "
                          f"{cfg.monitor} improvement for {bad_epochs} "
                          f"epochs)")
                    break
        except BaseException:
            # save on exception (main.py:792-796), redoing the interrupted
            # epoch. A failed in-flight save must not mask the original
            # exception: drop it (the save below rewrites "last")
            if self._pending_save is not None:
                self._pending_save[0].join()
                self._pending_save = None
            self.save_checkpoint(state, "last", epoch=epoch)
            raise
        self._join_pending_save()
        if self._wandb is not None:
            self._wandb.finish()
        return state
