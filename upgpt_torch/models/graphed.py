"""CUDA graphs of the U-Net's ResBlocks and SpatialTransformers while it
samples.

A sampling step launches every kernel of the U-Net from Python, and the
host takes longer to launch a step than the card takes to run it. Here each
`ResBlock.forward` and `SpatialTransformer.forward` replays a CUDA graph of
its own body instead: the same kernels with the same arguments, one launch
from the host. The graph replays inside the layer's own `forward`, so its
forward hooks and its span stay as they were, and a profiler gives the
graph's kernels the correlation id of the launch that replays them, inside
the layer's call. What lies between the layers (`conv_in`, the time
embedding, the down- and upsamples, the skip concats, the out head) stays
eager.

The gate (`refusals`) reads only what a call can observe. A layer replays
a graph only where
- a `sampling()` block is open on this thread: `GenerationPipeline` opens
  one around its sampling, so a U-Net called anywhere else (the training
  step, the distillation teacher, a loss) runs eagerly and holds no graph,
- its input is on a CUDA device,
- autograd records nothing (`torch.no_grad`, `torch.inference_mode`),
- no stream on this thread is capturing already,
- no `eager()` block is open on this thread (the tensor-parallel grid's
  U-Nets, whose in-process collectives do not belong in a graph, and the
  trainer's image log, whose graphs would hold memory through the run),
  and
- it is a plain `ResBlock` or `SpatialTransformer` called inside
  `UNetModel.forward` (`unet_eval` opens the graph path there).
Every other call runs the layer's eager body, unchanged.

Signature and cache. A call's signature is its arguments' structure,
shapes and dtypes, the device, the current stream, whether inference mode
is on, and the data pointers of the layer's parameters: weights replaced
by new tensors are captured again, weights loaded in place are read by the
graph as they are. The first call of a signature runs eagerly, which also
warms cuDNN, cuBLAS and the kernels' plans; the second captures; the later
ones replay. A layer keeps at most `BOUND` signatures (`GraphCache`),
dropping the least recently used, and drops them all where its parameters
may have been replaced (`_apply`, `load_state_dict`).

Capture. On a side stream of this thread, in thread-local capture mode
(the serving engine's other threads keep running), without
`torch.cuda.graph`'s synchronize, gc and empty_cache. Every layer captured
during one U-Net eval goes into one memory pool, new for that eval; that is
safe because those graphs always replay in the order they were captured.

Inputs. A graph reads each tensor argument from a static buffer:
- an argument that is another graph's static output is captured where it
  is, so a layer fed by the previous layer's graph copies nothing;
- any other argument gets a buffer of the layer's own.
A call copies an argument into its buffer only where it is not the tensor
last copied there: by object identity and `_version`, never by address
alone, since a new batch's cross-attention K/V can reuse a freed batch's
memory. An inference tensor keeps no version counter: there identity
decides. So the K/V are copied once a batch and `emb` once a step.

Output. A layer returns its graph's static output, valid until the same
graph replays again; inside `UNetModel.forward` that is the next eval,
after every use of it, the skip list's included. Static buffers belong to
the model, so one thread at a time samples with it, as the serving
engine's dispatcher and the app's lock already ensure.

Counters. The kernel wrappers' launch counters rise at capture, as the
body runs; each replay adds that increase again
(`diagnostics.add_launches`), so `kernel_launches()` counts as an eager
run does. While the span recorder is on, `unet.graph.capture`,
`unet.graph.replay` and `unet.graph.eager` count the layer calls that
captured, replayed, or ran eagerly because the gate or the cache refused.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import weakref
from typing import Callable, List, Optional

import torch

from upgpt_torch.utils import diagnostics

BOUND = 4  # signatures a layer keeps

_local = threading.local()  # eval: the open U-Net eval; sampling; eager;
# streams
_SEEN = object()  # a signature's first call, which ran eagerly
_NO_EVAL = contextlib.nullcontext()


class GraphCache:
    """A layer's captured calls by signature: at most `bound`, the least
    recently used dropped first. A copy of the layer (`copy.deepcopy`,
    pickling) starts empty."""

    def __init__(self, bound: int = BOUND):
        self.bound = bound
        self.entries: collections.OrderedDict = collections.OrderedDict()
        self.params: Optional[list] = None  # [(a `_parameters` dict, key)]

    def get(self, key):
        entry = self.entries.get(key)
        if entry is not None:
            self.entries.move_to_end(key)
        return entry

    def put(self, key, entry) -> None:
        self.entries[key] = entry
        self.entries.move_to_end(key)
        while len(self.entries) > self.bound:
            self.entries.popitem(last=False)

    def clear(self) -> None:
        self.entries.clear()
        self.params = None

    def __len__(self) -> int:
        return len(self.entries)

    def __deepcopy__(self, memo) -> "GraphCache":
        return GraphCache(self.bound)

    def __reduce__(self):
        return GraphCache, (self.bound,)


def drop(module, _keys=None) -> None:
    """Forget every graph of `module` (a load_state_dict post hook)."""
    module._graphs.clear()


def _layer_kinds() -> tuple:
    from upgpt_torch.models.unet import ResBlock, SpatialTransformer

    return ResBlock, SpatialTransformer


def refusals(x: torch.Tensor) -> List[str]:
    """Why a U-Net eval on `x` does not take the graph path; empty where
    it does. Inside one that does, `call` admits the plain layer kinds."""
    why = []
    if not getattr(_local, "sampling", 0):
        why.append("sampling")
    if x.device.type != "cuda":
        why.append("device")
    elif torch.cuda.is_current_stream_capturing():
        why.append("capturing")
    if torch.is_grad_enabled():
        why.append("grad")
    if getattr(_local, "eager", 0):
        why.append("eager")
    return why


@contextlib.contextmanager
def _flag(name: str):
    setattr(_local, name, getattr(_local, name, 0) + 1)
    try:
        yield
    finally:
        setattr(_local, name, getattr(_local, name) - 1)


def sampling():
    """The U-Net evals inside, on this thread, may replay graphs: the
    block a sampling pipeline opens."""
    return _flag("sampling")


def eager():
    """Every layer called inside runs eagerly on this thread, even inside
    `sampling()`."""
    return _flag("eager")


def unet_eval(x: torch.Tensor):
    """The context of one U-Net eval on input `x`: the graph path where
    `refusals(x)` is empty, else a context that changes nothing."""
    if refusals(x):
        return _NO_EVAL
    return _Eval(x)


def _version(t: torch.Tensor) -> Optional[int]:
    return None if t.is_inference() else t._version


class _Slot:
    """The static buffer a graph reads one argument from, and the tensor
    last copied into it (a weak reference and its version)."""

    __slots__ = ("buffer", "src", "version")

    def __init__(self, t: torch.Tensor):
        """A buffer holding `t`'s values; where `t` is another graph's
        static output, `t` itself."""
        self.src = self.version = None
        if getattr(t, "_graph_output", False):
            self.buffer = t
        else:
            self.buffer = torch.empty_like(t)
            self.load(t)

    def load(self, t: torch.Tensor) -> bool:
        """Make the buffer hold `t`'s values; True where that copied."""
        if t is self.buffer or (self.src is not None and self.src() is t
                                and self.version == _version(t)):
            return False
        self.buffer.copy_(t)
        self.src, self.version = weakref.ref(t), _version(t)
        return True


class _Entry:
    """One captured call: its graph, the slots of its tensor arguments in
    order, its static output and the launch counters' increase."""

    __slots__ = ("graph", "slots", "out", "launches")

    def __init__(self, graph, slots, out, launches):
        self.graph, self.slots, self.out = graph, slots, out
        self.launches = launches

    def replay(self, leaves) -> torch.Tensor:
        for slot, t in zip(self.slots, leaves):
            slot.load(t)
        self.graph.replay()
        diagnostics.add_launches(self.launches)
        return self.out


class _Eval:
    """One U-Net eval on the graph path: the part of the signature its
    layers share, the layer kinds that replay, and the memory pool of the
    layers it captures."""

    def __init__(self, x: torch.Tensor):
        self.key = (x.device, torch.cuda.current_stream(x.device).cuda_stream,
                    torch.is_inference_mode_enabled())
        self.kinds = _layer_kinds()
        self.pool = None
        self.outer = None

    def __enter__(self):
        self.outer = getattr(_local, "eval", None)
        _local.eval = self
        return self

    def __exit__(self, *exc):
        _local.eval = self.outer
        return False

    def capture(self, body: Callable, args: tuple, leaves) -> _Entry:
        """Capture `body(*args)` on static copies of `leaves`, then replay
        it once for this call."""
        slots = [_Slot(t) for t in leaves]
        static = _rebuild(args, iter([s.buffer for s in slots]))
        before = diagnostics.launch_state()
        graph, out = _capture(self, body, static)
        out._graph_output = True
        entry = _Entry(graph, slots, out, diagnostics.launch_increase(
            before, diagnostics.launch_state()))
        graph.replay()
        return entry


def _capture(ev: _Eval, body: Callable, args: tuple):
    """(graph, output) of `body(*args)` captured on this thread's side
    stream into `ev`'s pool."""
    dev = ev.key[0]
    if ev.pool is None:
        ev.pool = torch.cuda.graph_pool_handle()
    streams = getattr(_local, "streams", None)
    if streams is None:
        streams = _local.streams = {}
    side = streams.get(dev)
    if side is None:
        side = streams[dev] = torch.cuda.Stream(dev)
    cur = torch.cuda.current_stream(dev)
    side.wait_stream(cur)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin(pool=ev.pool, capture_error_mode="thread_local")
        try:
            out = body(*args)
        finally:
            graph.capture_end()
    cur.wait_stream(side)
    return graph, out


def _flatten(obj, leaves: list, spec: list) -> None:
    """`obj`'s tensors into `leaves`, and its structure, shapes, dtypes
    and other values into `spec`."""
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        spec.append((tuple(obj.shape), obj.dtype))
    elif isinstance(obj, dict):
        spec.append(("dict", tuple(obj)))
        for v in obj.values():
            _flatten(v, leaves, spec)
    elif isinstance(obj, (tuple, list)):
        spec.append((type(obj), len(obj)))
        for v in obj:
            _flatten(v, leaves, spec)
    else:
        spec.append(("value", obj))


def _rebuild(obj, tensors):
    """`obj` with its tensors replaced, in `_flatten`'s order, by the
    next of `tensors`."""
    if isinstance(obj, torch.Tensor):
        return next(tensors)
    if isinstance(obj, dict):
        return {k: _rebuild(v, tensors) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_rebuild(v, tensors) for v in obj)
    return obj


def signature(module, args: tuple, leaves: Optional[list] = None) -> tuple:
    """A layer call's signature, less the eval's part (device, stream,
    inference mode): the arguments' structure, shapes and dtypes and the
    data pointers of the layer's parameters. Fills `leaves`, where given,
    with the arguments' tensors."""
    spec = []
    _flatten(args, [] if leaves is None else leaves, spec)
    cache = module._graphs
    if cache.params is None:
        cache.params = [(m._parameters, k) for m in module.modules()
                        for k in m._parameters]
    ptrs = tuple(None if d[k] is None else d[k].data_ptr()
                 for d, k in cache.params)
    return tuple(spec), ptrs


def call(module, body: Callable, *args) -> torch.Tensor:
    """`body(*args)`, the eager forward of layer `module`, through its
    graph where the open U-Net eval admits the layer (the eval has checked
    the rest of the gate): the first call of a signature eagerly, the
    second captured, the later ones replayed."""
    ev = getattr(_local, "eval", None)
    if ev is None or type(module) not in ev.kinds:
        diagnostics.count("unet.graph.eager")
        return body(*args)
    leaves = []
    key = (ev.key, signature(module, args, leaves))
    cache = module._graphs
    entry = cache.get(key)
    if entry is None:
        cache.put(key, _SEEN)
        diagnostics.count("unet.graph.eager")
        return body(*args)
    if entry is _SEEN:
        entry = ev.capture(body, args, leaves)
        cache.put(key, entry)
        diagnostics.count("unet.graph.capture")
        return entry.out
    diagnostics.count("unet.graph.replay")
    return entry.replay(leaves)
