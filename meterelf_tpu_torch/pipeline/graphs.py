"""CUDA graphs of the coefficient step's quad branch
(pipeline/decode.make_coef_decode_fn).

A ``Graph`` holds the device work of one call on fixed input tensors,
captured at its first replay and replayed after: one host call runs the
captured launches, with none of the wrappers' checks, argument lists,
output allocations or spans. The kernels, their order, their arguments
and their outputs are those of the eager call. A batch of the step
replays two:

- the back-half graph, K10 ``backhalf_planes`` from the coefficient
  planes to the crops, owned by the step (``StepGraphs``);
- the decode graph, ``_decode_batch`` from those crops to K13's packed
  BatchResult buffer (K1, K2, K3 and its cast, K4, K12, K13), owned by
  the decoder (``MeterDecoder.graph_crops``), which copies each replay's
  result into a fresh buffer, so that no result aliases the graph's
  memory.

The step writes the fallback slots it keeps into the crops between the
two replays, eagerly, as the eager step does.

Where a back-half graph reads its inputs (``StepGraphs.place``): inputs
already on the step's device are read where they lie, and their
addresses, shapes, strides and dtypes key the graph; this serves a
caller that uploads its feeds once and hands the same tensors again, as
the benchmark's resident cell hands its four. ``BOUND`` such graphs a
shape; a caller handing fresh device tensors each batch would otherwise
capture each batch. Inputs from the host, on another device or past the
bound are copied into the staging buffers of the shape's one staged
graph (host inputs through pinned memory, as ``upload`` sends them). A
graph keeps its input tensors alive, so that no other tensor takes their
addresses while the key holds them.

Each replay adds to the kernel wrappers' ``launches`` counters
(ops/launch.COUNTED) what its capture launched; the warm-up and the
capture add nothing. Counters (profiling.count): ``step_graph_captures``
and ``step_graph_replays`` (graphs), ``step_graph_staged`` (steps that
copied inputs already on the step's device into staging).
"""
from __future__ import annotations

import threading
from collections import defaultdict
from typing import Any, Callable, Dict, Sequence, Tuple

import torch

from ..ops.launch import COUNTED
from ..profiling import count

BOUND = 4   # back-half graphs a step shape on inputs read where they lie
_CAPTURE = threading.Lock()


def _launches() -> Dict[Any, int]:
    return {k: k.launches for k in COUNTED}


class Graph:
    """A CUDA graph of ``fn(*args)``: ``args`` are tensors on ``device``
    that the caller rewrites in place between replays. The first
    ``replay`` captures it: one eager warm-up on a side stream, then the
    capture in a private memory pool, under a process-wide lock; a
    capture that fails raises. ``replay`` returns what the captured call
    returned, in the graph's memory, which the next replay overwrites."""
    __slots__ = ("device", "fn", "args", "out", "_graph", "_launches")

    def __init__(self, device: torch.device, fn: Callable[..., Any],
                 args: Sequence[torch.Tensor]) -> None:
        self.device = device
        self.fn = fn
        self.args = tuple(args)
        self.out: Any = None
        self._graph: Any = None
        self._launches: Tuple[Tuple[Any, int], ...] = ()

    def _capture(self) -> None:
        with _CAPTURE, torch.cuda.device(self.device):
            before = _launches()
            try:
                side = torch.cuda.Stream(self.device)
                side.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(side):
                    self.fn(*self.args)
                start = _launches()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, stream=side,
                                      capture_error_mode="thread_local"):
                    self.out = self.fn(*self.args)
                self._launches = tuple(
                    (k, n - start.get(k, 0))
                    for k, n in _launches().items() if n != start.get(k, 0))
                torch.cuda.current_stream(self.device).wait_stream(side)
            finally:
                for k in COUNTED:
                    k.launches = before.get(k, 0)
        self._graph = graph
        count("step_graph_captures")

    def replay(self) -> Any:
        if self._graph is None:
            self._capture()
        self._graph.replay()
        for k, n in self._launches:
            k.launches += n
        count("step_graph_replays")
        return self.out


def _put(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy ``src`` into ``dst`` behind the work queued on ``dst``'s
    device; a host source goes through pinned memory, so that the host
    does not wait."""
    if dst.is_cuda and not src.is_cuda:
        src = src.pin_memory()
    dst.copy_(src, non_blocking=True)


def _where(ts: Sequence[torch.Tensor]) -> tuple:
    """Each tensor's address, shape, dtype and strides."""
    return tuple((t.data_ptr(), t.shape, t.dtype, t.stride()) for t in ts)


class StepGraphs:
    """The back-half graphs of one step on one device: ``place(inputs)``
    gives the Graph of ``tail(cy, cb, cr, qt, ok)`` that reads the step's
    inputs (tensors or numpy), as the module docstring says."""

    def __init__(self, device: torch.device,
                 tail: Callable[..., torch.Tensor]) -> None:
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device      # with its index: a tensor's device has one
        self._tail = tail
        self._in_place: Dict[tuple, Graph] = {}
        self._n_in_place: Dict[tuple, int] = defaultdict(int)
        self._staged: Dict[tuple, Graph] = {}

    def place(self, inputs: Sequence[Any]) -> Graph:
        if all(torch.is_tensor(a) and a.device == self.device
               for a in inputs):
            key = _where(inputs)
            g = self._in_place.get(key)
            if g is not None:
                return g
            shape = tuple((tuple(t.shape), t.dtype) for t in inputs)
            if self._n_in_place[shape] < BOUND:
                g = self._in_place[key] = Graph(self.device, self._tail,
                                                list(inputs))
                self._n_in_place[shape] += 1
                return g
        ts = [torch.as_tensor(a) for a in inputs]
        shape = tuple((tuple(t.shape), t.dtype) for t in ts)
        g = self._staged.get(shape)
        if g is None:
            g = self._staged[shape] = Graph(
                self.device, self._tail,
                [torch.empty(t.shape, dtype=t.dtype, device=self.device)
                 for t in ts])
        for b, t in zip(g.args, ts):
            _put(b, t)
        if any(t.device == self.device for t in ts):
            count("step_graph_staged")
        return g
