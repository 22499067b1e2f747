"""Multi-GPU and multi-process data parallelism: the batch split by rows
over a mesh of devices, one decoder replica a device.

Port of meterelf_tpu/parallel/mesh.py, function by function under the
same names. Per-image decode has no cross-image communication, so the
only parallel axis is the batch: each device decodes its rows with its
own MeterDecoder replica (the same kernels as one decoder: K1-K4 on the
quad branch, K10 or K11 in front of them on the coefficient feed), and
collectives carry only the aggregate metrics. As in the JAX package,
no model is sharded: there is none.

PyTorch idiom in place of jax.sharding: a ``DeviceMesh`` names this
process's devices in row order and the process group (the only global
state, ``torch.distributed``'s own). Process p of P owns global rows
[p*L, (p+1)*L) of a batch of P*L rows, and its local device d owns rows
[d*b, (d+1)*b) of that slice (b = L / local devices): the JAX global
mesh's row order when the devices are ordered by process. A process
decodes only its own slice, and no crop crosses a process boundary.

Multi-process deployment: every process runs the same program with
METERELF_DISTRIBUTED=1, METERELF_COORDINATOR (host:port of rank 0),
METERELF_NUM_PROCS and METERELF_PROC_ID; ``initialize_distributed()``
joins the group over TCP, NCCL for processes that decode on CUDA and
gloo for those on the CPU (``METERELF_DEVICE``), and ``make_mesh()``
then spans every process. Processes on one host choose their cards with
CUDA_VISIBLE_DEVICES or ``METERELF_DEVICE=cuda:i``. Meshes of two or
more cards have not been run: the port was verified on one H100 (a
one-device mesh, a one-rank NCCL group) and on the CPU (replicas of the
CPU device, a two-process gloo group).
"""
from __future__ import annotations

import atexit
import contextlib
import os
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.angles import tree_sum
from ..pipeline.decode import (BatchResult, MeterDecoder, make_coef_decode_fn,
                               to_host_later, upload)


class DeviceMesh(NamedTuple):
    """A 1-D mesh: this process's devices in row order, the process group
    (None for one process) and the mesh axis's name. ``size`` counts the
    devices of every process, as jax's ``Mesh.size`` does."""

    devices: Tuple[torch.device, ...]
    group: Any
    axis: str
    world: int    # processes
    rank: int     # this process's index

    @property
    def size(self) -> int:
        return self.world * len(self.devices)


class ShardedBatch(NamedTuple):
    """A process's slice of a batch, split by rows over its mesh devices
    (``shard_host_batch``). ``shape`` is the global batch's, as a
    globally sharded jax.Array's is."""

    shards: Tuple[torch.Tensor, ...]
    world: int

    @property
    def shape(self) -> Tuple[int, ...]:
        rows = sum(int(s.shape[0]) for s in self.shards)
        return (rows * self.world,) + tuple(self.shards[0].shape[1:])


class Aggregate(NamedTuple):
    """``aggregate_metrics``' (n_ok, n_err, mean value over ok)."""

    n_ok: Any
    n_err: Any
    mean: Any


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join the process group of a multi-process run; returns whether it
    was joined.

    A no-op returning False unless METERELF_DISTRIBUTED=1 or an explicit
    coordinator_address is given, so single-process runs never touch
    torch.distributed. The parameters default to METERELF_COORDINATOR
    (host:port of rank 0), METERELF_NUM_PROCS and METERELF_PROC_ID;
    nothing detects them otherwise. The backend follows the device the
    process decodes on (METERELF_DEVICE, default cuda): NCCL, with the
    communicator pinned to that card, or gloo for the CPU.
    The group is destroyed at exit (``shutdown_distributed``)."""
    from ..api import device_from_env

    if os.environ.get("METERELF_DISTRIBUTED") != "1" \
            and coordinator_address is None:
        return False
    if coordinator_address is None:
        coordinator_address = os.environ.get("METERELF_COORDINATOR")
    if num_processes is None and os.environ.get("METERELF_NUM_PROCS"):
        num_processes = int(os.environ["METERELF_NUM_PROCS"])
    if process_id is None and os.environ.get("METERELF_PROC_ID"):
        process_id = int(os.environ["METERELF_PROC_ID"])
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "initialize_distributed: set METERELF_COORDINATOR, "
            "METERELF_NUM_PROCS and METERELF_PROC_ID (or pass them)")
    dev = device_from_env()
    kwargs = {}
    if dev.type == "cuda":
        backend = "nccl"
        kwargs["device_id"] = _normal(dev)
        torch.cuda.set_device(kwargs["device_id"])
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, **kwargs)
    atexit.register(shutdown_distributed)
    return True


def shutdown_distributed() -> None:
    """Destroy the process group if one is up (NCCL warns of, or hangs
    on, a group left at exit)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(devices: Optional[Sequence] = None,
              axis: str = "data") -> DeviceMesh:
    """1-D mesh over this process's ``devices`` (default: every CUDA
    device) and, after ``initialize_distributed()``, every process.

    Without a card ``devices=None`` raises: nothing falls back to the
    CPU. A CPU mesh is asked for by name, e.g. ``["cpu"] * 4``: replicas
    on the one torch CPU device, standing in for the JAX package's
    virtual CPU devices."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh(): no CUDA device is available; pass devices= "
                "(e.g. ['cpu'] * 4) for a CPU mesh")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = tuple(_normal(torch.device(d)) for d in devices)
    if not devs:
        raise ValueError("make_mesh(): no devices")
    if dist.is_available() and dist.is_initialized():
        return DeviceMesh(devs, dist.group.WORLD, axis,
                          dist.get_world_size(), dist.get_rank())
    return DeviceMesh(devs, None, axis, 1, 0)


def shard_host_batch(local: Any, mesh: DeviceMesh,
                     axis: str = "data") -> ShardedBatch:
    """This process's slice of a batch (numpy or a tensor), split evenly
    over its mesh devices and put on each (pinned, non-blocking copies:
    pipeline/decode.upload)."""
    del axis
    n = len(mesh.devices)
    rows = int(local.shape[0])
    _check_divisible(rows * mesh.world, mesh)
    b = rows // n
    shards = []
    for i, d in enumerate(mesh.devices):
        with _on(d):
            shards.append(upload(local[i * b:(i + 1) * b], d))
    return ShardedBatch(tuple(shards), mesh.world)


class _DataParallel:
    """The function ``data_parallel_decoder`` returns; it keeps its last
    call's per-device results for ``MeshDecoder.aggregate``."""

    def __init__(self, decoder: MeterDecoder, mesh: DeviceMesh) -> None:
        self.mesh = mesh
        self.replicas = _replicas(decoder, mesh)
        self.last: Optional[Tuple[Any, List[BatchResult]]] = None

    def __call__(self, crops: Any, load_ok: Any = None) -> BatchResult:
        mesh = self.mesh
        if isinstance(crops, ShardedBatch):
            shards = crops.shards
            local_n = crops.shape[0] // mesh.world
        else:
            local_n = int(crops.shape[0])
            shards = shard_host_batch(crops, mesh).shards
        if load_ok is None:
            oks: Sequence[Any] = [None] * len(shards)
        elif isinstance(load_ok, ShardedBatch):
            oks = load_ok.shards
        else:
            if load_ok.shape[0] != local_n:
                raise AssertionError(
                    f"load_ok holds {load_ok.shape[0]} flags, expected the "
                    f"process-local batch of {local_n}")
            oks = shard_host_batch(load_ok, mesh).shards
        _check_divisible(local_n * mesh.world, mesh)
        parts = []
        for dec, x, ok in zip(self.replicas, shards, oks):
            with _on(dec.device):
                parts.append(dec.decode(x, ok))
        res = _gather(parts, mesh.devices[0])
        self.last = (res, parts)
        return res


def data_parallel_decoder(decoder: MeterDecoder, mesh: DeviceMesh,
                          axis: str = "data") -> _DataParallel:
    """A function decoding batches data-parallel over ``mesh``: one
    MeterDecoder replica a local device (the decoder's params, ``exact``
    and static arguments, its parameter arrays put on each device by
    params.to_device; the decoder itself where it is on that device),
    each shard dispatched on its own device without waiting for the
    card, and the results gathered in row order into one BatchResult on
    the mesh's first device (so a single event there orders the pull to
    the host after every shard).

    It takes this process's LOCAL slice of the batch as numpy or a
    tensor, or a ShardedBatch from ``shard_host_batch``; load_ok likewise
    (one flag a local row, None: all loaded). The global batch must be
    divisible by the mesh size."""
    del axis
    return _DataParallel(decoder, mesh)


class MeshDecoder:
    """Drop-in stream decoder running batches data-parallel over a mesh:
    ``__call__`` shards the batch over the mesh's devices, ``aggregate``
    reduces a batch's metrics across the mesh, and ``rescue_numpy`` hands
    the rare CCL-rescue decode to the replica on the first device, over
    host arrays (a slow path, not worth sharding)."""

    def __init__(self, decoder: MeterDecoder, mesh: DeviceMesh,
                 axis: str = "data") -> None:
        self.inner = decoder
        self.mesh = mesh
        self.axis = axis
        self._run = data_parallel_decoder(decoder, mesh, axis)

    def __call__(self, crops: Any, load_ok: Any = None) -> BatchResult:
        return self._run(crops, load_ok)

    def aggregate(self, res: BatchResult) -> Aggregate:
        """(n_ok, n_err, mean value over ok) of one batch's results,
        reduced on the devices and across processes (aggregate_metrics);
        per device when ``res`` is this decoder's last result."""
        return aggregate_metrics(*_shards_of(self._run.last, res),
                                 self.mesh, self.axis)

    def rescue_numpy(self, crops: Any, res: BatchResult) -> BatchResult:
        return self._run.replicas[0].rescue_numpy(
            np.asarray(crops), to_host_later(res)())


class MeshCoefStep:
    """The coefficient feed's step (pipeline/decode.make_coef_decode_fn)
    data-parallel over a mesh: the feed arrays cy, cb, cr, qt and ok are
    split by rows over the mesh's devices, and the small fallback payload
    (fb_packed, fb_idx: at most fb_slots rows) goes whole to the host
    slot choice of every shard's step.

    The port's step is bound to its decoder's device, so this class takes
    the decoder and the frame size and makes one step a replica, where
    the JAX package's takes a jitted step: ``MeshCoefStep(decoder,
    frame_wh, mesh)`` in place of ``MeshCoefStep(step, mesh)``. Its
    ``__call__(pa, cy, cb, cr, qt, ok, fb_packed, fb_idx)`` (pa is
    accepted and unused, as the step's) and ``aggregate`` are the JAX
    package's.

    Fallback slots index rows of the batch this process holds: a
    negative index counts from its end, slots outside it are dropped,
    and each kept slot goes to the shard owning its row, at the row's
    index there. On one process that is the global batch, as in JAX. The
    JAX package leaves undefined a replicated fb_idx that differs between
    processes; here each process's fb_idx indexes its own rows, which is
    what its own feed (io.jpeg.load_coef_feed) produced."""

    def __init__(self, decoder: MeterDecoder, frame_wh: Tuple[int, int],
                 mesh: DeviceMesh, axis: str = "data") -> None:
        self.mesh = mesh
        self.axis = axis
        self.replicas = _replicas(decoder, mesh)
        made = {}
        for r in self.replicas:
            if id(r) not in made:
                made[id(r)] = make_coef_decode_fn(r, frame_wh)
        self._steps = [made[id(r)][0] for r in self.replicas]
        self.last: Optional[Tuple[Any, List[BatchResult]]] = None

    def __call__(self, pa: Any, cy: Any, cb: Any, cr: Any, qt: Any, ok: Any,
                 fb_packed: Any, fb_idx: Any) -> BatchResult:
        del pa
        mesh = self.mesh
        n = len(mesh.devices)
        rows = int(cy.shape[0])
        _check_divisible(rows * mesh.world, mesh)
        b = rows // n
        idx = torch.as_tensor(fb_idx).cpu().to(torch.int64).numpy()
        idx = np.where(idx < 0, idx + rows, idx)
        owner = np.where((idx >= 0) & (idx < rows), idx // b, -1)
        parts = []
        for d, (step, r) in enumerate(zip(self._steps, self.replicas)):
            sl = slice(d * b, (d + 1) * b)
            # a slot of another shard gets row b: out of range, dropped
            local = np.where(owner == d, idx - d * b, b)
            with _on(r.device):
                parts.append(step(None, cy[sl], cb[sl], cr[sl], qt[sl],
                                  ok[sl], fb_packed, local))
        res = _gather(parts, mesh.devices[0])
        self.last = (res, parts)
        return res

    def aggregate(self, res: BatchResult) -> Aggregate:
        return aggregate_metrics(*_shards_of(self.last, res), self.mesh,
                                 self.axis)


def aggregate_metrics(values: Any, err: Any, mesh: DeviceMesh,
                      axis: str = "data") -> Aggregate:
    """(n_ok, n_err, mean value over ok) of a batch, reduced across the
    mesh; the mean is 0.0 when no row is ok.

    ``values`` and ``err`` are this process's rows (numpy or a tensor,
    split evenly over its mesh devices) or their per-device shards (a
    ShardedBatch, or a sequence of tensors). Each shard is summed on its
    device, its shard sums are then added in device order on the first
    device, and processes add theirs with one all_reduce(SUM) on the
    group: the JAX package's order of psums. A shard sums in XLA's CPU
    order (ops/angles.tree_sum), so on one process the mean has the JAX
    package's bits. Nothing waits for the card: the sums and the
    all_reduce (async_op=True; its wait() orders the current stream
    after it on NCCL) are queued and the three 0-d tensors come back on
    the first device. A gloo all_reduce on the CPU blocks."""
    del axis
    vs, es = _split(values, mesh), _split(err, mesh)
    first = vs[0].device
    acc = None
    for v, e in zip(vs, es):
        with _on(v.device):
            f = v.dtype if v.is_floating_point() else torch.float64
            ok = e == 0
            rows = torch.stack([torch.where(ok, v.to(f), 0.0), ok.to(f),
                                (~ok).to(f)])
            part = tree_sum(rows).to(first, non_blocking=True)
        acc = part if acc is None else acc + part
    if mesh.group is not None:
        dist.all_reduce(acc, group=mesh.group, async_op=True).wait()
    return Aggregate(acc[1].to(torch.int64), acc[2].to(torch.int64),
                     acc[0] / torch.clamp(acc[1], min=1.0))


def _normal(d: torch.device) -> torch.device:
    """A CUDA device with its index (the current device's when it has
    none), so that devices compare equal to a tensor's."""
    if d.type != "cuda" or d.index is not None:
        return d
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {d}: no CUDA device is available")
    return torch.device("cuda", torch.cuda.current_device())


def _on(d: torch.device):
    """The guard every launch needs: PyTorch's current device is ``d``
    (a launch on another device's stream fails)."""
    return (torch.cuda.device(d) if d.type == "cuda"
            else contextlib.nullcontext())


def _check_divisible(rows: int, mesh: DeviceMesh) -> None:
    if rows % mesh.size:
        raise AssertionError(
            f"batch {rows} not divisible by mesh size {mesh.size}")


def _replicas(decoder: MeterDecoder,
              mesh: DeviceMesh) -> List[MeterDecoder]:
    """One decoder a local mesh device, in mesh order; devices that
    repeat (CPU replicas) share one."""
    by_dev = {_normal(decoder.device): decoder}
    out = []
    for d in mesh.devices:
        if d not in by_dev:
            r = MeterDecoder(decoder.params, exact=decoder.exact, device=d)
            r.static_kwargs = dict(decoder.static_kwargs)
            by_dev[d] = r
        out.append(by_dev[d])
    return out


def _gather(parts: List[BatchResult], first: torch.device) -> BatchResult:
    """Per-device results -> one BatchResult on ``first``, in row order
    (copies between devices are ordered on their streams; the host does
    not wait)."""
    if len(parts) == 1:
        return parts[0]
    with _on(first):
        return BatchResult(*[
            torch.cat([p[i].to(first, non_blocking=True) for p in parts])
            for i in range(len(BatchResult._fields))])


def _shards_of(last: Any, res: Any) -> Tuple[Any, Any]:
    """(values, err) to reduce: the per-device results when ``res`` is
    the last gathered result, else res's own (split evenly)."""
    if last is not None and res is last[0]:
        parts = last[1]
        return [p.value for p in parts], [p.err for p in parts]
    return res.value, res.err


def _split(x: Any, mesh: DeviceMesh) -> List[torch.Tensor]:
    if isinstance(x, ShardedBatch):
        return list(x.shards)
    if isinstance(x, (list, tuple)):
        return [torch.as_tensor(s) for s in x]
    t = torch.as_tensor(x)
    n = len(mesh.devices)
    _check_divisible(int(t.shape[0]) * mesh.world, mesh)
    return list(t.split(int(t.shape[0]) // n))
