"""The collectives of the distribution layer, over ``torch.distributed`` —
the port of ``repro.distributed.compat``.

The reference's shim picks between two spellings of ``shard_map``; inside
it, ``sp.py`` and ``pp.py`` call ``jax.lax``'s collectives over a named
mesh axis.  Here a mesh axis is a process group
(``launch.mesh.Mesh.group``), and these functions are those collectives,
named after them: :func:`psum`, :func:`pmax`, :func:`all_gather`
(concatenating, as ``all_gather(..., tiled=True)``), :func:`reduce_scatter`
(``psum_scatter(..., tiled=True)``), :func:`ppermute` and
:func:`axis_index`.  Every collective of the port goes through this
module.  Each returns a new tensor and leaves its input as it was.

The backend: NCCL for CUDA, gloo for the CPU (:func:`init_distributed`).
NCCL refuses two ranks on one device (its duplicate-GPU check), so ranks
that share one card run on gloo.  Torch's gloo backend carries CUDA
tensors for ``all_reduce`` and ``broadcast`` (it copies them through the
host itself); for every other collective this module copies a CUDA
tensor to the host and back, and only when the group's backend is gloo
(:func:`host_staged`).  That is decided from the backend, never by
catching an error: on torch 2.11 gloo's point-to-point send of a CUDA
tensor fails in its transport (writev: Bad address), raising in one
run and aborting the process in another (``tools/dist_probe.py``).

``STATS`` counts, per collective, its calls, the bytes it moved (this
rank's input) and the seconds it took on the host's clock, each call
ended by the collective's own wait; :func:`reset_stats` sets them to 0.
A collective called with ``axis=`` is counted under ``"<axis>:<op>"``
(``distributed.tp`` passes ``"model"``), the others under the op's name.
Each is also counted by the mesh axes its group spans
(:meth:`CollectiveStats.by_axes`: ``"data,model:all_gather"``; a group
of ``launch.mesh.make_mesh_compat`` is described as ``"mesh:<axes>"``).
Inside :func:`counted_apart` a collective is counted in ``APART[name]``
as well: the recomputed forward of a checkpointed block
(``models.remat``, ``"recompute"``) and the gathers of weights (the
train step's, layer by layer, ``distributed.fsdp``; the serving steps'
working module, ``train.step.gather_working``: ``"working_gather"``)
are counted so.

``GATHERED`` counts the weights the train step gathers layer by layer
(``distributed.fsdp``): the leaves gathered, their bytes, the bytes of
gathered storage alive now and the most alive at once since the last
:func:`reset_stats` (which sets the first two to 0 and the high-water
mark to what is alive then).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
import threading
import time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["init_distributed", "psum", "pmax", "all_gather",
           "reduce_scatter", "ppermute", "axis_index", "host_staged", "STATS",
           "APART", "GATHERED", "reset_stats", "counted_apart",
           "CollectiveStats", "GatheredBytes"]

# the collectives torch's gloo backend takes CUDA tensors for
_GLOO_CUDA = ("all_reduce", "broadcast")


@dataclasses.dataclass
class CollectiveStats:
    """Per collective: calls, bytes of this rank's input, host seconds."""
    calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    bytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    # "<mesh axes>:<op>" -> [calls, bytes]
    axes: Dict[str, List[int]] = dataclasses.field(default_factory=dict)

    def add(self, op: str, nbytes: int, seconds: float,
            axes: Optional[str] = None) -> None:
        self.calls[op] = self.calls.get(op, 0) + 1
        self.bytes[op] = self.bytes.get(op, 0) + nbytes
        self.seconds[op] = self.seconds.get(op, 0.0) + seconds
        if axes is not None:
            tally = self.axes.setdefault(f"{axes}:{op.rpartition(':')[2]}",
                                         [0, 0])
            tally[0] += 1
            tally[1] += nbytes

    def as_dict(self) -> dict:
        return {op: dict(calls=self.calls[op], bytes=self.bytes[op],
                         seconds=self.seconds[op]) for op in self.calls}

    def by_axes(self) -> dict:
        """``{"<mesh axes>:<op>": {"calls", "bytes"}}``."""
        return {k: dict(calls=c, bytes=b) for k, (c, b) in self.axes.items()}

    def clear(self) -> None:
        for d in (self.calls, self.bytes, self.seconds, self.axes):
            d.clear()


class GatheredBytes:
    """The weights gathered layer by layer (module docstring): ``calls``
    (leaves gathered), ``bytes`` (their gathered bytes), ``alive`` (bytes
    of gathered storage not yet freed) and ``peak`` (the most alive at
    once).  Storage is freed in whatever thread drops it last (the
    autograd engine's, on CUDA), so the counts move under a lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self.calls = self.bytes = self.alive = self.peak = 0

    def gathered(self, t: torch.Tensor) -> None:
        """Count ``t``, a gathered weight, alive until its storage is
        freed."""
        storage = t.untyped_storage()
        nbytes = storage.nbytes()
        with self._lock:
            self.calls += 1
            self.bytes += nbytes
            self.alive += nbytes
            self.peak = max(self.peak, self.alive)
        weakref.finalize(storage, self._freed, nbytes)

    def _freed(self, nbytes: int) -> None:
        with self._lock:
            self.alive -= nbytes

    def as_dict(self) -> dict:
        with self._lock:
            return dict(calls=self.calls, bytes=self.bytes, alive=self.alive,
                        peak=self.peak)

    def clear(self) -> None:
        with self._lock:
            self.calls = self.bytes = 0
            self.peak = self.alive


STATS = CollectiveStats()
APART: Dict[str, CollectiveStats] = {}
GATHERED = GatheredBytes()
_APART: contextvars.ContextVar = contextvars.ContextVar("apart", default=())


def reset_stats() -> None:
    """Set every count of ``STATS`` to 0, empty ``APART`` and restart
    ``GATHERED``'s counts (module docstring)."""
    STATS.clear()
    APART.clear()
    GATHERED.clear()


@contextlib.contextmanager
def counted_apart(name: str):
    """Count the collectives called inside the block in ``APART[name]``
    too (``STATS`` counts them as ever)."""
    token = _APART.set(_APART.get() + (name,))
    try:
        yield
    finally:
        _APART.reset(token)


def init_distributed(device="cuda", backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None) -> str:
    """Initialise the default process group; returns its backend.

    ``backend`` defaults to NCCL for a CUDA ``device`` and gloo for the
    CPU.  ``init_method``, ``world_size`` and ``rank`` default to the
    environment's ``MASTER_ADDR`` / ``MASTER_PORT`` (``env://``),
    ``WORLD_SIZE`` and ``RANK``; nothing tells a program of a cluster, so
    a launcher passes them (``tcp://localhost:<port>``, ``file://<path>``).
    A CUDA device becomes this process's current device.
    """
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None \
        else world_size
    rank = int(os.environ["RANK"]) if rank is None else rank
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return backend


def host_staged(group, x: torch.Tensor, op: str) -> bool:
    """Whether ``op`` on ``x`` over ``group`` goes through a host copy:
    a CUDA tensor on a gloo group, for any collective but ``all_reduce``
    and ``broadcast``."""
    return (x.device.type == "cuda" and op not in _GLOO_CUDA
            and dist.get_backend(group) == "gloo")


def _mesh_axes(group) -> Optional[str]:
    """The mesh axes a group of ``make_mesh_compat`` spans (``"data"``,
    ``"data,model"``), from its description; None for another group."""
    desc = getattr(group, "group_desc", "") if group is not None else ""
    return desc[len("mesh:"):] if desc.startswith("mesh:") else None


@contextlib.contextmanager
def _timed(op: str, x: torch.Tensor, group, axis: Optional[str] = None):
    t = time.perf_counter()
    yield
    name = op if axis is None else f"{axis}:{op}"
    nbytes, seconds = x.numel() * x.element_size(), time.perf_counter() - t
    axes = _mesh_axes(group)
    STATS.add(name, nbytes, seconds, axes)
    for apart in _APART.get():
        APART.setdefault(apart, CollectiveStats()).add(name, nbytes, seconds,
                                                       axes)


def _all_reduce(x: torch.Tensor, group, op, axis) -> torch.Tensor:
    y = x.clone()
    with _timed("all_reduce", x, group, axis):
        dist.all_reduce(y, op=op, group=group)
    return y


def psum(x: torch.Tensor, group, axis: Optional[str] = None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (``jax.lax.psum``)."""
    return _all_reduce(x, group, dist.ReduceOp.SUM, axis)


def pmax(x: torch.Tensor, group, axis: Optional[str] = None) -> torch.Tensor:
    """The elementwise max of ``x`` over ``group`` (``jax.lax.pmax``)."""
    return _all_reduce(x, group, dist.ReduceOp.MAX, axis)


def all_gather(x: torch.Tensor, group, dim: int = 0,
               axis: Optional[str] = None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in the order of the
    ranks of ``group`` (``jax.lax.all_gather(..., tiled=True)``)."""
    staged = host_staged(group, x, "all_gather")
    with _timed("all_gather", x, group, axis):
        src = (x.detach().cpu() if staged else x.detach()).contiguous()
        parts = [torch.empty_like(src)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, src, group=group)
        out = torch.cat(parts, dim=dim)
        if staged:
            out = out.to(x.device)
    return out


# torch 2.13 renames reduce_scatter_tensor; older releases have only it
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def reduce_scatter(x: torch.Tensor, group, dim: int = 0,
                   axis: Optional[str] = None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, cut along ``dim`` into
    one equal block a rank, this rank's block (``jax.lax.psum_scatter(...,
    scatter_dimension=dim, tiled=True)``)."""
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    staged = host_staged(group, x, "reduce_scatter")
    with _timed("reduce_scatter", x, group, axis):
        src = (x.detach().cpu() if staged else x.detach()).movedim(
            dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
        _REDUCE_SCATTER(out, src, group=group)
        out = out.movedim(0, dim).contiguous()
        if staged:
            out = out.to(x.device)
    return out


def ppermute(x: torch.Tensor, group,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``jax.lax.ppermute``: for each ``(source, target)`` pair of ranks of
    ``group``, the target receives the source's ``x``; a rank that is no
    target receives zeros."""
    me = dist.get_rank(group)
    send = [t for s, t in perm if s == me]
    recv = [s for s, t in perm if t == me]
    if len(send) > 1 or len(recv) > 1:
        raise ValueError(f"perm {perm} is not a permutation")
    staged = host_staged(group, x, "ppermute")
    with _timed("ppermute", x, group):
        src = (x.detach().cpu() if staged else x.detach()).contiguous()
        out = torch.zeros_like(src)
        if send and send[0] == me:
            out.copy_(src)
        else:
            ops: List = []
            if send:
                ops.append(dist.P2POp(dist.isend, src, dist.get_global_rank(
                    group, send[0]), group))
            if recv:
                ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(
                    group, recv[0]), group))
            if ops:
                for work in dist.batch_isend_irecv(ops):
                    work.wait()
        if staged:
            out = out.to(x.device)
    return out


def axis_index(group) -> int:
    """This rank's index on the axis ``group`` spans
    (``jax.lax.axis_index``)."""
    return dist.get_rank(group)
