"""Device meshes over ``torch.distributed`` — the port of
``repro.launch.mesh``.

A :class:`Mesh` is a shape (axis names and sizes, ``mesh.shape``, as
JAX's) plus, optionally, live process groups.  The sharding rules
(``distributed.sharding``) read only ``mesh.shape``, so
:func:`make_production_mesh` returns a mesh with no groups: the rules can
be read for a 256- or 512-device production mesh without those devices.

:func:`make_mesh_compat` builds a live mesh over an initialised world
(``distributed.compat.init_distributed``): ranks map to coordinates in
row-major order (rank ``r`` of a ``(2, 4)`` ``("data", "model")`` mesh is
``(r // 4, r % 4)``), and every non-empty set of axes gets its process
groups, created on every rank in the same order (``torch.distributed``
requires it).  A group's rank order is the row-major order of its axes,
so a rank's index in the group of an axis tuple is its shard's index
along a dimension sharded over that tuple, as in a ``PartitionSpec``.
Each group is described as ``"mesh:<axes>"`` (``"mesh:data,model"``),
which ``distributed.compat`` counts its collectives by.
:func:`use_mesh` makes a mesh the current one (:func:`current_mesh`), the
mesh a call takes when it is given none.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

__all__ = ["Mesh", "make_production_mesh", "make_mesh_compat", "use_mesh",
           "current_mesh", "POD_SHAPE", "MULTIPOD_SHAPE"]

POD_SHAPE = (16, 16)                 # 256 chips (one v5e pod slice)
MULTIPOD_SHAPE = (2, 16, 16)         # 2 pods = 512 chips

_CURRENT: contextvars.ContextVar = contextvars.ContextVar("mesh",
                                                          default=None)


class Mesh:
    """Named axes over a row-major grid of ranks.

    ``shape`` maps each axis name to its size, in axis order.  A live mesh
    (:func:`make_mesh_compat`) also holds this rank's ``coords`` and one
    process group for each set of axes (:meth:`group`); ``device`` is the
    device its tensors live on.
    """

    def __init__(self, shape: Dict[str, int], groups=None, coords=None,
                 device=None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self._groups = groups
        self.coords = coords
        self.device = None if device is None else torch.device(device)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def live(self) -> bool:
        return self._groups is not None

    def _axes(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        order = [self.axis_names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"axes {axes} are not in the mesh's order "
                             f"{self.axis_names}")
        return axes

    def group(self, axes):
        """The process group over ``axes`` (a name or a tuple of names in
        the mesh's order) that holds this rank."""
        if not self.live:
            raise RuntimeError("this mesh has a shape and no process groups "
                               "(make_mesh_compat builds a live one)")
        return self._groups[self._axes(axes)]

    def index(self, axes) -> int:
        """This rank's row-major index over ``axes``: its shard's index
        along a dimension sharded over them."""
        i = 0
        for a in self._axes(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._axes(axes))

    def __repr__(self):
        return f"Mesh({self.shape}{', live' if self.live else ''})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh's shape (``POD_SHAPE`` or ``MULTIPOD_SHAPE``),
    with no process groups."""
    shape = MULTIPOD_SHAPE if multi_pod else POD_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(dict(zip(axes, shape)))


def make_mesh_compat(shape: Sequence[int], axes: Sequence[str],
                     device="cuda") -> Mesh:
    """A live mesh of ``shape`` over the initialised world, whose size must
    be ``prod(shape)``; called on every rank alike."""
    import torch.distributed as dist

    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} against axes {tuple(axes)}")
    world, rank = dist.get_world_size(), dist.get_rank()
    sizes = dict(zip(axes, shape))
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of {tuple(shape)} needs {math.prod(shape)} "
                         f"ranks, the world has {world}")
    coords = dict(zip(axes, _unravel(rank, shape)))
    groups = {}
    for n in range(1, len(axes) + 1):
        for sub in itertools.combinations(axes, n):
            rest = [a for a in axes if a not in sub]
            members = []
            for fixed in itertools.product(*(range(sizes[a]) for a in rest)):
                at = dict(zip(rest, fixed))
                members.append([_ravel({**at, **dict(zip(sub, v))}, axes,
                                       sizes)
                                for v in itertools.product(
                                    *(range(sizes[a]) for a in sub))])
            groups[sub], _ = dist.new_subgroups_by_enumeration(
                members, group_desc="mesh:" + ",".join(sub))
    return Mesh(sizes, groups=groups, coords=coords, device=device)


def _unravel(rank: int, shape: Sequence[int]):
    out = []
    for n in reversed(shape):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def _ravel(at: Dict[str, int], axes, sizes) -> int:
    r = 0
    for a in axes:
        r = r * sizes[a] + at[a]
    return r


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Make ``mesh`` the current mesh inside the ``with`` block."""
    token = _CURRENT.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.reset(token)


def current_mesh() -> Optional[Mesh]:
    """The mesh of the innermost :func:`use_mesh`, or None."""
    return _CURRENT.get()
