"""A mesh of ranks: named axes laid row-major over the ranks of a gloo
world, the counterpart of the JAX package's ``launch/mesh.py`` meshes
(``jax.make_mesh`` lays axes over devices the same way).  A mesh built
inside a world holds one gloo subgroup for each slice along each axis;
``make_production_mesh`` is shape-only (16 x 16, or 2 x 16 x 16), for the
sharding specs.  ``launch/mesh.py`` starts the ranks and re-exports these
names; this module needs only ``torch.distributed``, so the models and the
spec rules can import it without the launcher or the tracing daemon.
"""
from __future__ import annotations

import math
from typing import Optional

import torch.distributed as dist


class Mesh:
    """Named axes over ``size`` ranks, row-major: rank r's coordinates are
    r's digits in the mixed radix of ``shape`` (the last axis fastest).
    ``shape`` maps each axis name to its size, in order, as a JAX mesh's
    does.  Shape-only until :meth:`connect`, which creates, in every rank
    and in one order, a gloo subgroup for each slice along each axis (a
    group's ranks in coordinate order, so its group rank is the rank's
    coordinate on that axis).  A connected mesh covers the first ``size``
    ranks of the world (``member``)."""

    def __init__(self, shape: tuple, axis_names: tuple):
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(
                axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))
        self.size = math.prod(self.shape.values())
        self._groups: Optional[dict] = None

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    def coords(self, rank: int) -> tuple:
        """``rank``'s coordinate on each axis, in axis order."""
        out = []
        for a in reversed(self.axis_names):
            rank, c = divmod(rank, self.shape[a])
            out.append(c)
        return tuple(reversed(out))

    def rank_of(self, coords) -> int:
        r = 0
        for a, c in zip(self.axis_names, coords):
            r = r * self.shape[a] + c
        return r

    def slice_ranks(self, axis: str, rank: int) -> list:
        """The ranks of ``rank``'s slice along ``axis``, in coordinate
        order."""
        i = self.axis_names.index(axis)
        c = list(self.coords(rank))
        out = []
        for k in range(self.shape[axis]):
            c[i] = k
            out.append(self.rank_of(c))
        return out

    def connect(self, timeout=None) -> "Mesh":
        """Create the axes' subgroups; every rank of the gloo world (whose
        size is the mesh's) calls this, with the same mesh, in the same
        order as its other ``dist.new_group`` calls.  The mesh covers the
        world's first ``size`` ranks; any others hold no subgroup.
        ``timeout`` (a ``datetime.timedelta``, the world's by default) ends
        a stalled collective of the subgroups."""
        if dist.get_world_size() < self.size:
            raise ValueError(f"{self} needs {self.size} ranks, the world has "
                             f"{dist.get_world_size()}")
        me = dist.get_rank()
        self._groups = {}
        for a in self.axis_names:
            seen = set()
            for r in range(self.size):
                ranks = tuple(self.slice_ranks(a, r))
                if ranks in seen:
                    continue
                seen.add(ranks)
                g = dist.new_group(list(ranks), backend="gloo",
                                   timeout=timeout)
                if me in ranks:
                    self._groups[a] = g
        return self

    @property
    def member(self) -> bool:
        """Whether this rank is one of the connected mesh's."""
        return self._groups is not None and dist.get_rank() < self.size

    def group(self, axis: str):
        """This rank's subgroup along ``axis``."""
        if self._groups is None:
            raise RuntimeError(f"{self} is shape-only: connect() it inside a "
                               f"world of {self.size} ranks")
        return self._groups[axis]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (``jax.lax.axis_index``)."""
        return self.coords(dist.get_rank())[self.axis_names.index(axis)]


def make_mesh(shape: tuple, axis_names: tuple, timeout=None) -> Mesh:
    """A mesh of ``shape``, connected when a gloo world is up (every rank
    calls it, and it covers the world's first ranks; ``timeout`` as in
    :meth:`Mesh.connect`), shape-only otherwise."""
    mesh = Mesh(shape, axis_names)
    return mesh.connect(timeout) if dist.is_initialized() else mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single pod (256 chips) or 2x16x16 two-pod (512 chips): the
    reference's production meshes, shape-only (no ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_test_mesh(data: int = 2, model: int = 2, pod: int = 0) -> Mesh:
    """A small mesh over the ranks of the gloo world (see ``make_mesh``)."""
    if pod:
        return make_mesh((pod, data, model), ("pod", "data", "model"))
    return make_mesh((data, model), ("data", "model"))


def dp_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)
