"""The rank mesh: named axes over the ranks of a ``torch.distributed`` job.

Counterpart of :mod:`covo_mpc_tpu.parallel.mesh`. JAX lays its devices on
a named grid and ``shard_map`` runs one local function per device, whose
``lax.pmin`` / ``lax.psum`` reduce over a named axis. Here each rank is a
process driving one device; a :class:`Mesh` holds the grid's shape, this
rank's coordinates on it, the device, and one process group for each set
of axes (``dist.new_group``, made by every rank in the same order), and
:meth:`Mesh.axis` gives the bound axis whose :meth:`Axis.pmin`,
:meth:`Axis.psum` and :meth:`Axis.pmax` are ``dist.all_reduce`` with
``ReduceOp.MIN`` / ``SUM`` / ``MAX`` on that axis's group. The code every
rank runs on its own slice is the port of JAX's local function.

Rank r sits at JAX's grid position: the grid is ``reshape(scenarios,
samples)`` of the ranks (C order), so the sample groups are contiguous
ranks (the fast, adjacent links carry the solve's three collectives).

A mesh of one rank needs no process group: its collectives are the
identity, as a one-device ``shard_map``'s are. With a group up (a rank of
an NCCL job on one card, say) they are real all-reduces over that group,
whatever the axis size. A larger mesh raises unless a group of exactly its
size is up. An axis of size one inside a larger mesh reduces over itself
alone: the identity.

Gloo takes CUDA tensors (MIN, SUM, MAX and all_gather, each staged
through the host by gloo itself, the result back on the tensor's device),
so ranks that share one card run under it; its collectives run eagerly,
and a CUDA graph cannot hold them (``Mesh.capturable``). NCCL's can be
captured.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

SAMPLE_AXIS = "samples"
SCENARIO_AXIS = "scenarios"

_OPS = {"sum": "SUM", "min": "MIN", "max": "MAX"}
_LOCAL = "local"  # the group marker of a set of axes that spans one rank


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


class Axis:
    """A set of mesh axes bound to this rank: its size, this rank's index
    along it, and the collectives over its group (the port's counterpart of
    a named axis inside ``shard_map``)."""

    def __init__(self, mesh: "Mesh", names: Tuple[str, ...]):
        self.mesh, self.names = mesh, names
        self.size = math.prod(mesh.shape[n] for n in names)
        # row-major index over the axes, as lax.axis_index of a tuple
        self.index = 0
        for n in names:
            self.index = self.index * mesh.shape[n] + mesh.coords[n]
        self.group = mesh._group(names)

    def _reduce(self, x: torch.Tensor, op: str) -> torch.Tensor:
        if self.group is None:
            return x
        reduce_op = getattr(dist.ReduceOp, _OPS[op])
        group = None if self.group == dist.group.WORLD else self.group
        y = x.clone()
        dist.all_reduce(y, reduce_op, group=group)
        return y

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, "sum")

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, "min")

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, "max")

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` along this axis, concatenated on ``dim`` in the
        axis's index order (equal shapes on every rank)."""
        if self.group is None:
            return x
        group = None if self.group == dist.group.WORLD else self.group
        src = x.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=group)
        # the group lists its ranks in rank order; reorder by axis index
        order = self.mesh._axis_order(self.names)
        return torch.cat([parts[i] for i in order], dim=dim)


class Mesh:
    """A named grid of the job's ranks (see the module docstring).
    ``shape`` maps each axis to its size (in the grid's order),
    ``coords`` to this rank's index along it, ``device`` is this rank's
    device, ``capturable`` whether a CUDA graph can hold its collectives
    (not gloo's)."""

    def __init__(self, axis_names: Sequence[str], axis_sizes: Sequence[int],
                 device: Union[str, torch.device, None] = None):
        if len(axis_names) != len(axis_sizes) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axes {axis_names} / sizes {axis_sizes}")
        self.shape: Dict[str, int] = dict(zip(axis_names, map(int, axis_sizes)))
        self.size = math.prod(self.shape.values())
        up = _group_up()
        if up and dist.get_world_size() != self.size:
            raise ValueError(f"mesh {dict(self.shape)} has {self.size} ranks; the process "
                             f"group has {dist.get_world_size()}")
        if not up and self.size != 1:
            raise ValueError(f"mesh {dict(self.shape)} has {self.size} ranks: initialize "
                             "a process group of that size first "
                             "(parallel.initialize_distributed)")
        self.rank = dist.get_rank() if up else 0
        self.grid = np.arange(self.size).reshape(tuple(self.shape.values()))
        self.coords = dict(zip(self.shape, (int(c) for c in
                                             np.unravel_index(self.rank, self.grid.shape))))
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.backend = dist.get_backend() if up else None
        self.capturable = self.backend != "gloo"
        self._groups: dict = {}
        if up:
            # every rank makes every group, in one order (dist.new_group)
            names = tuple(self.shape)
            for k in range(1, len(names) + 1):
                for subset in itertools.combinations(names, k):
                    self._groups[subset] = self._make_group(subset)
        self._axes: dict = {}

    def _members(self, names: Tuple[str, ...], rank: int) -> list:
        """The ranks that share ``rank``'s coordinates off ``names``, in
        the order of their index along ``names``."""
        coords = np.unravel_index(rank, self.grid.shape)
        index = tuple(slice(None) if n in names else int(c)
                      for n, c in zip(self.shape, coords))
        sub = self.grid[index]
        # move the named axes into their given order, then flatten row-major
        kept = [n for n in self.shape if n in names]
        sub = np.transpose(sub, [kept.index(n) for n in names])
        return [int(r) for r in sub.reshape(-1)]

    def _make_group(self, names: Tuple[str, ...]):
        size = math.prod(self.shape[n] for n in names)
        if size == self.size:
            return dist.group.WORLD
        mine = None
        seen = set()
        for r in range(self.size):
            ranks = tuple(sorted(self._members(names, r)))
            if ranks in seen:
                continue
            seen.add(ranks)
            # a group of one reduces over itself alone; every rank still
            # makes the groups of more in the same order
            group = _LOCAL if len(ranks) == 1 else dist.new_group(list(ranks))
            if self.rank in ranks:
                mine = group
        return mine

    def _group(self, names: Tuple[str, ...]):
        """The group of ``names`` (None: the identity)."""
        if not _group_up():
            return None
        key = tuple(n for n in self.shape if n in names)
        group = self._groups[key]
        return None if group == _LOCAL else group

    def _axis_order(self, names: Tuple[str, ...]) -> list:
        """For each index along ``names``, the position of its rank in the
        group's rank-sorted list."""
        members = self._members(names, self.rank)
        ranked = sorted(members)
        return [ranked.index(r) for r in members]

    def axis(self, names: Union[str, Sequence[str]]) -> Axis:
        """The bound axis of one name or of a tuple of names."""
        names = (names,) if isinstance(names, str) else tuple(names)
        for n in names:
            if n not in self.shape:
                raise ValueError(f"mesh has no axis {n!r} (axes {tuple(self.shape)})")
        if names not in self._axes:
            self._axes[names] = Axis(self, names)
        return self._axes[names]

    def index(self, name: str) -> int:
        return self.coords[name]

    def shard(self, x, names: Union[str, Sequence[str]], dim: int = 0):
        """This rank's block of ``x`` along ``dim`` split evenly over the
        axis (JAX's ``PartitionSpec(axis)`` placement): a tensor, or a
        dataclass / dict / tuple of them (other leaves kept)."""
        from covo_mpc_tpu_torch.models.structs import tree_flatten, tree_unflatten

        ax = self.axis(names)

        def block(t):
            n = t.shape[dim]
            if n % ax.size:
                raise ValueError(f"{n} not divisible by the axis size {ax.size}")
            return t.narrow(dim, ax.index * (n // ax.size), n // ax.size)

        leaves, spec = tree_flatten(x)
        return tree_unflatten(spec, [block(t) for t in leaves])

    def gather(self, x, names: Union[str, Sequence[str]], dim: int = 0):
        """Assemble an output sharded over the axis: each rank's block
        concatenated on ``dim`` in axis order (a tensor, or a dataclass /
        dict / tuple of them), on every rank."""
        from covo_mpc_tpu_torch.models.structs import tree_flatten, tree_unflatten

        ax = self.axis(names)
        leaves, spec = tree_flatten(x)
        return tree_unflatten(spec, [ax.all_gather(t, dim) for t in leaves])

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, rank={self.rank}, coords={self.coords}, "
                f"device={self.device}, backend={self.backend})")


def make_mesh(samples: Optional[int] = None, scenarios: int = 1,
              device: Union[str, torch.device, None] = None) -> Mesh:
    """A (scenarios, samples) mesh over the job's ranks (JAX: make_mesh;
    ``samples`` defaults to the world size over ``scenarios``). The sample
    groups are contiguous ranks."""
    world = dist.get_world_size() if _group_up() else 1
    if samples is None:
        samples = world // scenarios
    if samples * scenarios != world:
        raise ValueError(f"mesh {samples}x{scenarios} != {world} ranks")
    return Mesh((SCENARIO_AXIS, SAMPLE_AXIS), (scenarios, samples), device)
