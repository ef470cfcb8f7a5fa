"""A process mesh over ``torch.distributed``: the port's counterpart of
``jax.sharding.Mesh`` as the CP baselines use it.

A mesh is an array of global ranks with one name per axis. Each process
finds its coordinate in it and, for every axis, the subgroup of the ranks
that differ from it only along that axis (its line). ``dist.new_group`` is
collective over the world: every process creates the subgroup of every
line of every axis, in the same order, including lines it is not on.

Collectives over a subgroup order their chunks by group rank, which
``new_group`` assigns in ascending global rank; the mesh therefore
requires the ranks to increase along every axis, so that group rank and
coordinate agree (every mesh :func:`..loongtrain.make_loongtrain_mesh`
builds does). A mesh of one rank needs no process group: it is the cp 1
case on one card.

Under ``P(axes)`` sharding of dim 0 the rows a process holds are shard
:meth:`ProcessMesh.index` of ``axes`` (row-major over the named axes, in
the order given); :func:`local_shard` cuts them from a global tensor.

A group over several axes (the flat cp group of a two-level ``cp_axis``)
is made at its first :meth:`ProcessMesh.group` call, again for every
line, so every process makes that call, in the same order: the key
entries of the API do, as they are collective.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def _this_rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class ProcessMesh:
    """Global ranks laid out over named axes, with this process's
    coordinate and the subgroup of each axis.

    Args:
        ranks: an array of global ranks, one dimension per axis; every
            rank at most once, increasing along every axis.
        axis_names: the axes' names, as ``jax.sharding.Mesh`` takes them.
    """

    def __init__(self, ranks, axis_names) -> None:
        ranks = np.asarray(ranks, dtype=np.int64)
        axis_names = tuple(axis_names)
        if ranks.ndim != len(axis_names):
            raise ValueError(f"ranks of shape {ranks.shape} for axes {axis_names}")
        if len(np.unique(ranks)) != ranks.size:
            raise ValueError(f"a rank appears twice in the mesh {ranks.tolist()}")
        if ranks.size > 1 and not dist.is_initialized():
            raise ValueError(f"a mesh of {ranks.size} ranks needs torch.distributed initialised")
        me = _this_rank()
        self.ranks = ranks
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, (int(n) for n in ranks.shape)))
        self._groups: dict[str, object] = {}
        self._lines: dict[str, list[int]] = {}
        for i, name in enumerate(axis_names):
            for line in np.moveaxis(ranks, i, -1).reshape(-1, ranks.shape[i]):
                if np.any(np.diff(line) <= 0):
                    raise ValueError(
                        f"ranks must increase along axis {name!r}, got {line.tolist()}"
                    )
                # collective: every process creates every line's group
                group = dist.new_group(line.tolist()) if line.size > 1 else None
                if me in line:
                    self._groups[name], self._lines[name] = group, line.tolist()
        where = np.argwhere(ranks == me)
        if len(where) != 1:  # after the groups: the others wait in new_group
            raise ValueError(f"rank {me} is not in the mesh {ranks.tolist()}")
        self.coords = dict(zip(axis_names, (int(c) for c in where[0])))

    @classmethod
    def of_group(cls, group, axis_name: str = "cp") -> "ProcessMesh":
        """A one-axis mesh over ``group``'s ranks (None: this process
        alone) whose line is ``group`` itself. It makes no group, so it
        is not collective: any process of the group may build it alone."""
        me = _this_rank()
        line = [me] if group is None else [int(r) for r in dist.get_process_group_ranks(group)]
        mesh = cls.__new__(cls)
        mesh.ranks = np.asarray(line, dtype=np.int64)
        mesh.axis_names = (axis_name,)
        mesh.shape = {axis_name: len(line)}
        mesh._groups = {axis_name: group}
        mesh._lines = {axis_name: line}
        mesh.coords = {axis_name: line.index(me)}
        return mesh

    def coord(self, axis: str) -> int:
        """This process's coordinate on ``axis``."""
        return self.coords[axis]

    def group(self, axis):
        """The subgroup of this process's line along ``axis`` (None when
        the axis has size 1: nothing to communicate). A tuple of axes
        names the line over all of them, the first slowest (made here at
        the first call, collectively)."""
        if isinstance(axis, tuple) and len(axis) == 1:
            axis = axis[0]
        if axis not in self._groups:
            self._make_line(axis)
        return self._groups[axis]

    def line(self, axis: str) -> list[int]:
        """The global ranks of this process's line along ``axis``, in
        coordinate order (equal to their group-rank order)."""
        return self._lines[axis]

    def _make_line(self, axes: tuple) -> None:
        """Create the group of every line over ``axes`` (collective) and
        keep this process's."""
        dims = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(self.ranks.ndim) if i not in dims]
        n = int(np.prod([self.ranks.shape[i] for i in dims]))
        me = _this_rank()
        for line in self.ranks.transpose(rest + dims).reshape(-1, n):
            if np.any(np.diff(line) <= 0):
                raise ValueError(f"ranks must increase along the axes {axes}, got {line.tolist()}")
            group = dist.new_group(line.tolist()) if line.size > 1 else None
            if me in line:
                self._groups[axes], self._lines[axes] = group, line.tolist()

    def index(self, axes) -> int:
        """This process's shard under ``P(axes)``: its coordinates over
        ``axes`` read row-major, the first axis slowest."""
        idx = 0
        for axis in axes:
            idx = idx * self.shape[axis] + self.coords[axis]
        return idx

    def count(self, axes) -> int:
        """The number of shards under ``P(axes)``."""
        return int(np.prod([self.shape[a] for a in axes], dtype=np.int64))


def local_shard(x: torch.Tensor, mesh: ProcessMesh, axes) -> torch.Tensor:
    """The rows of a global ``x`` this process holds under ``P(axes)``
    sharding of dim 0 (shard :meth:`ProcessMesh.index`)."""
    n = mesh.count(axes)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split into {n} shards")
    rows = x.shape[0] // n
    i = mesh.index(axes)
    return x[i * rows:(i + 1) * rows]
