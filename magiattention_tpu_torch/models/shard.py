"""Sharded parameter trees: ZeRO-3 over the data (cp) line and Megatron
tensor parallelism, each placement a collective with its backward.

JAX places every leaf with a ``NamedSharding`` (``shard_params``,
``shard_moe_params``) and XLA inserts the all-gathers, the
reduce-scatters and the tensor-parallel all-reduces. In per-rank
processes each rank holds its own block of every sharded leaf, and the
forward gathers a leaf where it computes with it:

- A :class:`ShardSpec` names the mesh axes that split a leaf's dim 0
  (``rows``) and dim 1 (``cols``), slowest first: under ``rows=(A, B)``
  the rank at coordinates ``(a, b)`` holds row block ``a * |B| + b``
  (``ProcessMesh.index``). ``ep`` marks an expert-parallel block, which
  the compute uses as it is held.
- The tree keeps its family's ``Layout`` (the same keys in the same
  order, each leaf this rank's block) and carries a :class:`Sharding`
  under the key ``"sharding"`` beside ``"layers"``: the mesh, the data
  axis, the tensor-parallel axis, and the spec of each top-level key and
  of each layer key (every layer's leaves have the same shapes).
- :func:`gatherer` gives the forward the tensors it computes with, a
  leaf gathered at each access (inside a ``remat`` region, so the
  recompute gathers again). Over the data axis, whose ranks compute
  their own rows, the gather is ``comm.functional.all_gather``: its
  backward reduce-scatters, so a leaf's gradient arrives summed over the
  line and cut to this rank's block. Under Megatron TP (the tree's
  ``tp_axis`` is the runtime key's ``head_axis``) the column- and
  row-parallel leaves keep their tensor-parallel block; with any other
  key they are gathered over the tensor-parallel axis too, by
  ``gather_from_region`` (its ranks then compute alike, and each takes
  its own block of the gradient).
- :func:`gather_params` is the inverse of sharding: every leaf gathered
  back to the whole tensor, as ``np.asarray`` reads a sharded global
  array in JAX. Tests and checkpoints use it; the training path does not.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping

import torch
import torch.distributed as dist

from ..comm.functional import all_gather, gather_from_region

SHARDING = "sharding"
# Megatron's column-parallel (output dim over TP) and row-parallel (input
# dim over TP) projections
COLUMN = ("wq", "wk", "wv", "w_gate", "w_up")
ROW = ("wo", "w_down")


@dataclass(frozen=True)
class ShardSpec:
    """The mesh axes that split dim 0 (``rows``) and dim 1 (``cols``) of
    a leaf, slowest first; ``ep``: an expert-parallel block, used as held."""

    rows: tuple[str, ...] = ()
    cols: tuple[str, ...] = ()
    ep: bool = False

    @property
    def axes(self) -> tuple[str, ...]:
        return self.rows + self.cols


@dataclass(frozen=True)
class Sharding:
    """How a tree is sharded: the ``ProcessMesh``, the data axis whose
    ranks hold different rows, the tensor-parallel axis (or None), and
    the spec of each top-level key and of each layer key."""

    mesh: object
    dp_axis: str
    tp_axis: str | None
    top: Mapping[str, ShardSpec]
    layer: Mapping[str, ShardSpec]

    def specs(self, layout, n_layers: int) -> list[ShardSpec]:
        """The specs in ``layout.leaves`` order."""
        return [self.top[k] for k in layout.top] + [self.layer[k] for k in layout.layer] * n_layers

    def complete(self, layout, n_layers: int) -> list[bool]:
        """Per leaf in ``layout.leaves`` order: is its gradient complete
        on this rank (split over the data axis: a ZeRO-3 leaf, whose
        gather's backward summed it, or an expert block whose exchange
        brought every rank's part home) and so not to be summed again?"""
        return [self.dp_axis in s.axes for s in self.specs(layout, n_layers)]


def zero3_spec(shape, mesh, axis: str) -> ShardSpec:
    """JAX's ZeRO-3 rule: dim 0 over ``axis`` where the leaf has two dims
    or more and the axis divides it, else replicated."""
    ok = len(shape) >= 2 and shape[0] % mesh.shape[axis] == 0
    return ShardSpec((axis,) if ok else ())


def block_of(x: torch.Tensor, spec: ShardSpec, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` under ``spec``, a copy."""
    for dim, axes in ((0, spec.rows), (1, spec.cols)):
        if axes:
            n = mesh.count(axes)
            if x.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {axes}")
            size = x.shape[dim] // n
            x = x.narrow(dim, mesh.index(axes) * size, size)
    return x.clone(memory_format=torch.contiguous_format)


def shard_tree(params: dict, mesh, spec_of: Callable, dp_axis: str, tp_axis: str | None) -> dict:
    """``params`` (whole tensors) as this rank's blocks under
    ``spec_of(name, shape)``, a :class:`Sharding` under ``"sharding"``."""
    if SHARDING in params:
        raise ValueError("the tree is sharded already")
    top = {k: spec_of(k, tuple(x.shape)) for k, x in params.items() if k != "layers"}
    layer: dict[str, ShardSpec] = {}
    layers = []
    for lyr in params["layers"]:
        held = {}
        for k, x in lyr.items():
            spec = spec_of(k, tuple(x.shape))
            if layer.setdefault(k, spec) != spec:
                raise ValueError(f"layer leaf {k!r} is {layer[k]} in one layer, {spec} in another")
            held[k] = block_of(x, spec, mesh)
        layers.append(held)
    tree = {k: block_of(params[k], spec, mesh) for k, spec in top.items()}
    tree["layers"] = layers
    tree[SHARDING] = Sharding(mesh, dp_axis, tp_axis, top, layer)
    return tree


def _along(fn, x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``fn`` (a dim-0 gather) along ``dim`` (0 or 1)."""
    return fn(x, group) if dim == 0 else fn(x.transpose(0, 1), group).transpose(0, 1)


def _whole(x: torch.Tensor, spec: ShardSpec, mesh) -> torch.Tensor:
    """The whole tensor of the block ``x``, a new tensor (never the held
    leaf itself, which an optimizer updates in place)."""
    for dim, axes in ((0, spec.rows), (1, spec.cols)):
        for axis in reversed(axes):  # the fastest axis first
            x = _along(all_gather, x, mesh.group(axis), dim)
    return x.clone(memory_format=torch.contiguous_format)


def gather_leaves(leaves, params: dict, layout) -> list[torch.Tensor]:
    """The whole tensors of ``leaves`` (in ``layout.leaves`` order),
    sharded as ``params``' leaves are (e.g. its gradients); no autograd."""
    sharding = params.get(SHARDING)
    if sharding is None:
        return list(leaves)
    specs = sharding.specs(layout, len(params["layers"]))
    with torch.no_grad():
        return [_whole(x, s, sharding.mesh) for x, s in zip(leaves, specs)]


def gather_params(params: dict) -> dict:
    """The whole tree of a sharded ``params`` (every leaf gathered, or
    copied where it is replicated; the tree's own mesh), without its
    ``"sharding"`` entry; no autograd. An unsharded tree is returned as
    it is."""
    sharding = params.get(SHARDING)
    if sharding is None:
        return params
    mesh = sharding.mesh
    with torch.no_grad():
        tree = {k: _whole(params[k], s, mesh) for k, s in sharding.top.items()}
        tree["layers"] = [{k: _whole(x, sharding.layer[k], mesh) for k, x in lyr.items()}
                          for lyr in params["layers"]]
    return tree


class ParamView(Mapping):
    """The tensors a layer (or the top level) computes with: each held
    leaf gathered as :func:`gatherer` decided, at each access."""

    def __init__(self, held: dict, specs: Mapping[str, ShardSpec], use: "Gatherer") -> None:
        self._held, self._specs, self._use = held, specs, use

    def __getitem__(self, key: str) -> torch.Tensor:
        return self._use.tensor(self._held[key], self._specs[key], key)

    def __iter__(self):
        return iter(self._specs)

    def __len__(self) -> int:
        return len(self._specs)

    @property
    def tp_group(self):
        return self._use.tp_group


def tp_region(lyr) -> object:
    """The group a layer's Megatron leaves are split over (None: none)."""
    return lyr.tp_group if isinstance(lyr, ParamView) else None


class _Plain:
    """An unsharded tree: its tensors as they are."""

    def top(self, params):
        return params

    def layer(self, lyr):
        return lyr


class Gatherer:
    """The gathers of one forward of a sharded tree under ``attn_key``."""

    def __init__(self, sharding: Sharding, attn_key) -> None:
        mesh, dp = sharding.mesh, sharding.dp_axis
        if attn_key is not None:
            line = ([mesh.line(dp)[mesh.coord(dp)]] if attn_key.cp_group is None
                    else [int(r) for r in dist.get_process_group_ranks(attn_key.cp_group)])
            if mesh.line(dp) != line:
                raise ValueError(
                    f"the tree is sharded over {dp!r} (ranks {mesh.line(dp)}), the key's cp "
                    f"group holds ranks {line}: shard over the key's cp axis")
        self.sharding = sharding
        tp = sharding.tp_axis
        megatron = tp is not None and getattr(attn_key, "head_axis", None) == tp
        self.tp_group = mesh.group(tp) if megatron else None
        if megatron:
            for k, s in sharding.layer.items():
                if (k in COLUMN and s.cols != (tp,)) or (k in ROW and s.rows[:1] != (tp,)):
                    raise ValueError(
                        f"Megatron TP over {tp!r}: leaf {k!r} is {s}, not split over {tp!r} "
                        "(its width does not divide by the axis sizes)")

    def top(self, params: dict) -> ParamView:
        return ParamView(params, self.sharding.top, self)

    def layer(self, lyr: dict) -> ParamView:
        return ParamView(lyr, self.sharding.layer, self)

    def tensor(self, x: torch.Tensor, spec: ShardSpec, name: str) -> torch.Tensor:
        if spec.ep:
            return x
        sh = self.sharding
        keep = None  # the (dim, axis) of the tensor-parallel block the compute keeps
        if self.tp_group is not None and name in COLUMN + ROW:
            keep = (1 if name in COLUMN else 0, sh.tp_axis)
        for dim, axes in ((0, spec.rows), (1, spec.cols)):
            for axis in reversed(axes):
                if (dim, axis) == keep:
                    continue
                fn = all_gather if axis == sh.dp_axis else gather_from_region
                x = _along(fn, x, sh.mesh.group(axis), dim)
        return x


_PLAIN = _Plain()


def gatherer(params: dict, attn_key=None):
    """What the forward of ``params`` under ``attn_key`` computes with:
    ``.top(params)`` and ``.layer(lyr)``: the tensors as they are for an
    unsharded tree, else a :class:`ParamView` (:func:`tp_region` of a
    layer's view is the Megatron region's group, or None)."""
    sharding = params.get(SHARDING)
    return _PLAIN if sharding is None else Gatherer(sharding, attn_key)
