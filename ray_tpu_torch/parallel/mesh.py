"""Named-axis device meshes (port of ray_tpu/parallel/mesh.py).

Every parallelism strategy (dp/fsdp/pp/tp/sp/ep) is a named dimension of
one `torch.distributed.DeviceMesh` over the ranks of the default process
group; a partition spec `P` says which mesh axes split which tensor dim,
and `spec_placements` turns it into DTensor placements.

Layout of a dim split over several axes. `P(("tp", "fsdp"), None)` on a
mesh with axes (fsdp, tp) cuts the dim into fsdp x tp blocks. JAX orders
the blocks by the spec (tp major: the device at fsdp f, tp t holds block
t * fsdp + f); DTensor orders them by the mesh's dims (fsdp major: block
f * tp + t). The port keeps DTensor's order: a parameter is stored in
other blocks than JAX stores it on such a mesh, and gathers to the same
tensor. A dim split over one axis, and every batch split, is laid out as
in JAX.

`shard_map` runs a function on each rank's local blocks, with the axis
collectives below (`psum`, `all_gather`, `ppermute`, `all_to_all`)
inside it. Their gradients follow JAX's shard_map with `check_vma=False`:
`psum`'s backward is a `psum`, and the cotangent of an output that is
replicated over some axes is split evenly between its replicas, so
gradients through `shard_map` equal those of the same function on the
global arrays.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, fields
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..device import resolve_device
from ..tree import is_node, rebuild

# Canonical axis order: data-like axes outermost, model axes innermost.
MESH_AXES: Tuple[str, ...] = ("dp", "fsdp", "pp", "sp", "ep", "tp")


def solve_axis_sizes(vals: Dict[str, int], total: int,
                     unit: str) -> Dict[str, int]:
    """Solve the named-axis size map against `total` items: at most one
    axis may be -1 ("fill with the remainder"), the rest must be
    positive and their product must divide (fill) or equal (no fill)
    `total`. Shared by the mesh solve (MeshConfig.sizes, unit="device")
    and the DCN solve (HybridMeshConfig.dcn_sizes, unit="slice")."""
    vals = dict(vals)
    fill = [k for k, v in vals.items() if v == -1]
    if len(fill) > 1:
        raise ValueError(f"only one axis may be -1, got {fill}")
    fixed = 1
    for k, v in vals.items():
        if v != -1:
            if v <= 0:
                raise ValueError(f"axis {k} must be positive or -1, got {v}")
            fixed *= v
    if fill:
        if total % fixed != 0:
            raise ValueError(
                f"{total} {unit}s not divisible by fixed axes "
                f"product {fixed}")
        vals[fill[0]] = total // fixed
    elif fixed != total:
        raise ValueError(
            f"mesh axes product {fixed} != {unit} count {total}")
    return vals


@dataclass(frozen=True)
class MeshConfig:
    """Sizes for each named axis; -1 on exactly one axis means "fill with
    the remaining ranks"."""

    dp: int = -1
    fsdp: int = 1
    pp: int = 1
    sp: int = 1
    ep: int = 1
    tp: int = 1

    def sizes(self, n_devices: int) -> Dict[str, int]:
        # fields(MeshConfig), not fields(self): subclasses (HybridMeshConfig)
        # add DCN axes that must not leak into this solve.
        vals = {f.name: getattr(self, f.name) for f in fields(MeshConfig)}
        solved = solve_axis_sizes(vals, n_devices, "device")
        return {k: solved[k] for k in MESH_AXES}

    def build(self, ranks: Optional[Sequence[int]] = None,
              device: Any = "cuda") -> DeviceMesh:
        return make_mesh(self, ranks, device=device)


def mesh_rank_array(config: MeshConfig,
                    ranks: Sequence[int]) -> np.ndarray:
    """The ranks laid out in the mesh's shape, row-major: the order the
    JAX package gives devices that carry no topology (CPU devices)."""
    sizes = config.sizes(len(ranks))
    return np.asarray(ranks, dtype=np.int64).reshape(
        tuple(sizes[a] for a in MESH_AXES))


def make_mesh(config: Optional[MeshConfig] = None,
              ranks: Optional[Sequence[int]] = None,
              device: Any = "cuda", **axis_sizes: int) -> DeviceMesh:
    """A `DeviceMesh` with the canonical named axes over `ranks` (default:
    every rank of the default process group, which must exist).

    make_mesh(MeshConfig(dp=2, tp=4))  or  make_mesh(dp=2, tp=4).
    `device` "cuda" (the default) raises without CUDA; each rank's card
    is the current CUDA device.
    """
    if config is None:
        config = MeshConfig(**axis_sizes) if axis_sizes else MeshConfig()
    elif axis_sizes:
        raise ValueError("pass either a MeshConfig or axis kwargs, not both")
    if ranks is None:
        ranks = range(dist.get_world_size())
    return rank_mesh(mesh_rank_array(config, list(ranks)), device)


def rank_mesh(rank_array: np.ndarray, device: Any = "cuda") -> DeviceMesh:
    """A `DeviceMesh` named MESH_AXES over an explicit rank array."""
    dev = resolve_device(device)
    return DeviceMesh(dev.type, torch.as_tensor(np.asarray(rank_array)),
                      mesh_dim_names=MESH_AXES)


class P(tuple):
    """A partition spec: one entry per tensor dim, each None (not split),
    an axis name, or a tuple of axis names (split over their product).
    Trailing dims left out are not split. `P("fsdp", "tp")` is the port's
    `jax.sharding.PartitionSpec("fsdp", "tp")` and equals it as a tuple."""

    def __new__(cls, *entries: Any) -> "P":
        return super().__new__(cls, tuple(
            tuple(e) if isinstance(e, list) else e for e in entries))

    def __repr__(self) -> str:
        return "P" + (tuple.__repr__(self) if len(self) != 1
                      else f"({self[0]!r})")


def spec_axes(entry: Any) -> Tuple[str, ...]:
    """The axis names of one spec entry: None -> (), "tp" -> ("tp",)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def axis_names(mesh: Any) -> Tuple[str, ...]:
    """The axis names of a DeviceMesh (or of anything with .axis_names)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = getattr(mesh, "axis_names", ())
    return tuple(names or ())


def mesh_sizes(mesh: DeviceMesh) -> Dict[str, int]:
    """Axis name -> size."""
    return dict(zip(axis_names(mesh), mesh.mesh.shape))


def map_specs(fn: Callable[[Any, Any, str], Any], specs: Any, tree: Any,
              path: str = "") -> Any:
    """`tree`'s structure with fn(spec, leaf, path) at each leaf. `specs`
    matches `tree` down to a `P`, which then holds for every leaf below
    it (a prefix, as JAX takes a sharding tree); `path` names the leaf as
    `jax.tree_util.keystr` does, e.g. "['blocks'][0]['attn']['qkv']"."""
    if isinstance(specs, P) or specs is None:
        spec = P() if specs is None else specs
        if isinstance(tree, dict) and is_node(tree):
            return rebuild(tree, ((k, map_specs(fn, spec, v,
                                                f"{path}[{k!r}]"))
                                  for k, v in tree.items()))
        if is_node(tree):
            return rebuild(tree, [map_specs(fn, spec, v, f"{path}[{i}]")
                                  for i, v in enumerate(tree)])
        return fn(spec, tree, path)
    if isinstance(tree, dict) and isinstance(specs, dict):
        if set(tree) != set(specs):
            raise ValueError(
                f"spec tree at {path or 'the root'} has keys "
                f"{sorted(specs)}, the tree {sorted(tree)}")
        return rebuild(tree, ((k, map_specs(fn, specs[k], v,
                                            f"{path}[{k!r}]"))
                              for k, v in tree.items()))
    if isinstance(tree, (list, tuple)) and isinstance(specs, (list, tuple)) \
            and len(tree) == len(specs):
        return rebuild(tree, [map_specs(fn, s, v, f"{path}[{i}]")
                              for i, (s, v) in enumerate(zip(specs, tree))])
    raise ValueError(f"spec tree does not match the tree at "
                     f"{path or 'the root'}: {type(specs).__name__} "
                     f"against {type(tree).__name__}")


def _spec_leaves(specs: Any) -> Iterator[P]:
    if isinstance(specs, P):
        yield specs
    elif isinstance(specs, dict):
        for v in specs.values():
            yield from _spec_leaves(v)
    elif isinstance(specs, (list, tuple)):
        for v in specs:
            yield from _spec_leaves(v)


def validate_axis_names(mesh: Any, specs: Any, what: str = "spec") -> None:
    """Raise a clear ValueError when a spec (or a tree of specs) names an
    axis the mesh does not have."""
    names = axis_names(mesh)
    if not names:
        return
    known = set(names)
    for spec in _spec_leaves(specs):
        for entry in spec:
            for ax in spec_axes(entry):
                if ax not in known:
                    raise ValueError(
                        f"unknown mesh axis {ax!r} in {what} {spec}: "
                        f"this mesh has axes {names} (canonical "
                        f"MESH_AXES = {MESH_AXES})")


def spec_placements(mesh: DeviceMesh, spec: P) -> Tuple[Any, ...]:
    """DTensor placements of `spec` on `mesh`: Shard(d) on each mesh dim
    that splits tensor dim d, Replicate() on the others."""
    where: Dict[str, int] = {}
    for dim, entry in enumerate(spec):
        for ax in spec_axes(entry):
            if ax in where:
                raise ValueError(f"spec {spec} uses mesh axis {ax!r} on "
                                 f"dims {where[ax]} and {dim}")
            where[ax] = dim
    return tuple(Shard(where[a]) if a in where else Replicate()
                 for a in axis_names(mesh))


def named_sharding(mesh: DeviceMesh, *spec: Any) -> Tuple[Any, ...]:
    """named_sharding(mesh, 'dp', None): the placements of P('dp', None)
    on `mesh`, axis names validated up front."""
    pspec = P(*spec)
    validate_axis_names(mesh, pspec, "named_sharding spec")
    return spec_placements(mesh, pspec)


def host_local_array_to_global(mesh: DeviceMesh, spec: P,
                               local: torch.Tensor) -> DTensor:
    """This rank's block of a global array as a DTensor laid out by
    `spec` (every rank passes its own block)."""
    validate_axis_names(mesh, spec, "host_local_array_to_global spec")
    return DTensor.from_local(local, mesh, spec_placements(mesh, spec),
                              run_check=False)


# ------------------------------------------------------ axis collectives

_MESH: contextvars.ContextVar = contextvars.ContextVar("shard_map_mesh",
                                                       default=None)


@contextlib.contextmanager
def axis_env(mesh: DeviceMesh):
    """Make `mesh` the one the axis collectives name axes of (shard_map
    enters it around its function)."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def _mesh(mesh: Optional[DeviceMesh]) -> DeviceMesh:
    mesh = mesh if mesh is not None else _MESH.get()
    if mesh is None:
        raise RuntimeError("axis collectives run inside shard_map (or "
                           "pass mesh=)")
    return mesh


def _dim(mesh: DeviceMesh, axis_name: str) -> int:
    names = axis_names(mesh)
    if axis_name not in names:
        raise ValueError(f"unknown mesh axis {axis_name!r}: this mesh has "
                         f"axes {names}")
    return names.index(axis_name)


def axis_size(axis_name: str, mesh: Optional[DeviceMesh] = None) -> int:
    """The number of ranks along `axis_name`."""
    mesh = _mesh(mesh)
    return int(mesh.mesh.shape[_dim(mesh, axis_name)])


def axis_index(axis_name: str, mesh: Optional[DeviceMesh] = None) -> int:
    """This rank's coordinate along `axis_name`."""
    mesh = _mesh(mesh)
    return int(mesh.get_coordinate()[_dim(mesh, axis_name)])


def _axis_ranks(mesh: DeviceMesh, axis_name: str) -> list:
    """Global ranks of this rank's line along `axis_name`, by coordinate."""
    dim = _dim(mesh, axis_name)
    coord = list(mesh.get_coordinate())
    ranks = []
    for j in range(int(mesh.mesh.shape[dim])):
        coord[dim] = j
        ranks.append(int(mesh.mesh[tuple(coord)]))
    return ranks


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    """Stacks each rank's x along a new dim 0, in axis-coordinate order."""

    @staticmethod
    def forward(ctx, x, group, order, index):
        ctx.group, ctx.index = group, index
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in order]
        dist.all_gather(parts, x, group=group)
        # all_gather fills parts by group rank (the sorted global ranks)
        by_rank = dict(zip(sorted(order), parts))
        return torch.stack([by_rank[r] for r in order])

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.index], None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, send_to, recv_from):
        ctx.group, ctx.send_to, ctx.recv_from = group, send_to, recv_from
        return _exchange(x, group, send_to, recv_from)

    @staticmethod
    def backward(ctx, g):
        return (_exchange(g, ctx.group, ctx.recv_from, ctx.send_to),
                None, None, None)


class _AllToAll(torch.autograd.Function):
    """Chunk j of x (cut on `split_axis`) to axis coordinate j; what each
    coordinate sent, joined on `concat_axis` in coordinate order. The
    backward is the inverse exchange, split and concat swapped."""

    @staticmethod
    def forward(ctx, x, group, order, split_axis, concat_axis, tiled):
        ctx.args = group, order, split_axis, concat_axis, tiled
        return _all_to_all(x, group, order, split_axis, concat_axis, tiled)

    @staticmethod
    def backward(ctx, g):
        group, order, split_axis, concat_axis, tiled = ctx.args
        return (_all_to_all(g, group, order, concat_axis, split_axis, tiled),
                None, None, None, None, None)


def _all_to_all(x: torch.Tensor, group, order: list, split_axis: int,
                concat_axis: int, tiled: bool) -> torch.Tensor:
    n = len(order)
    parts = x.chunk(n, split_axis) if tiled else x.unbind(split_axis)
    coord = {r: j for j, r in enumerate(order)}
    # the list form exchanges by group rank (the sorted global ranks)
    by_rank = sorted(order)
    send = [parts[coord[r]].contiguous() for r in by_rank]
    recv = [torch.empty_like(t) for t in send]
    dist.all_to_all(recv, send, group=group)
    got = dict(zip(by_rank, recv))
    joined = [got[r] for r in order]
    return torch.cat(joined, concat_axis) if tiled \
        else torch.stack(joined, concat_axis)


def _exchange(x: torch.Tensor, group, send_to: Optional[int],
              recv_from: Optional[int]) -> torch.Tensor:
    """Send x to global rank `send_to`, return what `recv_from` sent
    (zeros when nothing is received, as JAX's ppermute gives)."""
    x = x.contiguous()
    out = torch.zeros_like(x)
    me = dist.get_rank()
    ops = []
    if send_to is not None and send_to != me:
        ops.append(dist.P2POp(dist.isend, x, send_to, group))
    if recv_from is not None:
        if recv_from == me:
            out.copy_(x)
        else:
            ops.append(dist.P2POp(dist.irecv, out, recv_from, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def _as_names(axis_name: Any) -> Tuple[str, ...]:
    return tuple(axis_name) if isinstance(axis_name, (tuple, list)) \
        else (axis_name,)


def psum(x: torch.Tensor, axis_name: Any,
         mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """Sum of x over the ranks along `axis_name` (a name or a tuple of
    names); differentiable, its backward a psum of the cotangent."""
    mesh = _mesh(mesh)
    for name in _as_names(axis_name):
        if axis_size(name, mesh) > 1:
            x = _AllReduce.apply(x, mesh.get_group(name))
    return x


def all_gather(x: torch.Tensor, axis_name: str, *, axis: int = 0,
               tiled: bool = False,
               mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """Every rank's x along `axis_name`, stacked on a new dim `axis` in
    coordinate order (concatenated on dim `axis` with tiled=True)."""
    mesh = _mesh(mesh)
    order = _axis_ranks(mesh, axis_name)
    if len(order) == 1:
        y = x.unsqueeze(0)
    else:
        y = _AllGather.apply(x, mesh.get_group(axis_name), order,
                             axis_index(axis_name, mesh))
    y = torch.movedim(y, 0, axis)
    if tiled:
        y = y.flatten(axis, axis + 1)
    return y


def ppermute(x: torch.Tensor, axis_name: str, perm: Sequence[Tuple[int, int]],
             mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """JAX's ppermute: each (src, dst) pair of axis coordinates sends the
    src rank's x to the dst rank; a rank no pair sends to gets zeros.
    Differentiable (the backward sends the cotangent back)."""
    mesh = _mesh(mesh)
    ranks = _axis_ranks(mesh, axis_name)
    me = axis_index(axis_name, mesh)
    dsts = [d for s, d in perm if s == me]
    srcs = [s for s, d in perm if d == me]
    if len(dsts) > 1 or len(srcs) > 1:
        raise ValueError(f"perm {list(perm)} is not a permutation")
    send_to = ranks[dsts[0]] if dsts else None
    recv_from = ranks[srcs[0]] if srcs else None
    group = mesh.get_group(axis_name) if len(ranks) > 1 else None
    return _PPermute.apply(x, group, send_to, recv_from)


def all_to_all(x: torch.Tensor, axis_name: str, *, split_axis: int,
               concat_axis: int, tiled: bool = False,
               mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """`jax.lax.all_to_all`: x is cut on `split_axis` into one chunk per
    rank along `axis_name`, chunk j goes to axis coordinate j, and the
    chunks this rank receives are joined on `concat_axis` in coordinate
    order. tiled=False: x.shape[split_axis] must equal the axis size,
    each chunk is one slice of that dim (the dim goes), and the received
    slices stack on a new dim at `concat_axis`. tiled=True: the dim is
    cut into axis-size equal blocks, concatenated on `concat_axis`.
    Differentiable (the backward is the inverse exchange)."""
    mesh = _mesh(mesh)
    order = _axis_ranks(mesh, axis_name)
    n = len(order)
    size = x.shape[split_axis]
    if (size % n) if tiled else (size != n):
        raise ValueError(
            f"all_to_all over {axis_name!r} of size {n}: split dim "
            f"{split_axis} has size {size}, which must "
            f"{'be a multiple of' if tiled else 'equal'} the axis size")
    if n == 1:
        return x if tiled else torch.movedim(x, split_axis, concat_axis)
    return _AllToAll.apply(x, mesh.get_group(axis_name), order, split_axis,
                           concat_axis, tiled)


# ------------------------------------------------------------ row splits

@dataclass(frozen=True)
class RowSplit:
    """A global batch cut on its rows (dim 0) over `axes` of `mesh`, in
    the axes' order (the first axis major), as JAX lays a batch out on a
    data spec: this rank holds block `block` of `blocks`. The mesh
    TrainStep runs its loss under one (`split_rows`). A loss that is a
    mean over rows needs nothing of it; a function of the whole batch
    (MoE routing: each expert's capacity and queue, the balancing loss)
    gathers the rows with `gather` and takes its own back with `own`."""

    mesh: DeviceMesh
    axes: Tuple[str, ...]

    @property
    def blocks(self) -> int:
        return int(np.prod([axis_size(a, self.mesh) for a in self.axes]))

    @property
    def block(self) -> int:
        i = 0
        for a in self.axes:
            i = i * axis_size(a, self.mesh) + axis_index(a, self.mesh)
        return i

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every block's rows of x, in block order; differentiable (each
        block's cotangent is summed over the ranks)."""
        for a in reversed(self.axes):
            x = all_gather(x, a, axis=0, tiled=True, mesh=self.mesh)
        return x

    def own(self, y: torch.Tensor) -> torch.Tensor:
        """This rank's block of the rows of a gathered y."""
        n = y.shape[0] // self.blocks
        return y[self.block * n:(self.block + 1) * n]


_ROWS: contextvars.ContextVar = contextvars.ContextVar("row_split",
                                                       default=None)


@contextlib.contextmanager
def split_rows(split: Optional[RowSplit]):
    """Run the code inside on this rank's block of `split`'s rows."""
    token = _ROWS.set(split)
    try:
        yield split
    finally:
        _ROWS.reset(token)


def row_split() -> Optional[RowSplit]:
    """The row split the running code's batch has (inside a mesh
    TrainStep's loss), or None: the batch is whole."""
    return _ROWS.get()


# -------------------------------------------------------------- shard_map

class _SplitCotangent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def _local_block(mesh: DeviceMesh, spec: P, x: Any) -> Any:
    if not isinstance(x, torch.Tensor):
        return x
    placements = spec_placements(mesh, spec)
    if not isinstance(x, DTensor):
        # a plain tensor is the global array, the same on every rank
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    x = x.redistribute(mesh, placements)
    # the blocks' cotangents on replicated axes are partial sums
    return x.to_local(grad_placements=[
        Partial() if isinstance(p, Replicate) else p for p in placements])


def _global(mesh: DeviceMesh, spec: P, y: Any) -> Any:
    if not isinstance(y, torch.Tensor):
        return y
    placements = spec_placements(mesh, spec)
    copies = 1
    for size, p in zip(mesh.mesh.shape, placements):
        if isinstance(p, Replicate):
            copies *= int(size)
    if copies > 1 and y.requires_grad:
        y = _SplitCotangent.apply(y, copies)
    return DTensor.from_local(y, mesh, placements, run_check=False)


def shard_map(f: Callable, *, mesh: DeviceMesh, in_specs: Any,
              out_specs: Any) -> Callable:
    """fn(*args) running f on each rank's blocks of args, laid out by
    `in_specs` (one spec tree per argument; a DTensor is redistributed to
    it, a plain tensor is the global array), with the axis collectives
    naming `mesh`'s axes; f's outputs are this rank's blocks of DTensors
    laid out by `out_specs`. Spec axis names are validated up front."""
    validate_axis_names(mesh, in_specs, "shard_map in_specs")
    validate_axis_names(mesh, out_specs, "shard_map out_specs")
    if isinstance(in_specs, P):
        in_specs = (in_specs,)

    def run(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"{len(args)} arguments for "
                             f"{len(in_specs)} in_specs")
        local = [map_specs(lambda s, x, _: _local_block(mesh, s, x), s, a)
                 for s, a in zip(in_specs, args)]
        with axis_env(mesh):
            out = f(*local)
        return map_specs(lambda s, y, _: _global(mesh, s, y), out_specs,
                         out)

    return run


__all__ = ["MESH_AXES", "MeshConfig", "P", "RowSplit", "all_gather",
           "all_to_all", "axis_index", "axis_size",
           "host_local_array_to_global", "make_mesh", "map_specs",
           "mesh_rank_array", "mesh_sizes", "named_sharding", "ppermute",
           "psum", "row_split", "shard_map", "solve_axis_sizes",
           "spec_placements", "split_rows", "validate_axis_names"]
