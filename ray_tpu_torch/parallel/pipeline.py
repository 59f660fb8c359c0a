"""Pipeline parallelism: GPipe microbatch pipeline over the `pp` mesh
axis with `ppermute` activation transfer (port of
ray_tpu/parallel/pipeline.py).

Stage parameters are stacked on a leading axis and sharded over `pp`;
activations move to the next stage with `ppermute`. Schedule: GPipe
fill-drain. With S stages and M microbatches it runs M + S - 1 ticks;
rank 0 feeds microbatch t at tick t, rank S-1 emits microbatch t at tick
t + S - 1, and the last stage's outputs reach every pp rank by a masked
`psum`. Autograd through the ticks gives the pipelined backward; every
rank builds the same graph (masks, not branches, pick what a rank keeps),
so every rank runs the backward's transfers in the same order.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..tree import tree_leaves, tree_map
from .mesh import (P, axis_index, axis_size, map_specs, mesh_sizes,
                   ppermute, psum, shard_map, validate_axis_names)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x: torch.Tensor, *,
                   num_microbatches: int,
                   axis_name: str = "pp") -> torch.Tensor:
    """Run a pipelined forward pass. Call INSIDE shard_map over `axis_name`.

    stage_fn(params_for_one_stage, activation[mb, ...]) -> activation.
    stage_params: this rank's stage parameters.
    x: the full local batch [batch, ...]; it is split into
    `num_microbatches` equal microbatches along axis 0. Every rank receives
    the same x (replicated over `axis_name`); only rank 0's copy is fed in.

    Returns [batch, ...] outputs of the LAST stage, valid on every rank.
    """
    pp = axis_size(axis_name)
    rank = axis_index(axis_name)
    m = num_microbatches
    if x.shape[0] % m != 0:
        raise ValueError(f"batch {x.shape[0]} not divisible by "
                         f"num_microbatches {m}")
    mb = x.shape[0] // m
    micro = x.reshape(m, mb, *x.shape[1:])

    first = torch.tensor(rank == 0, device=x.device)
    last = torch.tensor(rank == pp - 1, device=x.device)
    perm = [(i, (i + 1) % pp) for i in range(pp)]
    recv = torch.zeros_like(micro[0])
    outs = []
    for t in range(m + pp - 1):
        # ticks past M reuse the last microbatch; their results are
        # never kept
        feed = micro[min(t, m - 1)]
        out = stage_fn(stage_params, torch.where(first, feed, recv))
        if out.shape != feed.shape:
            raise ValueError(
                "pipeline_apply requires shape-preserving stages "
                f"(input {tuple(feed.shape)}, stage output "
                f"{tuple(out.shape)}); fold embed/unembed into the "
                "surrounding code")
        if t >= pp - 1:  # the last rank holds microbatch t - (pp - 1)
            outs.append(out)
        recv = ppermute(out, axis_name, perm)
    outbuf = torch.stack(outs)
    outbuf = psum(torch.where(last, outbuf, torch.zeros_like(outbuf)),
                  axis_name)
    return outbuf.reshape(m * mb, *outbuf.shape[2:])


def stack_stage_params(per_stage_params: Sequence[Any]) -> Any:
    """Stack a list of per-stage param trees on a new leading axis, ready
    to shard with P('pp', ...)."""
    leaves = [tree_leaves(p) for p in per_stage_params]
    it = iter(torch.stack(xs) for xs in zip(*leaves))
    return tree_map(lambda _: next(it), per_stage_params[0])


def make_pipeline_fn(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                     mesh: DeviceMesh, *, num_microbatches: int,
                     data_axes=("dp", "fsdp"),
                     param_spec: Optional[Any] = None,
                     axis_name: str = "pp") -> Callable:
    """Build fn(stacked_params, x) -> y shard_mapped over the mesh.

    stacked_params: tree with leading stage axis of size
    mesh_sizes(mesh)['pp'] (see stack_stage_params). x: global batch,
    split on `data_axes`. param_spec: optional spec tree for the NON-stage
    dims of the stacked params (e.g. tp shardings); the leading 'pp' axis
    is prepended. y: a DTensor laid out P(data_axes).
    """
    validate_axis_names(mesh, P(axis_name, tuple(data_axes)),
                        "pipeline axes")
    if param_spec is not None:
        validate_axis_names(mesh, param_spec, "pipeline param_spec")
    sizes = mesh_sizes(mesh)
    pp = sizes[axis_name]

    def full_param_spec(stacked_params):
        if param_spec is None:
            return tree_map(lambda _: P(axis_name), stacked_params)
        return map_specs(lambda s, _x, _p: P(axis_name, *s), param_spec,
                         stacked_params)

    def run(stacked_params, x):
        leading = {leaf.shape[0] if leaf.dim() else None
                   for leaf in tree_leaves(stacked_params)}
        if leading != {pp}:
            raise ValueError(
                f"stacked_params leading (stage) axis must be "
                f"mesh.shape['{axis_name}']={pp}, got "
                f"{sorted(leading, key=str)} — did you forget "
                f"stack_stage_params()?")
        # validate num_microbatches against the GLOBAL batch here, where
        # the message can name the global batch and the mesh axes
        data_sizes = {a: sizes[a] for a in data_axes}
        data_shards = 1
        for v in data_sizes.values():
            data_shards *= v
        global_batch = int(x.shape[0]) if x.dim() else 0
        if global_batch % data_shards != 0:
            raise ValueError(
                f"global batch {global_batch} not divisible by the "
                f"data-axis product {data_shards} (mesh axes "
                f"{data_sizes})")
        local_batch = global_batch // data_shards
        if local_batch % num_microbatches != 0:
            raise ValueError(
                f"num_microbatches={num_microbatches} does not divide "
                f"the per-shard batch {local_batch} (global batch "
                f"{global_batch} over data axes {data_sizes}); choose "
                f"num_microbatches dividing {local_batch}, e.g. by "
                f"sizing the global batch as a multiple of "
                f"{data_shards * num_microbatches}")
        xspec = P(tuple(data_axes))

        def inner(params, xloc):
            # the stage axis is 1 long locally: squeeze it
            params = tree_map(lambda a: a[0], params)
            return pipeline_apply(
                stage_fn, params, xloc, num_microbatches=num_microbatches,
                axis_name=axis_name)

        return shard_map(inner, mesh=mesh,
                         in_specs=(full_param_spec(stacked_params), xspec),
                         out_specs=xspec)(stacked_params, x)

    return run


__all__ = ["pipeline_apply", "stack_stage_params", "make_pipeline_fn"]
