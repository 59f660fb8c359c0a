"""What each rank of a CPU gang runs to check sharded checkpoints.

    results = parallel.gang.run_gang(train.gang_checks.run_checks, 4,
                                     args=(inputs,))

`run_checks(rank, world, inputs)` runs every check named in `inputs`
(numpy arrays, configs and directories in; numpy arrays and flags out)
on one rank of a gloo gang and returns {name: result}; a check that
raises returns {"error": traceback}. The caller holds the results
against the JAX package. The checks live in the package because each
rank imports the module of the function it runs, and the tests import
JAX.

Checks: `reshard` (GPT-2 tiny's parameters laid out by its partition
specs, a bf16 copy of `wte` and a step, saved on each source mesh and
restored onto each target mesh and into plain tensors), `jax_ckpt` (a
checkpoint the JAX package wrote restored onto gang meshes) and `train`
(the mesh TrainStep saved after some steps on one mesh, restored onto
another, continued).
"""
from __future__ import annotations

import os
import traceback
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from ..models.convert import from_jax_params
from ..models.gpt2 import gpt2_loss, gpt2_partition_specs
from ..parallel.mesh import (MeshConfig, P, make_mesh, map_specs,
                             spec_placements)
from ..tree import tree_flatten, tree_map
from .async_checkpoint import async_save, restore
from .checkpoint import host_array

WTE_BF16_SPEC = P(("tp", "fsdp"), None)


def _bits(t: torch.Tensor) -> np.ndarray:
    """A plain tensor's values on a copy, bf16 as its raw 16-bit patterns
    (uint16)."""
    a = host_array(t.detach().cpu())
    return a.view(np.uint16) if a.dtype.kind == "V" else a.copy()


def _state(mesh, cfg, params: Any, fill=None) -> Dict[str, Any]:
    """GPT-2 params as DTensors laid out by the model's specs on `mesh`,
    a bf16 `wte` split over (tp, fsdp), and a step (zeros and 0 with
    `fill`)."""
    params = from_jax_params(params, device="cpu")
    if fill is not None:
        params = tree_map(torch.zeros_like, params)
    dist_params = map_specs(lambda spec, p, _: distribute_tensor(
        p, mesh, spec_placements(mesh, spec)), gpt2_partition_specs(cfg),
        params)
    wte16 = distribute_tensor(params["wte"].to(torch.bfloat16), mesh,
                              spec_placements(mesh, WTE_BF16_SPEC))
    return {"params": dist_params, "wte_bf16": wte16,
            "step": 0 if fill is not None else 3}


def _full_bits(tree: Any) -> list:
    """Every leaf in JAX's order, whole: DTensors gathered (a collective),
    numbers as numpy."""
    out = []
    for x in tree_flatten(tree)[0]:
        if isinstance(x, DTensor):
            x = x.full_tensor()
        out.append(_bits(x) if isinstance(x, torch.Tensor)
                   else np.asarray(x))
    return out


def _layout(tree: Any) -> list:
    return [(tuple(x.placements), tuple(x.to_local().shape))
            for x in tree_flatten(tree)[0] if isinstance(x, DTensor)]


def check_reshard(rank: int, world: int, inp: Dict[str, Any]) -> Dict:
    """For each source mesh: save the state, then restore it onto each
    target mesh (gathered back whole, and whether each DTensor has its
    template's placements and local shape) and, on rank 0, into plain
    tensors and with no template."""
    cfg, params = inp["config"], inp["params"]
    out: Dict[str, Any] = {}
    for src, src_axes in inp["src"].items():
        mesh = make_mesh(MeshConfig(**src_axes), device="cpu")
        d = os.path.join(inp["dir"], src)
        async_save(d, _state(mesh, cfg, params)).wait()
        dist.barrier()  # every rank's blocks committed
        for dst, dst_axes in inp["dst"].items():
            mesh_b = make_mesh(MeshConfig(**dst_axes), device="cpu")
            like = _state(mesh_b, cfg, params, fill=0)
            got = restore(d, like=like)
            out[f"{src}->{dst}"] = {"leaves": _full_bits(got),
                                    "layout": _layout(got) == _layout(like)}
        if rank == 0:  # no collective here: the others wait at the barrier
            zeros = tree_map(torch.zeros_like,
                             from_jax_params(params, device="cpu"))
            plain = {"params": zeros, "step": 0,
                     "wte_bf16": zeros["wte"].to(torch.bfloat16)}
            out[f"{src}->world1"] = {
                "leaves": _full_bits(restore(d, like=plain)),
                "whole": _full_bits(restore(d)), "layout": True}
        dist.barrier()
    return out


def check_jax_ckpt(rank: int, world: int, inp: Dict[str, Any]) -> Dict:
    """A checkpoint the JAX package wrote (GPT-2 params by its specs, its
    own block order for `wte`) restored onto each gang mesh."""
    out = {}
    for dst, axes in inp["dst"].items():
        mesh = make_mesh(MeshConfig(**axes), device="cpu")
        like = _state(mesh, inp["config"], inp["params"], fill=0)["params"]
        out[dst] = _full_bits(restore(inp["dir"], like=like))
    return out


def check_train(rank: int, world: int, inp: Dict[str, Any]) -> Dict:
    """The mesh TrainStep + adamw: `inp["steps"][0]` steps on mesh A,
    async_save of the whole state, restore onto mesh B with a fresh
    state of its TrainStep as the template, `inp["steps"][1]` more
    steps. Every loss, the restored step and count, and rank 0's
    gathered final params and first moments."""
    from .optim import adamw
    from .step import TrainStep

    cfg = inp["config"]
    batches = [tree_map(torch.from_numpy, b) for b in inp["batches"]]
    n_a, _ = inp["steps"]

    def make(axes):
        mesh = make_mesh(MeshConfig(**axes), device="cpu")
        step = TrainStep(lambda p, b: gpt2_loss(p, b["tokens"],
                                                b["targets"], cfg),
                         adamw(inp["lr"]), device="cpu", mesh=mesh,
                         param_specs=gpt2_partition_specs(cfg))
        return step, step.init_state(from_jax_params(inp["params"],
                                                     device="cpu"))

    step, state = make(inp["mesh_a"])
    losses = []
    for b in batches[:n_a]:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    async_save(inp["dir"], state).wait()
    dist.barrier()
    step, like = make(inp["mesh_b"])
    state = restore(inp["dir"], like=like)
    restored = (int(state["step"]), int(state["opt_state"]["count"]),
                _layout(state) == _layout(like))
    for b in batches[n_a:]:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    full_p = tree_map(lambda p: _bits(p.full_tensor()), state["params"])
    full_mu = tree_map(lambda p: _bits(p.full_tensor()),
                       state["opt_state"]["mu"])
    out = {"losses": losses, "restored": restored}
    if rank == 0:
        out["params"], out["mu"] = full_p, full_mu
    return out


CHECKS = {"reshard": check_reshard, "jax_ckpt": check_jax_ckpt,
          "train": check_train}


def run_checks(rank: int, world: int, inputs: Dict[str, Any]) -> Dict:
    """Every check named in `inputs`, in order."""
    out = {}
    for name, inp in inputs.items():
        try:
            out[name] = CHECKS[name](rank, world, inp)
        except Exception:  # noqa: BLE001 — reported per check
            out[name] = {"error": traceback.format_exc()}
    return out


__all__ = ["CHECKS", "run_checks"]
