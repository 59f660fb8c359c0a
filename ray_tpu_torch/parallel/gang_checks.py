"""What each rank of a CPU gang runs to check the parallel layer.

    results = gang.run_gang(gang_checks.run_checks, 4, args=(inputs,))

`run_checks(rank, world, inputs)` runs every check named in `inputs`
(numpy arrays and configs in, numpy arrays out) on one rank of a gloo
gang and returns {name: result}; a check that raises returns
{"error": traceback}. The caller holds the results against the JAX
package. The checks live in the package, not beside the tests, because
each rank imports the module of the function it runs, and the tests
import JAX.

Checks: `layout` (local blocks of a few specs), `shard_map` (psum,
all_gather, ppermute, axis_index / axis_size and their gradients),
`collective` (host groups: a pair and the whole gang), `pipeline`
(forward and gradients), `train_*` (the mesh TrainStep), `dp_grad` (the
data-parallel gradient through `TrainStep.gathered`, and through
`full_tensor()` for contrast), `all_to_all` (both forms, and at axis size
1), `seq_parallel` (ring and Ulysses attention and their gradients at sp
4 and sp 1), `moe_ep` (the expert-parallel `moe_ffn` and its gradients),
`row_split` (a batch's rows gathered over two data axes, and back) and
`rendezvous` (KV rendezvous into a new process group, a hybrid mesh over
it, a one-rank group); it ends the gang's process group, so it runs
last.
"""
from __future__ import annotations

import os
import traceback
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import distribute_tensor

from ..tree import tree_leaves, tree_map
from . import collective as col
from .distributed import initialize_torch_distributed
from .mesh import (MeshConfig, P, RowSplit, all_gather, all_to_all,
                   axis_index, axis_size, host_local_array_to_global,
                   make_mesh, ppermute, psum, shard_map, spec_placements)
from .multislice import HybridMeshConfig, discover_slice_topology, \
    make_hybrid_mesh
from .pipeline import make_pipeline_fn, stack_stage_params

LAYOUT_MESH = dict(dp=1, fsdp=2, tp=2)
LAYOUT_SPECS = [P(("tp", "fsdp"), None), P("fsdp", "tp"), P(None, "fsdp"),
                P("tp")]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().copy()


def check_layout(rank: int, world: int, inp: Dict[str, Any]) -> Dict:
    mesh = make_mesh(MeshConfig(**LAYOUT_MESH), device="cpu")
    w = torch.from_numpy(inp["w"])
    out = {"coordinate": list(mesh.get_coordinate())}
    for spec in LAYOUT_SPECS:
        d = distribute_tensor(w, mesh, spec_placements(mesh, spec))
        local = d.to_local()
        back = host_local_array_to_global(mesh, spec, local).full_tensor()
        out[repr(spec)] = {"local": _np(local),
                           "round_trip": bool(torch.equal(back, w))}
    return out


SHARD_MAP_MESH = dict(dp=1, fsdp=2, tp=2)
SHARD_MAP_IN = P("fsdp", "tp")
SHARD_MAP_OUT = (P("fsdp"), P(None, "tp"), P("fsdp", "tp"),
                 P("fsdp", "tp"))


def shard_map_body(xl: torch.Tensor):
    """psum over tp, all_gather (tiled) over fsdp, a swap over fsdp, and
    each block's (tp index, fsdp size)."""
    a = psum(xl, "tp")
    b = all_gather(xl, "fsdp", tiled=True)
    c = ppermute(xl, "fsdp", [(0, 1), (1, 0)])
    d = xl[:1, :1] * 0 + axis_index("tp") + 10 * axis_size("fsdp")
    return a, b, c, d


def check_shard_map(rank: int, world: int, inp: Dict[str, Any]) -> Dict:
    mesh = make_mesh(MeshConfig(**SHARD_MAP_MESH), device="cpu")
    x = torch.from_numpy(inp["x"]).requires_grad_()
    outs = shard_map(shard_map_body, mesh=mesh, in_specs=SHARD_MAP_IN,
                     out_specs=SHARD_MAP_OUT)(x)
    full = [o.full_tensor() for o in outs]
    loss = sum((f * torch.from_numpy(w)).sum()
               for f, w in zip(full, inp["weights"]))
    grad, = torch.autograd.grad(loss, [x])
    return {"outs": [_np(f) for f in full], "grad": _np(grad)}


def check_collective(rank: int, world: int, inp: Dict[str, Any]) -> Dict:
    out: Dict[str, Any] = {}
    # tests/test_collective.py's pair, on ranks 0 and 1 only
    if rank < 2:
        col.init_collective_group(2, rank, group_name="pair")
        out["pair_allreduce"] = col.allreduce(
            np.full((4,), float(rank + 1), dtype=np.float32), "pair")
        x = np.arange(3, dtype=np.float32) if rank == 0 \
            else np.zeros(3, dtype=np.float32)
        out["pair_broadcast"] = col.broadcast(x, 0, "pair")
        out["pair_broadcast_in_place"] = x
        out["pair_allgather"] = col.allgather(
            None, np.array([rank], np.int64), "pair")
        out["pair_reducescatter"] = col.reducescatter(
            np.arange(4, dtype=np.float32) + rank, group_name="pair")
        if rank == 0:
            col.send(np.array([42.0]), 1, "pair")
        else:
            buf = np.zeros(1)
            col.recv(buf, 0, "pair")
            out["pair_recv"] = buf
        col.barrier("pair")
        col.destroy_collective_group("pair")
    # the whole gang, every reducer, on inputs that differ by rank
    col.init_collective_group(world, rank, group_name="all")
    out["rank"] = col.get_rank("all")
    out["size"] = col.get_collective_group_size("all")
    mine = inp["per_rank"][rank]
    for op in ("sum", "product", "min", "max"):
        out[f"allreduce_{op}"] = col.allreduce(mine.copy(), "all", op)
        out[f"reduce_{op}"] = col.reduce(mine.copy(), 2, "all", op)
    buf = mine.copy()
    col.allreduce(buf, "all")
    out["allreduce_in_place"] = buf
    out["reducescatter"] = col.reducescatter(mine.copy(), group_name="all")
    out["allgather"] = col.allgather(None, mine, "all")
    col.destroy_collective_group("all")
    out["destroyed"] = not col.is_group_initialized("all")
    # a group re-created under the same name is a new group
    col.init_collective_group(world, rank, group_name="all")
    out["again"] = col.allreduce(np.array([rank], np.int64), "all")
    col.destroy_collective_group("all")
    return out


SEQ_MESH = dict(dp=1, sp=4)
EP_MESH = dict(dp=1, ep=4)
# name -> (split_axis, concat_axis, tiled, axis, this rank's block shape)
A2A_CASES = {
    "untiled_0_0": (0, 0, False, "sp", (4, 3, 2)),
    "untiled_0_2": (0, 2, False, "sp", (4, 3, 2)),
    "untiled_1_0": (1, 0, False, "sp", (3, 4, 2)),
    "tiled_2_1": (2, 1, True, "sp", (2, 3, 8, 2)),
    "tiled_1_2": (1, 2, True, "sp", (2, 8, 3, 2)),
    "size1_untiled": (0, 1, False, "dp", (1, 3, 2)),
    "size1_tiled": (1, 0, True, "dp", (2, 3, 2)),
}


def a2a_out_shape(block, split: int, concat: int, tiled: bool, n: int):
    """The shape `all_to_all` gives a block of shape `block` over n ranks."""
    out = list(block)
    if tiled:
        out[split] //= n
        out[concat] *= n
        return tuple(out)
    del out[split]
    out.insert(concat, n)
    return tuple(out)


def _grads_of(fn, tensors, weight):
    """fn(*tensors) as a whole array, and the gradients of
    sum(fn(...) * weight) in each tensor."""
    ts = [torch.from_numpy(t).requires_grad_() for t in tensors]
    y = fn(*ts)
    if hasattr(y, "full_tensor"):
        y = y.full_tensor()
    grads = torch.autograd.grad((y * torch.from_numpy(weight)).sum(), ts)
    return {"y": _np(y), "grads": [_np(g) for g in grads]}


def check_all_to_all(rank: int, world: int, inp: Dict[str, Any]) -> Dict:
    """Each A2A_CASES exchange over a block per rank stacked on dim 0, and
    its gradient."""
    mesh = make_mesh(MeshConfig(**SEQ_MESH), device="cpu")
    out = {}
    for name, (split, concat, tiled, axis, _) in A2A_CASES.items():
        def body(xl, split=split, concat=concat, tiled=tiled, axis=axis):
            return all_to_all(xl, axis, split_axis=split,
                              concat_axis=concat, tiled=tiled)

        spec = P("sp")
        fn = shard_map(body, mesh=mesh, in_specs=spec, out_specs=spec)
        out[name] = _grads_of(fn, [inp[name]["x"]], inp[name]["w"])
    return out


def check_seq_parallel(rank: int, world: int, inp: Dict[str, Any]) -> Dict:
    """Ring and Ulysses attention at sp 4 (q, k, v split on the sequence)
    and at sp 1 (a dp 4 mesh, each rank its own batch row), forward and
    gradients; Ulysses' refusal of heads sp does not divide."""
    from ..ops.ring_attention import ring_attention
    from ..ops.ulysses import ulysses_attention

    fns = {"ring": ring_attention, "ulysses": ulysses_attention}
    out = {}
    for name, case in inp["cases"].items():
        kind, causal, sp = case["kind"], case["causal"], case["sp"]
        mesh = make_mesh(MeshConfig(**(SEQ_MESH if sp > 1 else
                                       dict(dp=world))), device="cpu")
        spec = P(None, "sp") if sp > 1 else P("dp")

        def body(q, k, v, fn=fns[kind], causal=causal):
            return fn(q, k, v, axis_name="sp", causal=causal)

        fn = shard_map(body, mesh=mesh, in_specs=(spec,) * 3,
                       out_specs=spec)
        out[name] = _grads_of(fn, case["qkv"], case["w"])
    mesh = make_mesh(MeshConfig(**SEQ_MESH), device="cpu")
    q6 = torch.zeros(1, 16, 6, 8)
    try:
        shard_map(lambda q, k, v: ulysses_attention(q, k, v, "sp"),
                  mesh=mesh, in_specs=(P(None, "sp"),) * 3,
                  out_specs=P(None, "sp"))(q6, q6, q6)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def check_moe_ep(rank: int, world: int, inp: Dict[str, Any]) -> Dict:
    """The expert-parallel moe_ffn at ep 4, tokens and experts split on
    `ep`, the gate replicated: output and the gradients of x, gate_w,
    w_in and w_out."""
    from ..ops.moe import moe_ffn

    mesh = make_mesh(MeshConfig(**EP_MESH), device="cpu")
    out = {}
    for name, case in inp.items():
        def body(x, gw, wi, wo, cf=case["capacity_factor"]):
            return moe_ffn(x, gw, wi, wo, top_k=case["top_k"],
                           capacity_factor=cf, axis_name="ep")

        fn = shard_map(body, mesh=mesh,
                       in_specs=(P("ep"), P(), P("ep"), P("ep")),
                       out_specs=P("ep"))
        out[name] = _grads_of(fn, case["args"], case["w"])
    return out


def pipeline_stage(params, x: torch.Tensor) -> torch.Tensor:
    """tests/test_parallel.py's stage: tanh(x @ w + b)."""
    w, b = params
    return torch.tanh(x @ w + b)


def check_pipeline(rank: int, world: int, inp: Dict[str, Any]) -> Dict:
    mesh = make_mesh(MeshConfig(pp=world, dp=1), device="cpu")
    out = {}
    for name, case in inp.items():
        stacked = stack_stage_params([
            (torch.from_numpy(w), torch.from_numpy(b))
            for w, b in case["stages"]])
        stacked = tree_map(lambda a: a.requires_grad_(), stacked)
        pipe = make_pipeline_fn(pipeline_stage, mesh,
                                num_microbatches=case["microbatches"])
        y = pipe(stacked, torch.from_numpy(case["x"])).full_tensor()
        grads = torch.autograd.grad((y ** 2).sum(), tree_leaves(stacked))
        out[name] = {"y": _np(y), "grads": [_np(g) for g in grads]}
    return out


def _loss_fn(model: str, cfg):
    if model == "gpt2":
        from ..models.gpt2 import gpt2_loss as loss
    elif model == "moe":
        from ..models.moe_transformer import moe_loss as loss
    else:
        from ..models.llama import llama_loss as loss

    return lambda p, b: loss(p, b["tokens"], b["targets"], cfg)


def _specs(model: str, cfg):
    if model == "gpt2":
        from ..models.gpt2 import gpt2_partition_specs as specs
    elif model == "moe":
        from ..models.moe_transformer import moe_partition_specs as specs
    else:
        from ..models.llama import llama_partition_specs as specs

    return specs(cfg)


def check_train(rank: int, world: int, inp: Dict[str, Any]) -> Dict:
    """Steps of the mesh TrainStep + adamw (on `data_spec` when given):
    each loss, and rank 0's gathered params and first moments; whether
    every moment has its param's layout."""
    from ..models.convert import from_jax_params
    from ..train.optim import adamw
    from ..train.step import TrainStep

    model, cfg = inp["model"], inp["config"]
    mesh = make_mesh(MeshConfig(**inp["mesh"]), device="cpu")
    kw = {"data_spec": inp["data_spec"]} if "data_spec" in inp else {}
    step = TrainStep(_loss_fn(model, cfg), adamw(inp["lr"]), device="cpu",
                     mesh=mesh, param_specs=_specs(model, cfg), **kw)
    state = step.init_state(from_jax_params(inp["params"], device="cpu"))
    losses = []
    for b in inp["batches"]:
        state, m = step(state, tree_map(torch.from_numpy, b))
        losses.append(float(m["loss"]))
    params = tree_leaves(state["params"])
    mu = tree_leaves(state["opt_state"]["mu"])
    out = {"losses": losses, "step": state["step"],
           "same_layout": all(m.placements == p.placements
                              and m.to_local().shape == p.to_local().shape
                              for m, p in zip(mu, params))}
    full_p = tree_map(lambda p: _np(p.full_tensor()), state["params"])
    full_mu = tree_map(lambda p: _np(p.full_tensor()),
                       state["opt_state"]["mu"])
    if rank == 0:
        out["params"], out["mu"] = full_p, full_mu
    return out


class _SGD:
    """p -= g on each rank's blocks: the step's gradient, unscaled."""

    def init(self, params):
        return {}

    @torch.no_grad()
    def update_(self, grads, state, params):
        for p, g in zip(tree_leaves(params), grads):
            p.to_local().sub_(g.to_local())


def _dp_loss(p, b):
    return ((b["x"] @ p["w"]) ** 2).sum(-1).mean()


def check_dp_grad(rank: int, world: int, inp: Dict[str, Any]) -> Dict:
    """One SGD step of the mesh TrainStep on rows that differ by rank:
    the parameter moves by the global batch's gradient. The same step
    gathering with `full_tensor()` moves it by another amount."""
    from ..train.step import TrainStep

    class FullTensorStep(TrainStep):
        def gathered(self, params):
            return tree_map(lambda p: p.full_tensor(), params)

    mesh = make_mesh(MeshConfig(**inp["mesh"]), device="cpu")
    out = {}
    for name, cls in (("gathered", TrainStep),
                      ("full_tensor", FullTensorStep)):
        step = cls(_dp_loss, _SGD(), device="cpu", mesh=mesh,
                   param_specs={"w": P("fsdp")})
        state = step.init_state({"w": torch.from_numpy(inp["w"])})
        state, m = step(state, {"x": torch.from_numpy(inp["x"])})
        out[name] = {"w": _np(state["params"]["w"].full_tensor()),
                     "loss": float(m["loss"])}
    return out


def check_row_split(rank: int, world: int, inp: Dict[str, Any]) -> Dict:
    """A batch split on its rows over (dp, fsdp), as the mesh TrainStep
    splits it: this rank's block, the rows `RowSplit.gather` joins, and
    the gradient of sum(gather(block) * w) in the block."""
    mesh = make_mesh(MeshConfig(**inp["mesh"]), device="cpu")
    split = RowSplit(mesh, ("dp", "fsdp"))
    block = split.own(torch.from_numpy(inp["x"])).requires_grad_()
    rows = split.gather(block)
    (g,) = torch.autograd.grad((rows * torch.from_numpy(inp["w"])).sum(),
                               block)
    return {"block": split.block, "blocks": split.blocks, "own": _np(block),
            "rows": _np(rows), "grad": _np(g)}


class _FileKV:
    """kv_put / kv_get over files in a directory all ranks see."""

    def __init__(self, path: str):
        self.path = path

    def _file(self, key: bytes, namespace: str) -> str:
        return os.path.join(self.path, (namespace.encode() + b"|" + key)
                            .hex())

    def put(self, key: bytes, value: bytes, namespace: str) -> None:
        f = self._file(key, namespace)
        with open(f + ".tmp", "wb") as fh:
            fh.write(value)
        os.replace(f + ".tmp", f)

    def get(self, key: bytes, namespace: str):
        try:
            with open(self._file(key, namespace), "rb") as fh:
                return fh.read()
        except FileNotFoundError:
            return None


def check_rendezvous(rank: int, world: int, inp: Dict[str, Any]) -> Dict:
    """Leave the gang's group, rendezvous through a file KV into a new
    one with slice ids (process ids slice-major), all-reduce on it, build
    a hybrid mesh over the slices, then a one-rank group."""
    dist.destroy_process_group()
    kv = _FileKV(inp["kv_dir"])
    slice_ids = inp["slice_ids"]
    info = initialize_torch_distributed(
        "gang", rank, world, kv.put, kv.get, timeout=60.0,
        host="127.0.0.1", slice_id=slice_ids[rank], device="cpu")
    pid = dist.get_rank()
    t = torch.tensor([float(pid)])
    dist.all_reduce(t)
    by_pid = {info["process_ids"][r]: slice_ids[r] for r in range(world)}
    topo = discover_slice_topology(
        range(world), slice_ids=[by_pid[p] for p in range(world)])
    mesh = make_hybrid_mesh(HybridMeshConfig(**inp["hybrid"]),
                            topology=topo, device="cpu")
    dist.destroy_process_group()
    initialize_torch_distributed("one", 0, 1, kv.put, kv.get,
                                 device="cpu")
    one = dist.get_world_size()
    dist.destroy_process_group()
    return {"info": info, "pid": pid, "sum": float(t), "one": one,
            "mesh": mesh.mesh.tolist(), "coordinate": mesh.get_coordinate()}


CHECKS = {"layout": check_layout, "shard_map": check_shard_map,
          "collective": check_collective, "pipeline": check_pipeline,
          "dp_grad": check_dp_grad, "all_to_all": check_all_to_all,
          "seq_parallel": check_seq_parallel, "moe_ep": check_moe_ep,
          "row_split": check_row_split, "rendezvous": check_rendezvous}


def run_checks(rank: int, world: int, inputs: Dict[str, Any]) -> Dict:
    """Every check named in `inputs`, in order ("train_*" names run
    check_train); "rendezvous" must come last."""
    out = {}
    for name, inp in inputs.items():
        fn = check_train if name.startswith("train_") else CHECKS[name]
        try:
            out[name] = fn(rank, world, inp)
        except Exception:  # noqa: BLE001 — reported per check
            out[name] = {"error": traceback.format_exc()}
    return out


__all__ = ["CHECKS", "run_checks"]
