"""Sharded checkpoints of the port on a 4-rank gloo gang, against the JAX
package on 4 devices of the virtual CPU mesh (`jax.devices()[:4]`).

One gang runs every check (`ray_tpu_torch.train.gang_checks`) while this
process computes the JAX side; each check is a case below. GPT-2 tiny
(fp32, 2 heads; the port's init from a seed, the same numpy weights for
both packages) is laid out by its partition specs, `wte`'s split over
(tp, fsdp) included, plus a bf16 copy of `wte` and a step. Restores are
held bit for bit; the mesh TrainStep resumed on another mesh is held to
1e-4 against JAX's mesh step doing the same, as
tests/test_torch_parallel_gang.py holds the step (Adam's near-noise
elements to its steps times lr). The gang has a 120 s limit and kills
its ranks when it is hit.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.train import async_checkpoint as jac
from ray_tpu.train.trainer import TrainStep as JTrainStep
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models.convert import from_jax_params
from ray_tpu_torch.parallel import gang
from ray_tpu_torch.train import gang_checks
from ray_tpu_torch.tree import tree_flatten, tree_leaves, tree_map

WORLD = 4
GANG_TIMEOUT = 120.0
TRAIN_TOL = dict(atol=1e-4, rtol=1e-4)
TRAIN_STEPS, TRAIN_LR = (2, 2), 1e-3

JCFG = dataclasses.replace(jgpt2.GPT2Config.tiny(), num_heads=2,
                           dtype=jnp.float32)
TCFG = dataclasses.replace(tgpt2.GPT2Config.tiny(), num_heads=2,
                           dtype=torch.float32)
SRC = {"dp2_fsdp2": dict(dp=2, fsdp=2), "fsdp2_tp2": dict(dp=1, fsdp=2,
                                                         tp=2)}
DST = {"fsdp4": dict(dp=1, fsdp=4), "dp4": dict(dp=4)}
JAX_DST = {"fsdp2_tp2": SRC["fsdp2_tp2"], "dp2_fsdp2": SRC["dp2_fsdp2"]}
TRAIN_MESHES = (SRC["dp2_fsdp2"], SRC["fsdp2_tp2"])


def _params():
    return tree_map(lambda p: p.numpy(), tgpt2.gpt2_init(
        TCFG, torch.Generator().manual_seed(3), device="cpu"))


def _batches(n, b=8, t=64):
    toks = np.random.default_rng(5).integers(0, JCFG.vocab_size,
                                             (n, b, t + 1))
    return [{"tokens": x[:, :-1], "targets": x[:, 1:]} for x in toks]


def _jax_mesh(axes):
    return jmesh.make_mesh(jmesh.MeshConfig(**axes),
                           devices=jax.devices()[:WORLD])


def _want_leaves(params):
    """The saved state's leaves in JAX's order, bf16 as raw bits."""
    wte16 = torch.from_numpy(params["wte"]).to(torch.bfloat16)
    return tree_flatten({"params": params, "step": np.asarray(3),
                         "wte_bf16": wte16.view(torch.int16).numpy()
                         .view(np.uint16)})[0]


def _jax_checkpoint(params, d):
    """GPT-2 params saved by JAX's async_save on its (fsdp 2, tp 2) mesh:
    `wte` in JAX's block order (tp major)."""
    mesh = _jax_mesh(JAX_DST["fsdp2_tp2"])
    specs = jgpt2.gpt2_partition_specs(JCFG)
    state = jax.tree.map(lambda a, s: jax.device_put(
        a, NamedSharding(mesh, s)), params, specs,
        is_leaf=lambda x: isinstance(x, np.ndarray))
    jac.async_save(d, state).wait()


def _jax_place(restored, like):
    """A JAX TrainStep state restored whole (numpy), laid out as `like`:
    params and Adam moments by the params' shardings, the 0-d count and
    step left on the host. (JAX's `restore(like=)` commits every leaf to
    its template's devices, and JAX's multi-device step then refuses the
    moments and count that `init_state` left on one device.)"""
    shardings = jax.tree.map(lambda x: x.sharding, like["params"])
    place = lambda t: jax.tree.map(jax.device_put, t, shardings)  # noqa
    adam = restored["opt_state"][0]
    return {"params": place(restored["params"]), "step": restored["step"],
            "opt_state": (adam._replace(mu=place(adam.mu),
                                        nu=place(adam.nu)),
                          *restored["opt_state"][1:])}


def _jax_train(inp):
    """JAX's mesh TrainStep doing what check_train does."""
    specs = jgpt2.gpt2_partition_specs(JCFG)

    def make(axes):
        step = JTrainStep(lambda p, b: jgpt2.gpt2_loss(
            p, b["tokens"], b["targets"], JCFG), optax.adamw(TRAIN_LR),
            _jax_mesh(axes), specs)
        return step, step.init_state(jax.tree.map(jnp.asarray,
                                                  inp["params"]))

    n_a, _ = TRAIN_STEPS
    d = tempfile.mkdtemp(prefix="jax-train-ck-")
    try:
        step, state = make(inp["mesh_a"])
        losses = []
        for i, b in enumerate(inp["batches"]):
            if i == n_a:
                jac.async_save(d, state).wait()
                step, like = make(inp["mesh_b"])
                state = _jax_place(jac.restore(d), like)
            state, m = step(state, jax.tree.map(
                lambda a: jnp.asarray(a, jnp.int32), b))
            losses.append(float(m["loss"]))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    # Adam's near-noise elements (tests/test_torch_train.py)
    params = from_jax_params(inp["params"], device="cpu")
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    b = inp["batches"][0]
    first = iter(torch.autograd.grad(tgpt2.gpt2_loss(
        params, torch.from_numpy(b["tokens"]),
        torch.from_numpy(b["targets"]), TCFG), leaves))
    noise = tree_map(lambda _: next(first).abs().numpy() < 1e-7, params)
    return {"losses": losses,
            "params": jax.tree.map(np.asarray, state["params"]),
            "mu": jax.tree.map(np.asarray, state["opt_state"][0].mu),
            "noise": noise}


@pytest.fixture(scope="module")
def gang_run():
    """The gang's results by rank, its checkpoint directories, and the
    JAX references, computed while the gang runs."""
    base = tempfile.mkdtemp(prefix="ckpt-gang-")
    try:
        params = _params()
        _jax_checkpoint(params, os.path.join(base, "jax"))
        inputs = {
            "reshard": {"config": TCFG, "params": params,
                        "dir": os.path.join(base, "reshard"),
                        "src": SRC, "dst": DST},
            "jax_ckpt": {"config": TCFG, "params": params,
                         "dir": os.path.join(base, "jax"),
                         "dst": JAX_DST},
            "train": {"config": TCFG, "params": params, "lr": TRAIN_LR,
                      "batches": _batches(sum(TRAIN_STEPS)),
                      "steps": TRAIN_STEPS, "mesh_a": TRAIN_MESHES[0],
                      "mesh_b": TRAIN_MESHES[1],
                      "dir": os.path.join(base, "train")}}
        g = gang.Gang(gang_checks.run_checks, WORLD, args=(inputs,),
                      timeout=GANG_TIMEOUT).start()
        try:
            ref = _jax_train(inputs["train"])
        finally:
            results = g.join()
        manifests = {}
        for src in SRC:
            d = os.path.join(base, "reshard", src)
            manifests[src] = [json.load(open(os.path.join(
                d, f"manifest.{p}.json"))) for p in range(WORLD)]
        yield inputs, results, ref, manifests
    finally:
        shutil.rmtree(base, ignore_errors=True)


def _check(gang_run, name):
    """Every rank's result of check `name` (failing on a rank's error)."""
    _, results, _, _ = gang_run
    out = [r[name] for r in results]
    for rank, o in enumerate(out):
        assert "error" not in o, f"rank {rank}:\n{o['error']}"
    return out


def _assert_leaves_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, i
        np.testing.assert_array_equal(g, w, err_msg=f"leaf {i}")


@pytest.mark.parametrize("dst", [*DST, "world1"])
@pytest.mark.parametrize("src", list(SRC))
def test_reshard_restore_is_bit_exact(gang_run, src, dst):
    """Saved on (dp 2, fsdp 2) or (fsdp 2, tp 2), restored onto (fsdp 4),
    (dp 4) or one process (plain tensors; and with no template): every
    leaf, bf16 included, bit for bit, each DTensor with its template's
    placements and local block."""
    inputs, _, _, _ = gang_run
    want = _want_leaves(inputs["reshard"]["params"])
    out = _check(gang_run, "reshard")
    ranks = [0] if dst == "world1" else range(WORLD)
    for r in ranks:
        got = out[r][f"{src}->{dst}"]
        assert got["layout"]
        _assert_leaves_equal(got["leaves"], want)
        if dst == "world1":
            _assert_leaves_equal(got["whole"], want)


@pytest.mark.parametrize("src", list(SRC))
def test_every_element_is_written_once(gang_run, src):
    """Over the four manifests each element of each leaf lies in exactly
    one block: replicas are written by their coordinate-0 rank only, and
    the block sizes sum to the leaf's size."""
    _, _, _, manifests = gang_run
    n_leaves = len(manifests[src][0]["leaves"])
    for i in range(n_leaves):
        metas = [m["leaves"][str(i)] for m in manifests[src]]
        shape = metas[0]["shape"]
        count = np.zeros(shape, np.int64)
        total = 0
        for meta in metas:
            assert meta["shape"] == shape
            for sh in meta["shards"]:
                idx = tuple(slice(a, b) for a, b, _ in sh["index"])
                count[idx] += 1
                total += int(np.prod([b - a for a, b, _ in sh["index"]]))
        assert total == int(np.prod(shape)), i
        assert (count == 1).all(), i


def test_two_axis_blocks_are_indexed_in_dtensor_order(gang_run):
    """`wte` is P(("tp", "fsdp"), None): on (fsdp 2, tp 2) the rank at
    fsdp f, tp t holds row block f * 2 + t (DTensor's mesh-dim order, not
    JAX's t * 2 + f), and its manifest records that block's true rows."""
    inputs, _, _, manifests = gang_run
    rows = inputs["reshard"]["params"]["wte"].shape[0]
    leaf = tree_flatten({"params": inputs["reshard"]["params"],
                         "step": 0, "wte_bf16": 0})
    wte_i = [i for i, x in enumerate(leaf[0])
             if x is inputs["reshard"]["params"]["wte"]][0]
    # ranks are laid out row-major over (fsdp, tp): rank = f * 2 + t
    for rank, m in enumerate(manifests["fsdp2_tp2"]):
        (sh,) = m["leaves"][str(wte_i)]["shards"]
        n = rows // 4
        assert sh["index"][0] == [rank * n, (rank + 1) * n, 1]


@pytest.mark.parametrize("dst", list(JAX_DST))
def test_jax_checkpoint_restores_onto_gang_mesh(gang_run, dst):
    """GPT-2 params JAX saved from its (fsdp 2, tp 2) mesh (wte in JAX's
    tp-major blocks) restore onto the gang's (fsdp 2, tp 2) and (dp 2,
    fsdp 2) meshes bit for bit."""
    inputs, _, _, _ = gang_run
    want = tree_flatten(inputs["jax_ckpt"]["params"])[0]
    for o in _check(gang_run, "jax_ckpt"):
        _assert_leaves_equal(o[dst], want)


@pytest.mark.parametrize("what", ["losses", "params", "mu"])
def test_resharded_train_step_matches_jax(gang_run, what):
    """The mesh TrainStep + adamw(1e-3): 2 steps on (dp 2, fsdp 2),
    saved, restored onto (fsdp 2, tp 2) into a fresh state of its step,
    2 more steps; against JAX's TrainStep doing the same: every loss,
    and rank 0's gathered params and first moments, within 1e-4."""
    _, _, ref, _ = gang_run
    out = _check(gang_run, "train")
    for o in out:
        assert o["restored"] == (TRAIN_STEPS[0], TRAIN_STEPS[0], True)
    if what == "losses":
        for o in out:
            np.testing.assert_allclose(o["losses"], ref["losses"],
                                       **TRAIN_TOL)
    elif what == "params":
        for got, want, tiny in zip(jax.tree.leaves(out[0]["params"]),
                                   jax.tree.leaves(ref["params"]),
                                   jax.tree.leaves(ref["noise"])):
            np.testing.assert_allclose(got[~tiny], want[~tiny],
                                       **TRAIN_TOL)
            np.testing.assert_allclose(got[tiny], want[tiny],
                                       atol=sum(TRAIN_STEPS) * TRAIN_LR)
    else:
        for got, want in zip(jax.tree.leaves(out[0]["mu"]),
                             jax.tree.leaves(ref["mu"])):
            np.testing.assert_allclose(got, want, **TRAIN_TOL)
