"""The port's parallel layer on a 4-rank gloo gang, against the JAX
package on 4 devices of the virtual CPU mesh (`jax.devices()[:4]`).

One gang runs every check (`ray_tpu_torch.parallel.gang_checks`) while
this process computes the JAX side; each check is a case below. Inputs
are numpy arrays from fixed seeds (the models' from the port's init). The
gang has a 120 s limit and kills its ranks when it is hit.

Tolerances: 1e-5 for the small ops (the same fp32 arithmetic in another
order), 1e-4 for the mesh TrainStep's losses and parameters after 3
steps (as tests/test_torch_train.py, Adam's near-noise elements held to
3 steps of lr), exact for the collectives' small integer-valued inputs.
The sequence- and expert-parallel ops (`all_to_all`, ring and Ulysses
attention, the expert-parallel `moe_ffn`) are held, forward and
gradients, against `jax.grad` of the same shard-mapped JAX functions on
the shapes of tests/test_parallel.py (ep 4, sp 4).
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import functools
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu.models import moe_transformer as jmoe
from ray_tpu.ops.attention import mha_reference as jmha
from ray_tpu.ops.moe import moe_ffn as jmoe_ffn
from ray_tpu.ops.ring_attention import ring_attention as jring
from ray_tpu.ops.ulysses import ulysses_attention as julysses
from ray_tpu.parallel import collective as jcol
from ray_tpu.parallel import distributed as jdist
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import multislice as jms
from ray_tpu.parallel.pipeline import make_pipeline_fn as jpipeline
from ray_tpu.parallel.pipeline import stack_stage_params as jstack
from ray_tpu.train.trainer import TrainStep as JTrainStep
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import moe_transformer as tmoe
from ray_tpu_torch.models.convert import from_jax_params
from ray_tpu_torch.parallel import P, gang, gang_checks
from ray_tpu_torch.tree import tree_leaves, tree_map

WORLD = 4
GANG_TIMEOUT = 120.0
TOL = dict(atol=1e-5, rtol=1e-5)
TRAIN_TOL = dict(atol=1e-4, rtol=1e-4)
TRAIN_STEPS, TRAIN_LR = 3, 1e-3

MODELS = {
    "gpt2": (dataclasses.replace(jgpt2.GPT2Config.tiny(), num_heads=2,
                                 dtype=jnp.float32),
             dataclasses.replace(tgpt2.GPT2Config.tiny(), num_heads=2,
                                 dtype=torch.float32), jgpt2),
    "llama": (dataclasses.replace(jllama.LlamaConfig.tiny(),
                                  dtype=jnp.float32),
              dataclasses.replace(tllama.LlamaConfig.tiny(),
                                  dtype=torch.float32), jllama),
    "moe": (dataclasses.replace(jmoe.MoEConfig.tiny(), dtype=jnp.float32),
            dataclasses.replace(tmoe.MoEConfig.tiny(), dtype=torch.float32),
            jmoe),
}
LOSSES = {"gpt2": ("gpt2_loss", "gpt2_partition_specs", tgpt2.gpt2_init),
          "llama": ("llama_loss", "llama_partition_specs",
                    tllama.llama_init),
          "moe": ("moe_loss", "moe_partition_specs", tmoe.moe_init)}
# name: (model, mesh, data_spec; None for TrainStep's default)
TRAIN_CASES = {"train_gpt2_dp_fsdp": ("gpt2", dict(dp=2, fsdp=2), None),
               "train_gpt2_fsdp_tp": ("gpt2", dict(dp=1, fsdp=2, tp=2),
                                      None),
               "train_llama_dp_fsdp": ("llama", dict(dp=2, fsdp=2), None),
               # tests/test_models.py:101's mesh. MoE routing is not a
               # mean over rows (each expert's capacity and queue, and
               # the balancing loss, take the whole batch, as JAX's GSPMD
               # step computes them): with the batch split on dp the
               # model gathers the rows it routes; with P() every rank
               # takes the whole batch. Both give JAX's step.
               "train_moe_dp_ep": ("moe", dict(dp=-1, ep=2), None),
               "train_moe_dp_ep_whole_batch": ("moe", dict(dp=-1, ep=2),
                                               P())}
# tests/test_parallel.py's shapes: [B, T, H, D] and causal for each case
SEQ_CASES = {
    "ulysses_causal": ("ulysses", True, 4, (2, 32, 8, 16)),
    "ulysses_full": ("ulysses", False, 4, (2, 32, 8, 16)),
    "ring_causal": ("ring", True, 4, (1, 16, 4, 8)),
    "ring_full": ("ring", False, 4, (1, 16, 4, 8)),
    "agree_ulysses": ("ulysses", True, 4, (1, 16, 4, 8)),
    "ring_sp1": ("ring", True, 1, (4, 16, 4, 8)),
    "ulysses_sp1": ("ulysses", True, 1, (4, 16, 4, 8)),
}
# tests/test_parallel.py:85: 4 ranks x 8 tokens, d 16, f 32, 8 experts,
# top 2; capacity factor 8 drops nothing, 1.0 drops tokens
MOE_CASES = {"no_drop": 8.0, "drops": 1.0}
SLICE_IDS = [1, 0, 1, 0]
HYBRID = dict(dp=-1, dcn_dp=2)


def _batches(seed, vocab, n, b=8, t=64):
    toks = np.random.default_rng(seed).integers(0, vocab, (n, b, t + 1))
    return [{"tokens": x[:, :-1], "targets": x[:, 1:]} for x in toks]


def _inputs(rng, kv_dir):
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    inputs = {
        "layout": {"w": np.arange(32, dtype=np.float32).reshape(8, 4)},
        "shard_map": {"x": f32(8, 4),
                      "weights": [f32(8, 2), f32(8, 4), f32(8, 4)]},
        "collective": {"per_rank": [
            np.array([r + 1, 2.0, -r, 0.5 * r, 3.0 - r], np.float64)
            for r in range(WORLD)]},
        # tests/test_parallel.py:31-83: the forward at d 16, 4
        # microbatches; the gradients at d 8, 2 microbatches
        "pipeline": {
            "fwd": {"stages": [(f32(16, 16) * 0.3, f32(16) * 0.1)
                               for _ in range(WORLD)],
                    "x": f32(16, 16), "microbatches": 4},
            "grad": {"stages": [(f32(8, 8) * 0.3, np.zeros(8, np.float32))
                                for _ in range(WORLD)],
                     "x": f32(8, 8), "microbatches": 2}},
        "dp_grad": {"mesh": dict(dp=2, fsdp=2), "w": f32(8, 3),
                    "x": f32(8, 8)},
        "row_split": {"mesh": dict(dp=2, fsdp=2), "x": f32(8, 3),
                      "w": f32(8, 3)},
    }
    inputs["all_to_all"] = {}
    for name, (split, concat, tiled, axis, block) in \
            gang_checks.A2A_CASES.items():
        n = 4 if axis == "sp" else 1
        out = gang_checks.a2a_out_shape(block, split, concat, tiled, n)
        inputs["all_to_all"][name] = {
            "x": f32(WORLD * block[0], *block[1:]),
            "w": f32(WORLD * out[0], *out[1:])}
    inputs["seq_parallel"] = {"cases": {
        name: {"kind": kind, "causal": causal, "sp": sp,
               "qkv": [f32(*shape) for _ in range(3)], "w": f32(*shape)}
        for name, (kind, causal, sp, shape) in SEQ_CASES.items()}}
    # ring and Ulysses on the same inputs (tests/test_parallel.py:161)
    agree = inputs["seq_parallel"]["cases"]
    agree["agree_ulysses"]["qkv"] = agree["ring_causal"]["qkv"]
    agree["agree_ulysses"]["w"] = agree["ring_causal"]["w"]
    t, d, f, e = 8, 16, 32, 8
    inputs["moe_ep"] = {
        name: {"top_k": 2, "capacity_factor": cf,
               "args": [f32(WORLD * t, d), f32(d, e) * 0.5,
                        f32(e, d, f) * 0.2, f32(e, f, d) * 0.2],
               "w": f32(WORLD * t, d)}
        for name, cf in MOE_CASES.items()}
    for name, (model, mesh, spec) in TRAIN_CASES.items():
        jcfg, tcfg, _ = MODELS[model]
        # the port's init (the JAX layout, no compile before the gang
        # starts), the same numpy weights for both packages
        init = LOSSES[model][2]
        inputs[name] = {
            "model": model, "config": tcfg, "mesh": mesh, "lr": TRAIN_LR,
            "params": tree_map(lambda p: p.numpy(), init(
                tcfg, torch.Generator().manual_seed(3), device="cpu")),
            "batches": _batches(5, jcfg.vocab_size, TRAIN_STEPS)}
        if spec is not None:
            inputs[name]["data_spec"] = spec
    inputs["rendezvous"] = {"kv_dir": kv_dir, "slice_ids": SLICE_IDS,
                            "hybrid": HYBRID}
    return inputs


def _jax_mesh(**axes):
    return jmesh.make_mesh(jmesh.MeshConfig(**axes),
                           devices=jax.devices()[:WORLD])


def _jax_shard_map(inp):
    from jax import lax

    def body(xl):
        a = lax.psum(xl, "tp")
        b = lax.all_gather(xl, "fsdp", tiled=True)
        c = lax.ppermute(xl, "fsdp", [(0, 1), (1, 0)])
        d = xl[:1, :1] * 0 + lax.axis_index("tp") + 10 * lax.psum(1, "fsdp")
        return a, b, c, d

    fn = jmesh.shard_map(body, mesh=_jax_mesh(**gang_checks.SHARD_MAP_MESH),
                         in_specs=JP("fsdp", "tp"),
                         out_specs=(JP("fsdp"), JP(None, "tp"),
                                    JP("fsdp", "tp"), JP("fsdp", "tp")),
                         check_vma=False)

    def loss(x):
        outs = fn(x)
        return sum(jnp.sum(o * w) for o, w in zip(outs, inp["weights"]))

    x = jnp.asarray(inp["x"])
    return ([np.asarray(o, np.float32) for o in fn(x)],
            np.asarray(jax.grad(loss)(x)))


def _stage(params, x):
    w, b = params
    return jnp.tanh(x @ w + b)


def _jax_pipeline(case):
    stacked = jstack([(jnp.asarray(w), jnp.asarray(b))
                      for w, b in case["stages"]])
    pipe = jpipeline(_stage, _jax_mesh(dp=1, pp=WORLD),
                     num_microbatches=case["microbatches"])
    x = jnp.asarray(case["x"])
    y = jax.jit(pipe)(stacked, x)
    grads = jax.jit(jax.grad(lambda p: jnp.sum(pipe(p, x) ** 2)))(stacked)

    def seq_loss(p):
        h = x
        for i in range(WORLD):
            h = _stage(jax.tree.map(lambda a: a[i], p), h)
        return h

    seq_y = seq_loss(stacked)
    seq_g = jax.grad(lambda p: jnp.sum(seq_loss(p) ** 2))(stacked)
    return {"y": np.asarray(y), "grads": [np.asarray(g) for g in grads],
            "seq_y": np.asarray(seq_y),
            "seq_grads": [np.asarray(g) for g in seq_g]}


def _jax_grads(fn, args, w):
    """fn(*args) and the gradients of sum(fn(...) * w) in each argument."""
    args = [jnp.asarray(a) for a in args]
    y = fn(*args)
    grads = jax.grad(lambda *a: jnp.sum(fn(*a) * w),
                     argnums=tuple(range(len(args))))(*args)
    return {"y": np.asarray(y), "grads": [np.asarray(g) for g in grads]}


def _jax_all_to_all(inputs):
    """jax.lax.all_to_all under shard_map, and its gradient. JAX (0.9)
    cannot differentiate the untiled form with split_axis != concat_axis
    (its transpose gives the cotangent the wrong shape): there the
    gradient of sum(y * w) is the inverse exchange of w, which is what
    the exchange's transpose is, computed by JAX's forward."""
    from jax import lax

    out = {}
    mesh = _jax_mesh(**gang_checks.SEQ_MESH)

    def exchange(split, concat, tiled, axis):
        return jmesh.shard_map(
            lambda x: lax.all_to_all(x, axis, split, concat, tiled=tiled),
            mesh=mesh, in_specs=JP("sp"), out_specs=JP("sp"),
            check_vma=False)

    for name, (split, concat, tiled, axis, _) in \
            gang_checks.A2A_CASES.items():
        fn = exchange(split, concat, tiled, axis)
        x, w = inputs[name]["x"], inputs[name]["w"]
        if tiled or split == concat:
            out[name] = _jax_grads(fn, [x], w)
        else:
            inverse = exchange(concat, split, tiled, axis)
            out[name] = {"y": np.asarray(fn(jnp.asarray(x))),
                         "grads": [np.asarray(inverse(jnp.asarray(w)))]}
    return out


def _jax_seq_parallel(inputs):
    out = {}
    fns = {"ring": jring, "ulysses": julysses}
    for name, case in inputs["cases"].items():
        sp = case["sp"]
        mesh = _jax_mesh(**(gang_checks.SEQ_MESH if sp > 1
                            else dict(dp=WORLD)))
        spec = JP(None, "sp") if sp > 1 else JP("dp")
        fn = jmesh.shard_map(
            functools.partial(fns[case["kind"]], axis_name="sp",
                              causal=case["causal"]),
            mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
            check_vma=False)
        out[name] = _jax_grads(jax.jit(fn), case["qkv"], case["w"])
        out[name]["mha"] = np.asarray(jmha(
            *(jnp.asarray(a) for a in case["qkv"]), case["causal"]))
    return out


def _jax_moe_ep(inputs):
    out = {}
    mesh = _jax_mesh(**gang_checks.EP_MESH)
    for name, case in inputs.items():
        kw = dict(top_k=case["top_k"],
                  capacity_factor=case["capacity_factor"])
        fn = jmesh.shard_map(
            functools.partial(jmoe_ffn, axis_name="ep", **kw), mesh=mesh,
            in_specs=(JP("ep"), JP(), JP("ep"), JP("ep")),
            out_specs=JP("ep"), check_vma=False)
        out[name] = _jax_grads(jax.jit(fn), case["args"], case["w"])
        x, gw, wi, wo = (jnp.asarray(a) for a in case["args"])
        t = x.shape[0] // WORLD
        # tests/test_parallel.py:109: the dense layer on each rank's tokens
        out[name]["dense"] = np.concatenate([np.asarray(jmoe_ffn(
            x[i * t:(i + 1) * t], gw, wi, wo, **kw)) for i in range(WORLD)])
    return out


def _jax_train(inp, model):
    jcfg, tcfg, jmod = MODELS[model]
    loss_name, specs_name, _ = LOSSES[model]
    loss = getattr(jmod, loss_name)
    specs = getattr(jmod, specs_name)(jcfg)
    step = JTrainStep(lambda p, b: loss(p, b["tokens"], b["targets"], jcfg),
                      optax.adamw(TRAIN_LR), _jax_mesh(**inp["mesh"]),
                      specs)
    state = step.init_state(jax.tree.map(jnp.asarray, inp["params"]))
    losses = []
    for b in inp["batches"]:
        state, m = step(state, jax.tree.map(
            lambda a: jnp.asarray(a, jnp.int32), b))
        losses.append(float(m["loss"]))
    # Adam's first update divides a gradient by its own magnitude: the
    # elements whose first gradient is at the fp32 noise of its sum
    # (tests/test_torch_train.py:182-200), from the one-device port loss
    tloss = getattr({"gpt2": tgpt2, "llama": tllama, "moe": tmoe}[model],
                    loss_name)
    params = from_jax_params(inp["params"], device="cpu")
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    b = inp["batches"][0]
    first = torch.autograd.grad(
        tloss(params, torch.from_numpy(b["tokens"]),
              torch.from_numpy(b["targets"]), tcfg), leaves)
    it = iter(first)
    noise = tree_map(lambda _: next(it).abs().numpy() < 1e-7, params)
    return {"losses": losses,
            "params": jax.tree.map(np.asarray, state["params"]),
            "mu": jax.tree.map(np.asarray, state["opt_state"][0].mu),
            "noise": noise}


@pytest.fixture(scope="module")
def gang_run():
    """The gang's results by rank, and the JAX references, computed while
    the gang runs."""
    kv_dir = tempfile.mkdtemp(prefix="gang-kv-")
    try:
        inputs = _inputs(np.random.default_rng(0), kv_dir)
        g = gang.Gang(gang_checks.run_checks, WORLD, args=(inputs,),
                      timeout=GANG_TIMEOUT).start()
        try:
            # XLA compiles off the interpreter lock: the references in
            # threads take ~2/3 of the time one after another
            with cf.ThreadPoolExecutor(6) as pool:
                futs = {"shard_map": pool.submit(_jax_shard_map,
                                                 inputs["shard_map"])}
                futs.update({f"pipeline_{k}": pool.submit(_jax_pipeline, c)
                             for k, c in inputs["pipeline"].items()})
                # one JAX step for the cases of one model and mesh: the
                # data spec changes only the port's layout of the batch
                jax_of = {}
                for name, (model, mesh, _) in TRAIN_CASES.items():
                    key = (model, tuple(sorted(mesh.items())))
                    if key not in jax_of:
                        jax_of[key] = pool.submit(_jax_train, inputs[name],
                                                  model)
                    futs[name] = jax_of[key]
                for name, fn in (("all_to_all", _jax_all_to_all),
                                 ("seq_parallel", _jax_seq_parallel),
                                 ("moe_ep", _jax_moe_ep)):
                    futs[name] = pool.submit(fn, inputs[name])
                ref = {k: f.result() for k, f in futs.items()}
        finally:
            results = g.join()
    finally:
        shutil.rmtree(kv_dir, ignore_errors=True)
    return inputs, results, ref


def _check(gang_run, name):
    """Every rank's result of check `name` (failing on a rank's error)."""
    _, results, _ = gang_run
    out = [r[name] for r in results]
    for rank, o in enumerate(out):
        assert "error" not in o, f"rank {rank}:\n{o['error']}"
    return out


# ---------------------------------------------------------------- layout

@pytest.mark.parametrize("spec", gang_checks.LAYOUT_SPECS, ids=repr)
def test_local_blocks_against_jax_layout(gang_run, spec):
    """Each rank's block of a [8, 4] array against JAX's
    devices_indices_map at the same mesh coordinate: equal for dims split
    over one axis; for a dim split over (tp, fsdp) the port orders the
    blocks by the mesh (fsdp major), JAX by the spec (tp major)."""
    inputs, _, _ = gang_run
    out = _check(gang_run, "layout")
    w = inputs["layout"]["w"]
    jm = _jax_mesh(**gang_checks.LAYOUT_MESH)
    index = NamedSharding(jm, JP(*spec)).devices_indices_map(w.shape)
    sizes = jmesh.MeshConfig(**gang_checks.LAYOUT_MESH).sizes(WORLD)
    for rank, o in enumerate(out):
        got = o[repr(spec)]
        assert got["round_trip"]
        coord = tuple(o["coordinate"])
        jax_block = w[index[jm.devices[coord]]]
        if spec == gang_checks.LAYOUT_SPECS[0]:
            # P(("tp", "fsdp"), None): block f * tp + t of 4 row blocks
            f, t = coord[1], coord[5]
            port = f * sizes["tp"] + t
            jax_idx = t * sizes["fsdp"] + f
            np.testing.assert_array_equal(got["local"],
                                          w[2 * port:2 * port + 2])
            np.testing.assert_array_equal(jax_block,
                                          w[2 * jax_idx:2 * jax_idx + 2])
        else:
            np.testing.assert_array_equal(got["local"], jax_block)


# ------------------------------------------------------------- shard_map

@pytest.mark.parametrize("what", ["psum", "all_gather", "ppermute",
                                  "axis_index_size", "grad"])
def test_shard_map_collectives_match_jax(gang_run, what):
    _, _, ref = gang_run
    outs, grad = ref["shard_map"]
    for o in _check(gang_run, "shard_map"):
        if what == "grad":
            np.testing.assert_allclose(o["grad"], grad, **TOL)
        else:
            i = ["psum", "all_gather", "ppermute",
                 "axis_index_size"].index(what)
            np.testing.assert_allclose(o["outs"][i], outs[i], **TOL)


# ----------------------------------------------------------- collective

def _reduce(op, xs):
    return jcol._REDUCERS[op](list(xs))


@pytest.mark.parametrize("what", [
    "pair", "allreduce_sum", "allreduce_product", "allreduce_min",
    "allreduce_max", "reduce", "allgather", "reducescatter", "in_place",
    "groups"])
def test_host_collectives_match_jax_reducers(gang_run, what):
    inputs, _, _ = gang_run
    out = _check(gang_run, "collective")
    xs = inputs["collective"]["per_rank"]
    if what == "pair":
        # tests/test_collective.py's expectations, by JAX's reducers
        for r in range(2):
            np.testing.assert_array_equal(
                out[r]["pair_allreduce"],
                _reduce("sum", [np.full((4,), float(k + 1), np.float32)
                                for k in range(2)]))
            np.testing.assert_array_equal(out[r]["pair_broadcast"],
                                          np.arange(3, dtype=np.float32))
            np.testing.assert_array_equal(out[r]["pair_broadcast_in_place"],
                                          np.arange(3, dtype=np.float32))
            assert [int(x[0]) for x in out[r]["pair_allgather"]] == [0, 1]
        total = _reduce("sum", [np.arange(4, dtype=np.float32) + k
                                for k in range(2)])
        np.testing.assert_array_equal(out[0]["pair_reducescatter"],
                                      total[:2])
        np.testing.assert_array_equal(out[1]["pair_reducescatter"],
                                      total[2:])
        np.testing.assert_array_equal(out[1]["pair_recv"], [42.0])
        assert all("pair_allreduce" not in o for o in out[2:])
    elif what.startswith("allreduce_"):
        op = what.split("_")[1]
        for o in out:
            np.testing.assert_array_equal(o[what], _reduce(op, xs))
    elif what == "reduce":
        for op in ("sum", "product", "min", "max"):
            for r, o in enumerate(out):
                want = _reduce(op, xs) if r == 2 else xs[r]
                np.testing.assert_array_equal(o[f"reduce_{op}"], want)
    elif what == "allgather":
        for o in out:
            assert len(o["allgather"]) == WORLD
            for got, want in zip(o["allgather"], xs):
                np.testing.assert_array_equal(got, want)
    elif what == "reducescatter":
        chunks = np.array_split(_reduce("sum", xs), WORLD)
        for r, o in enumerate(out):
            np.testing.assert_array_equal(o["reducescatter"], chunks[r])
    elif what == "in_place":
        for o in out:
            np.testing.assert_array_equal(o["allreduce_in_place"],
                                          _reduce("sum", xs))
    else:
        for r, o in enumerate(out):
            assert (o["rank"], o["size"], o["destroyed"]) == (r, WORLD, True)
            np.testing.assert_array_equal(o["again"], [6])


# -------------------------------------------------------------- pipeline

@pytest.mark.parametrize("case", ["fwd", "grad"])
@pytest.mark.parametrize("against", ["jax_pipeline", "sequential"])
def test_pipeline_matches_jax(gang_run, case, against):
    """The GPipe forward and its gradients (of sum(y^2) in the stacked
    stage params) against JAX's make_pipeline_fn at pp 4 and against
    the stages run one after another."""
    _, _, ref = gang_run
    r = ref[f"pipeline_{case}"]
    want_y, want_g = ((r["y"], r["grads"]) if against == "jax_pipeline"
                      else (r["seq_y"], r["seq_grads"]))
    for o in _check(gang_run, "pipeline"):
        np.testing.assert_allclose(o[case]["y"], want_y, **TOL)
        for got, want in zip(o[case]["grads"], want_g):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------- TrainStep

@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_mesh_train_step_matches_jax(gang_run, name):
    """3 steps of the mesh TrainStep + adamw(1e-3) against JAX's
    TrainStep with the same partition specs on the same mesh: every
    rank's losses, rank 0's gathered params and first moments; the
    moments stored in the params' layout."""
    _, _, ref = gang_run
    r = ref[name]
    out = _check(gang_run, name)
    for o in out:
        assert o["step"] == TRAIN_STEPS and o["same_layout"]
        np.testing.assert_allclose(o["losses"], r["losses"], **TRAIN_TOL)
    got_p, got_mu = out[0]["params"], out[0]["mu"]
    for got, want, tiny in zip(jax.tree.leaves(got_p),
                               jax.tree.leaves(r["params"]),
                               jax.tree.leaves(r["noise"])):
        np.testing.assert_allclose(got[~tiny], want[~tiny], **TRAIN_TOL)
        np.testing.assert_allclose(got[tiny], want[tiny],
                                   atol=TRAIN_STEPS * TRAIN_LR)
    for got, want in zip(jax.tree.leaves(got_mu), jax.tree.leaves(r["mu"])):
        np.testing.assert_allclose(got, want, **TRAIN_TOL)


def test_data_parallel_gradient_is_the_global_batch_mean(gang_run):
    """One SGD step (p -= g) of the mesh TrainStep on (dp 2, fsdp 2),
    each rank on its own rows: the parameter moves by the gradient of the
    global batch's mean loss, and the loss is that mean. The same step
    gathering with `full_tensor()` moves it by another amount, so this
    check fails a step that gathers that way."""
    inputs, _, _ = gang_run
    inp = inputs["dp_grad"]

    def loss(w):
        return jnp.mean(jnp.sum((inp["x"] @ w) ** 2, axis=-1))

    w0 = jnp.asarray(inp["w"])
    want_w = np.asarray(w0 - jax.grad(loss)(w0))
    for o in _check(gang_run, "dp_grad"):
        np.testing.assert_allclose(o["gathered"]["w"], want_w, **TOL)
        np.testing.assert_allclose(o["gathered"]["loss"], float(loss(w0)),
                                   **TOL)
        assert not np.allclose(o["full_tensor"]["w"], want_w, atol=1e-3)


def test_row_split_gathers_the_batch_in_block_order(gang_run):
    """`RowSplit` over (dp 2, fsdp 2), the mesh TrainStep's split of a
    batch of 8 rows: rank r (at dp r // 2, fsdp r % 2) holds rows 2r and
    2r + 1, as JAX lays the batch out on P(("dp", "fsdp")); `gather`
    joins the four blocks in that order on every rank; the gradient of
    every rank's sum(gather(block) * w) in a block is the four ranks'
    cotangents summed, 4 w on its rows."""
    inputs, _, _ = gang_run
    x, w = inputs["row_split"]["x"], inputs["row_split"]["w"]
    for r, o in enumerate(_check(gang_run, "row_split")):
        assert (o["block"], o["blocks"]) == (r, WORLD)
        np.testing.assert_array_equal(o["own"], x[2 * r:2 * r + 2])
        np.testing.assert_array_equal(o["rows"], x)
        np.testing.assert_allclose(o["grad"], 4 * w[2 * r:2 * r + 2],
                                   **TOL)


# ---------------------------------------- sequence and expert parallelism

def _hold(got, want, tol=TOL):
    np.testing.assert_allclose(got["y"], want["y"], **tol)
    assert len(got["grads"]) == len(want["grads"])
    for g, w in zip(got["grads"], want["grads"]):
        np.testing.assert_allclose(g, w, **tol)


@pytest.mark.parametrize("case", list(gang_checks.A2A_CASES))
def test_all_to_all_matches_jax(gang_run, case):
    """`all_to_all` against `jax.lax.all_to_all` under shard_map, untiled
    and tiled, at axis size 4 and 1: the exchanged blocks and the
    gradient (the inverse exchange)."""
    _, _, ref = gang_run
    want = ref["all_to_all"][case]
    for o in _check(gang_run, "all_to_all"):
        assert o[case]["y"].shape == want["y"].shape
        _hold(o[case], want, dict(atol=0, rtol=0))


@pytest.mark.parametrize("case", list(SEQ_CASES))
def test_seq_parallel_matches_jax(gang_run, case):
    """Ring and Ulysses attention over sp 4 (and over sp 1 on a dp 4
    mesh) against JAX's under shard_map: the output and the gradients
    of q, k and v; the output also against the JAX `mha_reference` of
    the whole sequence (tests/test_parallel.py:144)."""
    _, _, ref = gang_run
    want = ref["seq_parallel"][case]
    for o in _check(gang_run, "seq_parallel"):
        _hold(o[case], want)
        np.testing.assert_allclose(o[case]["y"], want["mha"], rtol=2e-4,
                                   atol=2e-4)


def test_ring_and_ulysses_agree(gang_run):
    """tests/test_parallel.py:161: ring and Ulysses attention on the same
    inputs give the same output, and the same gradients."""
    for o in _check(gang_run, "seq_parallel"):
        _hold(o["ring_causal"], o["agree_ulysses"],
              dict(rtol=2e-4, atol=2e-4))


def test_ulysses_refuses_heads_sp_does_not_divide(gang_run):
    for o in _check(gang_run, "seq_parallel"):
        assert o["indivisible"] == "heads 6 not divisible by sp axis size 4"


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_expert_parallel_matches_jax(gang_run, case):
    """The expert-parallel `moe_ffn` at ep 4 against JAX's under
    shard_map: the output and the gradients of x, gate_w, w_in and w_out,
    with and without dropped tokens; without drops also the dense layer
    on each rank's tokens (tests/test_parallel.py:85)."""
    _, _, ref = gang_run
    want = ref["moe_ep"][case]
    for o in _check(gang_run, "moe_ep"):
        _hold(o[case], want)
        if case == "no_drop":
            np.testing.assert_allclose(o[case]["y"], want["dense"],
                                       rtol=2e-4, atol=2e-4)


# ------------------------------------------------------------ rendezvous

def test_rendezvous_into_a_torch_job_matches_jax(gang_run):
    """initialize_torch_distributed through a file KV with slice ids: the
    slice info and process ids JAX's rendezvous gives, each rank's rank
    in the new group its process id, an all-reduce over it, a hybrid
    mesh over the slices equal to JAX's device array for the same
    slices, and a one-rank group."""
    out = _check(gang_run, "rendezvous")
    slice_map = {}
    for r, s in enumerate(SLICE_IDS):
        slice_map.setdefault(s, []).append(r)
    pids = jdist.slice_process_ids({s: sorted(rs) for s, rs in
                                    sorted(slice_map.items())})
    by_pid = {pids[r]: SLICE_IDS[r] for r in range(WORLD)}
    groups = {}
    for p, dev in enumerate(jax.devices()[:WORLD]):  # device id p = pid p
        groups.setdefault(by_pid[p], []).append(dev)
    jtopo = jms.SliceTopology(slices=tuple(tuple(groups[s])
                                           for s in sorted(groups)),
                              source="slice_index")
    want_mesh = np.vectorize(lambda d: d.id)(jms.make_hybrid_mesh(
        jms.HybridMeshConfig(**HYBRID), topology=jtopo).devices).tolist()
    for r, o in enumerate(out):
        info = o["info"]
        assert info["slices"] == {s: sorted(rs)
                                  for s, rs in sorted(slice_map.items())}
        assert info["process_ids"] == pids and info["slice_id"] == \
            SLICE_IDS[r]
        assert o["pid"] == pids[r]
        assert o["sum"] == sum(range(WORLD)) and o["one"] == 1
        assert o["mesh"] == want_mesh
