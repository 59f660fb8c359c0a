"""Parity of the port's parallel layer (ray_tpu_torch.parallel) with the
JAX package's, on the pure functions: no process group, no gang.

Mesh sizes, axis-name validation, FSDP spec inference, the models'
partition specs, the spec check that guards the mesh TrainStep, hybrid
mesh rank arrays against JAX's device-id arrays on the 8-device virtual
CPU mesh, DCN factors, and the KV rendezvous over a dict with threads.
Each is held against the JAX function on the same inputs: equal results,
or a ValueError from both. The multi-rank checks are in
tests/test_torch_parallel_gang.py.
"""
from __future__ import annotations

import threading
import types

import jax
import numpy as np
import optax
import pytest
from jax.sharding import PartitionSpec as JP

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu.parallel import distributed as jdist
from ray_tpu.parallel import fsdp as jfsdp
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import multislice as jms
from ray_tpu.train.trainer import TrainStep as JTrainStep
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.parallel import distributed as tdist
from ray_tpu_torch.parallel import fsdp as tfsdp
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import multislice as tms
from ray_tpu_torch.parallel.shardcheck import check_specs

# ------------------------------------------------------------ mesh sizes

SIZE_CASES = [
    (dict(), 8), (dict(dp=2, tp=4), 8), (dict(dp=-1, fsdp=2, tp=2), 8),
    (dict(dp=1, pp=4, tp=2), 8), (dict(dp=-1, sp=2, ep=2), 4),
    (dict(tp=3), 8), (dict(dp=-1, tp=-1), 8), (dict(dp=0, tp=8), 8),
    (dict(dp=2), 8), (dict(dp=-1, tp=3), 8), (dict(dp=2, tp=-2), 8),
]


def _outcome(fn):
    try:
        return "ok", fn()
    except ValueError as e:
        return "ValueError", str(e)


@pytest.mark.parametrize("axes,n", SIZE_CASES)
def test_mesh_config_sizes_match_jax(axes, n):
    assert _outcome(lambda: tmesh.MeshConfig(**axes).sizes(n)) == \
        _outcome(lambda: jmesh.MeshConfig(**axes).sizes(n))


@pytest.mark.parametrize("vals,total", [
    ({"dp": 2, "fsdp": -1, "pp": 1}, 4), ({"dp": 2, "fsdp": 2}, 4),
    ({"dp": 3, "fsdp": -1}, 4), ({"dp": -1, "pp": -1}, 2),
    ({"dp": 2, "pp": 1}, 4), ({"dp": -3}, 3)])
def test_solve_axis_sizes_matches_jax(vals, total):
    assert _outcome(lambda: tmesh.solve_axis_sizes(vals, total, "slice")) \
        == _outcome(lambda: jmesh.solve_axis_sizes(vals, total, "slice"))


@pytest.mark.parametrize("axes", [dict(dp=8), dict(dp=2, tp=4),
                                  dict(dp=-1, fsdp=2, tp=2),
                                  dict(fsdp=2, pp=2, tp=2)])
def test_mesh_rank_array_is_jax_device_array(cpu_mesh8, axes):
    jm = jmesh.make_mesh(jmesh.MeshConfig(**axes), devices=cpu_mesh8)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    got = tmesh.mesh_rank_array(tmesh.MeshConfig(**axes), range(8))
    assert got.shape == ids.shape and (got == ids).all()


@pytest.mark.parametrize("spec", [(), ("fsdp", "tp"), (("tp", "fsdp"), None),
                                  (None, ["dp", "fsdp"])])
def test_partition_spec_equals_jax_as_tuple(spec):
    assert tuple(tmesh.P(*spec)) == tuple(JP(*spec))


@pytest.mark.parametrize("specs", [
    jmesh.P("dp", "bogus"), {"a": jmesh.P(("fsdp", "tpx"))},
    [jmesh.P(None), jmesh.P("tp")], jmesh.P(("dp", "fsdp"), None)])
def test_validate_axis_names_matches_jax(cpu_mesh8, specs):
    jm = jmesh.make_mesh(jmesh.MeshConfig(dp=2, fsdp=2, tp=2),
                         devices=cpu_mesh8)
    port_mesh = types.SimpleNamespace(axis_names=tmesh.MESH_AXES)
    port_specs = jax.tree.map(lambda s: tmesh.P(*s), specs,
                              is_leaf=lambda s: isinstance(s, JP))
    want = _outcome(lambda: jmesh.validate_axis_names(jm, specs, "spec"))
    got = _outcome(lambda: tmesh.validate_axis_names(port_mesh, port_specs,
                                                     "spec"))
    assert got[0] == want[0]
    if want[0] == "ValueError":
        # the same axis named, the same axes listed
        assert got[1].split(" in spec")[0] == want[1].split(" in spec")[0]
        assert got[1].split(": ", 1)[1] == want[1].split(": ", 1)[1]


# ------------------------------------------------------------------ fsdp

FSDP_PARAMS = {"w": (512, 1024), "b": (8,), "emb": (1000, 512),
               "odd": (1001, 512)}


def _leaf_specs(tree, is_jax):
    """path -> spec tuple, for a JAX or a port spec tree."""
    if is_jax:
        flat = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda s: isinstance(s, JP))[0]
        return {jax.tree_util.keystr(p): tuple(s) for p, s in flat}
    out = {}

    def walk(t, path):
        if isinstance(t, tmesh.P):
            out[path] = tuple(t)
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}[{k!r}]")
        else:
            for i, v in enumerate(t):
                walk(v, f"{path}[{i}]")

    walk(tree, "")
    return out


@pytest.mark.parametrize("case", [
    dict(fsdp_size=4, min_size_to_shard=1024),
    dict(fsdp_size=4, base={"w": (None, "tp")}, min_size_to_shard=1024),
    dict(fsdp_size=4, base={"w": ("fsdp", None)}, min_size_to_shard=1024),
    dict(fsdp_size=1), dict(fsdp_size=8),
    dict(fsdp_size=2, axis_name="dp", min_size_to_shard=8)])
def test_infer_fsdp_specs_matches_jax(case):
    case = dict(case)
    n = case.pop("fsdp_size")
    base = case.pop("base", None)
    params = {k: np.zeros(s, np.float32) for k, s in FSDP_PARAMS.items()}
    if base is not None:
        params = {"w": params["w"]}
    jbase = None if base is None else {k: JP(*v) for k, v in base.items()}
    tbase = None if base is None else {k: tmesh.P(*v)
                                       for k, v in base.items()}
    want = jfsdp.infer_fsdp_specs(params, n, base_specs=jbase, **case)
    got = tfsdp.infer_fsdp_specs(params, n, base_specs=tbase, **case)
    assert _leaf_specs(got, False) == _leaf_specs(want, True)


# ------------------------------------------------------ models' specs

@pytest.mark.parametrize("family", ["gpt2", "llama"])
@pytest.mark.parametrize("size", ["tiny", "small"])
def test_partition_specs_equal_jax(family, size):
    jmod, tmod = (jgpt2, tgpt2) if family == "gpt2" else (jllama, tllama)
    jcfg_cls = jmod.GPT2Config if family == "gpt2" else jmod.LlamaConfig
    tcfg_cls = tmod.GPT2Config if family == "gpt2" else tmod.LlamaConfig
    fn = f"{family}_partition_specs"
    want = getattr(jmod, fn)(getattr(jcfg_cls, size)())
    got = getattr(tmod, fn)(getattr(tcfg_cls, size)())
    got_leaves, want_leaves = _leaf_specs(got, False), _leaf_specs(want,
                                                                   True)
    assert got_leaves == want_leaves and len(got_leaves) > 10


# ------------------------------------------------------------ spec check

def _tiny_gpt2_params():
    return jax.tree.map(np.asarray, jgpt2.gpt2_init(
        jgpt2.GPT2Config.tiny(), jax.random.PRNGKey(0)))


SPEC_CASES = {
    "valid_gpt2": (dict(dp=2, fsdp=2, tp=2), None, None),
    "unknown_axis": (dict(dp=8), {"w": ("fsdp", "tq")}, None),
    "non_dividing": (dict(dp=2, fsdp=4), {"w": ("fsdp", None)}, (6, 4)),
    "non_dividing_pair": (dict(fsdp=2, tp=4), {"w": (("tp", "fsdp"),)},
                          (12, 4)),
    "duplicate_axis": (dict(dp=2, fsdp=4), {"w": ("fsdp", "fsdp")}, None),
    "rank_exceeds": (dict(dp=2, tp=4), {"w": (None, None, "tp")}, None),
}


@pytest.mark.parametrize("name", list(SPEC_CASES))
def test_spec_check_raises_where_jax_init_state_raises(cpu_mesh8, name):
    axes, spec, shape = SPEC_CASES[name]
    if spec is None:
        params = _tiny_gpt2_params()
        jspecs = jgpt2.gpt2_partition_specs(jgpt2.GPT2Config.tiny())
        tspecs = tgpt2.gpt2_partition_specs(tgpt2.GPT2Config.tiny())
    else:
        params = {"w": np.zeros(shape or (8, 4), np.float32)}
        jspecs = {k: JP(*v) for k, v in spec.items()}
        tspecs = {k: tmesh.P(*v) for k, v in spec.items()}
    jm = jmesh.make_mesh(jmesh.MeshConfig(**axes), devices=cpu_mesh8)
    jstep = JTrainStep(lambda p, b: 0.0, optax.adamw(1e-3), jm, jspecs)
    want = _outcome(lambda: jstep.init_state(params))
    got = _outcome(lambda: check_specs(tspecs, params,
                                       tmesh.MeshConfig(**axes).sizes(8)))
    assert got[0] == want[0], (got, want)
    if want[0] == "ValueError":
        # the same parameter named under the same rule
        assert "params['w']" in got[1] and "params['w']" in want[1]
        rule = name.replace("_pair", "").replace("_", "-").replace(
            "rank-exceeds", "rank-exceeds-ndim")
        assert rule in got[1] and rule in want[1], (got[1], want[1])


# ----------------------------------------------------------- multislice

HYBRID_CASES = {
    "dcn_dp_tp": (dict(dp=-1, tp=2, dcn_dp=2), 2),
    "dcn_pp_fsdp": (dict(fsdp=4, dcn_pp=2), 2),
    "dcn_fill": (dict(tp=2, dcn_dp=-1), 2),
    "dcn_mismatch": (dict(dp=-1, dcn_dp=3), 2),
    "single_slice": (dict(dp=-1, tp=2, dcn_dp=2), None),
    "four_slices": (dict(dp=-1, dcn_dp=2, dcn_fsdp=2), 4),
    "dcn_fsdp_tp": (dict(fsdp=2, tp=2, dcn_fsdp=-1), 2),
}


@pytest.mark.parametrize("name", list(HYBRID_CASES))
def test_hybrid_rank_array_is_jax_device_array(cpu_mesh8, monkeypatch,
                                               name):
    cfg, slices = HYBRID_CASES[name]
    monkeypatch.delenv("MEGASCALE_NUM_SLICES", raising=False)
    if slices is None:
        monkeypatch.delenv("RAY_TPU_VIRTUAL_SLICES", raising=False)
    else:
        monkeypatch.setenv("RAY_TPU_VIRTUAL_SLICES", str(slices))
    want = _outcome(lambda: np.vectorize(lambda d: d.id)(
        jms.HybridMeshConfig(**cfg).build(cpu_mesh8).devices))
    topo = tms.discover_slice_topology(range(8), num_slices=slices)
    got = _outcome(lambda: tms.hybrid_rank_array(
        tms.HybridMeshConfig(**cfg), topology=topo))
    assert got[0] == want[0], (got, want)
    if want[0] == "ok":
        assert got[1].shape == want[1].shape and (got[1] == want[1]).all()
    else:
        assert got[1] == want[1]


def test_hybrid_rank_array_explicit_topology(cpu_mesh8):
    jtopo = jms.SliceTopology(slices=(tuple(cpu_mesh8[4:]),
                                      tuple(cpu_mesh8[:4])),
                              source="virtual")
    want = np.vectorize(lambda d: d.id)(jms.make_hybrid_mesh(
        jms.HybridMeshConfig(dp=-1, tp=2, dcn_dp=2),
        topology=jtopo).devices)
    ttopo = tms.SliceTopology(slices=((4, 5, 6, 7), (0, 1, 2, 3)),
                              source="virtual")
    got = tms.hybrid_rank_array(tms.HybridMeshConfig(dp=-1, tp=2, dcn_dp=2),
                                topology=ttopo)
    assert (got == want).all()
    with pytest.raises(ValueError, match="does not cover"):
        tms.hybrid_rank_array(tms.HybridMeshConfig(dp=-1, dcn_dp=2),
                              ranks=range(4), topology=ttopo)


class _FakeDev:
    def __init__(self, i, s):
        self.id, self.slice_index = i, s


@pytest.mark.parametrize("slice_ids", [[0, 0, 1, 1, 0, 0, 1, 1],
                                       [1, 1, 1, 1, 0, 0, 0, 0],
                                       [0] * 8, [0, 1, 2, 3] * 2,
                                       [0, 0, 0, 1, 1, 1, 1, 1]])
def test_slice_topology_from_slice_ids_matches_jax(monkeypatch, slice_ids):
    monkeypatch.delenv("RAY_TPU_VIRTUAL_SLICES", raising=False)
    monkeypatch.delenv("MEGASCALE_NUM_SLICES", raising=False)
    devs = [_FakeDev(i, s) for i, s in enumerate(slice_ids)]
    want = _outcome(lambda: jms.discover_slice_topology(devs))
    got = _outcome(lambda: tms.discover_slice_topology(
        range(8), slice_ids=slice_ids))
    assert got[0] == want[0]
    if want[0] == "ok":
        assert got[1].source == want[1].source
        assert got[1].slices == tuple(tuple(d.id for d in s)
                                      for s in want[1].slices)
    else:
        assert got[1] == want[1]


@pytest.mark.parametrize("slices", [3, 0, 4])
def test_virtual_slice_partition_matches_jax(cpu_mesh8, monkeypatch,
                                             slices):
    monkeypatch.setenv("RAY_TPU_VIRTUAL_SLICES", str(slices))
    want = _outcome(lambda: jms._partition(cpu_mesh8, slices, "virtual"))
    got = _outcome(lambda: tms.discover_slice_topology(
        range(8), num_slices=slices) if slices else
        tms._partition(list(range(8)), 0, "virtual"))
    assert got[0] == want[0]
    if want[0] == "ok":
        assert got[1].slices == tuple(tuple(d.id for d in s)
                                      for s in want[1].slices)
    else:
        assert got[1] == want[1]


@pytest.mark.parametrize("cfg,n,slices", [
    ("flat", 8, 2), ("flat", 8, 1), ("flat", 6, 2), ("flat_tp4", 8, 2),
    ("hybrid", 8, 2), ("flat_dp8", 8, 4)])
def test_dcn_axis_factors_match_jax(cfg, n, slices):
    def make(mod):
        return {"flat": lambda: mod.MeshConfig(dp=-1, tp=2),
                "flat_tp4": lambda: mod.MeshConfig(dp=2, tp=4),
                "flat_dp8": lambda: mod.MeshConfig(dp=8),
                "hybrid": lambda: mod.HybridMeshConfig(dp=-1, tp=2,
                                                       dcn_dp=2)}[cfg]()
    want = jms.dcn_axis_factors(make(jms), n, slices)
    got = tms.dcn_axis_factors(make(tms), n, slices)
    assert got == want


# ------------------------------------------------------------ rendezvous

class _DictKV:
    def __init__(self):
        self._d = {}
        self._lock = threading.Lock()

    def put(self, k, v, namespace="default"):
        with self._lock:
            self._d[(namespace, bytes(k))] = bytes(v)

    def get(self, k, namespace="default"):
        with self._lock:
            return self._d.get((namespace, bytes(k)))


def _gang_of_threads(fn, world):
    """fn(rank) on `world` threads: {rank: ("ok", result) or
    ("ValueError", message)}."""
    out = {}

    def run(rank):
        out[rank] = _outcome(lambda: fn(rank))

    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert all(not t.is_alive() for t in threads)
    return out


@pytest.mark.parametrize("slice_of", [
    {0: 1, 1: 1, 2: 0, 3: 0}, {0: None, 1: None, 2: None},
    {0: 0, 1: None, 2: 1}, {0: 0, 1: 1, 2: 0, 3: 1, 4: 2, 5: 2},
    {0: None, 1: 0}])
def test_rendezvous_slices_matches_jax(slice_of):
    world = len(slice_of)
    results = []
    for mod in (jdist, tdist):
        kv = _DictKV()
        results.append(_gang_of_threads(
            lambda r: mod.rendezvous_slices(kv.put, kv.get, "g", r, world,
                                            slice_of[r], timeout=10.0),
            world))
    want, got = results
    assert got == want
    if any(v[0] == "ValueError" for v in want.values()):
        assert all(v[0] == "ValueError" and "all-or-none" in v[1]
                   for v in got.values())


@pytest.mark.parametrize("slice_map", [
    {0: [2, 3], 1: [0, 1]}, {0: [0, 1], 1: [2, 3]}, {0: [0, 2], 1: [1, 3]},
    {5: [1, 4], 2: [0, 5], 7: [2, 3]}])
def test_slice_process_ids_match_jax(slice_map):
    assert tdist.slice_process_ids(slice_map) == \
        jdist.slice_process_ids(slice_map)


def test_rendezvous_coordinator_matches_jax():
    results = []
    for mod in (jdist, tdist):
        kv = _DictKV()
        results.append(_gang_of_threads(
            lambda r: mod.rendezvous_coordinator(kv.put, kv.get, "g", r,
                                                 timeout=10.0,
                                                 host="127.0.0.1"), 4))
    for res in results:
        addrs = {v for v in res.values()}
        assert len(addrs) == 1
        status, addr = addrs.pop()
        host, port = addr.split(":")
        assert status == "ok" and host == "127.0.0.1" and int(port) > 0
    kv = _DictKV()
    with pytest.raises(TimeoutError):
        tdist.rendezvous_coordinator(kv.put, kv.get, "g", 1, timeout=0.05)


def test_entry_points_default_to_cuda_and_raise_without_it():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    kv = _DictKV()
    for call in (
            lambda: tmesh.make_mesh(tmesh.MeshConfig(dp=1), ranks=[0]),
            lambda: tms.make_hybrid_mesh(tms.HybridMeshConfig(dp=1),
                                         ranks=[0]),
            lambda: tdist.initialize_torch_distributed(
                "g", 0, 1, kv.put, kv.get)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.mark.parametrize("stages,batch,micro", [
    (3, 16, 2),    # stacked params' leading axis is not mesh pp
    (4, 5, 1),     # global batch not divisible by the data axes
    (4, 16, 3),    # microbatches do not divide the per-shard batch
])
def test_pipeline_validation_messages_match_jax(cpu_mesh8, stages, batch,
                                                micro):
    """make_pipeline_fn's checks on the batch, the microbatches and the
    stacked axis raise JAX's messages, before any collective runs (the
    port's mesh here is a stand-in with the mesh's names and shape)."""
    import torch

    from ray_tpu.parallel import pipeline as jpipe
    from ray_tpu_torch.parallel import pipeline as tpipe

    axes = dict(dp=2, pp=4)
    jm = jmesh.make_mesh(jmesh.MeshConfig(**axes), devices=cpu_mesh8)
    sizes = tmesh.MeshConfig(**axes).sizes(8)
    port_mesh = types.SimpleNamespace(
        mesh_dim_names=tmesh.MESH_AXES,
        mesh=np.empty(tuple(sizes[a] for a in tmesh.MESH_AXES)))
    w = np.zeros((stages, 4, 4), np.float32)
    x = np.zeros((batch, 4), np.float32)
    want = _outcome(lambda: jpipe.make_pipeline_fn(
        lambda p, h: h, jm, num_microbatches=micro)((w,), x))
    got = _outcome(lambda: tpipe.make_pipeline_fn(
        lambda p, h: h, port_mesh, num_microbatches=micro)(
            (torch.from_numpy(w),), torch.from_numpy(x)))
    assert want[0] == "ValueError" and got == want


def test_fsdp_shardings_and_named_sharding_place_jax_specs(cpu_mesh8):
    """fsdp_shardings gives, leaf by leaf, the placements of JAX's
    fsdp_shardings' specs (Shard(d) on the mesh dim that splits dim d);
    named_sharding validates its axes as JAX's does."""
    from torch.distributed.tensor import Replicate, Shard

    axes = dict(dp=2, fsdp=4)
    jm = jmesh.make_mesh(jmesh.MeshConfig(**axes), devices=cpu_mesh8)
    sizes = tmesh.MeshConfig(**axes).sizes(8)
    port_mesh = types.SimpleNamespace(
        mesh_dim_names=tmesh.MESH_AXES,
        mesh=np.empty(tuple(sizes[a] for a in tmesh.MESH_AXES)))
    params = {k: np.zeros(s, np.float32) for k, s in FSDP_PARAMS.items()}
    want = jfsdp.fsdp_shardings(jm, params, min_size_to_shard=1024)
    got = tfsdp.fsdp_shardings(port_mesh, params, min_size_to_shard=1024)
    for k in params:
        spec = tuple(want[k].spec) + (None,) * 2
        dim = {a: d for d, a in enumerate(spec[:2]) if a is not None}
        assert got[k] == tuple(Shard(dim[a]) if a in dim else Replicate()
                               for a in tmesh.MESH_AXES), k
    assert tmesh.named_sharding(port_mesh, "dp", None) == \
        (Shard(0),) + (Replicate(),) * 5
    for mod, mesh in ((jmesh, jm), (tmesh, port_mesh)):
        with pytest.raises(ValueError, match="unknown mesh axis 'dq'"):
            mod.named_sharding(mesh, "dq")
