"""The port's checkpoints (ray_tpu_torch.train.checkpoint,
.async_checkpoint) against the JAX package's (ray_tpu.train), on the CPU.

The same numpy inputs from a seed go to both packages. Round trips are
held bit for bit (bf16 by its raw 16-bit patterns); the two packages'
files are read across: the port restores a checkpoint JAX's
`async_save` wrote on its 8-device CPU mesh, and JAX's own manifest
reader and `_LeafReader` read the port's blocks.
"""
from __future__ import annotations

import json
import os
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as JP

from ray_tpu.train import async_checkpoint as jac
from ray_tpu.train import checkpoint as jck
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models.convert import numpy_tensor
from ray_tpu_torch.train import async_checkpoint as tac
from ray_tpu_torch.train import checkpoint as tck
from ray_tpu_torch.train.optim import adamw
from ray_tpu_torch.tree import (tree_flatten, tree_leaves, tree_map,
                                tree_unflatten)


def _bits(x) -> np.ndarray:
    """A tensor's or array's values as comparable numpy: bf16 as its raw
    16-bit patterns."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    if x.dtype == ml_dtypes.bfloat16 or x.dtype.kind == "V":
        return x.view(np.uint16)
    return x


def _assert_bits_equal(got, want):
    g, w = _bits(got), _bits(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w)


def _numpy_tree(seed, bf16=False):
    rng = np.random.default_rng(seed)
    tree = {"w": rng.standard_normal((6, 5), dtype=np.float32),
            "blocks": [{"b": rng.standard_normal(5, dtype=np.float32),
                        "a": rng.integers(-9, 9, (3,), dtype=np.int32)}],
            "count": np.asarray(3, np.int64)}
    if bf16:
        tree["h"] = rng.standard_normal((4, 3)).astype(ml_dtypes.bfloat16)
    return tree


def _to_torch(tree):
    return tree_map(numpy_tensor, tree)  # keeps the key order


# ------------------------------------------------------- save_pytree

@pytest.mark.parametrize("bf16", [False, True], ids=["fp32_int", "bf16"])
def test_save_load_pytree_matches_jax(tmp_path, bf16):
    """The same tree through both packages' save_pytree: the two npz
    files hold the same arrays under the same leaf_{i} names (JAX's leaf
    order; bf16 as 2-byte records), and the port's load_pytree gives
    every leaf back bit for bit."""
    tree = _numpy_tree(1, bf16)
    jck.save_pytree(tree, str(tmp_path / "j"))
    tck.save_pytree(_to_torch(tree), str(tmp_path / "t"))
    jz = np.load(str(tmp_path / "j" / "state.npz"))
    tz = np.load(str(tmp_path / "t" / "state.npz"))
    assert sorted(jz.files) == sorted(tz.files)
    for k in jz.files:
        _assert_bits_equal(tz[k], jz[k])
    assert not os.path.exists(tmp_path / "t" / ".state.npz.tmp")
    loaded = tck.load_pytree(str(tmp_path / "t"))
    assert list(loaded) == list(tree)  # the saver's key order is kept
    for got, want in zip(jax.tree.leaves(loaded), jax.tree.leaves(tree)):
        _assert_bits_equal(got, want)


def test_checkpoint_directory_api(tmp_path):
    data = {"a": 1, "b": [2.5, "x"]}
    for mod in (jck, tck):
        ck = mod.Checkpoint.from_dict(data)
        assert ck.to_dict() == data
        with ck.as_directory() as d:
            assert d == ck.path
        dst = ck.to_directory(str(tmp_path / mod.__name__))
        assert mod.Checkpoint.from_directory(dst).to_dict() == data
        assert ck.to_directory() == ck.path


# --------------------------------------------------- CheckpointManager

MANAGER_CASES = {
    "recency_all": (None, None, "max"),
    "recency_keep2": (2, None, "max"),
    "loss_min_keep2": (2, "loss", "min"),
    "acc_max_keep3": (3, "acc", "max"),
    "loss_min_keep1": (1, "loss", "min"),
}


@pytest.mark.parametrize("case", list(MANAGER_CASES))
def test_checkpoint_manager_matches_jax(tmp_path, case):
    """One sequence of registrations (scores, a reserved index that
    registers late, a metric missing its score, numpy scalars) into both
    managers: the same kept indices, best, latest, listing and
    metrics.json."""
    keep, attr, order = MANAGER_CASES[case]
    rng = np.random.default_rng(4)
    seq = []
    for i in range(7):
        m = {"loss": float(rng.uniform(0, 2)), "acc": np.float32(
            rng.uniform()), "step": np.int64(i), "tag": object.__name__}
        if i == 3:
            m.pop("loss")
            m.pop("acc")
        seq.append(m)
    out = {}
    for mod in (jck, tck):
        root = tmp_path / mod.__name__
        mgr = mod.CheckpointManager(str(root / "ck"), num_to_keep=keep,
                                    score_attribute=attr, score_order=order)
        late = None
        for i, m in enumerate(seq):
            src = root / f"src{i}"
            src.mkdir(parents=True)
            (src / "x").write_text(str(i))
            if i == 1:
                late = (mod.Checkpoint(str(src)), m, mgr.reserve_index())
                continue
            mgr.register(mod.Checkpoint(str(src)), m)
        mgr.register(late[0], late[1], index=late[2])
        name = lambda c: os.path.basename(c.path)  # noqa: E731
        out[mod] = {
            "kept": sorted(os.listdir(root / "ck")),
            "best": name(mgr.best_checkpoint),
            "latest": name(mgr.latest_checkpoint),
            "list": [(name(c), {k: str(v) for k, v in m.items()})
                     for c, m in mgr.list_checkpoints()],
            "metrics": {d: json.loads((root / "ck" / d / "metrics.json")
                                      .read_text())
                        for d in os.listdir(root / "ck")},
            "x": {d: (root / "ck" / d / "x").read_text()
                  for d in os.listdir(root / "ck")}}
    assert out[tck] == out[jck]


def test_manager_copies_when_rename_fails(tmp_path, monkeypatch):
    """register() copies a checkpoint it cannot rename (another
    filesystem) and keeps the caller's handle valid."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "f").write_text("x")
    mgr = tck.CheckpointManager(str(tmp_path / "ck"))

    def no_rename(a, b):
        raise OSError("cross-device link")

    monkeypatch.setattr(tck.os, "replace", no_rename)
    ck = tck.Checkpoint(str(src))
    got = mgr.register(ck, {"step": 1})
    assert ck.path == got.path and (tmp_path / "ck" / "checkpoint_000000"
                                    / "f").read_text() == "x"
    assert not src.exists()


# --------------------------------------------------------- async_save

ROUND_TRIP_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16,
                     "fp16": torch.float16, "int32": torch.int32,
                     "int64": torch.int64}


def _torch_leaf(rng, shape, dtype):
    if dtype.is_floating_point:
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32)).to(dtype)
    return torch.from_numpy(rng.integers(-1000, 1000, shape)).to(dtype)


@pytest.mark.parametrize("name", list(ROUND_TRIP_DTYPES))
def test_async_round_trip_bit_exact(tmp_path, name):
    """async_save then restore, with like=None and with a template, bit
    for bit: [7, 5], [3] and 0-d tensors of the dtype, a Python int and a
    numpy scalar; the manifest names the dtype as JAX does."""
    dtype = ROUND_TRIP_DTYPES[name]
    rng = np.random.default_rng(5)
    tree = {"m": _torch_leaf(rng, (7, 5), dtype),
            "v": [_torch_leaf(rng, (3,), dtype),
                  _torch_leaf(rng, (), dtype)],
            "step": 11, "count": np.int32(4)}
    d = str(tmp_path / "ck")
    tac.async_save(d, tree).wait()
    with open(os.path.join(d, "manifest.0.json")) as f:
        man = json.load(f)
    assert man["process_count"] == 1
    jname = "bfloat16" if name == "bf16" else np.dtype(
        torch.empty((), dtype=dtype).numpy().dtype).name
    assert [man["leaves"][str(i)]["dtype"] for i in range(5)] == \
        ["int32", jname, "int64", jname, jname]
    whole = tac.restore(d)
    like = {"m": torch.zeros(7, 5, dtype=dtype),
            "v": [torch.zeros(3, dtype=dtype), torch.zeros((), dtype=dtype)],
            "step": 0, "count": 0}
    back = tac.restore(d, like=like)
    for k in ("m", "v"):
        for got, want in zip(tree_leaves(whole[k]), tree_leaves(tree[k])):
            _assert_bits_equal(got, want)
        for got, want in zip(tree_leaves(back[k]), tree_leaves(tree[k])):
            _assert_bits_equal(got, want)
    assert int(whole["step"]) == 11 and int(back["step"]) == 11
    assert isinstance(back["step"], np.ndarray) and \
        back["step"].dtype == np.int64
    assert back["count"].dtype == np.int32 and int(back["count"]) == 4


def test_restore_like_keeps_template_device_grad_and_dtype(tmp_path):
    """A template casts on its device (bf16 from fp32, fp16, the same
    dtype untouched) and passes on requires_grad; like JAX's
    test_restore_like_dtype_cast_template."""
    rng = np.random.default_rng(9)
    tree = {"a": _torch_leaf(rng, (16, 8), torch.float32),
            "b": _torch_leaf(rng, (8, 16), torch.float32),
            "c": _torch_leaf(rng, (4, 4), torch.float32)}
    d = str(tmp_path / "ck")
    tac.async_save(d, tree).wait()
    like = {"a": torch.zeros(16, 8, dtype=torch.bfloat16),
            "b": torch.zeros(8, 16, requires_grad=True),
            "c": torch.zeros(4, 4, dtype=torch.float16)}
    out = tac.restore(d, like=like)
    assert out["a"].dtype == torch.bfloat16 and \
        out["c"].dtype == torch.float16 and out["b"].dtype == torch.float32
    assert out["b"].requires_grad and out["b"].is_leaf
    assert not out["a"].requires_grad
    for k in tree:
        _assert_bits_equal(out[k], tree[k].to(like[k].dtype))
    with pytest.raises(ValueError, match="shape"):
        tac.restore(d, like={**like, "c": torch.zeros(4, 5)})
    with pytest.raises(ValueError, match="leaves"):
        tac.restore(d, like={"a": like["a"]})


def test_save_returns_before_write_completes(tmp_path):
    """save() returns once the leaves are copied, before its files are
    written (a 0.5 s writer delay); wait() returns after them."""
    w = tac.AsyncCheckpointer()
    w._test_write_delay = 0.5
    state = {"w": torch.randn(64, 64)}
    t0 = time.monotonic()
    ck = w.save(str(tmp_path / "ck"), state)
    assert time.monotonic() - t0 < 0.2
    assert not ck.committed
    ck.wait()
    assert ck.committed and time.monotonic() - t0 >= 0.5
    assert ck.write_s is not None and ck.write_s >= 0
    _assert_bits_equal(tac.restore(str(tmp_path / "ck"))["w"], state["w"])


def test_expedite_cuts_the_write_delay_short(tmp_path):
    w = tac.AsyncCheckpointer()
    w._test_write_delay = 30.0
    ck = w.save(str(tmp_path / "ck"), {"w": torch.ones(3)})
    tac.expedite_all()
    ck.future.result(timeout=10)
    w.wait_until_finished()


def test_snapshot_before_return_survives_in_place_adamw(tmp_path):
    """The port's AdamW updates params and moments in place (its stand-in
    for JAX's donation). A step taken right after save() must not reach
    the files: they hold the pre-step bits, fp32 and bf16."""
    rng = np.random.default_rng(2)
    opt = adamw(1e-1)
    for dtype in (torch.float32, torch.bfloat16):
        params = {"w": _torch_leaf(rng, (8, 100), dtype),
                  "b": _torch_leaf(rng, (100,), dtype)}
        state = {"params": params, "opt_state": opt.init(params), "step": 0}
        opt.update_([torch.ones_like(p) for p in tree_leaves(params)],
                    state["opt_state"], params)
        before = tree_map(lambda t: t.clone() if isinstance(
            t, torch.Tensor) else t, state)
        w = tac.AsyncCheckpointer()
        w._test_write_delay = 0.3
        # the writer is held by an earlier save's delay, so this save's
        # files are written after the step below
        w.save(str(tmp_path / f"{dtype}-first"), {"x": torch.ones(1)})
        d = str(tmp_path / str(dtype))
        ck = w.save(d, state)
        opt.update_([torch.ones_like(p) for p in tree_leaves(params)],
                    state["opt_state"], params)
        assert not torch.equal(params["w"], before["params"]["w"])
        ck.wait()
        got = tac.restore(d)
        for g, want in zip(jax.tree.leaves(got), jax.tree.leaves(before)):
            _assert_bits_equal(g, torch.as_tensor(want))


def test_commit_hooks_run_before_wait_and_inline_after(tmp_path):
    w = tac.AsyncCheckpointer()
    w._test_write_delay = 0.2
    seen = []
    ck = w.save(str(tmp_path / "ck"), {"w": torch.ones(2)})
    ck.add_commit_hook(lambda c: seen.append(("hook", c.committed)))
    ck.add_commit_hook(lambda c: 1 / 0)  # logged, the save still commits
    ck.wait()
    assert seen == [("hook", False)]
    ck.add_commit_hook(lambda c: seen.append(("late", c.committed)))
    assert seen[-1] == ("late", True)


def test_torn_checkpoint_detected(tmp_path):
    d = tmp_path / "ck"
    tac.async_save(str(d), {"w": torch.ones(4)}).wait()
    os.remove(d / "commit.0")
    with pytest.raises(ValueError, match="torn"):
        tac.restore(str(d))
    with pytest.raises(FileNotFoundError):
        tac.restore(str(tmp_path / "nothing"))


def test_missing_and_stale_manifests(tmp_path):
    """A manifest naming 2 processes without process 1's is torn; a
    stale manifest of a process past process_count is ignored."""
    d = tmp_path / "ck"
    tac.async_save(str(d), {"w": torch.ones(4)}).wait()
    (d / "manifest.3.json").write_text("{}")  # an older, larger world
    _assert_bits_equal(tac.restore(str(d))["w"], torch.ones(4))
    man = json.loads((d / "manifest.0.json").read_text())
    man["process_count"] = 2
    (d / "manifest.0.json").write_text(json.dumps(man))
    with pytest.raises(ValueError, match="manifest of process 1/2"):
        tac.restore(str(d))


def test_overwrite_crash_reads_torn_not_mixed(tmp_path):
    """A second save into the same directory that dies after removing
    the commit marker reads as torn; a later good save heals it."""
    d = str(tmp_path / "ck")
    state = {"w": torch.arange(12.0).reshape(3, 4)}
    tac.async_save(d, state).wait()
    w = tac.AsyncCheckpointer()

    def dies_after_invalidate(directory, snaps, structure):
        os.remove(os.path.join(directory, "commit.0"))
        raise RuntimeError("simulated crash mid-write")

    w._write_one = dies_after_invalidate
    ck = w.save(d, {"w": state["w"] + 1})
    with pytest.raises(RuntimeError, match="simulated"):
        ck.wait()
    with pytest.raises(ValueError, match="torn"):
        tac.restore(d)
    tac.async_save(d, state).wait()
    _assert_bits_equal(tac.restore(d)["w"], state["w"])


# ---------------------------------------------------------- leaf order

def test_leaf_order_matches_jax_flatten_on_gpt2_tiny():
    """`tree_flatten` orders GPT-2 tiny's parameters, and a TrainStep
    state around them, as `jax.tree.flatten` does (dict keys sorted),
    where `tree_leaves` keeps insertion order; the structure rebuilds the
    tree with its own key order."""
    params = tgpt2.gpt2_init(tgpt2.GPT2Config.tiny(),
                             torch.Generator().manual_seed(0), device="cpu")
    opt = adamw(1e-3)
    state = {"params": params, "opt_state": opt.init(params), "step": 3}
    for tree in (params, state):
        leaves, structure = tree_flatten(tree)
        as_np = jax.tree.map(lambda t: _bits(t) if isinstance(
            t, torch.Tensor) else np.asarray(t), tree)
        want = jax.tree.leaves(as_np)
        assert len(leaves) == len(want)
        for got, w in zip(leaves, want):
            _assert_bits_equal(torch.as_tensor(got), w)
        back = tree_unflatten(structure, leaves)
        assert list(back) == list(tree)
        assert all(a is b for a, b in zip(tree_leaves(back),
                                          tree_leaves(tree)))
    assert [k for k in params] != sorted(params)  # the orders do differ
    assert tree_flatten({"a": None, "b": (1, [2])})[0] == \
        jax.tree.leaves({"a": None, "b": (1, [2])})


# ------------------------------------------------------ across packages

JSPECS = {
    "w_fsdp": ((16, 8), JP(("dp", "fsdp"), None)),
    "w_tp": ((8, 16), JP(None, "fsdp")),
    "w_rep": ((4, 4), JP(None, None)),
    "w_bf16": ((16, 8), JP("fsdp", None)),
}


def _jax_mesh(axes):
    n = int(np.prod([s for _, s in axes]))
    return Mesh(np.array(jax.devices()[:n]).reshape([s for _, s in axes]),
                [a for a, _ in axes])


def _jax_state(seed):
    mesh = _jax_mesh([("dp", 2), ("fsdp", 4)])
    rng = np.random.default_rng(seed)
    out, host = {}, {}
    for name, (shape, spec) in JSPECS.items():
        arr = rng.standard_normal(shape).astype(np.float32)
        if name == "w_bf16":
            arr = arr.astype(ml_dtypes.bfloat16)
        host[name] = arr
        out[name] = jax.device_put(arr, NamedSharding(mesh, spec))
    out["step"] = jnp.int32(7)
    host["step"] = np.asarray(7, np.int32)
    return out, host


@pytest.mark.parametrize("seed", [0, 1])
def test_port_restores_jax_sharded_checkpoint(tmp_path, seed):
    """A checkpoint JAX's async_save wrote on its (dp 2, fsdp 4) CPU mesh
    (tests/test_async_checkpoint.py's specs plus a bf16 leaf, blocks
    written by replica 0 only) restores into plain tensors of a template,
    bit for bit, without reading JAX's treedef."""
    state, host = _jax_state(seed)
    d = str(tmp_path / "ck")
    jac.async_save(d, state).wait()
    like = {"w_fsdp": torch.zeros(16, 8), "w_tp": torch.zeros(8, 16),
            "w_rep": torch.zeros(4, 4),
            "w_bf16": torch.zeros(16, 8, dtype=torch.bfloat16), "step": 0}
    got = tac.restore(d, like=like)
    for k in JSPECS:
        _assert_bits_equal(got[k], host[k])
    assert got["step"].dtype == np.int32 and int(got["step"]) == 7


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_jax_reader_reads_port_files(tmp_path, bf16):
    """JAX's `_load_manifests` and `_LeafReader` read the port's blocks to
    the same bits, whole and by a slice across blocks. (JAX's own reader
    cannot cast 2-byte records to its bfloat16, "No cast function
    available", so its bf16 leaves are read through a loader that views
    the records as ml_dtypes' bfloat16.)"""
    tree = _numpy_tree(6, bf16)
    d = str(tmp_path / "ck")
    tac.async_save(d, _to_torch(tree)).wait()
    manifests = jac._load_manifests(d)
    want = jax.tree.leaves(tree)
    assert len(manifests[0]["leaves"]) == len(want)
    for i, w in enumerate(want):
        meta = manifests[0]["leaves"][str(i)]
        loader = None
        if meta["dtype"] == "bfloat16":
            def loader(sh):
                return np.load(os.path.join(d, sh["file"]),
                               mmap_mode="r").view(ml_dtypes.bfloat16)
        r = jac._LeafReader(d, tuple(meta["shape"]),
                            np.dtype(meta["dtype"]), meta["shards"],
                            loader=loader)
        _assert_bits_equal(r.read(tuple(slice(0, n) for n in r.shape)), w)
        if w.ndim == 2:
            _assert_bits_equal(r.read((slice(1, 4), slice(2, 3))),
                               w[1:4, 2:3])
