"""Async sharded checkpointing (port of ray_tpu/train/async_checkpoint.py),
in the JAX package's file format.

- ``save()`` copies this process's share of every leaf to host memory
  that nothing else aliases (a clone on the CPU, a device-to-host copy
  from the card) before it returns, then hands the writes to a
  background thread and returns an :class:`AsyncCheckpoint`. The
  snapshot is what makes the port's in-place AdamW step safe: the next
  step may overwrite the tensors the moment save() returns.
- Each process writes only its own blocks (``leaf{i}_p{proc}_s{j}.npy``),
  a manifest (``manifest.{proc}.json``) and, last, a commit marker
  (``commit.{proc}``); restore requires every process's marker, so a torn
  save is detected, never half loaded. "Process" is the rank in the
  default process group (world 1 without one). Leaf i is the i-th leaf in
  JAX's order (`tree.tree_flatten`), and ``treedef.pkl`` holds the
  port's own structure, so the two packages read each other's blocks.
- A DTensor leaf contributes the local block of every rank whose
  coordinate is 0 on each mesh dim where it is replicated (JAX's
  ``replica_id == 0``), indexed by its true global offset in DTensor's
  block order, so the blocks cover the leaf exactly once.
- ``restore(like=)`` reshards onto a possibly different mesh: each rank
  reads only the slice its block of the template needs, from mmap'd
  block files.
- bf16 blocks are the 2-byte records JAX writes (numpy ``V2``), named
  "bfloat16" in the manifest, assembled as uint16 and viewed as
  ``torch.bfloat16``: nothing needs ml_dtypes.
"""
from __future__ import annotations

import glob
import json
import logging
import os
import pickle
import threading
import time
import weakref
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from ..tree import tree_flatten, tree_unflatten
from .checkpoint import (Checkpoint, dtype_name, host_array, raw_view,
                         storage_dtype, to_tensor)

# Live writers, for the preemption grace flow (which waits for the
# actor runtime): a "checkpoint now" notice expedites every in-flight
# save in the process.
_live_writers: "weakref.WeakSet[AsyncCheckpointer]" = weakref.WeakSet()


def expedite_all() -> None:
    """Make every live AsyncCheckpointer in this process commit its
    queued saves as fast as possible (drops test delays); idempotent."""
    for writer in list(_live_writers):
        writer.expedite()


_MANIFEST = "manifest.{proc}.json"
_COMMIT = "commit.{proc}"
_TREEDEF = "treedef.pkl"


def _process() -> Tuple[int, int]:
    """(rank, world size) in the default process group; (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class AsyncCheckpoint(Checkpoint):
    """A Checkpoint whose bytes may still be in flight. ``wait()`` blocks
    until the write is committed (re-raising write errors); passing one
    to ``train.report`` defers manager registration until commit.
    ``write_s`` is the writer thread's time for its files, once
    committed."""

    def __init__(self, path: str):
        super().__init__(path)
        self.future: "Future[None]" = Future()
        self.write_s: Optional[float] = None
        self._hooks: List[Callable[["AsyncCheckpoint"], None]] = []
        self._hook_lock = threading.Lock()

    @property
    def committed(self) -> bool:
        return self.future.done()

    def wait(self) -> "AsyncCheckpoint":
        self.future.result()
        return self

    def add_commit_hook(self, fn: Callable[["AsyncCheckpoint"], None]
                        ) -> None:
        """Run ``fn(self)`` once the write is committed: on the writer
        thread, strictly before ``wait()`` returns; inline if already
        committed. (The future resolves under _hook_lock, so a hook added
        while done() is False is never lost.)"""
        with self._hook_lock:
            if not self.future.done():
                self._hooks.append(fn)
                return
        fn(self)

    def _run_hooks_and_resolve(self, error: Optional[BaseException]) -> None:
        while True:
            with self._hook_lock:
                hooks, self._hooks = self._hooks, []
                if not hooks:
                    # resolve under the lock: closes the window where a
                    # concurrent add_commit_hook appends after the swap
                    # but before done() flips
                    if error is not None:
                        self.future.set_exception(error)
                    else:
                        self.future.set_result(None)
                    return
            if error is None:
                for fn in hooks:
                    try:
                        fn(self)
                    except Exception:  # noqa: BLE001 — a bad hook ≠ bad save
                        logging.getLogger("ray_tpu_torch.train").exception(
                            "async-checkpoint commit hook failed for %s "
                            "(checkpoint is on disk but NOT registered)",
                            self.path)


def _block(t: torch.Tensor) -> np.ndarray:
    """A host copy of `t` that nothing else aliases, as numpy."""
    return host_array(t.detach().to("cpu", copy=True))


def _leaf_snapshots(leaf: Any) -> Tuple[Dict[str, Any],
                                        List[Tuple[tuple, np.ndarray]]]:
    """(meta, [(index, host_array)]) for this process's share of a leaf:
    a DTensor's local block where this rank holds its replica 0, a plain
    tensor or any other value whole from process 0. `index` is one
    (start, stop, step) per dim."""
    if isinstance(leaf, DTensor):
        shape = tuple(leaf.shape)
        meta = {"shape": list(shape), "dtype": dtype_name(leaf.dtype)}
        mesh = leaf.device_mesh
        coord = mesh.get_coordinate()
        if coord is None or any(isinstance(p, Replicate) and c != 0
                                for p, c in zip(leaf.placements, coord)):
            return meta, []
        if not all(isinstance(p, (Replicate, Shard))
                   for p in leaf.placements):
            raise ValueError(f"cannot save a leaf with placements "
                             f"{leaf.placements}")
        local = leaf.to_local()
        lshape, offset = compute_local_shape_and_global_offset(
            shape, mesh, leaf.placements)
        if tuple(lshape) != tuple(local.shape):
            raise ValueError(f"local block {tuple(local.shape)} is not the "
                             f"{tuple(lshape)} its placements give")
        idx = tuple((o, o + n, 1) for o, n in zip(offset, lshape))
        return meta, [(idx, _block(local))]
    rank0 = _process()[0] == 0
    if isinstance(leaf, torch.Tensor):
        meta = {"shape": list(leaf.shape), "dtype": dtype_name(leaf.dtype)}
        arr = _block(leaf) if rank0 else None
    else:
        arr = np.array(leaf)  # a copy: a numpy leaf may change after save
        meta = {"shape": list(arr.shape), "dtype": arr.dtype.name}
    if not rank0:
        return meta, []
    return meta, [(tuple((0, d, 1) for d in meta["shape"]), arr)]


class AsyncCheckpointer:
    """Background writer for sharded checkpoints. One writer thread
    serializes saves in submission order (so deferred manager
    registrations happen in order too)."""

    def __init__(self):
        self._queue: List[Tuple[AsyncCheckpoint, list, Any]] = []
        self._cv = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._test_write_delay = 0.0  # test knob: per-save artificial I/O
        self._expedited = False
        _live_writers.add(self)

    def expedite(self) -> None:
        """Commit queued saves promptly: skip test delays (an in-progress
        delay is cut short)."""
        with self._cv:
            self._expedited = True
            self._cv.notify_all()

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._write_loop,
                                            daemon=True,
                                            name="async-ckpt-writer")
            self._thread.start()

    def save(self, directory: str, tree: Any) -> AsyncCheckpoint:
        """Snapshot now, write later. Returns once every leaf is copied to
        host memory; the returned checkpoint's ``wait()`` / ``future``
        tracks the disk write."""
        leaves, structure = tree_flatten(tree)
        snaps = []
        for i, leaf in enumerate(leaves):
            meta, shards = _leaf_snapshots(leaf)
            snaps.append((i, meta, shards))
        ckpt = AsyncCheckpoint(os.path.abspath(directory))
        with self._cv:
            self._queue.append((ckpt, snaps, structure))
            self._ensure_thread()
            self._cv.notify()
        return ckpt

    def wait_until_finished(self) -> None:
        with self._cv:
            while self._queue:
                self._cv.wait(0.05)

    def _write_loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue:
                    self._cv.wait(0.2)
                ckpt, snaps, structure = self._queue[0]
            error: Optional[BaseException] = None
            try:
                t0 = time.perf_counter()
                self._write_one(ckpt.path, snaps, structure)
                ckpt.write_s = time.perf_counter() - t0
                if self._test_write_delay:
                    # poll-sleep so expedite() can cut a delay short
                    deadline = time.monotonic() + self._test_write_delay
                    while time.monotonic() < deadline \
                            and not self._expedited:
                        time.sleep(0.01)
            except BaseException as e:  # noqa: BLE001 — surface via future
                error = e
            ckpt._run_hooks_and_resolve(error)
            with self._cv:
                self._queue.pop(0)
                self._cv.notify_all()

    def _write_one(self, directory: str, snaps: list, structure: Any
                   ) -> None:
        proc, nproc = _process()
        os.makedirs(directory, exist_ok=True)
        # Overwriting an existing checkpoint: invalidate OUR commit marker
        # before touching any block, and clear our stale files: a crash
        # mid-write must read as torn, never as the old checkpoint mixed
        # with new blocks. (Each process touches only its own files;
        # restore ignores manifests >= process_count.)
        try:
            os.remove(os.path.join(directory, _COMMIT.format(proc=proc)))
        except FileNotFoundError:
            pass
        for stale in glob.glob(os.path.join(directory,
                                            f"leaf*_p{proc}_s*.npy")):
            os.remove(stale)
        manifest: Dict[str, Any] = {"process": proc, "process_count": nproc,
                                    "leaves": {}}
        for leaf_idx, meta, shards in snaps:
            entries = []
            for shard_idx, (index, host_arr) in enumerate(shards):
                fname = f"leaf{leaf_idx}_p{proc}_s{shard_idx}.npy"
                with open(os.path.join(directory, fname), "wb") as f:
                    np.save(f, host_arr)
                entries.append({"file": fname,
                                "index": [list(t) for t in index]})
            manifest["leaves"][str(leaf_idx)] = {**meta, "shards": entries}
        if proc == 0:
            with open(os.path.join(directory, _TREEDEF), "wb") as f:
                pickle.dump(structure, f, protocol=5)
        tmp = os.path.join(directory, f".manifest.{proc}.tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(directory,
                                     _MANIFEST.format(proc=proc)))
        # commit marker last: a restore that sees it knows every block
        # and the manifest of this process are fully on disk
        with open(os.path.join(directory, _COMMIT.format(proc=proc)),
                  "w") as f:
            f.write("ok")


_default = AsyncCheckpointer()


def async_save(directory: str, tree: Any) -> AsyncCheckpoint:
    """Save on a shared default writer."""
    return _default.save(directory, tree)


def wait_until_finished() -> None:
    _default.wait_until_finished()


def _load_manifests(directory: str) -> List[Dict[str, Any]]:
    head = os.path.join(directory, _MANIFEST.format(proc=0))
    if not os.path.exists(head):
        raise FileNotFoundError(f"no checkpoint manifests in {directory}")
    with open(head) as f:
        first = json.load(f)
    nproc = int(first["process_count"])
    # read EXACTLY processes 0..nproc-1: a stale manifest.{>=nproc}.json
    # left by an earlier larger-world save must not leak old blocks in
    manifests = [first]
    for p in range(1, nproc):
        path = os.path.join(directory, _MANIFEST.format(proc=p))
        if not os.path.exists(path):
            raise ValueError(
                f"checkpoint {directory} is torn: manifest of process "
                f"{p}/{nproc} is missing")
        with open(path) as f:
            manifests.append(json.load(f))
    for p in range(nproc):
        if not os.path.exists(os.path.join(directory,
                                           _COMMIT.format(proc=p))):
            raise ValueError(
                f"checkpoint {directory} is torn: process {p}/{nproc} "
                "never committed its shards")
    return manifests


class _LeafReader:
    """Assembles any slice of one saved leaf from its (possibly many,
    possibly overlapping) blocks, reading only the bytes the slice
    touches.

    `loader(shard) -> np.ndarray` materializes one block; the default
    mmaps the checkpoint's .npy file, so a reshard never loads untouched
    bytes. The weight fabric (a later port) passes a loader that fetches
    the block from its producer. `dtype` is the assembly dtype
    (`checkpoint.storage_dtype`: uint16 for bf16); raw 2-byte records are
    viewed as it, not converted."""

    def __init__(self, directory: Optional[str], shape: tuple, dtype,
                 shards: List[Dict[str, Any]],
                 loader: Optional[Callable[[Dict[str, Any]],
                                           np.ndarray]] = None):
        self.directory = directory
        self.shape = shape
        self.dtype = np.dtype(dtype)
        self.shards = shards
        self._loader = loader or self._load_mmap

    def _load_mmap(self, shard: Dict[str, Any]) -> np.ndarray:
        return np.load(os.path.join(self.directory, shard["file"]),
                       mmap_mode="r")

    def read(self, index: Tuple[slice, ...]) -> np.ndarray:
        bounds = tuple(sl.indices(dim)[:2]
                       for sl, dim in zip(index, self.shape))
        out_shape = tuple(b - a for a, b in bounds)
        out = np.empty(out_shape, dtype=self.dtype)
        # coverage mask: replicated blocks overlap, and a later copy of
        # an already-filled region is not LOADED at all (block order is
        # the placement preference)
        mask = np.zeros(out_shape, dtype=bool)
        want = int(np.prod(out_shape)) if out_shape else 1
        for sh in self.shards:
            sidx = [tuple(t) for t in sh["index"]]
            inter = []
            for (a, b), (sa, sb, _step) in zip(bounds, sidx):
                lo, hi = max(a, sa), min(b, sb)
                if lo >= hi:
                    inter = None
                    break
                inter.append((lo, hi, sa, a))
            if inter is None and self.shape:
                continue
            if self.shape:
                dst = tuple(slice(lo - a, hi - a)
                            for lo, hi, _, a in inter)
                if mask[dst].all():
                    continue  # fully covered: skip the load entirely
            arr = raw_view(self._loader(sh), self.dtype)
            if not self.shape:  # scalar
                return np.array(arr, dtype=self.dtype)
            src = tuple(slice(lo - sa, hi - sa) for lo, hi, sa, _ in inter)
            out[dst] = arr[src]
            mask[dst] = True
        filled = int(mask.sum())
        if filled < want:
            raise ValueError(
                f"checkpoint shards do not cover requested slice {index} "
                f"of leaf with shape {self.shape} ({filled}/{want} elems)")
        return out


def _full(r: _LeafReader) -> np.ndarray:
    return r.read(tuple(slice(0, d) for d in r.shape))


def _check_shape(tmpl: torch.Tensor, r: _LeafReader) -> None:
    if tuple(tmpl.shape) != r.shape:
        raise ValueError(f"template leaf shape {tuple(tmpl.shape)} != "
                         f"saved shape {r.shape}")


def _tensor_like(arr: np.ndarray, name: str, tmpl: torch.Tensor
                 ) -> torch.Tensor:
    """`arr` on the template's device, cast there to its dtype."""
    t = to_tensor(arr, name).to(tmpl.device)
    return t if t.dtype == tmpl.dtype else t.to(tmpl.dtype)


def materialize_like(readers: List[_LeafReader], names: List[str],
                     like: Any) -> Any:
    """Rebuild a tree from per-leaf readers (`names`: each leaf's
    manifest dtype), leaf i the template's i-th leaf in JAX's order, with
    the template's layout:
    - a DTensor template leaf reads only this rank's block of it and is
      built with `DTensor.from_local` on the template's mesh,
      placements, shape and stride;
    - a plain tensor template leaf is read whole onto its device;
    - any other template leaf gives the numpy value.
    A tensor takes the template's dtype (cast on its device) and
    requires_grad. The tree keeps the template's structure."""
    like_leaves, like_structure = tree_flatten(like)
    if len(like_leaves) != len(readers):
        raise ValueError(f"template has {len(like_leaves)} leaves, the "
                         f"checkpoint {len(readers)}")
    out_leaves = []
    for r, name, tmpl in zip(readers, names, like_leaves):
        if isinstance(tmpl, DTensor):
            _check_shape(tmpl, r)
            mesh, placements = tmpl.device_mesh, tmpl.placements
            lshape, offset = compute_local_shape_and_global_offset(
                r.shape, mesh, placements)
            block = r.read(tuple(slice(o, o + n)
                                 for o, n in zip(offset, lshape)))
            local = _tensor_like(block, name, tmpl.to_local())
            leaf = DTensor.from_local(local, mesh, placements,
                                      run_check=False, shape=tmpl.shape,
                                      stride=tmpl.stride())
            out_leaves.append(leaf.requires_grad_(tmpl.requires_grad))
        elif isinstance(tmpl, torch.Tensor):
            _check_shape(tmpl, r)
            out_leaves.append(_tensor_like(_full(r), name, tmpl.detach())
                              .requires_grad_(tmpl.requires_grad))
        else:
            out_leaves.append(_full(r))
    return tree_unflatten(like_structure, out_leaves)


def restore(directory: str, *, like: Any = None) -> Any:
    """Load a checkpoint saved by :func:`async_save` / ``save``, or by the
    JAX package's (leaf i is the i-th leaf in JAX's order in both).

    ``like=None``: every leaf comes back whole as a CPU tensor (numpy in
    the JAX package; numpy holds no bf16), in the tree of the port's
    ``treedef.pkl``. ``like=template``: the template gives the tree
    (``treedef.pkl`` is not read, so a JAX checkpoint restores without
    JAX) and must have the saved leaves; its DTensor leaves are restored
    with the template's mesh and placements, each rank reading only its
    own block, so the source and target meshes may differ freely; see
    :func:`materialize_like`.
    """
    manifests = _load_manifests(directory)
    readers: List[_LeafReader] = []
    names: List[str] = []
    for i in range(len(manifests[0]["leaves"])):
        metas = [m["leaves"].get(str(i)) for m in manifests]
        meta = next(m for m in metas if m is not None)
        shards = [s for m in metas if m is not None for s in m["shards"]]
        names.append(meta["dtype"])
        readers.append(_LeafReader(directory, tuple(meta["shape"]),
                                   storage_dtype(meta["dtype"]), shards))
    if like is not None:
        return materialize_like(readers, names, like)
    with open(os.path.join(directory, _TREEDEF), "rb") as f:
        structure = pickle.load(f)
    return tree_unflatten(structure, [
        to_tensor(_full(r), name) for r, name in zip(readers, names)])
