"""Checkpointing: directory-based `Checkpoint` + top-K `CheckpointManager`
(port of ray_tpu/train/checkpoint.py).

A checkpoint is a directory; a manager keeps the top K by a score
attribute. `save_pytree` / `load_pytree` write one `{name}.npz` (by an
atomic rename) and `{name}.tree.pkl`. The npz holds `leaf_{i}` in the
JAX package's leaf order (`tree.tree_flatten`: dict keys sorted), so
leaf i is the same leaf in both packages; the pickle holds the port's
own structure (plain containers and leaf indices), never a JAX treedef.

numpy has no bfloat16 (the JAX package gets one from ml_dtypes, which
the port does without): a bf16 tensor is written as the 2-byte records
JAX writes for its bf16 arrays (numpy dtype `V2`) and read back by
viewing the raw bits as `torch.bfloat16`. So `load_pytree` returns CPU
tensors where the JAX package returns numpy arrays.
"""
from __future__ import annotations

import json
import os
import pickle
import shutil
import tempfile
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from ..tree import tree_flatten, tree_unflatten

BF16 = "bfloat16"


def dtype_name(dtype: Any) -> str:
    """The numpy name of a torch or numpy dtype ("bfloat16" for bf16), as
    the JAX package's manifests name it."""
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bfloat16:
            return BF16
        return np.dtype(torch.empty((), dtype=dtype).numpy().dtype).name
    return np.dtype(dtype).name


def host_array(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as numpy without a copy; bf16 as its raw 2-byte
    records (`V2`), as JAX's bf16 arrays are written."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def storage_dtype(name: str) -> np.dtype:
    """The numpy dtype a leaf named `name` is assembled in: bf16 as
    uint16 (the same 2-byte layout), anything else as itself."""
    return np.dtype(np.uint16) if name == BF16 else np.dtype(name)


def raw_view(arr: np.ndarray, dtype: np.dtype) -> np.ndarray:
    """A stored array as `dtype`: raw 2-byte records (bf16, written as
    `V2` by either package) are reinterpreted, not converted."""
    if arr.dtype.kind == "V" and arr.dtype != dtype:
        return arr.view(dtype)
    return arr


def to_tensor(arr: np.ndarray, name: str) -> torch.Tensor:
    """A CPU tensor on the memory of `arr`, a stored leaf (its manifest
    dtype `name`) freshly read, which the tensor then owns; bf16 from its
    raw bits."""
    if name == BF16:
        return torch.from_numpy(raw_view(arr, np.dtype(np.uint16))
                                .view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class Checkpoint:
    """A directory of files (Ray's `ray.train.Checkpoint`)."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        d = tempfile.mkdtemp(prefix="ray_tpu_ckpt_")
        with open(os.path.join(d, "data.pkl"), "wb") as f:
            pickle.dump(data, f, protocol=5)
        return cls(d)

    def to_dict(self) -> Dict[str, Any]:
        with open(os.path.join(self.path, "data.pkl"), "rb") as f:
            return pickle.load(f)

    def to_directory(self, path: Optional[str] = None) -> str:
        if path is None:
            return self.path
        if os.path.abspath(path) != self.path:
            shutil.copytree(self.path, path, dirs_exist_ok=True)
        return path

    @contextmanager
    def as_directory(self) -> Iterator[str]:
        yield self.path

    def __repr__(self) -> str:
        return f"Checkpoint({self.path})"


def _host_leaf(x: Any) -> np.ndarray:
    if isinstance(x, DTensor):
        x = x.full_tensor()  # a collective: every rank of its mesh calls
    if isinstance(x, torch.Tensor):
        return host_array(x.detach().to("cpu", copy=True))
    return np.asarray(x)


def save_pytree(tree: Any, directory: str, name: str = "state") -> None:
    """Flatten a tree of tensors (and numbers) to {name}.npz +
    {name}.tree.pkl. A DTensor leaf is gathered whole."""
    os.makedirs(directory, exist_ok=True)
    leaves, structure = tree_flatten(tree)
    arrays = {f"leaf_{i}": _host_leaf(x) for i, x in enumerate(leaves)}
    tmp = os.path.join(directory, f".{name}.npz.tmp")
    # pass an open file, not the path: np.savez silently appends ".npz"
    # to string filenames, which would break the atomic rename
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, os.path.join(directory, f"{name}.npz"))
    with open(os.path.join(directory, f"{name}.tree.pkl"), "wb") as f:
        pickle.dump(structure, f, protocol=5)


def load_pytree(directory: str, name: str = "state") -> Any:
    """The tree `save_pytree` wrote, every leaf a CPU tensor (a 2-byte
    void record array is bf16)."""
    with open(os.path.join(directory, f"{name}.tree.pkl"), "rb") as f:
        structure = pickle.load(f)
    data = np.load(os.path.join(directory, f"{name}.npz"),
                   allow_pickle=False)
    leaves = []
    for i in range(len(data.files)):
        arr = np.array(data[f"leaf_{i}"])  # writable: npz arrays are not
        leaves.append(to_tensor(arr, BF16 if arr.dtype.kind == "V"
                                else arr.dtype.name))
    return tree_unflatten(structure, leaves)


@dataclass(order=True)
class _Tracked:
    score: float
    index: int
    checkpoint: Checkpoint = field(compare=False)
    metrics: Dict[str, Any] = field(compare=False, default_factory=dict)


class CheckpointManager:
    """Keeps the top K checkpoints by metric under a root directory."""

    def __init__(self, root: str, num_to_keep: Optional[int] = None,
                 score_attribute: Optional[str] = None,
                 score_order: str = "max"):
        self.root = root
        self.num_to_keep = num_to_keep
        self.score_attribute = score_attribute
        self.score_order = score_order
        self._tracked: List[_Tracked] = []
        self._index = 0
        # async checkpoints register from the writer thread (at commit)
        # while the trainer may register sync ones
        self._lock = threading.Lock()
        os.makedirs(root, exist_ok=True)

    def reserve_index(self) -> int:
        """Claim the next checkpoint slot now: an async save registering
        later (at commit, on the writer thread) keeps its report-time
        place in the recency order."""
        with self._lock:
            idx = self._index
            self._index += 1
            return idx

    def register(self, checkpoint: Checkpoint,
                 metrics: Optional[Dict[str, Any]] = None,
                 index: Optional[int] = None) -> Checkpoint:
        """Move `checkpoint` under the managed root and apply retention.
        Disk work happens outside the lock: a multi-GB copy on the async
        writer thread must not block report() or best/latest reads."""
        metrics = dict(metrics or {})
        if index is None:
            index = self.reserve_index()
        dst = os.path.join(self.root, f"checkpoint_{index:06d}")
        if checkpoint.path != dst:
            if os.path.exists(dst):
                shutil.rmtree(dst)
            # same-filesystem rename when possible, else copy
            try:
                os.replace(checkpoint.path, dst)
            except OSError:
                shutil.copytree(checkpoint.path, dst)
                shutil.rmtree(checkpoint.path, ignore_errors=True)
            checkpoint.path = dst  # the caller's handle stays valid
        ckpt = Checkpoint(dst)
        with open(os.path.join(dst, "metrics.json"), "w") as f:
            json.dump(_json_safe(metrics), f)
        if self.score_attribute and self.score_attribute in metrics:
            score = float(metrics[self.score_attribute])
            if self.score_order == "min":
                score = -score
        else:
            score = float(index)  # fall back to recency
        doomed: List[_Tracked] = []
        with self._lock:
            self._tracked.append(_Tracked(score, index, ckpt, metrics))
            if self.num_to_keep is not None:
                while len(self._tracked) > self.num_to_keep:
                    worst = min(self._tracked)
                    self._tracked.remove(worst)
                    doomed.append(worst)
        for t in doomed:  # deletion outside the lock too
            shutil.rmtree(t.checkpoint.path, ignore_errors=True)
        return ckpt

    @property
    def best_checkpoint(self) -> Optional[Checkpoint]:
        with self._lock:
            if not self._tracked:
                return None
            return max(self._tracked).checkpoint

    @property
    def latest_checkpoint(self) -> Optional[Checkpoint]:
        with self._lock:
            if not self._tracked:
                return None
            return max(self._tracked, key=lambda t: t.index).checkpoint

    def list_checkpoints(self) -> List[Tuple[Checkpoint, Dict[str, Any]]]:
        with self._lock:
            return [(t.checkpoint, t.metrics)
                    for t in sorted(self._tracked, key=lambda t: t.index)]


def _json_safe(d: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in d.items():
        if isinstance(v, (np.floating, np.integer)):
            out[k] = v.item()
        elif isinstance(v, (int, float, str, bool, type(None))):
            out[k] = v
        else:
            out[k] = str(v)
    return out
