"""A function of the port on N local CPU ranks over gloo.

    results = run_gang(fn, 4, args=(inputs,), timeout=120.0)

Each rank is a fresh process (the `spawn` start method) that joins a
gloo process group of `world` ranks on a `file://` store in a temporary
directory, runs with one intra-op thread (`torch.set_num_threads(1)`),
calls `fn(rank, world, *args)` and returns its result. `fn`, `args` and
the results are pickled, so `fn` is a module-level function of a module
every rank can import. The results come back in rank order; if a rank
raises, the others are killed and RuntimeError carries that rank's
traceback; if the gang has not finished within `timeout` seconds, every
rank is killed and TimeoutError is raised.

This is the multi-rank check of the parallel layer where there is one
card or none: the collectives, meshes and the mesh `TrainStep` run over
gloo on the CPU as they run over NCCL on cards.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Sequence


def _rank_main(payload: str, rank: int, world: int, store: str,
               timeout: float, results) -> None:
    try:
        with open(payload, "rb") as f:
            fn, args = pickle.load(f)
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(rank, world, *args)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 — reported to the parent
        results.put((rank, False, traceback.format_exc()))


class Gang:
    """`world` ranks running fn(rank, world, *args); start() returns at
    once, join() waits for the results (see the module docstring)."""

    def __init__(self, fn: Callable, world: int, args: Sequence[Any] = (),
                 timeout: float = 120.0):
        if world < 1:
            raise ValueError(f"world {world} < 1")
        self.fn, self.world, self.args = fn, world, tuple(args)
        self.timeout = timeout
        self._procs: List[Any] = []

    def start(self) -> "Gang":
        ctx = multiprocessing.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="gang-")
        self._results = ctx.Queue()
        self._deadline = time.monotonic() + self.timeout
        store = os.path.join(self._dir, "store")
        # fn and args go through a file: a rank that dies while starting
        # cannot leave start() blocked on a pipe it never reads
        payload = os.path.join(self._dir, "payload")
        with open(payload, "wb") as f:
            pickle.dump((self.fn, self.args), f)
        self._procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(payload, r, self.world, store, self.timeout,
                  self._results)) for r in range(self.world)]
        for p in self._procs:
            p.start()
        return self

    def join(self) -> List[Any]:
        got: Dict[int, Any] = {}
        try:
            while len(got) < self.world:
                left = self._deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"gang of {self.world} did not finish within "
                        f"{self.timeout}s; ranks without a result: "
                        f"{sorted(set(range(self.world)) - set(got))}")
                try:
                    rank, ok, val = self._results.get(timeout=min(left, 0.5))
                except queue.Empty:
                    for r, p in enumerate(self._procs):
                        if r not in got and p.exitcode not in (None, 0):
                            raise RuntimeError(
                                f"gang rank {r} exited with code "
                                f"{p.exitcode} and no result")
                    continue
                if not ok:
                    raise RuntimeError(f"gang rank {rank} failed:\n{val}")
                got[rank] = val
            for p in self._procs:
                p.join(timeout=max(1.0, self._deadline - time.monotonic()))
        finally:
            self.kill()
        return [got[r] for r in range(self.world)]

    def kill(self) -> None:
        """End every rank still running and remove the store."""
        for p in self._procs:
            if p.is_alive():
                p.kill()
        for p in self._procs:
            p.join(timeout=10)
        shutil.rmtree(getattr(self, "_dir", ""), ignore_errors=True)


def run_gang(fn: Callable, world: int, args: Sequence[Any] = (),
             timeout: float = 120.0) -> List[Any]:
    """fn(rank, world, *args) on `world` ranks; the results in rank
    order."""
    return Gang(fn, world, args, timeout).start().join()


__all__ = ["Gang", "run_gang"]
