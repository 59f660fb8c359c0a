"""Node memory monitor / OOM protection (the port's copy of the JAX
package's memory monitor: the same threshold, readers and victim
policy).

Reference: src/ray/common/memory_monitor.h:52 (cgroup-aware node usage
polling) + src/ray/raylet/worker_killing_policy.cc (victim choice). A
runaway task must not hand the host to the kernel OOM killer — which
kills arbitrary processes, possibly the conductor, with zero diagnosis.
Instead the conductor (head node) and each node agent poll node usage
every refresh interval; above the threshold they SIGKILL the worker
using the most memory — task workers before actors before idle workers,
matching the reference's "prefer retriable work" policy — and record
the death as OOM so the submitter raises OutOfMemoryError (with usage
numbers) rather than a bare WorkerCrashedError.

On a GPU host the monitor watches host memory only, as the JAX one
does: a CUDA process's resident set includes the CUDA runtime's host
mappings, so an idle GPU worker is larger than an idle host worker (the
card's number is in PERF.md), and device memory is not this monitor's
business.
"""
from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Tuple

# worker states in kill-preference order: running tasks are retriable,
# actors lose state, idle workers free the least
_KILL_ORDER = {"BUSY": 0, "ACTOR": 1, "IDLE": 2}


def _read_first_int(path: str) -> Optional[int]:
    try:
        with open(path) as f:
            txt = f.read().strip()
        if txt == "max":
            return None
        return int(txt.split()[0])
    except (OSError, ValueError):
        return None


def cgroup_limit_and_usage() -> Tuple[Optional[int], Optional[int]]:
    """(limit, used) from cgroup v2 then v1, None when unlimited/absent
    (reference memory_monitor.cc GetCGroupMemoryLimit/UsedBytes)."""
    limit = _read_first_int("/sys/fs/cgroup/memory.max")
    used = _read_first_int("/sys/fs/cgroup/memory.current")
    if limit is None or used is None:
        limit = limit or _read_first_int(
            "/sys/fs/cgroup/memory/memory.limit_in_bytes")
        used = used or _read_first_int(
            "/sys/fs/cgroup/memory/memory.usage_in_bytes")
    # a v1 "unlimited" reads as a huge number; treat >= 2^60 as no limit
    if limit is not None and limit >= 1 << 60:
        limit = None
    return limit, used


def proc_meminfo() -> Tuple[int, int]:
    """(total, available) bytes from /proc/meminfo."""
    total = avail = 0
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                total = int(line.split()[1]) * 1024
            elif line.startswith("MemAvailable:"):
                avail = int(line.split()[1]) * 1024
            if total and avail:
                break
    return total, avail


def node_usage() -> Tuple[int, int]:
    """(used, total) for this node: the tighter of the cgroup limit and
    the host's physical memory."""
    total, avail = proc_meminfo()
    used = total - avail
    climit, cused = cgroup_limit_and_usage()
    if climit is not None and cused is not None and climit < total:
        return cused, climit
    return used, total


def pid_rss(pid: int) -> int:
    """Resident set size of `pid` in bytes (0 if gone)."""
    try:
        with open(f"/proc/{pid}/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        return 0


class MemoryMonitor:
    """Threshold check + victim selection; pure logic with injectable
    readers so policy is unit-testable without real memory pressure."""

    def __init__(self, threshold: float,
                 usage_fn: Callable[[], Tuple[int, int]] = node_usage,
                 rss_fn: Callable[[int], int] = pid_rss):
        self.threshold = threshold
        self._usage_fn = usage_fn
        self._rss_fn = rss_fn

    def over_threshold(self) -> Optional[Tuple[int, int]]:
        """(used, total) when the node is above the kill threshold."""
        if self.threshold <= 0:
            return None
        used, total = self._usage_fn()
        if total > 0 and used / total > self.threshold:
            return used, total
        return None

    def kill_greediest(self, workers: Sequence[Tuple[str, int, str]],
                       node_label: str = ""
                       ) -> Optional[Tuple[str, str]]:
        """Full monitor tick shared by conductor and node agent: if the
        node is over threshold, SIGKILL the chosen victim and return
        (worker_id, cause). No cause is reported when the kill failed —
        a process that exited on its own in the pick→kill window must
        not be mislabeled as OOM-killed."""
        over = self.over_threshold()
        if over is None:
            return None
        used, total = over
        victim = self.pick_victim(workers)
        if victim is None:
            return None
        worker_id, pid, rss = victim
        try:
            os.kill(pid, 9)
        except OSError:
            return None
        label = f"node {node_label} " if node_label else "node "
        return worker_id, (
            f"oom: {label}memory {used}/{total} bytes "
            f"({used / max(1, total):.0%}) over threshold "
            f"{self.threshold:.0%}; killed greediest worker "
            f"(rss {rss} bytes)")

    def pick_victim(self, workers: Sequence[Tuple[str, int, str]]
                    ) -> Optional[Tuple[str, int, int]]:
        """workers: (worker_id, pid, state). Returns (worker_id, pid,
        rss) of the victim: the highest-RSS worker in the most
        killable state class present."""
        best: Optional[Tuple[str, int, int]] = None
        best_key: Optional[Tuple[int, int]] = None
        for worker_id, pid, state in workers:
            order = _KILL_ORDER.get(state)
            if order is None or pid is None:
                continue
            rss = self._rss_fn(pid)
            if rss <= 0:
                continue
            key = (order, -rss)
            if best_key is None or key < best_key:
                best_key = key
                best = (worker_id, pid, rss)
        return best
