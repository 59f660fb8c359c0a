"""Per-node log monitor: tail worker log files, publish new lines (the
port's copy of the JAX package's log monitor, unchanged).

Reference: python/ray/_private/log_monitor.py — a per-node daemon that
tails the session's worker logs and publishes them over GCS pubsub so
drivers can mirror task/actor prints to their own console
(log_to_driver). Here each node's monitor (conductor for the head,
node agent for worker hosts) tails `{session}/logs/worker-*.log` and
publishes batches on the conductor's `worker_logs` channel; drivers
subscribe through the existing pubsub fan-in and write to stderr with a
`(worker=… node=…)` prefix.
"""
from __future__ import annotations

import glob
import os
import threading
from typing import Callable, Dict, List, Optional

_MAX_LINE = 4096          # clip pathological lines
_MAX_LINES_PER_TICK = 500  # a log-spamming worker must not wedge pubsub


class LogMonitor:
    def __init__(self, logs_dir: str,
                 publish_fn: Callable[[List[Dict[str, str]]], None],
                 node_label: str = "", poll_s: float = 0.5):
        self.logs_dir = logs_dir
        self.publish_fn = publish_fn
        self.node_label = node_label
        self.poll_s = poll_s
        self._offsets: Dict[str, int] = {}
        self._partial: Dict[str, bytes] = {}   # unterminated trailing line
        self._backlog: Dict[str, List[bytes]] = {}  # cap-hit surplus lines
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "LogMonitor":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="log-monitor")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stopped.set()

    def _loop(self) -> None:
        while not self._stopped.wait(self.poll_s):
            try:
                batch = self.poll_once()
                if batch:
                    self.publish_fn(batch)
            except Exception:  # noqa: BLE001 — the tailer must survive
                pass

    def poll_once(self) -> List[Dict[str, str]]:
        """New complete lines since the last call, across all worker
        logs (bounded per tick)."""
        out: List[Dict[str, str]] = []
        for path in sorted(glob.glob(
                os.path.join(self.logs_dir, "worker-*.log"))):
            if len(out) >= _MAX_LINES_PER_TICK:
                break
            worker = os.path.basename(path)[len("worker-"):-len(".log")]
            lines = self._backlog.pop(path, None)
            if lines is None:
                # No retained surplus: read new bytes. While a backlog
                # exists we do NOT read — otherwise a log-spamming worker
                # grows the buffer without bound (each tick drains only
                # _MAX_LINES_PER_TICK but could read ~1MB more).
                try:
                    size = os.path.getsize(path)
                    offset = self._offsets.get(path, 0)
                    if size < offset:  # truncated/rotated: start over
                        offset = 0
                        self._partial.pop(path, None)
                    if size == offset:
                        continue
                    with open(path, "rb") as f:
                        f.seek(offset)
                        data = f.read(min(size - offset, 1 << 20))
                        self._offsets[path] = f.tell()
                except OSError:
                    continue
                data = self._partial.pop(path, b"") + data
                *lines, tail = data.split(b"\n")
                if tail:
                    self._partial[path] = tail
            for i, raw in enumerate(lines):
                if len(out) >= _MAX_LINES_PER_TICK:
                    # Cap hit inside an already-read chunk: the offset has
                    # advanced past these lines, so retain the surplus for
                    # the next tick instead of dropping it (bounded at one
                    # read's worth — see the no-read-while-backlog rule).
                    self._backlog[path] = lines[i:]
                    break
                line = raw[:_MAX_LINE].decode("utf-8", "replace").rstrip()
                if line:
                    out.append({"worker": worker, "node": self.node_label,
                                "line": line})
        return out


def format_log_line(entry: Dict[str, str]) -> str:
    """Driver-side rendering, reference `(pid=..., ip=...)` prefix."""
    node = entry.get("node") or ""
    src = f"worker={entry.get('worker', '?')}"
    if node:
        src += f", node={node}"
    return f"({src}) {entry.get('line', '')}"
