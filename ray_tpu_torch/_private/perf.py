"""Core-runtime micro benchmarks — the ray_perf analog (the port's copy
of the JAX package's _private/perf.py).

Measures the pure control plane (no torch in any task): task and actor-call
latency/throughput, put/get across object sizes, a 10k-task queue drain,
and actor churn. Reference surface:
python/ray/_private/ray_perf.py:93-315 (micro-ops) and
release/benchmarks/distributed/test_many_tasks.py:111 (tasks_per_second
envelope). Numbers are NOT comparable 1:1 with the reference's C++
raylet — this runtime's conductor/worker plane is Python — which is
exactly why the envelope must be measured and published rather than
implied.

Run: `python -m ray_tpu_torch._private.perf [--scale S] [--out FILE]`
(a host benchmark: it runs on the CPUs of whatever machine holds it)
Scale multiplies iteration counts (0.1 = smoke, 1.0 = full envelope).
Emits one JSON line per benchmark and an aggregate JSON file.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Any, Callable, Dict, List

import numpy as np


def _latency_stats(samples_s: List[float]) -> Dict[str, float]:
    ms = sorted(s * 1e3 for s in samples_s)
    n = len(ms)
    return {
        "p50_ms": round(ms[n // 2], 3),
        "p99_ms": round(ms[min(n - 1, int(n * 0.99))], 3),
        "mean_ms": round(statistics.fmean(ms), 3),
    }


def _emit(rec: Dict[str, Any], sink: List[Dict[str, Any]]) -> None:
    sink.append(rec)
    print(json.dumps(rec), flush=True)


# -------------------------------------------------------------- benches

def bench_task_roundtrip(rt, sink, scale: float) -> None:
    """Submit → execute → get, one at a time (ray_perf 'single client
    tasks sync')."""
    @rt.remote
    def f():
        return b"ok"

    n = max(20, int(300 * scale))
    for _ in range(10):
        rt.get(f.remote())
    lat = []
    t0 = time.perf_counter()
    for _ in range(n):
        s = time.perf_counter()
        rt.get(f.remote())
        lat.append(time.perf_counter() - s)
    dt = time.perf_counter() - t0
    _emit({"name": "task_roundtrip_sync", "iters": n,
           "ops_per_s": round(n / dt, 1), **_latency_stats(lat)}, sink)


def bench_tasks_async(rt, sink, scale: float) -> None:
    """Pipelined submission, one batched get (ray_perf 'single client
    tasks async')."""
    @rt.remote
    def f():
        return b"ok"

    n = max(50, int(1000 * scale))
    # fully warm the worker pool: a cold pool amortizes process spawns
    # into the measurement and understates steady-state throughput
    rt.get([f.remote() for _ in range(max(50, n // 5))])
    t0 = time.perf_counter()
    rt.get([f.remote() for _ in range(n)], timeout=600.0)
    dt = time.perf_counter() - t0
    _emit({"name": "tasks_async", "iters": n,
           "ops_per_s": round(n / dt, 1)}, sink)


def bench_actor_calls(rt, sink, scale: float) -> None:
    """1:1 actor calls, sync latency and async throughput (ray_perf
    '1:1 actor calls sync/async')."""
    @rt.remote
    class A:
        def m(self):
            return b"ok"

    a = A.remote()
    rt.get(a.m.remote())

    n = max(20, int(300 * scale))
    lat = []
    t0 = time.perf_counter()
    for _ in range(n):
        s = time.perf_counter()
        rt.get(a.m.remote())
        lat.append(time.perf_counter() - s)
    dt = time.perf_counter() - t0
    _emit({"name": "actor_call_sync", "iters": n,
           "ops_per_s": round(n / dt, 1), **_latency_stats(lat)}, sink)

    n = max(50, int(1000 * scale))
    t0 = time.perf_counter()
    rt.get([a.m.remote() for _ in range(n)], timeout=600.0)
    dt = time.perf_counter() - t0
    _emit({"name": "actor_calls_async", "iters": n,
           "ops_per_s": round(n / dt, 1)}, sink)
    rt.kill(a)


def bench_put_get(rt, sink, scale: float) -> None:
    """put/get at 1KB / 1MB / 100MB (ray_perf put calls + put
    gigabytes). 100MB exercises the shm zero-copy path."""
    for label, nbytes, iters in (("1kb", 1 << 10, max(20, int(300 * scale))),
                                 ("1mb", 1 << 20, max(10, int(100 * scale))),
                                 ("100mb", 100 << 20, max(3, int(8 * scale)))):
        payload = np.random.default_rng(0).integers(
            0, 255, nbytes, dtype=np.uint8)
        rt.get(rt.put(payload))  # warm
        put_lat, get_lat, refs = [], [], []
        for _ in range(iters):
            s = time.perf_counter()
            r = rt.put(payload)
            put_lat.append(time.perf_counter() - s)
            refs.append(r)
        for r in refs:
            s = time.perf_counter()
            got = rt.get(r)
            get_lat.append(time.perf_counter() - s)
        assert got.nbytes == nbytes
        del refs
        # NB: get() of a locally-put object is a zero-copy store read, so
        # its "bandwidth" is a dict-lookup artifact — the cross-process
        # fetch is measured separately in bench_task_result_fetch.
        _emit({"name": f"put_{label}", "iters": iters,
               "ops_per_s": round(iters / sum(put_lat), 1),
               **_latency_stats(put_lat)}, sink)
        _emit({"name": f"get_local_{label}", "iters": iters,
               "ops_per_s": round(iters / sum(get_lat), 1),
               **_latency_stats(get_lat)}, sink)


def bench_task_result_fetch(rt, sink, scale: float) -> None:
    """get() of worker-produced results across process boundaries —
    1MB rides the RPC plane, 100MB the zero-copy shm slab (ray_perf
    'single client get calls' with real transfer)."""
    @rt.remote
    def make(nbytes):
        return np.zeros(nbytes, np.uint8)

    for label, nbytes, iters in (("1mb", 1 << 20, max(5, int(50 * scale))),
                                 ("100mb", 100 << 20, max(3, int(8 * scale)))):
        rt.get(make.remote(nbytes))  # warm
        lat = []
        for _ in range(iters):
            r = make.remote(nbytes)
            rt.wait([r], timeout=120.0)  # produced; time the fetch
            s = time.perf_counter()
            got = rt.get(r)
            lat.append(time.perf_counter() - s)
            assert got.nbytes == nbytes
            del got, r
        gbps = nbytes / statistics.fmean(lat) / 1e9
        _emit({"name": f"task_result_fetch_{label}", "iters": iters,
               "gb_per_s": round(gbps, 3), **_latency_stats(lat)}, sink)


def bench_queue_drain(rt, sink, scale: float) -> None:
    """Submit a deep queue of no-op tasks, then drain — the
    test_many_tasks.py:111 tasks_per_second shape at this runtime's
    scale (10k, not 1M: the conductor is Python and says so)."""
    @rt.remote
    def noop():
        return 0

    n = max(200, int(10_000 * scale))
    t0 = time.perf_counter()
    refs = [noop.remote() for _ in range(n)]
    t_submit = time.perf_counter() - t0
    rt.get(refs, timeout=1800.0)
    dt = time.perf_counter() - t0
    _emit({"name": "queue_drain", "iters": n,
           "submit_per_s": round(n / t_submit, 1),
           "tasks_per_s": round(n / dt, 1)}, sink)


def bench_actor_churn(rt, sink, scale: float) -> None:
    """Create → call → kill actors in bounded waves (release
    many_actors shape; each actor is a real worker process here)."""
    @rt.remote
    class Cell:
        def __init__(self, v):
            self.v = v

        def get(self):
            return self.v

    n = max(24, int(1000 * scale))
    wave = 8  # stay under the CPU resource cap while churning
    t0 = time.perf_counter()
    done = 0
    while done < n:
        k = min(wave, n - done)
        actors = [Cell.remote(i) for i in range(k)]
        got = rt.get([a.get.remote() for a in actors], timeout=120.0)
        assert got == list(range(k))
        for a in actors:
            rt.kill(a)
        done += k
    dt = time.perf_counter() - t0
    _emit({"name": "actor_churn", "iters": n,
           "actors_per_s": round(n / dt, 1)}, sink)


# fetch runs BEFORE put_get: the ~1GB of locally-pinned put payloads
# creates shm/page-cache pressure that would contaminate the fetch
# numbers (measured 20x degradation when ordered after)
BENCHES: List[Callable] = [
    bench_task_roundtrip, bench_tasks_async, bench_actor_calls,
    bench_task_result_fetch, bench_put_get, bench_queue_drain,
    bench_actor_churn,
]


def run(scale: float = 1.0, out: str = "") -> List[Dict[str, Any]]:
    import os

    import ray_tpu_torch as rt

    sink: List[Dict[str, Any]] = []
    rt.init(num_cpus=8)
    try:
        for bench in BENCHES:
            bench(rt, sink, scale)
    finally:
        rt.shutdown()
    if out:
        with open(out, "w") as f:
            # host_cpus contextualizes the numbers: on a 1-core host
            # every process timeshares one core, so pipelined throughput
            # cannot exceed serial by the usual margins
            json.dump({"scale": scale,
                       "host_cpus": os.cpu_count(),
                       "results": sink}, f, indent=1)
    return sink


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    run(scale=args.scale, out=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
