"""The runtime's checks, run by `isolated.run_checks` in a driver process
of their own (tests/test_torch_runtime_*.py make each one a test case).

Most are twins of the JAX package's runtime tests (tests/test_core.py,
test_actor.py, test_cancel.py, test_refcount.py, test_native_store.py,
test_object_plane.py, test_fork_server.py, test_config.py), one
function per case, named after its file and case. The rest check where
the port differs: tensors in the object plane, whole-GPU leases, pid
identity, calls that would end the driver, the arena build, and what
this slice leaves out. A check raises (an AssertionError) to fail.

The functions live in the package because a worker imports by name what
a check pickles by reference (the module-level actor classes here), and
the test modules import JAX, which no process of the port may. This
module imports no torch at the top: the fork template must not either.
"""
from __future__ import annotations

import gc
import multiprocessing as mp
import os
import random
import signal
import subprocess
import sys
import time

import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch import exceptions as exc
from ray_tpu_torch.exceptions import TaskCancelledError


def _raises(excs, fn, *args, **kwargs):
    """The exception `fn(*args, **kwargs)` raised, which must be one of
    `excs`."""
    try:
        fn(*args, **kwargs)
    except excs as e:
        return e
    raise AssertionError(f"{getattr(fn, '__name__', fn)} did not raise "
                         f"{excs}")


def _worker():
    return rt._private.worker.global_worker


def _wait_until(pred, timeout=10.0, msg=""):
    from ray_tpu_torch._private import refcount

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        gc.collect()
        refcount.tracker.flush()
        time.sleep(0.05)
    raise AssertionError(msg or "condition not reached")


# ---------------------------------------------------------------- core
# twins of tests/test_core.py (a cluster of 4 CPUs each, as its fixture)

def core_put_get():
    ref = rt.put({"a": 1, "b": [1, 2, 3]})
    assert rt.get(ref) == {"a": 1, "b": [1, 2, 3]}


def core_put_get_numpy_large():
    x = np.arange(1_000_000, dtype=np.float32)  # 4 MB -> shm path
    ref = rt.put(x)
    y = rt.get(ref)
    np.testing.assert_array_equal(x, y)


def core_simple_task():
    @rt.remote
    def add(a, b):
        return a + b

    assert rt.get(add.remote(1, 2)) == 3


def core_task_with_ref_args():
    @rt.remote
    def add(a, b):
        return a + b

    a = rt.put(10)
    b = add.remote(a, 5)
    c = add.remote(b, rt.put(1))
    assert rt.get(c) == 16


def core_task_large_result():
    @rt.remote
    def make(n):
        return np.ones(n, dtype=np.float64)

    out = rt.get(make.remote(500_000))  # 4 MB
    assert out.shape == (500_000,)
    assert float(out.sum()) == 500_000.0


def core_many_parallel_tasks():
    @rt.remote
    def sq(i):
        return i * i

    refs = [sq.remote(i) for i in range(50)]
    assert rt.get(refs) == [i * i for i in range(50)]


def core_task_exception_propagates():
    @rt.remote
    def boom():
        raise ValueError("kaboom")

    e = _raises(exc.TaskError, rt.get, boom.remote())
    assert isinstance(e.cause, ValueError)
    assert "kaboom" in str(e)


def core_num_returns():
    @rt.remote(num_returns=3)
    def three():
        return 1, 2, 3

    r1, r2, r3 = three.remote()
    assert rt.get([r1, r2, r3]) == [1, 2, 3]


def core_wait():
    @rt.remote
    def fast():
        return "fast"

    @rt.remote
    def slow():
        time.sleep(5)
        return "slow"

    f, s = fast.remote(), slow.remote()
    ready, not_ready = rt.wait([f, s], num_returns=1, timeout=4)
    assert ready == [f]
    assert not_ready == [s]


def core_wait_timeout_empty():
    @rt.remote
    def slow():
        time.sleep(10)

    ready, not_ready = rt.wait([slow.remote()], timeout=0.2)
    assert ready == []
    assert len(not_ready) == 1


def core_get_timeout():
    @rt.remote
    def slow():
        time.sleep(10)

    _raises(exc.GetTimeoutError, rt.get, slow.remote(), timeout=0.3)


def core_nested_tasks():
    @rt.remote
    def inner(x):
        return x * 2

    @rt.remote
    def outer(x):
        return rt.get(inner.remote(x)) + 1

    assert rt.get(outer.remote(10)) == 21


def core_task_passing_ref_between_tasks():
    @rt.remote
    def produce():
        return np.full(300_000, 7.0)  # large -> stays on producer worker

    @rt.remote
    def consume(arr):
        return float(arr[0]) + float(arr[-1])

    assert rt.get(consume.remote(produce.remote())) == 14.0


def core_cluster_resources():
    assert rt.cluster_resources().get("CPU") == 4.0


def core_options_override():
    @rt.remote
    def f():
        return 1

    assert rt.get(f.options(num_cpus=2, name="custom").remote()) == 1


def core_reinit_error():
    _raises(RuntimeError, rt.init)
    rt.init(ignore_reinit_error=True)


def core_result_larger_than_store_cap():
    """A task result bigger than the object-store cap is spilled by the
    executing worker and comes back as a locator — get() must
    chunk-fetch it from the holder, never hang waiting for a store entry
    that will never exist."""
    rt.init(num_cpus=1, _system_config={"object_store_cap": 256 * 1024})

    @rt.remote
    def big():
        return np.ones(1024 * 1024, dtype=np.float32)  # 4 MB

    out = rt.get(big.remote(), timeout=60.0)
    assert out.nbytes == 4 * 1024 * 1024
    assert float(out[-1]) == 1.0


def core_nested_get_releases_lease_no_deadlock():
    """A task blocked in get() must release its CPU lease so the task it
    waits on can schedule. With 1 CPU, parent-get()s-child deadlocks
    without it."""
    rt.init(num_cpus=1)

    @rt.remote
    def leaf():
        return 7

    @rt.remote
    def parent():
        return rt.get(leaf.remote()) + 1

    assert rt.get(parent.remote(), timeout=30.0) == 8

    @rt.remote
    def grandparent():
        return rt.get(parent.remote()) + 1  # two levels deep

    assert rt.get(grandparent.remote(), timeout=30.0) == 9


# --------------------------------------------------------------- actors
# twins of tests/test_actor.py

@rt.remote
class Counter:
    def __init__(self, start=0):
        self.n = start

    def incr(self, by=1):
        self.n += by
        return self.n

    def value(self):
        return self.n

    def fail(self):
        raise RuntimeError("actor method failure")


def actor_basic():
    c = Counter.remote(10)
    assert rt.get(c.incr.remote()) == 11
    assert rt.get(c.incr.remote(5)) == 16
    assert rt.get(c.value.remote()) == 16


def actor_ordering():
    c = Counter.remote()
    refs = [c.incr.remote() for _ in range(20)]
    assert rt.get(refs) == list(range(1, 21))


def actor_method_exception():
    c = Counter.remote()
    e = _raises(exc.TaskError, rt.get, c.fail.remote())
    assert isinstance(e.cause, RuntimeError)
    assert rt.get(c.value.remote()) == 0  # actor still alive


def actor_named():
    Counter.options(name="the-counter").remote(5)
    h = rt.get_actor("the-counter")
    assert rt.get(h.value.remote()) == 5


def actor_named_conflict():
    Counter.options(name="dup").remote()
    _raises(Exception, Counter.options(name="dup").remote)


def actor_get_if_exists():
    a = Counter.options(name="gie", get_if_exists=True).remote(1)
    rt.get(a.incr.remote())
    b = Counter.options(name="gie", get_if_exists=True).remote(1)
    assert rt.get(b.value.remote()) == 2


def actor_init_failure():
    @rt.remote
    class Bad:
        def __init__(self):
            raise ValueError("bad init")

    _raises(exc.ActorDiedError, Bad.remote)


def actor_kill():
    c = Counter.remote()
    assert rt.get(c.value.remote()) == 0
    rt.kill(c)
    time.sleep(1.0)
    _raises((exc.ActorError, exc.TaskError), rt.get, c.value.remote())


def actor_exit():
    @rt.remote
    class Quitter:
        def quit(self):
            rt.exit_actor()

    q = Quitter.remote()
    _raises(exc.ActorDiedError, rt.get, q.quit.remote())


def actor_restart():
    @rt.remote(max_restarts=1, max_task_retries=-1)
    class Phoenix:
        def __init__(self):
            self.n = 0

        def incr(self):
            self.n += 1
            return self.n

        def die(self):
            # die *after* replying, so the death isn't mid-call
            import threading

            threading.Timer(0.2, lambda: os._exit(1)).start()
            return "dying"

    p = Phoenix.remote()
    assert rt.get(p.incr.remote()) == 1
    assert rt.get(p.die.remote()) == "dying"
    time.sleep(1.5)  # monitor notices, restarts
    # state is reset after restart
    assert rt.get(p.incr.remote()) == 1


def actor_max_concurrency():
    @rt.remote(max_concurrency=4)
    class Sleeper:
        def nap(self, t):
            time.sleep(t)
            return t

    s = Sleeper.remote()
    t0 = time.monotonic()
    rt.get([s.nap.remote(0.5) for _ in range(4)])
    elapsed = time.monotonic() - t0
    assert elapsed < 1.6, f"calls did not overlap: {elapsed:.2f}s"


def actor_async():
    @rt.remote(max_concurrency=8)
    class AsyncActor:
        async def work(self, x):
            import asyncio

            await asyncio.sleep(0.2)
            return x * 2

    a = AsyncActor.remote()
    t0 = time.monotonic()
    refs = [a.work.remote(i) for i in range(8)]
    assert rt.get(refs) == [i * 2 for i in range(8)]
    assert time.monotonic() - t0 < 1.5


def actor_handle_passed_to_task():
    @rt.remote
    def use_counter(c):
        return rt.get(c.incr.remote(100))

    c = Counter.remote()
    assert rt.get(use_counter.remote(c)) == 100
    assert rt.get(c.value.remote()) == 100


def actor_ordering_burst():
    """Many back-to-back ordered calls from one handle all complete in
    submission order."""
    @rt.remote
    class Log:
        def __init__(self):
            self.seen = []

        def add(self, i):
            self.seen.append(i)
            return i

        def seen_list(self):
            return self.seen

    a = Log.remote()
    n = 60
    assert rt.get([a.add.remote(i) for i in range(n)]) == list(range(n))
    assert rt.get(a.seen_list.remote()) == list(range(n))


def actor_graceful_exit_releases_resources():
    """exit_actor() returns the actor's lease to the node pool."""
    @rt.remote
    class Quitter:
        def quit(self):
            rt.exit_actor()

    before = rt.available_resources().get("CPU", 0)
    quitters = [Quitter.remote() for _ in range(3)]
    for q in quitters:
        try:
            rt.get(q.quit.remote(), timeout=30)
        except exc.ActorDiedError:
            pass
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        if rt.available_resources().get("CPU", 0) >= before:
            break
        time.sleep(0.1)
    assert rt.available_resources().get("CPU", 0) >= before


# --------------------------------------------------------------- cancel
# twins of tests/test_cancel.py

def cancel_sleeping_task_returns_fast():
    @rt.remote
    def sleeper():
        time.sleep(30)
        return "done"

    ref = sleeper.remote()
    time.sleep(0.5)  # let it start executing
    t0 = time.monotonic()
    rt.cancel(ref)
    _raises(TaskCancelledError, rt.get, ref, timeout=10.0)
    assert time.monotonic() - t0 < 1.0


def cancel_force_kills_worker():
    @rt.remote
    def sleeper():
        time.sleep(30)
        return "done"

    ref = sleeper.remote()
    time.sleep(0.5)
    t0 = time.monotonic()
    rt.cancel(ref, force=True)
    _raises(TaskCancelledError, rt.get, ref, timeout=10.0)
    assert time.monotonic() - t0 < 1.0

    @rt.remote
    def ok():
        return 42

    # the cluster still works afterwards (death path cleaned up)
    assert rt.get(ok.remote(), timeout=60.0) == 42


def cancel_interrupts_python_loop():
    @rt.remote
    def spin():
        x = 0
        for i in range(10 ** 10):
            x += i
        return x

    ref = spin.remote()
    time.sleep(0.7)
    rt.cancel(ref)
    _raises(TaskCancelledError, rt.get, ref, timeout=10.0)

    @rt.remote
    def ok():
        return 1

    t0 = time.monotonic()
    assert rt.get(ok.remote(), timeout=60.0) == 1
    assert time.monotonic() - t0 < 30.0


def cancel_before_execution():
    @rt.remote
    def dep():
        time.sleep(5)
        return 1

    @rt.remote
    def consumer(x):
        return x + 1

    ref = consumer.remote(dep.remote())
    rt.cancel(ref)
    _raises(TaskCancelledError, rt.get, ref, timeout=10.0)


def cancel_actor_survives_cancel_of_queued_call():
    @rt.remote
    class A:
        def slow(self):
            time.sleep(2)
            return "slow"

        def fast(self):
            return "fast"

    a = A.remote()
    running = a.slow.remote()   # occupies the single-concurrency actor
    queued = a.fast.remote()    # waits in the dispatch queue
    time.sleep(0.3)
    rt.cancel(queued)
    _raises(TaskCancelledError, rt.get, queued, timeout=10.0)
    assert rt.get(running, timeout=30.0) == "slow"
    assert rt.get(a.fast.remote(), timeout=30.0) == "fast"


def cancel_completed_task_is_noop():
    @rt.remote
    def f():
        return 7

    ref = f.remote()
    assert rt.get(ref, timeout=60.0) == 7
    rt.cancel(ref)  # no effect
    assert rt.get(ref, timeout=10.0) == 7


def cancel_force_on_actor_call_rejected():
    @rt.remote
    class A:
        def slow(self):
            time.sleep(30)

    a = A.remote()
    ref = a.slow.remote()
    time.sleep(0.3)
    _raises(ValueError, rt.cancel, ref, force=True)
    rt.cancel(ref)  # non-force still works
    _raises(TaskCancelledError, rt.get, ref, timeout=10.0)


def cancel_one_of_multi_return_delivers_siblings():
    @rt.remote(num_returns=2)
    def pair():
        time.sleep(0.8)
        return "a", "b"

    r1, r2 = pair.remote()
    time.sleep(0.2)
    rt.cancel(r1)
    _raises(TaskCancelledError, rt.get, r1, timeout=10.0)
    # the sibling resolves: the value, or a cancel — never a hang
    try:
        assert rt.get(r2, timeout=10.0) == "b"
    except TaskCancelledError:
        pass


def cancel_borrowed_ref_forwards_to_owner():
    @rt.remote
    def sleeper():
        time.sleep(30)
        return "done"

    @rt.remote
    class Owner:
        def start(self):
            self.ref = sleeper.remote()
            return [self.ref]

        def probe(self):
            try:
                return rt.get(self.ref, timeout=0.1)
            except Exception as e:  # noqa: BLE001
                return type(e).__name__

    o = Owner.remote()
    [ref] = rt.get(o.start.remote())
    time.sleep(0.5)  # task is executing on some worker now
    rt.cancel(ref)  # we are a borrower: must forward to the owner
    deadline = time.monotonic() + 10
    seen = None
    while time.monotonic() < deadline:
        seen = rt.get(o.probe.remote())
        if seen == "TaskCancelledError":
            break
        time.sleep(0.2)
    assert seen == "TaskCancelledError", seen


def cancel_borrowed_dep_wait_releases_submit_slots():
    @rt.remote
    def never():
        time.sleep(120)
        return 1

    @rt.remote
    def child(x):
        return x

    @rt.remote
    class Spawner:
        def spawn(self, refs):
            return [child.remote(r) for r in refs]

        def probe(self):
            return rt.get(child.remote(rt.put("pong")))

    s = Spawner.remote()
    dep = never.remote()
    children = rt.get(s.spawn.remote([dep] * 20), timeout=30.0)
    assert len(children) == 20
    time.sleep(1.0)  # let the submit pool fill with dep waiters
    for c in children:
        rt.cancel(c)
    t0 = time.monotonic()
    assert rt.get(s.probe.remote(), timeout=30.0) == "pong"
    assert time.monotonic() - t0 < 15.0
    rt.cancel(dep, force=True)


# ------------------------------------------------------------- refcount
# twins of tests/test_refcount.py (a cluster of 2 CPUs each)

def _store_stats():
    return _worker().store.stats()


def _spill_bytes(w) -> int:
    total = 0
    for root, _, files in os.walk(w.store._spill_dir):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return total


def refcount_put_loop_holds_store_flat():
    w = _worker()
    payload = np.ones(256 * 1024, dtype=np.uint8)  # 256KB, shm path
    for i in range(200):
        ref = rt.put(payload)
        assert rt.get(ref).nbytes == payload.nbytes
        del ref
        if i % 50 == 0:
            gc.collect()
    _wait_until(lambda: _store_stats()["num_objects"] <= 2,
                msg=f"store not drained: {_store_stats()}")
    assert _store_stats()["bytes"] <= 2 * payload.nbytes + 1_000_000
    assert _spill_bytes(w) == 0, "spill dir must stay empty"


def refcount_task_result_freed_on_drop():
    @rt.remote
    def big():
        return np.ones(2 * 1024 * 1024, dtype=np.uint8)  # 2MB

    ref = big.remote()
    assert rt.get(ref).nbytes == 2 * 1024 * 1024
    w = _worker()

    def worker_bytes():
        total = 0
        for rec in w.conductor.call("list_workers", timeout=10.0):
            addr = rec.get("address")
            if not addr:
                continue
            try:
                total += w.clients.get(tuple(addr)).call(
                    "store_stats", timeout=5.0)["bytes"]
            except Exception:  # noqa: BLE001 — worker gone
                pass
        return total

    assert worker_bytes() >= 2 * 1024 * 1024
    del ref
    _wait_until(lambda: worker_bytes() < 2 * 1024 * 1024,
                msg="holder copy of dropped result not freed")


def refcount_result_dropped_while_pending_is_freed():
    @rt.remote
    def slowish():
        time.sleep(0.3)
        return np.ones(1024 * 1024, dtype=np.uint8)

    ref = slowish.remote()
    oid = ref.id
    del ref
    gc.collect()
    w = _worker()
    _wait_until(lambda: not w._is_pending_local(oid), timeout=15.0)
    _wait_until(
        lambda: oid not in w._locators and not w.store.contains(oid),
        msg="dead-pending result not freed on arrival")


def refcount_borrowed_ref_survives_lender_death():
    from ray_tpu_torch._private import refcount

    @rt.remote
    class Holder:
        def __init__(self):
            self.ref = None

        def keep(self, boxed):
            # a LIST-nested ref is not materialized by the arg resolver
            self.ref = boxed[0]
            return True

        def read(self):
            return rt.get(self.ref).nbytes

        def drop(self):
            self.ref = None
            return True

    @rt.remote
    def lender(boxed, holder):
        return rt.get(holder.keep.remote(boxed))

    holder = Holder.remote()
    data_ref = rt.put(np.ones(512 * 1024, dtype=np.uint8))
    assert rt.get(lender.remote([data_ref], holder)) is True
    oid = data_ref.id
    del data_ref
    gc.collect()
    refcount.tracker.flush()
    time.sleep(0.3)  # lender's drop + driver's drop both land
    assert rt.get(holder.read.remote(), timeout=30.0) == 512 * 1024
    assert rt.get(holder.drop.remote()) is True
    w = _worker()
    _wait_until(lambda: not w.store.contains(oid),
                msg="owner copy not freed after last borrower dropped")


def refcount_live_handle_never_freed():
    from ray_tpu_torch._private import refcount

    ref = rt.put(np.arange(1000))
    for _ in range(3):
        gc.collect()
        refcount.tracker.flush()
        time.sleep(0.1)
    assert rt.get(ref).sum() == 499500


# --------------------------------------------------------- native store
# twins of tests/test_native_store.py

def _arena():
    from ray_tpu_torch._native import Arena
    from ray_tpu_torch._private.object_store import ARENA_PREFIX

    return Arena.create(f"{ARENA_PREFIX}{os.getpid()}_t"
                        f"{random.randint(0, 1 << 30)}", 32 * 1024 * 1024)


def _with_arena(fn):
    a = _arena()
    try:
        fn(a)
    finally:
        a.close(unlink=True)


def native_alloc_write_read():
    def run(arena):
        off = arena.alloc(100)
        assert off > 0
        arena.view(off, 3)[:] = b"abc"
        assert bytes(arena.view(off, 3)) == b"abc"
        arena.free(off)
        assert arena.num_allocs == 0

    _with_arena(run)


def native_alignment():
    def run(arena):
        offs = [arena.alloc(random.randint(1, 1000)) for _ in range(50)]
        assert all(o % 8 == 0 for o in offs)
        for o in offs:
            arena.free(o)

    _with_arena(run)


def native_exhaustion_returns_zero():
    def run(arena):
        assert arena.alloc(64 * 1024 * 1024) == 0  # bigger than the arena
        offs = []
        while True:
            o = arena.alloc(1024 * 1024)
            if o == 0:
                break
            offs.append(o)
        assert len(offs) >= 28  # ~32MB arena minus metadata
        for o in offs:
            arena.free(o)
        big = arena.alloc(16 * 1024 * 1024)  # full coalescing
        assert big != 0
        arena.free(big)

    _with_arena(run)


def native_free_coalescing_and_reuse():
    def run(arena):
        a1 = arena.alloc(1000)
        a2 = arena.alloc(1000)
        a3 = arena.alloc(1000)
        arena.free(a2)
        arena.free(a1)  # backward coalesce with a2's block
        a4 = arena.alloc(1900)  # fits only if coalesced
        assert a4 != 0
        arena.free(a3)
        arena.free(a4)
        assert arena.used_bytes == 0

    _with_arena(run)


def native_double_free_ignored():
    def run(arena):
        off = arena.alloc(100)
        arena.free(off)
        arena.free(off)  # must not corrupt
        assert arena.num_allocs == 0
        assert arena.alloc(100) != 0

    _with_arena(run)


def native_random_stress():
    def run(arena):
        rng = random.Random(7)
        live = {}
        for i in range(5000):
            if live and (rng.random() < 0.5 or len(live) > 200):
                k = rng.choice(list(live))
                off, size, pat = live.pop(k)
                assert bytes(arena.view(off, size)) == bytes([pat]) * size
                arena.free(off)
            else:
                size = rng.randint(1, 100_000)
                off = arena.alloc(size)
                if off:
                    pat = rng.randint(0, 255)
                    arena.view(off, size)[:] = bytes([pat]) * size
                    live[i] = (off, size, pat)
        for off, size, pat in live.values():
            assert bytes(arena.view(off, size)) == bytes([pat]) * size
            arena.free(off)
        assert arena.num_allocs == 0 and arena.used_bytes == 0

    _with_arena(run)


def attach_and_read(name, off, n, q):
    """Target of native_cross_process_read's reader process."""
    from ray_tpu_torch._native import Arena

    b = Arena.attach(name)
    q.put(bytes(b.view(off, n)))
    b.close()


def native_cross_process_read():
    def run(arena):
        off = arena.alloc(1 << 20)
        data = np.random.default_rng(0).bytes(1 << 20)
        arena.view(off, 1 << 20)[:] = data
        ctx = mp.get_context("spawn")
        q = ctx.Queue()
        p = ctx.Process(target=attach_and_read,
                        args=(arena.name, off, 1 << 20, q))
        p.start()
        try:
            assert q.get(timeout=30) == data
        finally:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
        assert not p.is_alive()
        arena.free(off)

    _with_arena(run)


def native_odd_arena_size():
    from ray_tpu_torch._native import Arena
    from ray_tpu_torch._private.object_store import ARENA_PREFIX

    a = Arena.create(f"{ARENA_PREFIX}{os.getpid()}_odd", 1_000_001)
    offs = [o for o in (a.alloc(10_000) for _ in range(50)) if o]
    for o in offs:
        a.free(o)
    assert a.used_bytes == 0
    a.close(unlink=True)


def native_delete_reclaims_arena_blocks():
    """put/delete cycles return blocks to the allocator, even while the
    user still holds the ORIGINAL value."""
    w = _worker()
    assert w.store._arena is not None
    w.store._QUARANTINE_S = 0.0
    baseline = w.store._arena.num_allocs
    held = []
    for _ in range(10):
        x = np.full(500_000, 7.0)
        held.append(x)  # user keeps the original alive
        ref = rt.put(x)
        assert np.all(rt.get(ref) == 7.0)
        w.store.delete(ref.id)
    w.store._drain_quarantine(everything=True)
    assert w.store._arena.num_allocs == baseline, "arena blocks leaked"


def native_store_integration_uses_arena():
    """A large task arg travels through the owner's arena."""
    w = _worker()
    assert w.store._arena is not None

    @rt.remote
    def roundtrip(x):
        return x.sum()

    x = np.arange(500_000, dtype=np.float64)  # 4MB > shm_threshold
    before = w.store._arena.num_allocs
    ref = rt.put(x)
    assert w.store._arena.num_allocs == before + 1
    assert rt.get(roundtrip.remote(ref)) == x.sum()


def native_cleanup_leaked_segments():
    """Dead-pid segments of the port are swept, live-pid ones kept, and
    the JAX package's segments are never touched."""
    from ray_tpu_torch._private.object_store import cleanup_leaked_segments

    dead = "/dev/shm/rtt_a_999999999_deadbeef"
    dead_seg = "/dev/shm/rtt_s_999999999_deadbeef"
    live = f"/dev/shm/rtt_a_{os.getpid()}_cafecafe"
    other = "/dev/shm/rtpu_a_999999999_deadbeef"
    for p in (dead, dead_seg, live, other):
        with open(p, "wb") as f:
            f.write(b"x")
    try:
        assert cleanup_leaked_segments() >= 2
        assert not os.path.exists(dead)
        assert not os.path.exists(dead_seg)
        assert os.path.exists(live)
        assert os.path.exists(other)
    finally:
        for p in (dead, dead_seg, live, other):
            try:
                os.unlink(p)
            except OSError:
                pass


# --------------------------------------------------------- object plane
# twins of tests/test_object_plane.py

def _store(cap, tag):
    import tempfile

    from ray_tpu_torch._private.object_store import LocalObjectStore

    return LocalObjectStore(cap=cap, spill_dir=tempfile.mkdtemp(prefix=tag))


def object_plane_put_beyond_cap_all_readable():
    store = _store(1 * 1024 * 1024, "spill")
    arrays = {}
    for i in range(12):  # 12 x 256KB = 3MB >> 1MB cap
        oid = f"obj{i:02d}"
        arrays[oid] = np.random.default_rng(i).integers(
            0, 255, size=256 * 1024, dtype=np.uint8)
        store.put_value(oid, arrays[oid])
    st = store.stats()
    assert st["spilled_objects"] > 0, "nothing was spilled"
    assert st["bytes"] <= 1 * 1024 * 1024 * 1.1
    for oid, want in arrays.items():
        store._deserialized_cache.pop(oid, None)  # force real read path
        np.testing.assert_array_equal(store.get_local(oid), want)
    store.shutdown()


def object_plane_spill_restore_survives_reeviction():
    store = _store(512 * 1024, "s")
    a = np.arange(100_000, dtype=np.int64)
    b = np.arange(100_000, dtype=np.float32) * 2.5
    store.put_value("a", a)
    store.put_value("b", b)  # evicts a to disk
    store._deserialized_cache.clear()
    np.testing.assert_array_equal(store.get_local("a"), a)  # restore a
    store._deserialized_cache.clear()
    np.testing.assert_array_equal(store.get_local("b"), b)
    np.testing.assert_array_equal(store.get_local("a"), a)
    store.shutdown()


def object_plane_read_range_matches_stream():
    store = _store(64 * 1024 * 1024, "s")
    arr = np.random.default_rng(0).standard_normal(50_000).astype(np.float64)
    store.put_value("x", arr)
    meta, total, sizes = store.stream_info("x")
    assert total == sum(sizes)
    whole = store.read_range("x", 0, total)
    assert len(whole) == total
    got = bytearray()
    pos = 0
    for chunk in (1000, 37, 100_000, total):
        take = min(chunk, total - pos)
        got += store.read_range("x", pos, take)
        pos += take
        if pos >= total:
            break
    assert bytes(got) == whole
    with store._cv:  # after spilling, identical ranges come from the file
        assert store._spill_entry_locked("x", store._entries["x"])
    assert store.read_range("x", 0, total) == whole
    store.shutdown()


def object_plane_error_entries_not_spilled():
    store = _store(1024, "s")
    store.put_error("e", exc.ObjectLostError("e", "boom"))
    store.put_value("big", np.zeros(10_000))
    _raises(exc.ObjectLostError, store.get_local, "e")
    store.shutdown()


# the forced-remote cluster: every process claims a distinct machine id
# and chunks are 256KB, so one box runs the cross-host chunked protocol
FORCED_REMOTE = {"num_cpus": 2, "_system_config": {
    "force_remote_fetch": 1, "fetch_chunk": 256 * 1024}}


def object_plane_cross_host_chunked_fetch():
    @rt.remote
    def big():
        rng = np.random.default_rng(7)
        return rng.integers(0, 255, size=3 * 1024 * 1024, dtype=np.uint8)

    ref = big.remote()
    got = rt.get(ref, timeout=120.0)
    want = np.random.default_rng(7).integers(
        0, 255, size=3 * 1024 * 1024, dtype=np.uint8)
    np.testing.assert_array_equal(got, want)
    # the value rode the stream path, not a shm-name handoff
    entry = _worker().store._entries[ref.id]
    assert entry.shm_name is None, "cross-host fetch still used a shm handoff"
    assert entry.buffers is not None


def object_plane_cross_host_small_inline():
    @rt.remote
    def small():
        return {"x": np.arange(10), "s": "hello"}

    got = rt.get(small.remote(), timeout=60.0)
    np.testing.assert_array_equal(got["x"], np.arange(10))
    assert got["s"] == "hello"


# ----------------------------------------------------------- fork server
# twins of tests/test_fork_server.py

def _sleeper():
    return subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(30)"])


def fork_forked_proc_liveness_and_signals():
    from ray_tpu_torch._private.fork_server import proc_start_time
    from ray_tpu_torch._private.worker_spawn import ForkedProc

    proc = _sleeper()
    fp = ForkedProc(proc.pid, proc_start_time(proc.pid))
    assert fp.poll() is None
    fp.terminate()
    proc.wait(timeout=10)  # the real parent (us) reaps
    deadline = time.monotonic() + 5
    while fp.poll() is None and time.monotonic() < deadline:
        time.sleep(0.02)
    assert fp.poll() == 0
    fp.kill()  # signalling a dead pid is a no-op, not an error
    assert fp.wait(timeout=1) == 0


def fork_forked_proc_wait_timeout():
    from ray_tpu_torch._private.fork_server import proc_start_time
    from ray_tpu_torch._private.worker_spawn import ForkedProc

    proc = _sleeper()
    fp = ForkedProc(proc.pid, proc_start_time(proc.pid))
    _raises(subprocess.TimeoutExpired, fp.wait, timeout=0.2)
    proc.kill()
    proc.wait(timeout=10)


def fork_cluster_uses_fork_server_and_workers_die_fast():
    @rt.remote
    def f():
        return os.getpid()

    pids = set(rt.get([f.remote() for _ in range(8)], timeout=60.0))
    assert pids
    session = _worker().session_dir
    assert os.path.exists(os.path.join(session, "fork_server.sock"))
    pid = next(iter(pids))
    os.kill(pid, signal.SIGTERM)
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return
        time.sleep(0.05)
    raise AssertionError(f"worker {pid} still visible 5s after SIGTERM")


def fork_cached_lease_survives_worker_crash():
    """A worker can die while its lease sits in the driver's reuse
    cache; the next task falls back to a fresh lease via the
    crash-retry path. The lease idle TTL is pinned up so the reaper
    cannot win the race against the cached-lease assertion."""
    rt.init(num_cpus=4, _system_config={"lease_idle_ttl": 5.0})

    @rt.remote
    def whoami():
        return os.getpid()

    pid = rt.get(whoami.remote(), timeout=60.0)
    gw = _worker()
    with gw._lease_cache_lock:
        cached = [wid for lst in gw._lease_cache.values()
                  for wid, _, _ in lst]
    assert cached, "lease was not recached after the task"
    os.kill(pid, signal.SIGKILL)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            break
        time.sleep(0.05)
    assert rt.get(whoami.remote(), timeout=60.0) != pid


# ---------------------------------------------------------------- config
# twins of tests/test_config.py; the port reads no RAY_TPU_* variable

def config_defaults_and_system_config_resolution():
    from ray_tpu_torch._private.config import RayTpuConfig

    cfg = RayTpuConfig()
    assert cfg.get("worker_start_timeout") == 60.0
    os.environ["RAY_TPU_WORKER_START_TIMEOUT"] = "3.5"
    try:
        # the environment is not read
        assert cfg.get("worker_start_timeout") == 60.0
    finally:
        del os.environ["RAY_TPU_WORKER_START_TIMEOUT"]
    cfg.apply({"worker_start_timeout": "3.5"})
    assert cfg.get("worker_start_timeout") == 3.5
    assert cfg.worker_start_timeout == 3.5  # attribute sugar


def config_unknown_flag_rejected():
    from ray_tpu_torch._private.config import config

    _raises(KeyError, config.get, "not_a_flag")
    _raises(ValueError, config.apply, {"not_a_flag": 1})
    # the JAX package's flags with no counterpart are unknown here, so
    # setting one for an unported subsystem raises instead of doing nothing
    _raises(KeyError, config.get, "pallas_interpret")
    _raises(KeyError, config.get, "chips")
    before = config.snapshot()
    _raises(ValueError, rt.init, num_cpus=1,
            _system_config={"data_memory_budget": 2})
    _raises(ValueError, rt.init, num_cpus=1,
            _system_config={"workflow_storage": "/tmp/x"})
    assert not rt.is_initialized() and config.snapshot() == before


def config_apply_exports_nothing():
    """apply() changes the table only; the environment stays as it is
    (the JAX package exports RAY_TPU_<NAME>)."""
    from ray_tpu_torch._private.config import RayTpuConfig

    before = dict(os.environ)
    cfg = RayTpuConfig()
    prior = cfg.apply({"fetch_chunk": 12345})
    assert cfg.get("fetch_chunk") == 12345
    assert cfg.snapshot() == {"fetch_chunk": 12345}
    assert dict(os.environ) == before
    cfg.restore(prior)
    assert cfg.get("fetch_chunk") == 64 * 1024 * 1024
    assert cfg.snapshot() == {}


def config_describe_lists_all_flags():
    from ray_tpu_torch._private.config import RayTpuConfig

    cfg = RayTpuConfig()
    cfg.apply({"arena_size": 1 << 20})
    rows = {r["name"]: r for r in cfg.describe()}
    assert rows["arena_size"]["value"] == 1 << 20
    assert rows["arena_size"]["source"] == "system_config"
    assert rows["object_store_cap"]["source"] == "default"
    assert all(r["doc"] for r in rows.values())


def config_system_config_reaches_the_runtime():
    """An object-store override handed to init() governs the driver's
    store AND its workers' (the table reaches them through the spawn)."""
    rt.init(num_cpus=1, _system_config={"object_store_cap": 256 * 1024})
    w = _worker()
    refs = [rt.put(np.zeros(64 * 1024, dtype=np.uint8))
            for _ in range(8)]  # 512KB total > 256KB cap
    assert w.store.stats()["spilled_objects"] > 0
    for r in refs:
        assert rt.get(r, timeout=30.0).nbytes == 64 * 1024

    @rt.remote
    def cap():
        from ray_tpu_torch._private.config import config

        return config.object_store_cap

    assert rt.get(cap.remote(), timeout=30.0) == 256 * 1024


def config_system_config_restored_on_shutdown():
    from ray_tpu_torch._private.config import config

    assert config.fetch_chunk == 64 * 1024 * 1024
    rt.init(num_cpus=1, _system_config={"fetch_chunk": 1024 * 1024})
    assert config.fetch_chunk == 1024 * 1024
    assert os.environ.get("RAY_TPU_FETCH_CHUNK") is None
    rt.shutdown()
    assert config.fetch_chunk == 64 * 1024 * 1024


# ------------------------------------------------------------ the port
# where the port differs from the JAX package's runtime

def _tensor_cases():
    import torch

    g = torch.Generator().manual_seed(0)
    big = torch.randn(512, 1024, generator=g)  # 2 MB: the arena
    grad = torch.randn(4, generator=g).requires_grad_(True)
    return big, {
        "bf16": torch.randn(64, 33, generator=g).to(torch.bfloat16),
        "fp32": torch.randn(7, 5, generator=g),
        "int64": torch.arange(-50, 50, dtype=torch.int64),
        "bool": torch.rand(10, generator=g) > 0.5,
        "zero_d": torch.tensor(3.25),
        "empty": torch.empty(0, 4),
        "non_contiguous": big.t()[::3],
        "offset_view": big[100:104, 10:20],
        "large": big,
        "parameter": torch.nn.Parameter(torch.randn(3, 3, generator=g)),
        "requires_grad": grad,
    }


def _same_tensor(label, got, want):
    import torch

    assert type(got) is type(want), (label, type(got), type(want))
    assert got.device.type == want.device.type, (label, got.device)
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (label, got.dtype, got.shape, want.dtype, want.shape)
    assert got.requires_grad == want.requires_grad, label
    assert torch.equal(got.detach(), want.detach()), label


@rt.remote
class TensorKeeper:
    """Holds tensors sent in and hands them back (both directions)."""

    def __init__(self):
        self.kept = None

    def keep(self, tensors):
        self.kept = tensors
        return sorted(tensors)

    def give(self):
        return self.kept


def port_tensor_round_trips_cpu():
    """CPU tensors of every kind come back bit-equal, on the CPU, with
    their class, dtype, shape and requires_grad: through put/get read
    back from the store, a task (as a value and as a ref) and an actor
    both ways. A small view of a large tensor ships only the view's
    bytes; a tensor past shm_threshold takes the arena."""
    import torch

    from ray_tpu_torch._private import serialization

    big, cases = _tensor_cases()
    w = _worker()
    for label, t in cases.items():
        ref = rt.put(t)  # never cached: the get reads the store
        _same_tensor(label, rt.get(ref), t)
    meta, bufs = serialization.serialize(cases["offset_view"])
    assert [b.nbytes for b in bufs] == [4 * 10 * 4], bufs
    assert len(meta) < 1024, len(meta)
    ref = rt.put(big)
    assert w.store._entries[ref.id].shm_name.startswith("arena:")

    @rt.remote
    def echo(x):
        assert not torch.cuda.is_available()  # a host worker
        return x

    for label, t in cases.items():
        _same_tensor(label + " (task value)", rt.get(echo.remote(t)), t)
        _same_tensor(label + " (task ref)",
                     rt.get(echo.remote(rt.put(t))), t)
    keeper = TensorKeeper.remote()
    assert rt.get(keeper.keep.remote(cases)) == sorted(cases)
    back = rt.get(keeper.give.remote())
    for label, t in cases.items():
        _same_tensor(label + " (actor)", back[label], t)


@rt.remote
class TensorOwner:
    """Owns a put of its own, and returns a tensor it keeps writing."""

    def __init__(self):
        import torch

        self.live = torch.zeros(4)

    def put_write_get(self):
        import torch

        x = torch.arange(8, dtype=torch.float32)
        ref = rt.put(x)
        x.add_(1)
        rt.get(ref).add_(1)
        return rt.get(ref)

    def state(self):
        return self.live

    def bump(self):
        self.live.add_(1)


@rt.remote
def _read_write_read(box):
    rt.get(box[0]).add_(1)
    return rt.get(box[0])


def port_tensor_puts_are_snapshots():
    """A put or a task's result holds the tensor as it was then. Writing
    the put tensor in place, or a tensor a get returned, changes no
    later get: in the owner (the driver or a worker) and in a reader,
    for an inline object and one in the arena, or in per-object
    segments where the cluster runs with native_store=0."""
    import torch

    from ray_tpu_torch._private.config import config

    w = _worker()
    for n in (8, 256 * 1024):  # inline; past shm_threshold
        label = "inline" if n == 8 else (
            "arena" if config.native_store else "segment")
        x = torch.arange(n, dtype=torch.float32)
        want = x.clone()
        ref = rt.put(x)
        if n > 8:
            where = w.store._entries[ref.id].shm_name
            assert where.startswith("arena:") == bool(config.native_store), \
                where
        x.add_(1)
        got = rt.get(ref)
        _same_tensor(label + " (owner)", got, want)
        got.add_(1)
        _same_tensor(label + " (owner, again)", rt.get(ref), want)
        _same_tensor(label + " (reader)",
                     rt.get(_read_write_read.remote([ref]), timeout=60.0),
                     want)
        _same_tensor(label + " (owner, after the reader)", rt.get(ref),
                     want)
    owner = TensorOwner.remote()
    _same_tensor("worker owner",
                 rt.get(owner.put_write_get.remote(), timeout=60.0),
                 torch.arange(8, dtype=torch.float32))
    ref = owner.state.remote()
    rt.get(owner.bump.remote(), timeout=60.0)
    _same_tensor("actor result", rt.get(ref, timeout=60.0), torch.zeros(4))


def port_tensor_puts_are_snapshots_in_segments():
    """The same, on a cluster with native_store=0: large objects lie in
    per-object segments, whose mappings are writable."""
    port_tensor_puts_are_snapshots()


class CudaRecord:
    """What the serializer writes for a CUDA tensor, made by hand: no
    CUDA tensor exists where these checks run."""

    def __init__(self, data: bytes):
        self.data = data

    def __reduce__(self):
        import pickle

        from ray_tpu_torch._private.serialization import _rebuild_tensor

        return (_rebuild_tensor,
                ("tensor", "float32", (len(self.data) // 4,), False, "cuda",
                 pickle.PickleBuffer(bytearray(self.data))))


def port_cuda_record_needs_a_gpu_lease():
    """A CUDA tensor's record loads only where a GPU is leased: a host
    worker's get raises an error that names the object and the missing
    lease, and never returns a CPU tensor. So does the driver's, where
    it sees no GPU."""
    import torch

    from ray_tpu_torch._private.serialization import GpuLeaseRequiredError

    rec = CudaRecord(np.arange(8, dtype=np.float32).tobytes())
    ref = rt.put(rec)

    @rt.remote
    def load(x):
        return x

    e = _raises(exc.TaskError, rt.get, load.remote(ref), timeout=60.0)
    assert isinstance(e.cause, GpuLeaseRequiredError), e
    assert ref.id in str(e.cause) and "no GPU lease" in str(e.cause), e

    @rt.remote
    def load_boxed(box):
        try:
            rt.get(box[0])
        except GpuLeaseRequiredError as err:
            return str(err)
        return "loaded"

    said = rt.get(load_boxed.remote([ref]), timeout=60.0)
    assert ref.id in said and "no GPU lease" in said, said
    if not torch.cuda.is_available():
        e = _raises(GpuLeaseRequiredError, rt.get, ref)
        assert ref.id in str(e)


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


@rt.remote(num_gpus=1)
class GpuHolder:
    def where(self):
        from ray_tpu_torch._private.worker_spawn import ENV_GPU_INDICES

        return {"visible": os.environ["CUDA_VISIBLE_DEVICES"],
                "indices": os.environ[ENV_GPU_INDICES],
                "pid": os.getpid(), "ppid": os.getppid()}


def port_gpu_leases_follow_the_visible_list():
    """Whole-GPU leases under a driver started with
    CUDA_VISIBLE_DEVICES=3,5 and two GPUs counted: the workers are
    spawned cold and bound to "3" and "5" (the driver's ids, not the
    pool's indices); host workers and fractional shares see no GPU. A
    killed GPU actor's GPU returns to the pool only once its process
    has exited, and the next GPU actor gets it. worker_env cannot hand
    host workers a GPU past the leases."""
    e = _raises(ValueError, rt.init, num_cpus=1, resources={"GPU": 1},
                worker_env={"CUDA_VISIBLE_DEVICES": "0"})
    assert "CUDA_VISIBLE_DEVICES" in str(e), e
    assert not rt.is_initialized()
    old = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = "3,5"
    try:
        rt.init(num_cpus=2, resources={"GPU": 2})
        assert rt.cluster_resources()["GPU"] == 2.0

        @rt.remote(num_gpus=1)
        def gpu_task():
            return os.environ["CUDA_VISIBLE_DEVICES"]

        @rt.remote
        def host_task():
            return os.environ["CUDA_VISIBLE_DEVICES"]

        assert rt.get(gpu_task.remote(), timeout=60.0) in ("3", "5")
        assert rt.get(host_task.remote(), timeout=60.0) == ""
        assert rt.get(host_task.options(num_gpus=0.5).remote(),
                      timeout=60.0) == ""
        a, b = GpuHolder.remote(), GpuHolder.remote()
        wa, wb = rt.get([a.where.remote(), b.where.remote()], timeout=60.0)
        assert {wa["visible"], wb["visible"]} == {"3", "5"}, (wa, wb)
        assert {wa["indices"], wb["indices"]} == {"0", "1"}, (wa, wb)
        for where in (wa, wb):  # cold: the driver's own child
            assert where["ppid"] == os.getpid(), where
        assert rt.available_resources()["GPU"] == 0.0
        rt.kill(a)
        deadline = time.monotonic() + 15.0
        while rt.available_resources()["GPU"] < 1.0:
            assert time.monotonic() < deadline, "GPU never returned"
            time.sleep(0.02)
        assert not _alive(wa["pid"]), "GPU back before its process exited"
        c = GpuHolder.remote()
        wc = rt.get(c.where.remote(), timeout=60.0)
        assert wc["visible"] == wa["visible"], (wc, wa)
    finally:
        if old is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES", None)
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = old


def port_recycled_pid_is_not_signalled():
    """A worker handle whose pid now names another process (same pid,
    another start time) reports the worker exited and never signals
    that process; the fork template reports each worker's real start
    time."""
    import errno

    from ray_tpu_torch._private.fork_server import proc_start_time
    from ray_tpu_torch._private.worker_spawn import ForkedProc

    def no_pidfd(pid):
        raise OSError(errno.ENOSYS, "Function not implemented")

    real_pidfd_open = os.pidfd_open
    for pidfd_open in (real_pidfd_open, no_pidfd):  # a kernel without them
        os.pidfd_open = pidfd_open
        proc = _sleeper()
        try:
            fp = ForkedProc(proc.pid, proc_start_time(proc.pid) + 1)
            assert fp.poll() == 0
            fp.kill()
            fp.terminate()
            time.sleep(0.2)
            assert proc.poll() is None, "an unrelated process was signalled"
            fp = ForkedProc(proc.pid, proc_start_time(proc.pid))
            assert fp.poll() is None
            fp.kill()
            assert proc.wait(timeout=10) == -signal.SIGKILL
        finally:
            os.pidfd_open = real_pidfd_open
            proc.kill()
            proc.wait(timeout=10)
    rt.init(num_cpus=2)

    @rt.remote
    def pid():
        return os.getpid()

    rt.get([pid.remote() for _ in range(4)], timeout=60.0)
    forked = [w.proc for w in rt._conductor.handler._workers.values()
              if isinstance(w.proc, ForkedProc)]
    assert forked, "no worker came from the fork template"
    for p in forked:
        assert p.start_time == proc_start_time(p.pid), p.pid
        assert p.poll() is None


def port_driver_refuses_process_exits():
    """shutdown_worker, a force cancel and exit_actor's exit end a
    worker, never the driver: sent to the driver they raise, and the
    driver goes on."""
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch._private.rpc import RemoteError

    driver = _worker().address

    @rt.remote
    def poke(addr):
        c = rt._private.worker.global_worker.clients.get(tuple(addr))
        said = []
        for method, args in (("shutdown_worker", ()),
                             ("cancel_task", (["x" * 32], True))):
            try:
                c.call(method, *args, timeout=10.0)
                said.append("ran")
            except RemoteError as e:
                said.append(f"{type(e.cause).__name__}: {e.cause}")
        return said

    said = rt.get(poke.remote(driver), timeout=60.0)
    assert all(s.startswith("RuntimeError") and "driver" in s
               for s in said), said
    _raises(RuntimeError, worker_mod._refuse_in_driver, _worker(), "exit")
    time.sleep(0.3)  # a refused exit would have ended us by now
    assert rt.get(rt.put(41)) == 41


def port_failed_arena_build_raises():
    """With native_store=1 (the default) a failed arena build raises;
    the store never falls back to per-object segments on its own.
    native_store=0 chooses them, named with the port's prefix."""
    import tempfile

    from ray_tpu_torch import _native
    from ray_tpu_torch._private.config import config
    from ray_tpu_torch._private.object_store import (SEGMENT_PREFIX,
                                                     LocalObjectStore)

    bad = os.path.join(tempfile.mkdtemp(prefix="badsrc"), "shm_store.cc")
    with open(bad, "w") as f:
        f.write("this is not C++\n")
    saved = (_native._SRC, _native._lib)
    _native._SRC, _native._lib = type(saved[0])(bad), None
    try:
        e = _raises(RuntimeError, LocalObjectStore)
        assert "building the shm arena failed" in str(e), e
        prior = config.apply({"native_store": 0})
        try:
            store = LocalObjectStore()
            assert store._arena is None
            store.put_value("x", np.ones(1 << 20, dtype=np.uint8))
            entry = store._entries["x"]
            assert entry.shm_name.startswith(SEGMENT_PREFIX), entry.shm_name
            store._deserialized_cache.clear()
            assert store.get_local("x").sum() == 1 << 20
            store.shutdown()
        finally:
            config.restore(prior)
    finally:
        _native._SRC, _native._lib = saved


# the L6 report and get methods wait for their subsystems (ROADMAP
# Queue 1 items 3-8)
OMITTED_RPCS = [
    ("get_kvcache_stats", ()),
    ("get_lora_status", ()),
]


def port_omitted_parts_raise():
    """What the port leaves out raises: the conductor's omitted RPCs
    are absent (not stubs), and the API's unported options and hooks
    raise NotImplementedError naming the ROADMAP item."""
    from ray_tpu_torch._private.rpc import RemoteError

    rt.init(num_cpus=2)
    conductor = _worker().conductor
    for method, args in OMITTED_RPCS:
        e = _raises(RemoteError, conductor.call, method, *args, timeout=10.0)
        assert isinstance(e.cause, AttributeError), (method, e)

    def f():
        return 1

    e = _raises(NotImplementedError, rt.remote(num_tpus=1), f)
    assert "num_gpus" in str(e), e
    _raises(NotImplementedError, rt.remote(f).bind)
    c = Counter.remote()
    e = _raises(exc.TaskError, rt.get,
                c._invoke("__ray_tpu_compiled_loop__", (), {}), timeout=30.0)
    assert isinstance(e.cause, NotImplementedError), e
    assert "ROADMAP Queue 1" in str(e.cause), e
    assert rt.get(c.incr.remote()) == 1  # the actor goes on


def port_fork_template_imports_no_torch():
    """The template (whose modules every forked worker starts with)
    imports no torch, and host workers are its children."""
    from ray_tpu_torch._private import worker_spawn

    @rt.remote
    def modules():
        return "torch" in sys.modules, os.getppid()

    has_torch, ppid = rt.get(modules.remote(), timeout=60.0)
    assert not has_torch
    template = worker_spawn._fork_servers[_worker().session_dir].proc.pid
    assert ppid == template, (ppid, template)


def port_package_import_is_lazy():
    """Importing the package imports no torch; resolve_device still
    comes from the package root."""
    code = ("import sys, ray_tpu_torch\n"
            "assert 'torch' not in sys.modules\n"
            "from ray_tpu_torch import resolve_device\n"
            "assert resolve_device('cpu').type == 'cpu'\n"
            "assert 'torch' in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def port_reads_no_ray_tpu_knob():
    """RAY_TPU_* variables in the driver's environment change nothing,
    and the runtime wires its processes with RTT_* variables only."""
    knobs = {"RAY_TPU_OBJECT_STORE_CAP": "1024",
             "RAY_TPU_NO_FORK_SERVER": "1",
             "RAY_TPU_LEASE_IDLE_TTL": "100",
             "RAY_TPU_NODE_TIMEOUT": "1",
             "RAY_TPU_LOG_TO_DRIVER": "0",
             "RAY_TPU_ADDRESS": "127.0.0.1:1"}
    os.environ.update(knobs)
    try:
        rt.init(num_cpus=2)
        from ray_tpu_torch._private.config import config

        assert config.object_store_cap == 2 * 1024 ** 3
        assert _worker().store._cap == 2 * 1024 ** 3
        assert (config.node_timeout, config.log_to_driver) == (10.0, 1)
        assert rt._conductor is not None  # RAY_TPU_ADDRESS named no head

        @rt.remote
        def env():
            from ray_tpu_torch._private.config import config as c

            return ({k for k in os.environ if k.startswith("RTT_")},
                    c.object_store_cap, c.lease_idle_ttl)

        names, cap, ttl = rt.get(env.remote(), timeout=60.0)
        assert cap == 2 * 1024 ** 3 and ttl == 0.1, (cap, ttl)
        assert {"RTT_WORKER_ID", "RTT_CONDUCTOR",
                "RTT_SESSION_DIR"} <= names, names
        assert os.path.exists(os.path.join(_worker().session_dir,
                                           "fork_server.sock"))
    finally:
        for k in knobs:
            os.environ.pop(k, None)


def port_conductor_kv_pubsub_and_tables():
    """The conductor's internal KV (namespaces, overwrite=False), its
    pubsub pushed to a subscribed driver, and its actor and task-event
    tables."""
    import threading

    w = _worker()
    c = w.conductor
    assert c.call("kv_put", b"k1", b"v1", timeout=10.0) is True
    assert c.call("kv_put", b"k1", b"v2", False, timeout=10.0) is False
    assert c.call("kv_get", b"k1", timeout=10.0) == b"v1"
    assert c.call("kv_put", b"k1", b"other", True, "ns2", timeout=10.0)
    assert c.call("kv_get", b"k1", "ns2", timeout=10.0) == b"other"
    assert c.call("kv_keys", b"k", timeout=10.0) == [b"k1"]
    assert c.call("kv_del", b"k1", timeout=10.0) is True
    assert c.call("kv_get", b"k1", timeout=10.0) is None
    seen, arrived = [], threading.Event()

    def on_news(msg):
        seen.append(msg)
        arrived.set()

    w.subscribe_channel("news", on_news)
    c.call("publish", "news", {"x": 1}, timeout=10.0)
    assert arrived.wait(10.0) and seen == [{"x": 1}], seen
    a = Counter.remote()
    assert rt.get(a.incr.remote()) == 1
    assert any(x["actor_id"] == a.actor_id and x["state"] == "ALIVE"
               for x in c.call("list_actors", timeout=10.0))

    @rt.remote
    def traced():
        return 1

    assert rt.get([traced.remote() for _ in range(3)]) == [1, 1, 1]
    w._flush_task_events()
    _wait_until(lambda: sum(
        e["name"] == "traced" and e["status"] == "FINISHED"
        for e in c.call("get_task_events", timeout=10.0)) == 3,
        msg="task events not recorded")
