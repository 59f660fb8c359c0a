"""Checks of the runtime's user surface: runtime environments, the
multiprocessing / joblib shims, the ray:// client, tracing spans, the
device profile, metrics, the state API and the control-plane
microbenchmark. `isolated.run_checks` runs them in a driver process of
their own (tests/test_torch_{runtime_env,client,tracing,profiling,state,
perf_suite}.py make each one a test case).

They are twins of the JAX package's tests/test_runtime_env_{shims,pip,
conda_uv}.py, test_ray_client.py, test_tracing.py, test_profiling.py,
test_state.py and test_perf_suite.py, one function per case, named after
its file and case, plus the port's own: CUDA_VISIBLE_DEVICES refused in
env_vars, a job's whole runtime_env, the client's refusal of a CUDA
tensor and the span lane of the merged timeline. A check raises (an
AssertionError) to fail.

They live in the package because a worker imports by name what a check
pickles by reference (the module-level functions and classes here), and
the test modules import JAX, which no process of the port may. This
module imports no torch at the top: the fork template must not either.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import textwrap
import threading
import time
import zipfile

import ray_tpu_torch as rt
from ray_tpu_torch._private import runtime_env as renv
from ray_tpu_torch._private.runtime_checks import (_raises, _wait_until,
                                                   _worker)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# -------------------------------------------------- runtime env (shims)
# twins of tests/test_runtime_env_shims.py (4 CPUs each, as its fixture)

def renv_env_vars_applied_and_restored():
    @rt.remote
    def read_env():
        return os.environ.get("RTT_TEST_VAR")

    assert rt.get(read_env.options(
        runtime_env={"env_vars": {"RTT_TEST_VAR": "42"}}).remote(),
        timeout=60.0) == "42"
    # shared worker must NOT keep the var for the next plain task
    assert rt.get(read_env.remote(), timeout=60.0) is None


def renv_working_dir_staged():
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "data.txt"), "w") as f:
            f.write("staged!")
        with open(os.path.join(d, "helper_mod_rtt.py"), "w") as f:
            f.write("VALUE = 123\n")

        @rt.remote
        def read_from_wd():
            import helper_mod_rtt  # importable: working_dir on sys.path

            with open("data.txt") as f:
                return f.read(), helper_mod_rtt.VALUE

        out = rt.get(read_from_wd.options(
            runtime_env={"working_dir": d}).remote(), timeout=60.0)
    assert out == ("staged!", 123), out


def renv_py_modules():
    with tempfile.TemporaryDirectory() as d:
        pkg = os.path.join(d, "my_rtt_pkg")
        os.makedirs(pkg)
        with open(os.path.join(pkg, "__init__.py"), "w") as f:
            f.write("def answer():\n    return 7\n")

        @rt.remote
        def use_module():
            import my_rtt_pkg

            return my_rtt_pkg.answer()

        assert rt.get(use_module.options(
            runtime_env={"py_modules": [d]}).remote(), timeout=60.0) == 7


class EnvActor:
    def read(self):
        return os.environ.get("RTT_ACTOR_VAR")


def renv_actor_runtime_env_permanent():
    a = rt.remote(EnvActor).options(
        runtime_env={"env_vars": {"RTT_ACTOR_VAR": "actor"}}).remote()
    assert rt.get(a.read.remote(), timeout=60.0) == "actor"
    assert rt.get(a.read.remote(), timeout=60.0) == "actor"  # for life


def renv_unsupported_keys_rejected():
    @rt.remote
    def f():
        return 1

    e = _raises(ValueError,
                f.options(runtime_env={"pip": ["requests"]}).remote)
    assert "not supported" in str(e), e


def port_renv_cuda_visible_devices_refused():
    """env_vars may not set CUDA_VISIBLE_DEVICES, on a task or an actor:
    a GPU reaches a worker only through its lease."""
    @rt.remote
    def f():
        return 1

    spec = {"env_vars": {"CUDA_VISIBLE_DEVICES": "0"}}
    for make in (f.options(runtime_env=spec).remote,
                 rt.remote(EnvActor).options(runtime_env=spec).remote):
        e = _raises(ValueError, make)
        assert "CUDA_VISIBLE_DEVICES" in str(e), e


JOB_SCRIPT = """
import json, os
import ray_tpu_torch as rt
rt.init()

@rt.remote
def probe():
    import job_mod_rtt
    return (os.environ.get("RTT_JOB_VAR"), os.environ.get("RTT_TASK_VAR"),
            job_mod_rtt.VALUE)

base = rt.get(probe.remote(), timeout=60.0)
own = rt.get(probe.options(runtime_env={"env_vars": {
    "RTT_TASK_VAR": "task"}}).remote(), timeout=60.0)
import job_mod_rtt
print("JOB_RESULT", json.dumps([base, own, os.environ.get("RTT_JOB_VAR"),
                                job_mod_rtt.VALUE]))
rt.shutdown()
"""


def port_job_whole_runtime_env():
    """A job's runtime_env takes every key a task takes: the entrypoint
    runs with its env_vars and py_modules, and its driver's tasks inherit
    the whole of it under their own (env_vars merged)."""
    from ray_tpu_torch.job_submission import JobSubmissionClient

    with tempfile.TemporaryDirectory() as d:
        mods = os.path.join(d, "mods")
        os.makedirs(mods)
        with open(os.path.join(mods, "job_mod_rtt.py"), "w") as f:
            f.write("VALUE = 'py-module'\n")
        with open(os.path.join(d, "job.py"), "w") as f:
            f.write(JOB_SCRIPT)
        client = JobSubmissionClient()
        job = client.submit_job(
            entrypoint=f"{sys.executable} job.py",
            runtime_env={"working_dir": d, "py_modules": [mods],
                         "env_vars": {"RTT_JOB_VAR": "job"}})
        status = client.wait_until_finished(job, timeout=120.0)
        logs = client.get_job_logs(job)
    assert status == "SUCCEEDED", logs
    line = [x for x in logs.splitlines() if x.startswith("JOB_RESULT")]
    assert line, logs
    base, own, driver_var, driver_mod = json.loads(line[0].split(" ", 1)[1])
    assert base == ["job", None, "py-module"], base
    assert own == ["job", "task", "py-module"], own
    assert (driver_var, driver_mod) == ("job", "py-module")
    e = _raises(ValueError, client.submit_job, entrypoint="true",
                runtime_env={"pip": ["requests"]})
    assert "not supported" in str(e), e


# ---------------------------------------------------------------- shims

def _square(x):
    return x * x


def pool_map():
    from ray_tpu_torch.util.multiprocessing import Pool

    with Pool(processes=4) as p:
        assert p.map(_square, range(20)) == [x * x for x in range(20)]


def pool_apply_and_async():
    from ray_tpu_torch.util.multiprocessing import Pool

    with Pool() as p:
        assert p.apply(_square, (6,)) == 36
        r = p.apply_async(_square, (7,))
        assert r.get(timeout=60) == 49 and r.successful()


def pool_imap_orders():
    from ray_tpu_torch.util.multiprocessing import Pool

    with Pool() as p:
        assert list(p.imap(_square, range(10), chunksize=3)) == \
            [x * x for x in range(10)]
        assert sorted(p.imap_unordered(_square, range(10), chunksize=3)) \
            == sorted(x * x for x in range(10))


def pool_starmap_and_errors():
    from ray_tpu_torch.util.multiprocessing import Pool

    with Pool() as p:
        assert p.starmap(pow, [(2, 3), (3, 2)]) == [8, 9]
        _raises(Exception, p.map, lambda x: 1 / x, [1, 0, 2])
    _raises(ValueError, p.apply, _square, (1,))  # closed


def joblib_backend():
    import joblib

    from ray_tpu_torch.util.joblib import register_ray_tpu_torch

    register_ray_tpu_torch()
    with joblib.parallel_backend("ray_tpu_torch", n_jobs=4):
        out = joblib.Parallel()(joblib.delayed(_square)(i)
                                for i in range(16))
    assert out == [i * i for i in range(16)]


# ---------------------------------------------------- runtime env (pip)
# twins of tests/test_runtime_env_pip.py and test_runtime_env_conda_uv.py

WHEEL_PKG = "rtt_wheel_demo"


def make_wheel(dirpath: str) -> str:
    """Hand-roll a minimal valid wheel (a wheel is just a zip)."""
    name = f"{WHEEL_PKG}-1.0-py3-none-any.whl"
    path = os.path.join(dirpath, name)
    info = f"{WHEEL_PKG}-1.0.dist-info"
    with zipfile.ZipFile(path, "w") as z:
        z.writestr(f"{WHEEL_PKG}/__init__.py",
                   "VALUE = 42\n\ndef shout():\n    return 'wheel!'\n")
        z.writestr(f"{info}/METADATA",
                   f"Metadata-Version: 2.1\nName: {WHEEL_PKG}\n"
                   "Version: 1.0\n")
        z.writestr(f"{info}/WHEEL",
                   "Wheel-Version: 1.0\nGenerator: test\n"
                   "Root-Is-Purelib: true\nTag: py3-none-any\n")
        z.writestr(f"{info}/RECORD", "")
    return path


def make_pkg(dirpath: str, name: str, value) -> str:
    """A local source package (a pyproject.toml on setuptools)."""
    pkg = os.path.join(dirpath, name)
    os.makedirs(os.path.join(pkg, name))
    with open(os.path.join(pkg, name, "__init__.py"), "w") as f:
        f.write(f"VALUE = {value!r}\n")
    with open(os.path.join(pkg, "pyproject.toml"), "w") as f:
        f.write(textwrap.dedent(f"""
            [build-system]
            requires = []
            build-backend = "setuptools.build_meta"
            [project]
            name = "{name}"
            version = "0.0.1"
        """))
    return pkg


def make_fake_conda_env(root: str, name: str) -> str:
    """A minimal 'conda env': bin/python + a site-packages marker."""
    prefix = os.path.join(root, name)
    os.makedirs(os.path.join(prefix, "bin"))
    os.symlink(sys.executable, os.path.join(prefix, "bin", "python"))
    vi = f"python{sys.version_info.major}.{sys.version_info.minor}"
    sp = os.path.join(prefix, "lib", vi, "site-packages")
    os.makedirs(sp)
    with open(os.path.join(sp, "conda_marker_mod.py"), "w") as f:
        f.write("WHERE = 'conda-env'\n")
    return prefix


def pip_wheel_env():
    with tempfile.TemporaryDirectory() as d:
        wheel = make_wheel(d)

        @rt.remote(runtime_env={"pip": [wheel]})
        def use_pkg():
            import rtt_wheel_demo

            return rtt_wheel_demo.VALUE, rtt_wheel_demo.shout()

        assert rt.get(use_pkg.remote(), timeout=120.0) == (42, "wheel!")


def pip_env_cached_across_tasks():
    with tempfile.TemporaryDirectory() as d:
        wheel = make_wheel(d)

        @rt.remote(runtime_env={"pip": [wheel]})
        def site_dir():
            import rtt_wheel_demo

            return os.path.dirname(os.path.dirname(rtt_wheel_demo.__file__))

        d1 = rt.get(site_dir.remote(), timeout=120.0)
        d2 = rt.get(site_dir.remote(), timeout=120.0)
    assert d1 == d2  # content-keyed venv reused, not rebuilt


def pip_actor_env():
    with tempfile.TemporaryDirectory() as d:
        wheel = make_wheel(d)

        @rt.remote(runtime_env={"pip": [wheel]})
        class Uses:
            def val(self):
                import rtt_wheel_demo

                return rtt_wheel_demo.VALUE

        a = Uses.remote()
        assert rt.get(a.val.remote(), timeout=120.0) == 42


def port_pip_env_keeps_the_workers_torch():
    """The venv's site-packages goes onto sys.path, and the torch the
    worker imports stays the interpreter's own, not one the venv's base
    interpreter might hold."""
    import torch

    with tempfile.TemporaryDirectory() as d:
        wheel = make_wheel(d)

        @rt.remote(runtime_env={"pip": [wheel]})
        def where():
            import rtt_wheel_demo
            import torch as t

            return t.__file__, rtt_wheel_demo.__file__

        torch_file, pkg_file = rt.get(where.remote(), timeout=120.0)
    assert torch_file == torch.__file__, (torch_file, torch.__file__)
    assert os.path.join("runtime_env", "venvs") in pkg_file, pkg_file


class StampPlugin(renv.RuntimeEnvPlugin):
    """Module-level so WORKERS can import it via the env-var class path
    (reference RAY_RUNTIME_ENV_PLUGINS)."""

    name = "stamp"

    def validate(self, value):
        if not isinstance(value, str):
            raise ValueError("stamp must be str")
        return value

    def apply(self, conductor, value):
        os.environ["RTT_STAMP"] = value


def pip_custom_plugin():
    os.environ[renv.ENV_PLUGINS] = \
        "ray_tpu_torch._private.surface_checks:StampPlugin"
    renv._ENV_PLUGINS_LOADED = None  # re-scan under the new env var
    rt.init(num_cpus=2)
    try:
        @rt.remote(runtime_env={"stamp": "hello-plugin"})
        def read_stamp():
            return os.environ.get("RTT_STAMP")

        assert rt.get(read_stamp.remote(), timeout=60.0) == "hello-plugin"
    finally:
        rt.shutdown()
        os.environ.pop(renv.ENV_PLUGINS, None)
        renv._PLUGINS.pop("stamp", None)
        renv._ENV_PLUGINS_LOADED = None


def uv_env_installs_local_package():
    """End-to-end: a task under runtime_env={'uv': [...]} imports the
    package (pip fallback exercises the same venv when uv is absent)."""
    with tempfile.TemporaryDirectory() as d:
        pkg = make_pkg(d, "uvdemo_rtt_pkg", 41)
        rt.init(num_cpus=2)
        try:
            @rt.remote(runtime_env={"uv": [pkg]})
            def use():
                import uvdemo_rtt_pkg
                return uvdemo_rtt_pkg.VALUE

            assert rt.get(use.remote(), timeout=120.0) == 41
        finally:
            rt.shutdown()


def conda_env_activates_in_task():
    with tempfile.TemporaryDirectory() as d:
        prefix = make_fake_conda_env(d, "env_b")
        os.environ["CONDA_ENVS_PATH"] = d
        rt.init(num_cpus=2)
        try:
            @rt.remote(runtime_env={"conda": "env_b"})
            def use():
                import conda_marker_mod
                return (conda_marker_mod.WHERE,
                        os.environ.get("CONDA_DEFAULT_ENV"),
                        os.environ["PATH"].split(os.pathsep)[0])

            where, env_name, path0 = rt.get(use.remote(), timeout=60.0)
            assert where == "conda-env"
            assert env_name == "env_b"
            assert path0 == os.path.join(prefix, "bin")

            # task-scoped: the env does NOT leak into the next task
            @rt.remote
            def plain():
                return os.environ.get("CONDA_DEFAULT_ENV")

            assert rt.get(plain.remote(), timeout=60.0) is None
        finally:
            rt.shutdown()
            os.environ.pop("CONDA_ENVS_PATH", None)


# ---------------------------------------------------------------- client
# twins of tests/test_ray_client.py

CLIENT_SCRIPT = textwrap.dedent("""
    import os, sys
    import ray_tpu_torch as rt

    info = rt.init(address="ray://" + sys.argv[1])
    assert info.get("client") is True

    # put / get
    ref = rt.put({"k": [1, 2, 3]})
    assert rt.get(ref) == {"k": [1, 2, 3]}

    # tasks, with a client ref as an arg
    @rt.remote
    def add(a, b):
        return a + b

    r1 = add.remote(1, 2)
    r2 = add.remote(r1, rt.put(10))
    assert rt.get(r2) == 13

    # wait
    ready, not_ready = rt.wait([r1, r2], num_returns=2, timeout=10)
    assert len(ready) == 2 and not not_ready

    # errors propagate typed
    @rt.remote
    def boom():
        raise ValueError("client boom")

    try:
        rt.get(boom.remote())
        raise SystemExit("expected TaskError")
    except Exception as e:
        assert "client boom" in str(e)

    # actors
    @rt.remote
    class Counter:
        def __init__(self, start):
            self.n = start
        def bump(self, by=1):
            self.n += by
            return self.n

    c = Counter.remote(100)
    assert rt.get(c.bump.remote()) == 101
    assert rt.get(c.bump.remote(by=5)) == 106

    # conductor passthrough
    res = rt.cluster_resources()
    assert res.get("CPU", 0) > 0

    rt.shutdown()
    print("CLIENT_OK")
""")


def _client_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def _run_client(script: str, proxy) -> str:
    host, port = proxy.address
    r = subprocess.run([sys.executable, "-c", script, f"{host}:{port}"],
                       capture_output=True, text=True, timeout=120,
                       env=_client_env())
    assert r.returncode == 0, f"stdout={r.stdout}\nstderr={r.stderr}"
    return r.stdout


def client_end_to_end():
    from ray_tpu_torch.client import ClientProxy

    proxy = ClientProxy(host="127.0.0.1", port=0)
    try:
        assert "CLIENT_OK" in _run_client(CLIENT_SCRIPT, proxy)
    finally:
        proxy.stop()


def client_session_pins_released_on_disconnect():
    from ray_tpu_torch.client import ClientProxy, ClientWorker

    proxy = ClientProxy(host="127.0.0.1", port=0)
    try:
        handler = proxy.handler
        cw = ClientWorker(proxy.address)
        ref = cw.put(list(range(100)))
        sid = cw.session_id
        assert len(handler._sessions[sid].refs) == 1
        assert cw.get(ref) == list(range(100))
        cw.shutdown()
        assert sid not in handler._sessions
    finally:
        proxy.stop()


CLIENT_CUDA_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch._private.runtime_checks import CudaRecord
    from ray_tpu_torch._private.serialization import GpuLeaseRequiredError

    rt.init(address="ray://" + sys.argv[1])

    @rt.remote
    def make():
        return CudaRecord(np.arange(8, dtype=np.float32).tobytes())

    ref = make.remote()
    # the stand-in for a machine with a card: the client must refuse
    # the CUDA record for want of a lease, not of a device
    torch.cuda.is_available = lambda: True
    try:
        rt.get(ref, timeout=60.0)
        raise SystemExit("a client loaded a CUDA tensor")
    except GpuLeaseRequiredError as err:
        assert ref.id in str(err) and "no GPU lease" in str(err), err
    rt.shutdown()
    print("CLIENT_REFUSED")
""")


def port_client_cuda_get_refused():
    """A client holds no GPU lease: the proxy hands it a CUDA tensor's
    record unopened, and its get raises GpuLeaseRequiredError naming the
    object even where it sees a card."""
    from ray_tpu_torch.client import ClientProxy

    proxy = ClientProxy(host="127.0.0.1", port=0)
    try:
        assert "CLIENT_REFUSED" in _run_client(CLIENT_CUDA_SCRIPT, proxy)
    finally:
        proxy.stop()


# --------------------------------------------------------------- tracing
# twins of tests/test_tracing.py's cluster cases

def _spans_by_name(names: set, timeout: float = 15.0) -> dict:
    w = _worker()
    by_name: dict = {}

    def seen():
        w._flush_task_events()
        by_name.clear()
        for s in w.conductor.call("get_spans", timeout=10.0):
            by_name[s["name"]] = s
        return names <= set(by_name)

    _wait_until(seen, timeout, f"spans {names} never reached the conductor")
    return dict(by_name)


class _Tracing:
    """Tracing on in this driver for one check, off again after it."""

    def __enter__(self):
        from ray_tpu_torch.util import tracing

        tracing.enable()
        return tracing

    def __exit__(self, *exc_info) -> None:
        from ray_tpu_torch.util import tracing

        tracing._enabled = False
        os.environ.pop(tracing.ENV_TRACING, None)


def tracing_spans_cross_task_boundary():
    """One trace spans the full chain: driver section -> automatic
    submit span -> worker-side task span, all in the conductor's span
    table with correct parentage."""
    with _Tracing() as tracing:
        _spans_cross_task_boundary(tracing)


def _spans_cross_task_boundary(tracing):
    @rt.remote
    def traced_work(x):
        return x + 1

    with tracing.span("driver-section"):
        assert rt.get(traced_work.remote(1), timeout=60.0) == 2

    by_name = _spans_by_name({"task:traced_work", "submit:traced_work",
                              "driver-section"})
    task_span = by_name["task:traced_work"]
    submit_span = by_name["submit:traced_work"]
    driver_span = by_name["driver-section"]
    assert task_span["trace_id"] == driver_span["trace_id"]
    assert submit_span["trace_id"] == driver_span["trace_id"]
    assert task_span["parent_id"] == submit_span["span_id"]
    assert submit_span["parent_id"] == driver_span["span_id"]
    assert task_span["pid"] != driver_span["pid"]


class T:
    def m(self):
        return 1


def tracing_spans_cross_actor_boundary():
    a = rt.remote(T).remote()
    with _Tracing() as tracing, tracing.span("actor-call-site"):
        assert rt.get(a.m.remote(), timeout=60.0) == 1
    by_name = _spans_by_name({"actor:T.m", "actor-call-site"})
    assert by_name["actor:T.m"]["trace_id"] == \
        by_name["actor-call-site"]["trace_id"]


def tracing_conductor_span_buffer_capped():
    """report_spans is bounded the same way report_task_events is: the
    conductor's span table trims to 100k entries, so a chatty tracer
    cannot grow head memory without limit. Exercised on a bare handler,
    no cluster needed."""
    from ray_tpu_torch._private.conductor import ConductorHandler

    with tempfile.TemporaryDirectory() as d:
        handler = ConductorHandler({"CPU": 1.0}, d)
        span = {"name": "s", "trace_id": "t", "span_id": "i",
                "parent_id": None, "start": 0.0, "end": 0.0,
                "attrs": {}, "status": "OK", "pid": 0}
        handler.report_spans([dict(span) for _ in range(60_000)])
        handler.report_spans([dict(span) for _ in range(60_000)])
        assert len(handler.get_spans(limit=200_000)) <= 100_000


def port_tracing_spans_in_merged_timeline():
    """Spans reach the merged timeline's span lane (pid = recording
    process, tid = trace id prefix) beside the call's task event."""
    from ray_tpu_torch.util import state

    a = rt.remote(T).remote()
    with _Tracing() as tracing, tracing.span("timeline-root") as root:
        assert rt.get(a.m.remote(), timeout=60.0) == 1
    _spans_by_name({"actor:T.m", "timeline-root"})
    trace = state.timeline(merged=True)
    spans = [e for e in trace if e.get("cat") == "span"]
    lane = {e["name"]: e for e in spans if e["tid"] == root.trace_id[:8]}
    assert {"timeline-root", "actor:T.m"} <= set(lane), spans
    assert lane["actor:T.m"]["pid"] != lane["timeline-root"]["pid"]
    assert any(e.get("cat") == "task" and e["name"].endswith(".m")
               for e in trace)


# -------------------------------------------------------------- profiling
# twin of tests/test_profiling.py's remote case (device="cpu": no card)

class Model:
    def step(self, n):
        import torch

        x = torch.ones((n, n))
        return float(torch.mm(x, x).sum())


def profile_actor_remote_capture():
    from ray_tpu_torch.util import profiling

    m = rt.remote(Model).remote()
    assert rt.get(m.step.remote(64), timeout=60.0) > 0
    stop = threading.Event()

    def churn():
        while not stop.is_set():
            rt.get(m.step.remote(128), timeout=60.0)

    t = threading.Thread(target=churn, daemon=True)
    t.start()
    try:
        d = profiling.profile_actor(m, seconds=1.0, device="cpu")
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive()
    files = profiling.trace_files(d)
    assert files, os.listdir(d)
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    # the actor's calls ran on its executor threads, not the profiler's
    assert any(e.get("name") == "aten::mm" for e in events)


def port_device_profile_refused_without_cuda():
    """Without CUDA, a device profile (the default) raises on the worker
    instead of writing a CPU-only trace."""
    from ray_tpu_torch._private.rpc import RemoteError
    from ray_tpu_torch.util import profiling

    m = rt.remote(Model).remote()
    assert rt.get(m.step.remote(8), timeout=60.0) > 0
    e = _raises(RemoteError, profiling.profile_actor, m, seconds=0.1)
    assert "no CUDA device" in str(e.cause), e
    # the worker is free for the next profile
    d = profiling.profile_actor(m, seconds=0.1, device="cpu")
    assert profiling.trace_files(d)


# ------------------------------------------------------------------ state
# twins of tests/test_state.py (4 CPUs each, as its module fixture)

def state_list_nodes_and_workers():
    from ray_tpu_torch.util import state

    nodes = state.list_nodes()
    assert len(nodes) >= 1
    assert all(n["alive"] and "total" in n for n in nodes)


def state_list_tasks_and_summary():
    from ray_tpu_torch.util import state

    @rt.remote
    def tracked_task(x):
        time.sleep(0.01)
        return x

    rt.get([tracked_task.remote(i) for i in range(5)], timeout=60.0)
    tasks = state.list_tasks(name="tracked_task")
    assert len(tasks) >= 5
    assert all(t["end"] >= t["start"] for t in tasks)
    summary = state.summarize_tasks()
    assert summary["tracked_task"]["count"] >= 5
    assert summary["tracked_task"]["mean_s"] >= 0.005


def state_failed_task_status():
    from ray_tpu_torch.util import state

    @rt.remote
    def exploding():
        raise ValueError("nope")

    _raises(Exception, rt.get, exploding.remote(), timeout=60.0)
    tasks = state.list_tasks(name="exploding")
    assert any(t.get("status") == "FAILED" for t in tasks)


class Tracked:
    def ping(self):
        return 1


def state_list_actors():
    from ray_tpu_torch.util import state

    a = rt.remote(Tracked).options(name="state-test-actor").remote()
    rt.get(a.ping.remote(), timeout=60.0)
    actors = state.list_actors()
    assert any(rec.get("name") == "state-test-actor" for rec in actors)


def state_list_objects():
    import numpy as np

    from ray_tpu_torch.util import state

    ref = rt.put(np.ones(200_000))
    stats = state.list_objects()
    assert any(s.get("is_driver") for s in stats)
    assert sum(s["num_objects"] for s in stats) >= 1
    del ref


def state_timeline_chrome_trace():
    from ray_tpu_torch.util import state

    @rt.remote
    def traced():
        return 1

    rt.get([traced.remote() for _ in range(3)], timeout=60.0)
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "trace.json")
        trace = state.timeline(out)
        assert len(trace) >= 3
        with open(out) as f:
            loaded = json.load(f)
    ev = next(e for e in loaded if e["name"] == "traced")
    assert ev["ph"] == "X" and ev["dur"] >= 0 and "ts" in ev


def state_metrics_counter_gauge():
    from ray_tpu_torch.util import metrics, state

    c = metrics.Counter("test_requests_total", "reqs", tag_keys=("route",))
    c.inc(1, tags={"route": "/a"})
    c.inc(2, tags={"route": "/a"})
    c.inc(5, tags={"route": "/b"})
    g = metrics.Gauge("test_queue_depth", "depth")
    g.set(7)
    metrics.flush()
    text = state.prometheus_metrics()
    assert 'test_requests_total{route="/a"' in text
    assert "# TYPE test_requests_total counter" in text
    assert "test_queue_depth" in text and " 7" in text


def state_metrics_histogram():
    from ray_tpu_torch.util import metrics, state

    h = metrics.Histogram("test_latency_s", "lat",
                          boundaries=[0.01, 0.1, 1.0])
    for v in [0.005, 0.05, 0.5, 5.0]:
        h.observe(v)
    metrics.flush()
    text = state.prometheus_metrics()
    assert 'test_latency_s_bucket' in text
    assert 'le="+Inf"} 4' in text
    assert "test_latency_s_count" in text


def state_metrics_in_worker():
    from ray_tpu_torch.util import state

    @rt.remote
    def emits_metrics():
        from ray_tpu_torch.util import metrics as m

        c = m.Counter("test_worker_side_total", "from a task")
        c.inc(3)
        m.flush()
        return True

    assert rt.get(emits_metrics.remote(), timeout=60.0)
    # the flush is a one-way notify: bounded wait for it to land
    _wait_until(lambda: "test_worker_side_total"
                in state.prometheus_metrics(), 10.0,
                "the worker's metric never reached the conductor")


def state_cluster_summary():
    from ray_tpu_torch.util import state

    s = state.cluster_summary()
    assert s["resources_total"].get("CPU", 0) >= 4
    assert s["num_workers"] >= 0 and len(s["nodes"]) >= 1


def state_invalid_metric_usage():
    from ray_tpu_torch.util import metrics

    _raises(ValueError, metrics.Counter, "bad name!")
    c = metrics.Counter("test_valid_total", tag_keys=("k",))
    _raises(ValueError, c.inc, 1, tags={"unknown": "x"})
    _raises(ValueError, c.inc, -1)


def state_rpc_handler_stats():
    """The conductor's RPC server accounts per-method queue/handler
    latency (reference instrumented_io_context.h stats)."""
    from ray_tpu_torch.util import state

    @rt.remote
    def f():
        return 1

    assert rt.get([f.remote() for _ in range(5)], timeout=60.0) == [1] * 5
    stats = state.rpc_stats()
    assert "lease_worker" in stats, sorted(stats)
    s = stats["lease_worker"]
    # lease reuse pipelines same-shape tasks onto cached leases, so 5
    # tasks need >= 1 lease RPC, not 5
    assert s["count"] >= 1
    assert s["mean_handler_ms"] >= 0.0
    assert s["max_handler_ms"] >= s["mean_handler_ms"] - 1e-9
    assert s["max_queue_ms"] >= 0.0


def port_state_recent_logs():
    """The head's log tailer keeps the newest worker lines for the state
    API (the conductor's get_recent_logs)."""
    from ray_tpu_torch.util import state

    @rt.remote
    def speak():
        print("rtt-recent-log-marker", flush=True)
        return 1

    assert rt.get(speak.remote(), timeout=60.0) == 1
    _wait_until(lambda: any("rtt-recent-log-marker" in str(e.get("line"))
                            for e in state.recent_logs()), 15.0,
                "the worker's line never reached the conductor's ring")


# ------------------------------------------------------------ perf suite
# twins of tests/test_perf_suite.py

def perf_microbench_smoke():
    from ray_tpu_torch._private import perf

    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "micro.json")
        sink = perf.run(scale=0.02, out=out)
        names = {r["name"] for r in sink}
        assert {"task_roundtrip_sync", "tasks_async", "actor_call_sync",
                "actor_calls_async", "put_1kb", "put_100mb",
                "task_result_fetch_100mb", "queue_drain",
                "actor_churn"} <= names, names
        for r in sink:
            assert r["iters"] > 0
            ops = [v for k, v in r.items()
                   if k.endswith(("_per_s", "gb_per_s"))]
            assert ops and all(v > 0 for v in ops), r
        with open(out) as f:
            data = json.load(f)
    assert data["results"] == sink


def perf_pipelined_tasks_not_inverted():
    """Pipelined task throughput stays at least comparable to serial
    round trips (the JAX twin's 0.6 floor)."""
    rt.init(num_cpus=8)
    try:
        @rt.remote
        def f():
            return b"ok"

        rt.get([f.remote() for _ in range(50)], timeout=120.0)  # warm
        n = 200
        t0 = time.perf_counter()
        for _ in range(n):
            rt.get(f.remote(), timeout=60.0)
        sync_rate = n / (time.perf_counter() - t0)

        t0 = time.perf_counter()
        rt.get([f.remote() for _ in range(n)], timeout=120.0)
        async_rate = n / (time.perf_counter() - t0)
    finally:
        rt.shutdown()
    assert async_rate > 0.6 * sync_rate, (
        f"pipelined inversion returned: async {async_rate:.0f}/s vs "
        f"sync {sync_rate:.0f}/s")


def perf_actor_churn_floor():
    """create+call+kill waves sustain >= 10 actors/s (the JAX twin's
    floor). The class is defined here, as the twin's is: pickled by
    value, a new actor imports no module of the checks."""
    rt.init(num_cpus=8)
    try:
        @rt.remote
        class Cell:
            def __init__(self, v):
                self.v = v

            def get(self):
                return self.v

        cell = Cell
        a = cell.remote(0)
        rt.get(a.get.remote(), timeout=60.0)
        rt.kill(a)  # warm (fork server boots on first spawn)

        n, wave, done = 24, 8, 0
        t0 = time.perf_counter()
        while done < n:
            k = min(wave, n - done)
            actors = [cell.remote(i) for i in range(k)]
            got = rt.get([x.get.remote() for x in actors], timeout=120.0)
            assert got == list(range(k))
            for x in actors:
                rt.kill(x)
            done += k
        rate = n / (time.perf_counter() - t0)
    finally:
        rt.shutdown()
    assert rate >= 10.0, f"actor churn regressed to {rate:.1f}/s"

