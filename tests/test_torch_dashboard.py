"""The port's web dashboard (ray_tpu_torch/dashboard/, on the standard
library's HTTP layer serve/_http.py) and its CLI's surface, against the
JAX package's dashboard (aiohttp) and CLI, on the CPU.

Twins of the 5 cases of tests/test_dashboard.py, each a check of
`_private/dashboard_checks.py` in a driver process of its own
(`isolated.run_checks`, a 2-CPU cluster each), and of the CLI legs of
tests/test_observability.py (`train-status`, `/api/train`) and
test_resilience.py (`resilience-status`, `/api/resilience`). The port's
own checks there: `/api/oracle` answers 501 naming ROADMAP Queue 1 item
7; every route JAX's dashboard registers (read from its aiohttp app)
answers, and `stop()` leaves no thread, socket or client; the runtime
views (`summary`, `memory`, `list`, `metrics`, `timeline`, `config`)
equal the state API.

In this process: the parser holds JAX's commands but `oracle` and
`analyze`; a view's `--help` in a subprocess loads no torch and no JAX
package; the SPA is JAX's but where it names the package; and `start
--head --port 0 --dashboard-port 0` in a subprocess prints a dashboard
URL whose `/api/summary` answers, and `stop` ends the head.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time
import urllib.request

import pytest

from ray_tpu_torch._private import isolated

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_routes() -> list:
    """The canonical routes of the JAX package's dashboard app."""
    from ray_tpu.dashboard import DashboardServer, _ClusterData

    srv = DashboardServer.__new__(DashboardServer)
    srv.data = _ClusterData.__new__(_ClusterData)  # no conductor needed
    return [r.canonical for r in srv._make_app().router.resources()]


CLUSTER = {"num_cpus": 2}
CHECKS = {name: CLUSTER for name in (
    "dashboard_spa_and_summary",
    "dashboard_entity_endpoints_reflect_cluster",
    "dashboard_logs_endpoint_carries_worker_prints",
    "dashboard_actor_drilldown_and_serve_view",
    "dashboard_rpc_and_autoscaler_views",
    "port_dashboard_oracle_not_ported",
    "port_dashboard_every_jax_route_answers",
    "flight_train_status_cli_and_dashboard_route",
    "resilience_status_cli_and_dashboard_payload",
    "port_cli_runtime_views_equal_the_state_api")}


@pytest.fixture(scope="module")
def outcomes():
    return isolated.run_checks(CHECKS, timeout=300.0,
                               inputs={"routes": _jax_routes()})


@pytest.mark.parametrize("name", [*CHECKS, isolated.SESSION_ENDED])
def test_dashboard_checks(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text


def test_every_jax_route_was_asked(outcomes):
    ok, text = outcomes["port_dashboard_every_jax_route_answers"]
    assert ok, text
    routes = _jax_routes()
    assert len(routes) == 31 and "/api/actors/{actor_id}" in routes
    assert json.loads(text)["routes"] == len(routes)


# ------------------------------------------------------ the parser

def _commands(main) -> set:
    """The subcommands a CLI's parser offers, from its --help."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        main(["--help"])
    return set(re.search(r"\{([^}]*)\}", out.getvalue()).group(1)
               .split(","))


def test_cli_commands_are_jax_but_oracle_and_analyze():
    from ray_tpu.scripts import cli as jcli
    from ray_tpu_torch.scripts import cli as tcli

    jax, port = _commands(jcli.main), _commands(tcli.main)
    assert jax - port == {"oracle", "analyze"}
    assert port - jax == set()
    assert len(port) == 27  # six before, twenty views, dashboard
    doc = " ".join(tcli.__doc__.split())
    assert "`oracle` and `analyze` are not in the parser" in doc
    assert "ROADMAP Queue 1 item 7" in doc


@pytest.mark.parametrize("view", ["kvcache", "speculate", "lora", "disagg",
                                  "kvplane", "servefault", "gateway",
                                  "autoscale", "online"])
def test_view_flags_are_jax(view):
    """Each serving and loop view takes JAX's flags."""
    from ray_tpu.scripts import cli as jcli
    from ray_tpu_torch.scripts import cli as tcli

    def flags(main):
        out = io.StringIO()
        with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
            main([view, "--help"])
        return set(re.findall(r"--[a-z][a-z-]*", out.getvalue()))

    assert flags(tcli.main) == flags(jcli.main)


def test_help_loads_no_torch_and_no_jax_package():
    code = ("import sys\n"
            "from ray_tpu_torch.scripts import cli\n"
            "try:\n"
            "    cli.main(['kvcache', '--help'])\n"
            "except SystemExit:\n"
            "    pass\n"
            "bad = sorted(m for m in sys.modules if m == 'torch'\n"
            "             or m == 'jax' or m == 'ray_tpu'\n"
            "             or m.startswith(('torch.', 'jax.', 'ray_tpu.')))\n"
            "print('LOADED', bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "--engine" in out.stdout
    assert out.stdout.strip().splitlines()[-1] == "LOADED []", out.stdout
    out = subprocess.run([sys.executable, "-m", "ray_tpu_torch", "--help"],
                         capture_output=True, text=True, timeout=120,
                         env=env, cwd=REPO)
    assert out.returncode == 0 and "dashboard" in out.stdout


def test_spa_is_jax_but_the_package_names():
    with open(os.path.join(REPO, "ray_tpu", "dashboard", "index.html")) as f:
        jax = f.read().splitlines()
    with open(os.path.join(REPO, "ray_tpu_torch", "dashboard",
                           "index.html")) as f:
        port = f.read().splitlines()
    assert len(jax) == len(port)
    changed = [(a, b) for a, b in zip(jax, port) if a != b]
    assert len(changed) == 5, changed
    for a, b in changed:
        assert "ray_tpu" in a or "RAY_TPU" in a, a
        assert "RAY_TPU" not in b and "ray_tpu " not in b, b


def test_dashboard_port_default_is_one():
    from ray_tpu.dashboard import DEFAULT_DASHBOARD_PORT as jport
    from ray_tpu_torch import dashboard
    from ray_tpu_torch.scripts import cli

    assert cli.DEFAULT_DASHBOARD_PORT == dashboard.DEFAULT_DASHBOARD_PORT \
        == jport == 8265


# --------------------------------------------- the head, as a user runs it

def test_head_serves_its_dashboard_and_stops(tmp_path):
    """`start --head --port 0 --dashboard-port 0` prints `dashboard at
    URL`; its /api/summary answers with the head's CPUs; `stop` ends the
    head's process."""
    env = dict(os.environ, PYTHONPATH=REPO, TMPDIR=str(tmp_path))
    env.pop("RTT_ADDRESS", None)
    head = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch", "start", "--head",
         "--port", "0", "--dashboard-port", "0", "--num-cpus", "1",
         "--num-gpus", "0"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env, cwd=str(tmp_path),
        start_new_session=True)
    lines = []
    try:
        url = address = None
        deadline = time.monotonic() + 120.0
        while address is None and time.monotonic() < deadline:
            line = head.stdout.readline()
            if not line:
                break
            lines.append(line)
            m = re.match(r"dashboard at (http://\S+)", line)
            url = m.group(1) if m else url
            m = re.match(r"ray_tpu_torch head started at (\S+)", line)
            address = m.group(1) if m else None
        assert url and address, lines
        with urllib.request.urlopen(url + "/api/summary",
                                    timeout=30.0) as r:
            s = json.loads(r.read())
        assert s["resources_total"]["CPU"] == 1.0
        assert s["address"] == [address.rsplit(":", 1)[0],
                                int(address.rsplit(":", 1)[1])]
        out = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch", "stop"],
            capture_output=True, text=True, timeout=120, env=env,
            cwd=str(tmp_path))
        assert out.returncode == 0, out.stderr
        assert f"head at {address} stopped" in out.stdout
        assert head.wait(timeout=60) == 0
    finally:
        if head.poll() is None:
            os.killpg(head.pid, 9)
            head.wait()
