"""The cluster CLI (port of the JAX package's scripts/cli.py: `start`,
`stop`, `status`, `list`, `job` and `serve`), an analog of the reference's
python/ray/scripts/scripts.py (`ray start` :568, `stop` :1044,
`submit` :1578) and util/state/state_cli.py (`ray list ...`).

    python -m ray_tpu_torch start --head --num-cpus 4
    python -m ray_tpu_torch start --address HOST:PORT --num-gpus 1
    python -m ray_tpu_torch status --address HOST:PORT
    python -m ray_tpu_torch job --address HOST:PORT submit -- python x.py
    python -m ray_tpu_torch serve --address HOST:PORT deploy app.yaml
    python -m ray_tpu_torch stop --address HOST:PORT

A command's address is `--address`, else RTT_ADDRESS, else the file the
last head started on this machine wrote. The JAX CLI's other commands
(dashboard, timeline, metrics, the subsystem views, ...) are not ported
yet (ROADMAP Queue 1 item 7) and are not in the parser.
"""
from __future__ import annotations

import argparse
import json
import os
import shlex
import sys
import time
from typing import Any, Dict, List, Optional


def _addr_file() -> str:
    from .. import session_root

    return os.path.join(session_root(), "head_address.txt")


def _resolve_address(explicit: Optional[str]) -> str:
    from .._private.conductor import ENV_ADDRESS

    if explicit:
        return explicit
    env = os.environ.get(ENV_ADDRESS)
    if env:
        return env
    try:
        with open(_addr_file()) as f:
            return f.read().strip()
    except FileNotFoundError:
        raise SystemExit(
            f"no cluster address: pass --address, set {ENV_ADDRESS}, or "
            "start a head on this machine with "
            "`python -m ray_tpu_torch start --head`")


def _client(args):
    from .._private.rpc import RpcClient

    host, _, port = _resolve_address(args.address).rpartition(":")
    return RpcClient((host or "127.0.0.1", int(port)))


def cmd_start(args) -> None:
    """Foreground head or worker-host process — reference `ray start`
    (--head starts the conductor; --address joins a running cluster as
    a worker host through the per-host NodeAgent)."""
    if not args.head:
        if not args.address:
            raise SystemExit("pass --head to start a cluster or "
                             "--address host:port to join one")
        from .._private.node_agent import main as agent_main

        argv = ["--address", args.address, "--num-cpus",
                str(args.num_cpus), "--host", args.host]
        for flag, value in (("--num-gpus", args.num_gpus),
                            ("--resources", args.resources),
                            ("--node-id", args.node_id),
                            ("--maintenance-event", args.maintenance_event)):
            if value is not None:
                argv += [flag, str(value)]
        agent_main(argv)
        return
    start_head(args)


def start_head(args) -> None:
    import tempfile
    import uuid

    from .. import session_root
    from .._private.conductor import Conductor
    from .._private.config import config
    from .._private.node_agent import node_gpus

    if args.system_config:
        config.apply(json.loads(args.system_config))
    resources: Dict[str, float] = {"CPU": float(args.num_cpus)}
    if args.resources:
        resources.update(json.loads(args.resources))
    n_gpus, gpu_ids = node_gpus(resources.pop("GPU", args.num_gpus))
    resources["GPU"] = float(n_gpus)
    os.makedirs(session_root(), exist_ok=True)
    session_dir = tempfile.mkdtemp(
        prefix=f"session_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}_"
               f"{uuid.uuid4().hex[:8]}_", dir=session_root())
    c = Conductor(resources, session_dir, host=args.host, port=args.port,
                  worker_env={"CUDA_VISIBLE_DEVICES": ""}, gpu_ids=gpu_ids,
                  standalone=True,
                  maintenance_event=args.maintenance_event).start()
    host, port = c.address
    with open(_addr_file(), "w") as f:
        f.write(f"{host}:{port}")
    print(f"ray_tpu_torch head started at {host}:{port}\n"
          f"  session dir: {session_dir}\n"
          f"  connect with ray_tpu_torch.init(address=\"{host}:{port}\") "
          f"or RTT_ADDRESS={host}:{port}", flush=True)
    # the head lives in this process (background it with `&`/systemd);
    # `stop` ends it through shutdown_cluster
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        c.stop()


def cmd_stop(args) -> None:
    from .._private.object_store import cleanup_leaked_segments

    addr = _resolve_address(args.address)
    try:
        _client(args).call("shutdown_cluster", timeout=10.0)
        print(f"head at {addr} stopped")
    except Exception as e:  # noqa: BLE001
        # keep the address file: the head may still be alive and reachable
        raise SystemExit(f"could not stop the head at {addr}: {e}")
    try:
        os.unlink(_addr_file())
    except OSError:
        pass
    # The head tears down asynchronously (SIGTERM grace then SIGKILL can
    # take >3s): sweep until its workers' segments are gone.
    removed, deadline = 0, time.monotonic() + 6.0
    while time.monotonic() < deadline:
        n = cleanup_leaked_segments()
        removed += n
        if not n:
            break
        time.sleep(0.5)
    if removed:
        print(f"removed {removed} leaked shm segment(s)")


def cluster_summary(c) -> Dict[str, Any]:
    """One-call overview — reference `ray status`."""
    return {
        "timestamp": time.time(),
        "nodes": c.call("nodes", timeout=10.0),
        "resources_total": c.call("cluster_resources", timeout=10.0),
        "resources_available": c.call("available_resources", timeout=10.0),
        "num_actors": len(c.call("list_actors", timeout=10.0)),
        "num_workers": len(c.call("list_workers", timeout=10.0)),
        "placement_groups": c.call("list_placement_groups", timeout=10.0),
    }


def _objects(c) -> List[Dict[str, Any]]:
    """Per-worker object-store stats (reference `ray memory` summary)."""
    from .._private.rpc import RpcClient

    out = []
    for rec in c.call("list_workers", timeout=10.0):
        if not rec.get("address") or rec.get("state") == "DEAD":
            continue
        try:
            w = RpcClient(tuple(rec["address"]), connect_timeout=2.0)
            try:
                out.append(w.call("store_stats", timeout=5.0))
            finally:
                w.close()
        except Exception:  # noqa: BLE001 — worker gone meanwhile
            continue
    return out


def cmd_status(args) -> None:
    print(json.dumps(cluster_summary(_client(args)), indent=2,
                     default=str))


def cmd_list(args) -> None:
    c = _client(args)
    calls = {"nodes": "nodes", "workers": "list_workers",
             "actors": "list_actors", "tasks": "get_task_events",
             "placement-groups": "list_placement_groups"}
    out = _objects(c) if args.kind == "objects" else \
        c.call(calls[args.kind], timeout=30.0)
    print(json.dumps(out, indent=2, default=str))


def cmd_job(args) -> None:
    from ..job_submission import JobSubmissionClient

    client = JobSubmissionClient(_resolve_address(args.address))
    if args.job_cmd == "submit":
        tokens = args.entrypoint
        if tokens and tokens[0] == "--":  # REMAINDER keeps the separator
            tokens = tokens[1:]
        job_id = client.submit_job(
            entrypoint=" ".join(shlex.quote(t) for t in tokens))
        print(job_id)
        if args.wait:
            status = client.wait_until_finished(job_id, timeout=args.timeout)
            sys.stdout.write(client.get_job_logs(job_id))
            print(f"job {job_id}: {status}")
            if status != "SUCCEEDED":
                raise SystemExit(1)
    elif args.job_cmd == "status":
        print(client.get_job_status(args.job_id))
    elif args.job_cmd == "logs":
        sys.stdout.write(client.get_job_logs(args.job_id))
    elif args.job_cmd == "stop":
        print("stopped" if client.stop_job(args.job_id) else "not running")
    elif args.job_cmd == "list":
        print(json.dumps(client.list_jobs(), indent=2, default=str))


def _connect(args) -> None:
    import ray_tpu_torch as rt

    rt.init(address=_resolve_address(args.address), ignore_reinit_error=True)


def cmd_serve(args) -> None:
    """`serve run|deploy|status|config|delete|shutdown` — reference
    python/ray/serve/scripts.py:147-746 (run/deploy/config/status) over
    the declarative schema (serve/schema.py). `serve config` prints the
    deployed config as JSON, which YAML readers take as it is."""
    _connect(args)
    from .. import serve
    from ..serve.schema import (ServeDeploySchema, deploy_config,
                                get_deployed_config)

    if args.serve_cmd in ("run", "deploy"):
        if args.config_or_import.endswith((".yaml", ".yml")):
            schema = ServeDeploySchema.from_yaml_file(args.config_or_import)
        else:
            # bare import path: one app with defaults
            schema = ServeDeploySchema.from_dict({"applications": [
                {"import_path": args.config_or_import}]})
        names = deploy_config(schema)
        print(f"deployed application(s): {', '.join(names)}")
        addr = serve.proxy_address()
        if addr:
            print(f"HTTP ingress at http://{addr[0]}:{addr[1]}")
        if args.serve_cmd == "run":
            # reference `serve run` stays attached and tears down on ^C
            try:
                while True:
                    time.sleep(3600)
            except KeyboardInterrupt:
                for name in names:
                    serve.delete(name)
                print("applications deleted")
    elif args.serve_cmd == "status":
        try:
            print(json.dumps(serve.status(), indent=2, default=str))
        except RuntimeError as e:
            print(json.dumps({"applications": {}, "error": str(e)}))
    elif args.serve_cmd == "config":
        cfg = get_deployed_config()
        if cfg is None:
            print("no config deployed (code-deployed apps have no "
                  "declarative config)")
        else:
            print(json.dumps(cfg, indent=2))
    elif args.serve_cmd == "delete":
        serve.delete(args.name)
        print(f"application {args.name!r} deleted")
    elif args.serve_cmd == "shutdown":
        serve.shutdown()
        print("serve shut down")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="ray_tpu_torch", description="ray_tpu_torch cluster CLI")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("start",
                        help="start a head node or join as a worker host")
    sp.add_argument("--head", action="store_true")
    sp.add_argument("--address", help="head host:port to join (worker host)")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=0)
    sp.add_argument("--num-cpus", type=float,
                    default=float(os.cpu_count() or 1))
    sp.add_argument("--num-gpus", type=int, default=None,
                    help="GPUs to count (default: the ones this process "
                         "sees, by torch.cuda.device_count())")
    sp.add_argument("--resources", help='extra resources as JSON, e.g. '
                    '\'{"widget": 2}\'')
    sp.add_argument("--node-id", help="pre-assigned node id (worker host)")
    sp.add_argument("--maintenance-event",
                    help="a file whose appearance announces this host's "
                         "preemption (default: no channel)")
    sp.add_argument("--system-config",
                    help="flags of the head's table as JSON, e.g. "
                         "'{\"node_timeout\": 3}'; joining agents take "
                         "them from the head")
    sp.set_defaults(fn=cmd_start)

    for name, fn in [("stop", cmd_stop), ("status", cmd_status)]:
        sp = sub.add_parser(name)
        sp.add_argument("--address")
        sp.set_defaults(fn=fn)

    sp = sub.add_parser("list", help="list cluster entities")
    sp.add_argument("kind", choices=["nodes", "workers", "actors", "tasks",
                                     "objects", "placement-groups"])
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_list)

    sp = sub.add_parser("job", help="job submission")
    sp.add_argument("--address")
    jsub = sp.add_subparsers(dest="job_cmd", required=True)
    j = jsub.add_parser("submit")
    j.add_argument("--wait", action="store_true")
    j.add_argument("--timeout", type=float, default=600.0)
    j.add_argument("entrypoint", nargs=argparse.REMAINDER)
    for jc in ["status", "logs", "stop"]:
        j = jsub.add_parser(jc)
        j.add_argument("job_id")
    jsub.add_parser("list")
    sp.set_defaults(fn=cmd_job)

    sp = sub.add_parser("serve", help="Serve applications: run/deploy from "
                                      "a YAML config, status, shutdown")
    sp.add_argument("--address")
    ssub = sp.add_subparsers(dest="serve_cmd", required=True)
    for sc in ("run", "deploy"):
        s = ssub.add_parser(sc, help="deploy apps from a YAML config or a "
                                     "module:attr import path"
                                     + (" and stay attached"
                                        if sc == "run" else ""))
        s.add_argument("config_or_import",
                       help="path/to/config.yaml or module:application")
    ssub.add_parser("status")
    ssub.add_parser("config", help="echo the last deployed config")
    s = ssub.add_parser("delete")
    s.add_argument("name")
    ssub.add_parser("shutdown")
    sp.set_defaults(fn=cmd_serve)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
