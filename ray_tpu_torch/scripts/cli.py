"""The cluster CLI (port of the JAX package's scripts/cli.py), an analog
of the reference's python/ray/scripts/scripts.py (`ray start` :568,
`stop` :1044, `submit` :1578, status / memory / timeline) and
util/state/state_cli.py (`ray list ...`).

    python -m ray_tpu_torch start --head --num-cpus 4   # + the dashboard
    python -m ray_tpu_torch start --address HOST:PORT --num-gpus 1
    python -m ray_tpu_torch status --address HOST:PORT
    python -m ray_tpu_torch kvcache --json
    python -m ray_tpu_torch timeline --merged trace.json
    python -m ray_tpu_torch dashboard --port 8265
    python -m ray_tpu_torch job --address HOST:PORT submit -- python x.py
    python -m ray_tpu_torch serve --address HOST:PORT deploy app.yaml
    python -m ray_tpu_torch stop --address HOST:PORT

Commands: the cluster's (`start`, `stop`, `status`, `list`, `job`,
`serve`, `dashboard`), the runtime's views (`summary`, `memory`,
`metrics`, `timeline`, `config`, `microbench`), training and recovery
(`train-status`, `resilience-status`, `weights`, `pipeline`, `online`)
and serving (`kvcache`, `speculate`, `lora`, `disagg`, `kvplane`,
`servefault`, `gateway`, `requests`, `autoscale`). Each view takes the
JAX command's flags and prints its text, or with `--json` the state
API's dict (util/state.py). The JAX CLI's `oracle` and `analyze` are not
in the parser: they read the step-time oracle and the analysis tools
(observability/roofline.py, analysis/), which are not ported yet
(ROADMAP Queue 1 item 7).

A command's address is `--address`, else RTT_ADDRESS, else the file the
last head started on this machine wrote. No command touches the device,
and none imports torch unless a view's own code does.
"""
from __future__ import annotations

import argparse
import json
import os
import shlex
import sys
import time
from typing import Any, Dict, List, Optional

DEFAULT_DASHBOARD_PORT = 8265  # dashboard/'s, without its import


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


def _connect(args) -> None:
    import ray_tpu_torch as rt

    rt.init(address=_resolve_address(getattr(args, "address", None)),
            ignore_reinit_error=True)


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
    dash = None
    if not args.no_dashboard:
        try:
            from ..dashboard import DashboardServer

            dash = DashboardServer((host, port), host=args.host,
                                   port=args.dashboard_port).start()
            print(f"dashboard at {dash.url}", flush=True)
        except Exception as e:  # noqa: BLE001 — a port problem
            print(f"dashboard not started: {e}", flush=True)
    with open(_addr_file(), "w") as f:
        f.write(f"{host}:{port}")
    print(f"ray_tpu_torch head started at {host}:{port}\n"
          f"  session dir: {session_dir}\n"
          f"  connect with ray_tpu_torch.init(address=\"{host}:{port}\") "
          f"or RTT_ADDRESS={host}:{port}", flush=True)
    # the head lives in this process either way (background it with
    # `&`/systemd; --block is accepted for the reference CLI's sake);
    # `stop` ends the process through shutdown_cluster
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        if dash is not None:
            dash.stop()
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


def cmd_summary(args) -> None:
    _connect(args)
    from ..util import state

    print(json.dumps(state.summarize_tasks(), indent=2, default=str))


def cmd_memory(args) -> None:
    _connect(args)
    from ..util import state

    print(json.dumps(state.list_objects(), indent=2, default=str))


def cmd_timeline(args) -> None:
    _connect(args)
    from ..util import state

    output = args.output_flag or args.output
    n = len(state.timeline(output, merged=args.merged))
    what = "merged (tasks+spans+train steps)" if args.merged else "task"
    print(f"wrote {n} {what} events to {output} "
          f"(load in chrome://tracing or Perfetto)")


def cmd_metrics(args) -> None:
    _connect(args)
    from ..util import state

    sys.stdout.write(state.prometheus_metrics())


def cmd_dashboard(args) -> None:
    from ..dashboard import main as dash_main

    dash_main(["--address", _resolve_address(args.address),
               "--host", args.host, "--port", str(args.port)])


def cmd_config(args) -> None:
    """Print the flag table (ray_config_def.h analog) with live values,
    then the environment variables a user may set (the flags come only
    from init(_system_config=) / `start --system-config`)."""
    from .._private.conductor import ENV_ADDRESS
    from .._private.config import config
    from .._private.runtime_env import ENV_PLUGINS
    from ..util.tracing import ENV_TRACING

    env_vars = ((ENV_ADDRESS, "the cluster address of init() and this CLI"),
                (ENV_TRACING, "tracing on in spawned workers"),
                (ENV_PLUGINS, "runtime_env plugin classes"))
    rows = config.describe()
    w = max(len(r["name"]) for r in rows)
    for r in rows:
        mark = "*" if r["source"] != "default" else " "
        print(f"{mark} {r['name']:<{w}}  {r['type']:<5} "
              f"= {r['value']!r:<14} {r['doc']}")
    print("\n(* = overridden via _system_config)\n")
    w = max(len(name) for name, _ in env_vars)
    for name, doc in env_vars:
        value = os.environ.get(name)
        print(f"  {name:<{w}}  = {value!r:<14} {doc}")


def cmd_microbench(args) -> None:
    from .._private import perf

    perf.run(scale=args.scale, out=args.out)


def cmd_train_status(args) -> None:
    """Flight-recorder view of running/recent training gangs: per-rank
    step stats, the latest step's time breakdown, skew, stragglers."""
    _connect(args)
    from ..util import state

    progress = state.train_progress(getattr(args, "run", None))
    if args.json:
        print(json.dumps(progress, indent=2, default=str))
        return
    if not progress:
        print("no training telemetry recorded "
              "(is the gang using ray_tpu_torch.train.report()?)")
        return
    for run_id, run in progress.items():
        print(f"run {run_id}: world={run['world']} "
              f"last_step={run['last_step']} "
              f"steps_buffered={run['steps_buffered']}")
        bd = run.get("last_step_breakdown") or {}
        if bd:
            parts = " ".join(f"{k[:-3]}={v:.1f}ms" for k, v in bd.items())
            print(f"  last step: {parts}")
        skew = run.get("last_step_skew") or {}
        if skew:
            print(f"  skew: min={skew['min_ms']:.1f}ms "
                  f"median={skew['median_ms']:.1f}ms "
                  f"p99={skew['p99_ms']:.1f}ms "
                  f"max/median={skew['max_over_median']:.2f}")
        for rank, st in sorted(run["per_rank"].items()):
            extra = ""
            if st.get("tokens_per_sec"):
                extra += f" tok/s={st['tokens_per_sec']:.0f}"
            if st.get("mfu") is not None:
                extra += f" mfu={100 * st['mfu']:.2f}%"
            mark = " <- STRAGGLER" if rank in run["stragglers"] else ""
            print(f"  rank {rank}: steps={st['steps']} "
                  f"mean={st['mean_ms']:.1f}ms p99={st['p99_ms']:.1f}ms"
                  f"{extra}{mark}")


def _print_event_tail(events, n: int) -> None:
    """Shared `[HH:MM:SS] kind k=v ...` tail rendering for the event
    logs (resilience / kvcache / pipeline)."""
    for ev in events[-n:]:
        when = time.strftime("%H:%M:%S", time.localtime(ev.get("ts", 0)))
        extra = {k: v for k, v in ev.items()
                 if k not in ("kind", "ts") and v is not None}
        print(f"  [{when}] {ev.get('kind')} "
              + " ".join(f"{k}={v}" for k, v in extra.items()))


def cmd_resilience_status(args) -> None:
    """Recovery-subsystem view: quarantined/draining hosts with their
    decayed failure scores, event counters, and recent events."""
    _connect(args)
    from ..util import state

    st = state.resilience_status()
    if args.json:
        print(json.dumps(st, indent=2, default=str))
        return
    excluded = set(st.get("excluded") or [])
    print(f"quarantine threshold: {st['threshold']:g} "
          f"(half-life {st['half_life_s']:g}s)")
    domains = st.get("domains") or {}
    if not domains:
        print("no failure history recorded")
    for node_id, d in sorted(domains.items()):
        flags = []
        if d.get("quarantined"):
            flags.append("QUARANTINED" + (" (manual)" if d.get("manual")
                                          else ""))
        if d.get("draining"):
            flags.append(f"DRAINING {d['drain_remaining_s']:.0f}s left "
                         f"({d.get('drain_reason')})")
        if d.get("exempt"):
            flags.append("exempt")
        mark = " <- EXCLUDED" if node_id in excluded else ""
        print(f"  {node_id[:16]}: score={d['score']:.2f} "
              f"failures={d['failures']}"
              + (f" last={d['last_kind']}" if d.get("last_kind") else "")
              + (f" [{', '.join(flags)}]" if flags else "") + mark)
    counters = st.get("counters") or {}
    if counters:
        print("counters: " + " ".join(f"{k}={v}" for k, v
                                      in sorted(counters.items())))
    if st.get("last_ttr_s") is not None:
        print(f"last time-to-recovery: {st['last_ttr_s']:.2f}s")
    _print_event_tail(st.get("recent_events") or [], args.events)


def cmd_weights(args) -> None:
    """`ray_tpu_torch weights list|inspect|gc` — the live weight fabric's
    registry view (weights/): committed versions per name with
    sizes and host counts, one version's full manifest (minus chunk
    payloads), or an operator keep-last-K GC."""
    _connect(args)
    from .._private import worker as worker_mod
    from ..util import state

    w = worker_mod.global_worker
    if args.weights_cmd == "list":
        listing = state.weight_versions(getattr(args, "name", None))
        if args.json:
            print(json.dumps(listing, indent=2, default=str))
            return
        names = listing.get("names") or {}
        if not names and not listing.get("pending"):
            print("no weight versions published")
        for name, rec in sorted(names.items()):
            print(f"{name}: latest=v{rec['latest']} "
                  f"({len(rec['versions'])} kept)")
            for v in rec["versions"]:
                when = time.strftime("%H:%M:%S",
                                     time.localtime(v.get("ts", 0)))
                print(f"  v{v['version']}: step={v.get('step')} "
                      f"bytes={v['total_bytes']} hosts={v['num_hosts']} "
                      f"leaves={v['n_leaves']} chunks={v['n_chunks']} "
                      f"[{when}]"
                      + (f" run={v['run_id']}" if v.get("run_id") else ""))
        for p in listing.get("pending") or []:
            print(f"  PENDING {p['name']} v{p['version']}: "
                  f"{len(p['hosts_committed'])}/{p['num_hosts']} hosts, "
                  f"age {p['age_s']:.1f}s")
    elif args.weights_cmd == "inspect":
        m = w.conductor.call("weights_get_manifest", args.name,
                             args.version, timeout=10.0)
        if m is None:
            raise SystemExit(
                f"no committed version "
                f"{'(latest)' if args.version is None else args.version} "
                f"of {args.name!r}")
        m = dict(m)
        m.pop("treedef", None)  # pickled bytes, not printable
        print(json.dumps(m, indent=2, default=str))
    elif args.weights_cmd == "gc":
        dropped = w.conductor.call("weights_gc", args.name, args.keep,
                                   timeout=10.0)
        print(f"dropped {dropped} version(s) of {args.name!r}")


def cmd_kvcache(args) -> None:
    """`ray_tpu_torch kvcache` — paged-KV prefix-cache view (models/kvcache):
    per-engine hit/miss/eviction counters and pool utilization plus the
    cluster totals every other surface (state API, /api/kvcache,
    Prometheus, timeline markers) reports from the same snapshots."""
    _connect(args)
    from .._private import worker as worker_mod
    from ..util import state

    st = state.kv_cache_stats(getattr(args, "engine", None))
    if args.json:
        print(json.dumps(st, indent=2, default=str))
        return
    engines = st.get("engines") or {}
    totals = st.get("totals") or {}
    if not engines:
        print("no kv-cache telemetry recorded (is a "
              "ContinuousBatchingEngine with the prefix cache enabled "
              "running?)")
        return
    print(f"totals: lookups={totals.get('lookups', 0)} "
          f"hit_rate={totals.get('hit_rate', 0.0):.2%} "
          f"token_reuse={totals.get('token_reuse_rate', 0.0):.2%} "
          f"evictions={totals.get('evictions', 0)} "
          f"cow={totals.get('cow_copies', 0)}")
    for key, s in sorted(engines.items()):
        if not s.get("enabled", False):
            # decode replicas under disaggregation run cache-disabled:
            # they adopt prefilled KV, they never prefill
            print(f"  {key}: prefix cache DISABLED "
                  f"(admitted={s.get('admitted', 0)} "
                  f"prefill={s.get('prefill_admitted', 0)} "
                  f"adopted={s.get('adopted', 0)})")
            continue
        print(f"  {key}: hits={s.get('hits', 0)} "
              f"partial={s.get('partial_hits', 0)} "
              f"misses={s.get('misses', 0)} "
              f"reused_tok={s.get('reused_tokens', 0)} "
              f"prefilled_tok={s.get('prefilled_tokens', 0)} "
              f"pool={s.get('pool_utilization', 0.0):.0%} "
              f"({s.get('cached_blocks', 0)} cached / "
              f"{s.get('pinned_blocks', 0)} pinned / "
              f"{s.get('num_blocks', 0)} blocks) "
              f"evictions={s.get('evictions', 0)} "
              f"cow={s.get('cow_copies', 0)} "
              f"invalidations={s.get('invalidations', 0)}")
    if args.events:
        w = worker_mod.global_worker
        events = w.conductor.call("get_kvcache_events", args.events,
                                  timeout=10.0)
        _print_event_tail(events, args.events)


def cmd_speculate(args) -> None:
    """`ray_tpu_torch speculate` — speculative-decoding view (models/engine):
    per-engine draft proposal/acceptance counters, tokens-per-verify
    and acceptance rate plus the cluster totals every other surface
    (state API, /api/speculation, Prometheus, the kvcache timeline
    lane's spec markers) reports from the same snapshots."""
    _connect(args)
    from .._private import worker as worker_mod
    from ..util import state

    st = state.speculation_stats(getattr(args, "engine", None))
    if args.json:
        print(json.dumps(st, indent=2, default=str))
        return
    engines = st.get("engines") or {}
    totals = st.get("totals") or {}
    if not engines:
        print("no speculation telemetry recorded (is an engine running "
              "with speculate_k > 0?)")
        return
    print(f"totals: proposed={totals.get('spec_proposed', 0)} "
          f"accepted={totals.get('spec_accepted', 0)} "
          f"acceptance={totals.get('acceptance_rate', 0.0):.2%} "
          f"verify_ticks={totals.get('spec_verify_ticks', 0)} "
          f"tokens/verify={totals.get('tokens_per_verify', 0.0):.2f}")
    for key, s in sorted(engines.items()):
        print(f"  {key}: k={s.get('speculate_k', 0)} "
              f"proposed={s.get('spec_proposed', 0)} "
              f"accepted={s.get('spec_accepted', 0)} "
              f"acceptance={s.get('acceptance_rate', 0.0):.2%} "
              f"tokens/verify={s.get('tokens_per_verify', 0.0):.2f} "
              f"int8_kv={'on' if s.get('kv_int8') else 'off'}")
    if args.events:
        w = worker_mod.global_worker
        events = w.conductor.call("get_kvcache_events", 10_000,
                                  timeout=10.0)
        spec = [e for e in events
                if str(e.get("kind", "")).startswith("spec_")]
        _print_event_tail(spec[-args.events:], args.events)


def cmd_pipeline(args) -> None:
    """`ray_tpu_torch pipeline` — MPMD pipeline view (mpmd/): per-
    pipeline stage registry + per-stage run stats (bubble fraction,
    channel bytes) plus the cluster totals every other surface (state
    API, /api/pipeline, Prometheus, timeline markers) reports from the
    same registry."""
    _connect(args)
    from .._private import worker as worker_mod
    from ..util import state

    st = state.pipeline_status(getattr(args, "name", None))
    if args.json:
        print(json.dumps(st, indent=2, default=str))
        return
    pipelines = st.get("pipelines") or {}
    if not pipelines:
        print("no MPMD pipelines registered (is a PipelineConductor/"
              "PipelineTrainer running?)")
        return
    for name, rec in sorted(pipelines.items()):
        status = "closed" if rec.get("closed") else (
            "formed" if rec.get("formed") else
            f"forming {len(rec.get('stages') or {})}/"
            f"{rec['num_stages']}")
        est = rec.get("bubble_estimate")
        print(f"{name}: stages={rec['num_stages']} "
              f"schedule={rec.get('schedule')} "
              f"microbatches={rec.get('num_microbatches')} [{status}]"
              + (f" est_bubble={est:.1%}" if est is not None else ""))
        totals = rec.get("totals") or {}
        if totals.get("steps"):
            mean = totals.get("bubble_fraction_mean")
            print(f"  totals: steps={totals['steps']} "
                  f"activation_bytes={totals['activation_bytes']}"
                  + (f" bubble_mean={mean:.1%}"
                     if mean is not None else ""))
        stages = rec.get("stages") or {}
        stats = rec.get("stats") or {}
        for s in sorted(stages, key=int):
            reg = stages[s]
            st_s = stats.get(s) or stats.get(str(s)) or {}
            line = (f"  stage {s}: slice={reg.get('slice_id')} "
                    f"worker={str(reg.get('worker_id'))[:12]}")
            if st_s:
                line += (f" steps={st_s.get('steps')} "
                         f"bubble={st_s.get('bubble_fraction', 0.0):.1%}"
                         f" sent={st_s.get('sent_bytes', 0)}B "
                         f"recv={st_s.get('recv_bytes', 0)}B")
            print(line)
    if args.events:
        w = worker_mod.global_worker
        events = w.conductor.call("get_pipeline_events", args.events,
                                  timeout=10.0)
        _print_event_tail(events, args.events)


def cmd_online(args) -> None:
    """`ray_tpu_torch online` — online learning loop view (online/):
    per-sampler rollout/staleness stats, buffer occupancy and
    backpressure, learner ingest progress, plus the cluster totals
    every other surface (state API, /api/online, Prometheus, timeline
    markers) reports from the same snapshots."""
    _connect(args)
    from .._private import worker as worker_mod
    from ..util import state

    st = state.online_status()
    if args.json:
        print(json.dumps(st, indent=2, default=str))
        return
    totals = st.get("totals") or {}
    if not (st.get("samplers") or st.get("buffers")
            or st.get("learners")):
        print("no online-loop telemetry recorded (is an "
              "OnlineTrainer / RolloutSampler running?)")
        return
    stale = totals.get("max_staleness_versions")
    print(f"totals: samplers={totals.get('samplers', 0)} "
          f"rollouts={totals.get('rollouts', 0)} "
          f"rollout_tokens={totals.get('rollout_tokens', 0)} "
          f"ingested={totals.get('ingested_rollouts', 0)} "
          f"buffer={totals.get('buffer_occupancy', 0)}"
          f"/{totals.get('buffer_capacity', 0)} "
          f"max_staleness={stale if stale is not None else '-'}")
    for key, s in sorted((st.get("samplers") or {}).items()):
        print(f"  {key}: rollouts={s.get('rollouts', 0)} "
              f"tokens={s.get('rollout_tokens', 0)} "
              f"serving=v{s.get('serving_version')} "
              f"latest=v{s.get('latest_version')} "
              f"staleness={s.get('staleness_versions')} "
              f"(max {s.get('max_staleness_versions')}) "
              f"swaps={s.get('swap_count', 0)}"
              + ("" if s.get("registry_reachable", True)
                 else " [REGISTRY UNREACHABLE]"))
    for key, b in sorted((st.get("buffers") or {}).items()):
        print(f"  {key}: occupancy={b.get('occupancy', 0)}"
              f"/{b.get('capacity', 0)} in={b.get('total_in', 0)} "
              f"out={b.get('total_out', 0)} "
              f"rejected={b.get('rejected', 0)}")
    for key, l in sorted((st.get("learners") or {}).items()):
        print(f"  {key}: steps={l.get('steps', 0)} "
              f"ingested={l.get('ingested_rollouts', 0)} "
              f"last_loss={l.get('last_loss')} "
              f"published=v{l.get('published_version')}")
    if args.events:
        w = worker_mod.global_worker
        events = w.conductor.call("get_online_events", args.events,
                                  timeout=10.0)
        _print_event_tail(events, args.events)


def cmd_disagg(args) -> None:
    """`ray_tpu_torch disagg` — disaggregated prefill/decode serving view
    (serve/disagg.py): prefill-tier reuse + published KV, decode-tier
    transfer accounting (shm vs rpc — the no-full-copy evidence),
    router dispatch/shed/queue-depth, plus the cluster totals every
    other surface (state API, /api/disagg, Prometheus, timeline
    markers) reports from the same snapshots."""
    _connect(args)
    from .._private import worker as worker_mod
    from ..util import state

    st = state.disagg_status()
    if args.json:
        print(json.dumps(st, indent=2, default=str))
        return
    totals = st.get("totals") or {}
    if not (st.get("prefill") or st.get("decode") or st.get("routers")):
        print("no disagg telemetry recorded (is a PrefillServer/"
              "DecodeServer/DisaggRouter running?)")
        return
    print(f"totals: transfers={totals.get('transfers', 0)} "
          f"kv_bytes={totals.get('kv_fetched_bytes', 0)} "
          f"(shm={totals.get('shm_bytes', 0)} "
          f"rpc={totals.get('rpc_bytes', 0)}) "
          f"adopted={totals.get('adopted', 0)} "
          f"dispatched={totals.get('dispatched', 0)} "
          f"shed={totals.get('shed', 0)} "
          f"queue_depth={totals.get('queue_depth', 0)} "
          f"(max {totals.get('max_queue_depth_seen', 0)})")
    for key, p in sorted((st.get("prefill") or {}).items()):
        pc = p.get("prefix_cache") or {}
        print(f"  {key}: prefills={p.get('prefills', 0)} "
              f"prefilled_tok={p.get('prefilled_tokens', 0)} "
              f"reused_tok={p.get('reused_tokens', 0)} "
              f"published={p.get('published_transfers', 0)} "
              f"({p.get('published_bytes', 0)}B) "
              f"held={p.get('held_transfers', 0)} "
              f"acked={p.get('acked', 0)}"
              + (f" hit_rate={pc.get('hit_rate', 0.0):.2%}"
                 if pc else ""))
    for key, d in sorted((st.get("decode") or {}).items()):
        print(f"  {key}: transfers={d.get('transfers', 0)} "
              f"fetched={d.get('kv_fetched_bytes', 0)}B "
              f"(shm={d.get('shm_bytes', 0)} rpc={d.get('rpc_bytes', 0)}) "
              f"adopted={d.get('adopted', 0)} "
              f"slots={d.get('free_slots', 0)}/{d.get('capacity', 0)} "
              f"prefill_programs={d.get('prefill_programs', 0)}")
    for key, r in sorted((st.get("routers") or {}).items()):
        print(f"  {key}: mode={r.get('mode')} "
              f"dispatched={r.get('dispatched', 0)} "
              f"completed={r.get('completed', 0)} "
              f"shed={r.get('shed', 0)} "
              f"pending={r.get('pending', 0)} "
              f"(max {r.get('max_pending', 0)}, "
              f"depth_knob={r.get('max_queue_depth')})")
    if args.events:
        w = worker_mod.global_worker
        events = w.conductor.call("get_disagg_events", args.events,
                                  timeout=10.0)
        _print_event_tail(events, args.events)


def cmd_kvplane(args) -> None:
    """`ray_tpu_torch kvplane` — global KV plane view (serve/kvplane.py):
    per-replica host arenas (tier-2 entries/bytes, spills absorbed,
    re-adopted tokens), tier-3 publish/adopt traffic through the chunk
    fabric, router directory routing outcomes (hit/fallback/miss), the
    conductor's prefix-directory summary, plus the cluster totals every
    other surface (state API, /api/kvplane, Prometheus, timeline
    markers) reports from the same snapshots."""
    _connect(args)
    from .._private import worker as worker_mod
    from ..util import state

    st = state.kvplane_status()
    if args.json:
        print(json.dumps(st, indent=2, default=str))
        return
    comps = st.get("components") or {}
    if not comps:
        print("no kvplane telemetry recorded (is a kvplane-enabled "
              "PrefillServer/DisaggRouter running?)")
        return
    t = st.get("totals") or {}
    print(f"totals: spills={t.get('spills', 0)} "
          f"({t.get('spill_bytes', 0)}B) "
          f"tier2_hits={t.get('tier2_hits', 0)}"
          f"/{t.get('tier2_probes', 0)} "
          f"({t.get('tier2_hit_rate', 0.0):.2%}) "
          f"t2_reused_tok={t.get('tier2_reused_tokens', 0)} "
          f"t3_publishes={t.get('tier3_publishes', 0)} "
          f"t3_adopts={t.get('tier3_adopts', 0)} "
          f"t3_reused_tok={t.get('tier3_reused_tokens', 0)} "
          f"directory_hit_rate={t.get('directory_hit_rate', 0.0):.2%} "
          f"arena={t.get('arena_entries', 0)} entries "
          f"({t.get('arena_bytes', 0)}B)")
    d = st.get("directory") or {}
    ns = d.get("namespaces") or {}
    ctr = d.get("counters") or {}
    print(f"directory: entries={d.get('entries', 0)} "
          f"({d.get('nbytes', 0)}B) namespaces={len(ns)} "
          f"publishes={ctr.get('publishes', 0)} "
          f"lookups={ctr.get('lookups', 0)} "
          f"reaped={ctr.get('reaped', 0)} "
          f"gced={ctr.get('gced', 0)} "
          f"unpublished={ctr.get('unpublished', 0)}")
    for key, c in sorted(comps.items()):
        if c.get("role") == "router":
            print(f"  {key}: directory hits={c.get('directory_hits', 0)} "
                  f"fallbacks={c.get('directory_fallbacks', 0)} "
                  f"misses={c.get('directory_misses', 0)}"
                  + (f" hit_rate={c['directory_hit_rate']:.2%}"
                     if c.get("directory_hit_rate") is not None else ""))
        else:
            print(f"  {key}: arena={c.get('entries', 0)} entries "
                  f"({c.get('bytes', 0)}B/{c.get('max_bytes', 0)}B) "
                  f"spills={c.get('spills', 0)} "
                  f"t2_hits={c.get('tier2_hits', 0)} "
                  f"t2_reused_tok={c.get('tier2_reused_tokens', 0)} "
                  f"t3_pub={c.get('tier3_publishes', 0)} "
                  f"t3_adopt={c.get('tier3_adopts', 0)} "
                  f"storms={c.get('evict_storms', 0)}")
    if args.events:
        w = worker_mod.global_worker
        events = w.conductor.call("get_kvplane_events", args.events,
                                  timeout=10.0)
        _print_event_tail(events, args.events)


def cmd_servefault(args) -> None:
    """`ray_tpu_torch servefault` — serving-plane fault-tolerance view
    (serve/disagg.py failover + serve/autoscale.py self-healing):
    per-router failovers by phase and sheds by attributed cause,
    per-healer deaths/replacements/breaker state, plus the cluster
    totals every other surface (state API, /api/servefault,
    Prometheus, resilience-lane timeline markers) reports from the
    same snapshots."""
    _connect(args)
    from .._private import worker as worker_mod
    from ..util import state

    st = state.servefault_status()
    if args.json:
        print(json.dumps(st, indent=2, default=str))
        return
    if not (st.get("routers") or st.get("healers")):
        print("no servefault telemetry recorded (is a DisaggRouter/"
              "DisaggAutoscaler running?)")
        return
    totals = st.get("totals") or {}
    fo = totals.get("failovers") or {}
    sheds = totals.get("sheds_by_cause") or {}
    repl = totals.get("replacements") or {}
    shed_txt = " ".join(f"{k}:{v}"
                        for k, v in sorted(sheds.items())) or "none"
    print(f"totals: failovers=prefill:{fo.get('prefill', 0)}"
          f"/decode:{fo.get('decode', 0)} "
          f"failed_over_requests={totals.get('failover_requests', 0)} "
          f"sheds={sum(sheds.values())} ({shed_txt}) "
          f"replacements=prefill:{repl.get('prefill', 0)}"
          f"/decode:{repl.get('decode', 0)} "
          f"breaker_trips={totals.get('breaker_trips', 0)} "
          f"drains_reaped={totals.get('drains_reaped', 0)}")
    for key, r in sorted((st.get("routers") or {}).items()):
        rec = (r.get("recent_failover_recovery_ms") or {})
        rfo = r.get("failovers") or {}
        rsh = r.get("sheds_by_cause") or {}
        rsh_txt = ", ".join(f"{k}:{v}" for k, v in sorted(rsh.items()))
        print(f"  {key}: failovers=pf:{rfo.get('prefill', 0)}"
              f"/dec:{rfo.get('decode', 0)} "
              f"failed_over_reqs={r.get('failover_requests', 0)} "
              "sheds={" + rsh_txt + "}"
              + (f" recovery_p50={rec.get('p50', 0.0):.0f}ms"
                 if rec.get("n") else ""))
    for key, h in sorted((st.get("healers") or {}).items()):
        d = h.get("deaths") or {}
        rp = h.get("replacements") or {}
        print(f"  {key}: deaths=pf:{d.get('prefill', 0)}"
              f"/dec:{d.get('decode', 0)} "
              f"replacements=pf:{rp.get('prefill', 0)}"
              f"/dec:{rp.get('decode', 0)} "
              f"blocked={h.get('replacements_blocked', 0)} "
              f"breaker_trips={h.get('breaker_trips', 0)} "
              f"breaker_open={h.get('breaker_open') or []} "
              f"drains_reaped={h.get('drains_reaped', 0)}")
    if args.events:
        w = worker_mod.global_worker
        events = w.conductor.call("get_servefault_events", args.events,
                                  timeout=10.0)
        _print_event_tail(events, args.events)


def cmd_gateway(args) -> None:
    """`ray_tpu_torch gateway` — HTTP front-door view (serve/gateway.py):
    per-replica request counters split by priority class and status
    code, recent TTFT per class, QoS admission/rejection, batch-slot
    preemptions, plus the cluster totals every other surface (state
    API, /api/gateway, Prometheus, `gateway` timeline lane) reports
    from the same snapshots."""
    _connect(args)
    from .._private import worker as worker_mod
    from ..util import state

    st = state.gateway_status()
    if args.json:
        print(json.dumps(st, indent=2, default=str))
        return
    if not st.get("gateways"):
        print("no gateway telemetry recorded (is a GatewayServer "
              "running?)")
        return
    totals = st.get("totals") or {}
    code_txt = " ".join(
        f"{k}:{v}"
        for k, v in sorted((totals.get("by_code") or {}).items())) \
        or "none"
    print(f"totals: gateways={totals.get('gateways', 0)} "
          f"accepted={totals.get('accepted', 0)} "
          f"completed={totals.get('completed', 0)} "
          f"(streamed {totals.get('streamed', 0)}) "
          f"tokens_out={totals.get('tokens_out', 0)} "
          f"rate_limited={totals.get('rate_limited', 0)} "
          f"sheds={totals.get('sheds', 0)} "
          f"disconnects={totals.get('disconnects', 0)} "
          f"preemptions={totals.get('preemptions', 0)} "
          f"codes=({code_txt})")
    for cls, row in sorted((totals.get("by_class") or {}).items()):
        print(f"  class {cls}: accepted={row.get('accepted', 0)} "
              f"completed={row.get('completed', 0)} "
              f"shed={row.get('shed', 0)} "
              f"disconnects={row.get('disconnects', 0)}")
    for key, g in sorted((st.get("gateways") or {}).items()):
        ttft = g.get("ttft_ms") or {}
        ttft_txt = " ".join(
            f"{c}_p99={w.get('p99', 0.0):.0f}ms"
            for c, w in sorted(ttft.items()) if w.get("n"))
        print(f"  {key}: {g.get('host')}:{g.get('port')} "
              f"models={','.join(g.get('models') or [])} "
              f"accepted={g.get('accepted', 0)} "
              f"completed={g.get('completed', 0)} "
              f"disconnects={g.get('disconnects', 0)} "
              f"sheds={g.get('sheds', 0)} "
              f"rate_limited={g.get('rate_limited', 0)} "
              f"preemptions={g.get('preemptions', 0)}"
              + (f" {ttft_txt}" if ttft_txt else ""))
    if args.events:
        w = worker_mod.global_worker
        events = w.conductor.call("get_gateway_events", args.events,
                                  timeout=10.0)
        _print_event_tail(events, args.events)


def cmd_requests(args) -> None:
    """`ray_tpu_torch requests` — per-request flight-recorder view
    (observability/requests.py): retention totals, the cluster-wide
    slowest requests with their per-phase latency breakdowns, and the
    p99-attribution report naming the phase that owns the tail —
    from the same aggregate every other surface (state API,
    /api/requesttrace, Prometheus, `requests` timeline lane) reads.
    `--trace <id>` replays one kept request's full span log."""
    _connect(args)
    from .._private import worker as worker_mod
    from ..util import state

    if args.trace:
        trc = state.request_trace(args.trace)
        if trc is None:
            print(f"no kept trace for request {args.trace!r} "
                  f"(sampled out, aged out, or never recorded)")
            return
        if args.json:
            print(json.dumps(trc, indent=2, default=str))
            return
        print(f"{trc.get('request_id')}: outcome={trc.get('outcome')} "
              f"total={trc.get('total_ms', 0.0):.1f}ms "
              f"attempts={trc.get('attempts', 1)} "
              f"preempts={trc.get('preempts', 0)} "
              f"source={trc.get('source')} "
              f"class={trc.get('class', '-')} "
              f"tenant={trc.get('tenant', '-')}")
        for ph in trc.get("phases") or []:
            extra = " ".join(
                f"{k}={v}" for k, v in sorted(ph.items())
                if k not in ("phase", "t_ms", "dur_ms", "attempt")
                and v is not None)
            print(f"  [a{ph.get('attempt', 1)}] "
                  f"{ph.get('phase'):<18} +{ph.get('t_ms', 0.0):9.1f}ms "
                  f"dur={ph.get('dur_ms', 0.0):9.2f}ms"
                  + (f"  {extra}" if extra else ""))
        for ph in trc.get("remote_phases") or []:
            print(f"  [a{ph.get('attempt', 1)}] "
                  f"{ph.get('phase'):<18} (remote) "
                  f"dur={ph.get('dur_ms', 0.0):9.2f}ms "
                  f"server={ph.get('server', '-')}")
        return
    st = state.requesttrace_status()
    if args.json:
        print(json.dumps(st, indent=2, default=str))
        return
    if not st.get("stores"):
        print("no request-trace telemetry recorded (serve traffic "
              "with the request recorder on, the default, first)")
        return
    totals = st.get("totals") or {}
    out_txt = " ".join(
        f"{k}:{v}"
        for k, v in sorted((totals.get("outcomes") or {}).items())) \
        or "none"
    print(f"totals: stores={totals.get('stores', 0)} "
          f"completed={totals.get('completed', 0)} "
          f"kept={totals.get('kept', 0)} "
          f"dropped={totals.get('dropped', 0)} "
          f"replayed={totals.get('replayed_requests', 0)} "
          f"preempted={totals.get('preempted_requests', 0)} "
          f"slowest={totals.get('slowest_ms', 0.0):.1f}ms "
          f"outcomes=({out_txt})")
    attr = st.get("attribution") or {}
    if attr.get("n"):
        owner = attr.get("tail_owner")
        share = attr.get("tail_share")
        print(f"p99 attribution over {attr['n']} requests: "
              f"p50={attr.get('p50_total_ms', 0.0):.1f}ms "
              f"p99={attr.get('p99_total_ms', 0.0):.1f}ms tail_owner="
              + (f"{owner} ({share:.0%} of the gap)"
                 if owner else "none"))
        for ph, row in sorted((attr.get("phases") or {}).items(),
                              key=lambda kv: -kv[1]["delta_ms"]):
            print(f"    {ph:<18} p50={row['p50_ms']:9.2f}ms "
                  f"p99={row['p99_ms']:9.2f}ms "
                  f"delta={row['delta_ms']:+9.2f}ms")
    k = max(1, int(args.slowest))
    for rec in (st.get("slowest") or [])[:k]:
        pm = rec.get("phase_ms") or {}
        ph_txt = " ".join(f"{p}={pm[p]:.1f}" for p in sorted(
            pm, key=lambda p: -pm[p]))
        print(f"  {rec.get('request_id')}: "
              f"{rec.get('total_ms', 0.0):.1f}ms "
              f"outcome={rec.get('outcome')} "
              f"attempts={rec.get('attempts', 1)}"
              + (f"  [{ph_txt}]" if ph_txt else ""))
    if args.events:
        w = worker_mod.global_worker
        events = w.conductor.call("get_requesttrace_events",
                                  args.events, timeout=10.0)
        _print_event_tail(events, args.events)


def cmd_lora(args) -> None:
    """`ray_tpu_torch lora` — multi-tenant LoRA serving view
    (serve/lora.py): per-pool adapter-paging counters and residents,
    per-tenant request counters, plus the cluster totals every other
    surface (state API, /api/lora, Prometheus, `lora` timeline lane)
    reports from the same snapshots."""
    _connect(args)
    from .._private import worker as worker_mod
    from ..util import state

    st = state.lora_status()
    if args.json:
        print(json.dumps(st, indent=2, default=str))
        return
    if not (st.get("pools") or st.get("routers")):
        print("no lora telemetry recorded (is an AdapterPool-backed "
              "replica running?)")
        return
    totals = st.get("totals") or {}
    print(f"totals: pools={totals.get('pools', 0)} "
          f"slots={totals.get('slots', 0)} "
          f"resident={totals.get('resident', 0)} "
          f"pinned={totals.get('pinned', 0)} "
          f"acquires={totals.get('acquires', 0)} "
          f"hit_rate={totals.get('hit_rate', 0.0):.2%} "
          f"misses={totals.get('misses', 0)} "
          f"evictions={totals.get('evictions', 0)} "
          f"swaps={totals.get('swaps', 0)} "
          f"page_in={totals.get('page_in_bytes', 0)}B "
          f"tenants={totals.get('tenants', 0)}")
    for key, p in sorted((st.get("pools") or {}).items()):
        print(f"  pool {key}: slots={p.get('slots')} "
              f"resident={p.get('resident')} "
              f"pinned={p.get('pinned')} "
              f"hits={p.get('hits')} misses={p.get('misses')} "
              f"evictions={p.get('evictions')} "
              f"swaps={p.get('swaps')} "
              f"rank_max={p.get('rank_max')}")
    tenants = st.get("tenants") or {}
    for t, ts in sorted(tenants.items()):
        print(f"  tenant {t}: dispatched={ts.get('dispatched', 0)} "
              f"completed={ts.get('completed', 0)} "
              f"shed={ts.get('shed', 0)} "
              f"slo_misses={ts.get('slo_misses', 0)} "
              f"pool_hits={ts.get('hits', 0)}/"
              f"misses={ts.get('misses', 0)} "
              f"swaps={ts.get('swaps', 0)}")
    if args.events:
        w = worker_mod.global_worker
        events = w.conductor.call("get_lora_events", args.events,
                                  timeout=10.0)
        _print_event_tail(events, args.events)


def cmd_autoscale(args) -> None:
    """`ray_tpu_torch autoscale` — serving-autoscaler view
    (serve/autoscale.py): per-loop tier targets, decision counts,
    drain outcomes, and replica-seconds, plus the cluster totals every
    other surface (state API, /api/autoscale, Prometheus, timeline
    markers) reports from the same snapshots."""
    _connect(args)
    from .._private import worker as worker_mod
    from ..util import state

    st = state.autoscaler_status()
    if args.json:
        print(json.dumps(st, indent=2, default=str))
        return
    loops = st.get("autoscalers") or {}
    if not loops:
        print("no autoscaler telemetry recorded (is a "
              "serve.autoscale.DisaggAutoscaler running?)")
        return
    totals = st.get("totals") or {}
    rs = totals.get("replica_seconds") or {}
    print(f"totals: scale_ups={totals.get('scale_ups', 0)} "
          f"scale_downs={totals.get('scale_downs', 0)} "
          f"drains={totals.get('drains_completed', 0)} "
          f"(forced {totals.get('drains_forced', 0)}) "
          f"replica_s=prefill:{rs.get('prefill', 0.0):.1f}"
          f"/decode:{rs.get('decode', 0.0):.1f}")
    for key, s in sorted(loops.items()):
        print(f"  {key}: router={s.get('router')} "
              f"target_p99={s.get('target_p99_ms')}ms")
        for tier in ("prefill", "decode"):
            bounds = s.get(f"{tier}_bounds") or ["?", "?"]
            print(f"    {tier}: active={s.get(f'{tier}_active', 0)}"
                  f"/{s.get(f'{tier}_replicas', 0)} "
                  f"bounds=[{bounds[0]},{bounds[1]}] "
                  f"ups={(s.get('scale_ups') or {}).get(tier, 0)} "
                  f"downs={(s.get('scale_downs') or {}).get(tier, 0)} "
                  f"last={(s.get('last_reason') or {}).get(tier, '')!r}")
        if s.get("draining"):
            for d in s["draining"]:
                print(f"    DRAINING {d.get('tier')}:{d.get('rid')}")
    if args.events:
        w = worker_mod.global_worker
        events = w.conductor.call("get_autoscale_events", args.events,
                                  timeout=10.0)
        _print_event_tail(events, args.events)


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
    sp.add_argument("--block", action="store_true",
                    help="accepted for the reference CLI's sake: the head "
                         "always stays in the foreground")
    sp.add_argument("--dashboard-port", type=int,
                    default=DEFAULT_DASHBOARD_PORT)
    sp.add_argument("--no-dashboard", action="store_true")
    sp.set_defaults(fn=cmd_start)

    sp = sub.add_parser("dashboard", help="serve the web dashboard for a "
                        "running cluster")
    sp.add_argument("--address", help="conductor host:port")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=DEFAULT_DASHBOARD_PORT)
    sp.set_defaults(fn=cmd_dashboard)

    for name, fn in [("stop", cmd_stop), ("status", cmd_status),
                     ("summary", cmd_summary), ("memory", cmd_memory),
                     ("metrics", cmd_metrics)]:
        sp = sub.add_parser(name)
        sp.add_argument("--address")
        sp.set_defaults(fn=fn)

    sp = sub.add_parser("config", help="show the runtime flag table")
    sp.set_defaults(fn=cmd_config)

    sp = sub.add_parser("list", help="list cluster entities")
    sp.add_argument("kind", choices=["nodes", "workers", "actors", "tasks",
                                     "objects", "placement-groups"])
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_list)

    sp = sub.add_parser("timeline", help="export chrome trace")
    sp.add_argument("output", nargs="?", default="ray_tpu_torch_timeline.json")
    sp.add_argument("--output", dest="output_flag",
                    help="the file to write (as the positional)")
    sp.add_argument("--merged", action="store_true",
                    help="one unified trace: task events + tracing spans "
                         "+ training step markers (flight recorder)")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_timeline)

    sp = sub.add_parser("train-status",
                        help="gang training telemetry: per-rank step "
                             "stats, MFU, skew, stragglers")
    sp.add_argument("--run", help="filter to one run id")
    sp.add_argument("--json", action="store_true")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_train_status)

    sp = sub.add_parser("resilience-status",
                        help="recovery subsystem: quarantined/draining "
                             "hosts, failure scores, restart/preemption "
                             "counters, recent events")
    sp.add_argument("--json", action="store_true")
    sp.add_argument("--events", type=int, default=10,
                    help="recent events to print (default 10)")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_resilience_status)

    sp = sub.add_parser("weights",
                        help="live weight fabric: published versions, "
                             "manifests, keep-last-K GC")
    # --address lives on the LEAF parsers only: a mid-level flag would
    # be clobbered by the leaf's default (None) and silently ignored
    wsub = sp.add_subparsers(dest="weights_cmd", required=True)
    ws = wsub.add_parser("list", help="versions per weight-set name")
    ws.add_argument("--name", help="filter to one weight set")
    ws.add_argument("--json", action="store_true")
    ws.add_argument("--address")
    ws = wsub.add_parser("inspect",
                         help="one version's manifest (metadata only)")
    ws.add_argument("name")
    ws.add_argument("--version", type=int,
                    help="default: latest committed")
    ws.add_argument("--address")
    ws = wsub.add_parser("gc", help="keep only the newest K versions")
    ws.add_argument("name")
    ws.add_argument("--keep", type=int, required=True)
    ws.add_argument("--address")
    sp.set_defaults(fn=cmd_weights)

    sp = sub.add_parser("kvcache",
                        help="paged KV prefix cache: per-engine "
                             "hit/miss/eviction stats, pool "
                             "utilization, recent events")
    sp.add_argument("--engine", help="filter to one engine id")
    sp.add_argument("--json", action="store_true")
    sp.add_argument("--events", type=int, default=0,
                    help="also print the last N cache events")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_kvcache)

    sp = sub.add_parser("speculate",
                        help="speculative decoding: per-engine draft "
                             "proposal/acceptance counters, "
                             "tokens-per-verify, int8-KV flag")
    sp.add_argument("--engine", help="filter to one engine id")
    sp.add_argument("--json", action="store_true")
    sp.add_argument("--events", type=int, default=0,
                    help="also print the last N spec_accept/"
                         "spec_reject markers")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_speculate)

    sp = sub.add_parser("pipeline",
                        help="MPMD pipelines: stage registry, per-stage "
                             "bubble fraction and channel bytes, "
                             "recent events")
    sp.add_argument("--name", help="filter to one pipeline")
    sp.add_argument("--json", action="store_true")
    sp.add_argument("--events", type=int, default=0,
                    help="also print the last N pipeline events")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_pipeline)

    sp = sub.add_parser("online",
                        help="online learning loop: per-sampler "
                             "rollout/staleness stats, buffer "
                             "occupancy, learner ingest, recent "
                             "events")
    sp.add_argument("--json", action="store_true")
    sp.add_argument("--events", type=int, default=0,
                    help="also print the last N online-loop events")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_online)

    sp = sub.add_parser("disagg",
                        help="disaggregated prefill/decode serving: "
                             "KV-transfer accounting (shm vs rpc), "
                             "router shed/queue depth, recent events")
    sp.add_argument("--json", action="store_true")
    sp.add_argument("--events", type=int, default=0,
                    help="also print the last N disagg events")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_disagg)

    sp = sub.add_parser("kvplane",
                        help="global KV plane: tiered prefix cache "
                             "(HBM -> host arena -> object store), "
                             "spill/re-adopt accounting, prefix "
                             "directory routing, recent events")
    sp.add_argument("--json", action="store_true")
    sp.add_argument("--events", type=int, default=0,
                    help="also print the last N kvplane events "
                         "(spill/tier2_hit/tier3_publish/tier3_adopt/"
                         "directory_hit markers)")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_kvplane)

    sp = sub.add_parser("servefault",
                        help="serving-plane fault tolerance: request "
                             "failovers by phase, sheds by cause, "
                             "replica deaths/replacements, breaker "
                             "state, recent events")
    sp.add_argument("--json", action="store_true")
    sp.add_argument("--events", type=int, default=0,
                    help="also print the last N servefault events "
                         "(the resilience lane's failover/replace/"
                         "breaker_trip slice)")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_servefault)

    sp = sub.add_parser("gateway",
                        help="HTTP front door: per-replica request "
                             "counters by priority class and status "
                             "code, recent TTFT, QoS admissions, "
                             "batch-slot preemptions, recent events")
    sp.add_argument("--json", action="store_true")
    sp.add_argument("--events", type=int, default=0,
                    help="also print the last N gateway events "
                         "(accept/first_byte/preempt/rate_limit/"
                         "disconnect markers)")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_gateway)

    sp = sub.add_parser("requests",
                        help="per-request flight recorder: slowest "
                             "requests with per-phase breakdowns, "
                             "p99 tail attribution, single-trace "
                             "replay by request id")
    sp.add_argument("--slowest", type=int, default=10,
                    help="print the K slowest kept requests "
                         "(default 10)")
    sp.add_argument("--trace",
                    help="replay ONE kept request's phase spans by "
                         "request id")
    sp.add_argument("--json", action="store_true")
    sp.add_argument("--events", type=int, default=0,
                    help="also print the last N request-trace events "
                         "(kept-trace + remote-phase records)")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_requests)

    sp = sub.add_parser("lora",
                        help="multi-tenant LoRA serving: adapter-pool "
                             "paging (hits/misses/evictions/swaps, "
                             "residents), per-tenant request counters, "
                             "recent page_in/evict/swap events")
    sp.add_argument("--json", action="store_true")
    sp.add_argument("--events", type=int, default=0,
                    help="also print the last N lora events")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_lora)

    sp = sub.add_parser("autoscale",
                        help="serving autoscaler: per-tier targets and "
                             "decision counts, drain outcomes, "
                             "replica-seconds, recent events")
    sp.add_argument("--json", action="store_true")
    sp.add_argument("--events", type=int, default=0,
                    help="also print the last N autoscale events")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_autoscale)

    sp = sub.add_parser("microbench",
                        help="core-runtime micro benchmarks (ray_perf "
                             "analog): task/actor/put-get/queue/churn")
    sp.add_argument("--scale", type=float, default=1.0)
    sp.add_argument("--out", default="")
    sp.set_defaults(fn=cmd_microbench)


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
