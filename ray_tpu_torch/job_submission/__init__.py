"""Job submission SDK (the port's copy of the JAX package's
job_submission/): analog of the reference's python/ray/job_submission/
(JobSubmissionClient, JobStatus) + dashboard/modules/job JobManager.
Entrypoint drivers run as subprocesses of the head, in its environment
with RTT_ADDRESS and RTT_JOB_ID set, so ``ray_tpu_torch.init()`` (or
``init(address="auto")``) inside one finds the cluster."""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"

    TERMINAL = frozenset({SUCCEEDED, FAILED, STOPPED})


class JobSubmissionClient:
    """``JobSubmissionClient("host:port")`` or, inside an inited driver,
    ``JobSubmissionClient()`` to use the current cluster."""

    def __init__(self, address: Optional[str] = None):
        from .._private.rpc import RpcClient

        if address is None:
            from .._private import worker as worker_mod

            w = worker_mod.global_worker
            if w is None:
                raise RuntimeError(
                    "no address given and ray_tpu_torch.init() not called")
            self._client = w.conductor
        else:
            host, _, port = address.rpartition(":")
            self._client = RpcClient((host or "127.0.0.1", int(port)))

    def submit_job(self, *, entrypoint: str,
                   runtime_env: Optional[Dict[str, Any]] = None,
                   submission_id: Optional[str] = None,
                   metadata: Optional[Dict[str, str]] = None) -> str:
        """`runtime_env` takes ``env_vars`` and ``working_dir`` only:
        the entrypoint's environment and directory (the runtime
        environments of tasks are not ported, ROADMAP Queue 1 item 2)."""
        runtime_env = dict(runtime_env or {})
        other = set(runtime_env) - {"env_vars", "working_dir"}
        if other:
            raise NotImplementedError(
                f"runtime_env keys {sorted(other)}: runtime environments "
                "are not ported yet (ROADMAP Queue 1 item 2, third part)")
        env = dict(runtime_env.get("env_vars") or {})
        return self._client.call(
            "submit_job", entrypoint, env, submission_id,
            runtime_env.get("working_dir"), metadata, timeout=30.0)

    def get_job_status(self, job_id: str) -> str:
        return self.get_job_info(job_id)["status"]

    def get_job_info(self, job_id: str) -> Dict[str, Any]:
        info = self._client.call("get_job", job_id, timeout=10.0)
        if info is None:
            raise KeyError(f"no job {job_id}")
        return info

    def list_jobs(self) -> List[Dict[str, Any]]:
        return self._client.call("list_jobs", timeout=10.0)

    def get_job_logs(self, job_id: str) -> str:
        return self._client.call("get_job_logs", job_id, timeout=30.0)

    def stop_job(self, job_id: str) -> bool:
        return self._client.call("stop_job", job_id, timeout=10.0)

    def wait_until_finished(self, job_id: str, timeout: float = 300.0,
                            poll_s: float = 0.2) -> str:
        deadline = time.monotonic() + timeout
        while True:
            status = self.get_job_status(job_id)
            if status in JobStatus.TERMINAL:
                return status
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"job {job_id} still {status} after {timeout}s")
            time.sleep(poll_s)
