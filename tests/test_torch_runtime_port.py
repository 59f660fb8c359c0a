"""Where the port's runtime (ray_tpu_torch) differs from the JAX
package's: torch tensors in the object plane (a put holds the tensor
as it was, whatever is written in place later), a CUDA tensor's record
where no GPU is leased, whole-GPU leases under a driver's
CUDA_VISIBLE_DEVICES, pid identity of forked workers, calls that would
end the driver, a failed arena build, the parts this slice leaves out,
the fork template without torch, no RAY_TPU_* knob, the
conductor's KV, pubsub and tables, and task submission that parks no
thread per task (a wait on a borrowed dependency delays no independent
task; an argument that does not serialize fails its own task alone).

Every check runs in a driver process of its own
(`ray_tpu_torch._private.isolated.run_checks`, hard timeout 200 s):
no cluster, worker or arena lives in the pytest process. The checks are
functions of `ray_tpu_torch/_private/runtime_checks.py`; each one is a
case here, and `__session_ended__` holds that every process of the run
had exited once its driver was done.
"""
from __future__ import annotations

import pytest

from ray_tpu_torch._private import isolated

C2 = {"num_cpus": 2}

CHECKS = {
    "port_tensor_round_trips_cpu": C2,
    "port_tensor_puts_are_snapshots": C2,
    "port_tensor_puts_are_snapshots_in_segments": {
        "num_cpus": 2, "_system_config": {"native_store": 0}},
    "port_cuda_record_needs_a_gpu_lease": C2,
    "port_gpu_leases_follow_the_visible_list": None,
    "port_recycled_pid_is_not_signalled": None,
    "port_driver_refuses_process_exits": C2,
    "port_failed_arena_build_raises": None,
    "port_omitted_parts_raise": None,
    "port_fork_template_imports_no_torch": C2,
    "port_package_import_is_lazy": None,
    "port_reads_no_ray_tpu_knob": None,
    "port_conductor_kv_pubsub_and_tables": C2,
    "port_borrowed_dep_wait_delays_no_independent_task": {"num_cpus": 4},
    "port_unsendable_argument_fails_its_task_alone": C2,
}


@pytest.fixture(scope="module")
def outcomes():
    return isolated.run_checks(CHECKS, timeout=200.0)


@pytest.mark.parametrize("name", [*CHECKS, isolated.SESSION_ENDED])
def test_port(outcomes, name):
    ok, text = outcomes[name]
    assert ok, text
