"""joblib backend over ray_tpu_torch (the port's copy of the JAX
package's backend; it registers as "ray_tpu_torch", so both packages'
backends can live in one process) — analog of the reference's
python/ray/util/joblib/ (register_ray + RayBackend on the multiprocessing
Pool shim). Usage:

    from ray_tpu_torch.util.joblib import register_ray_tpu_torch
    register_ray_tpu_torch()
    with joblib.parallel_backend("ray_tpu_torch"):
        Parallel()(delayed(f)(i) for i in range(100))
"""
from __future__ import annotations

from joblib._parallel_backends import MultiprocessingBackend
from joblib.parallel import register_parallel_backend


class RayTpuBackend(MultiprocessingBackend):
    """Reference util/joblib/ray_backend.py RayBackend — reuses joblib's
    pool-based backend with our Pool as the factory."""

    supports_timeout = True

    def effective_n_jobs(self, n_jobs):
        import ray_tpu_torch as rt

        if not rt.is_initialized():
            rt.init(ignore_reinit_error=True)
        eff = int(rt.cluster_resources().get("CPU", 1))
        if n_jobs is None or n_jobs == -1:
            return eff
        return min(abs(n_jobs), eff) if n_jobs else 1

    def configure(self, n_jobs=1, parallel=None, prefer=None, require=None,
                  **memmapping_kwargs):
        from .multiprocessing import Pool

        n_jobs = self.effective_n_jobs(n_jobs)
        self._pool = Pool(processes=n_jobs)
        self.parallel = parallel
        return n_jobs

    def terminate(self):
        if getattr(self, "_pool", None) is not None:
            self._pool.terminate()
            self._pool = None


def register_ray_tpu_torch() -> None:
    register_parallel_backend("ray_tpu_torch", RayTpuBackend)
