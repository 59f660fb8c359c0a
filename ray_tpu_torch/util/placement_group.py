"""Placement groups: atomic gang reservation of resources (the port's
copy of the JAX package's util/placement_group.py).

API of the reference's python/ray/util/placement_group.py
(placement_group() :145, PlacementGroup handle :41) with strategies
PACK, SPREAD, STRICT_PACK and STRICT_SPREAD. The conductor reserves all
bundles transactionally (one authority — no 2PC needed, cf. reference
gcs_placement_group_scheduler.cc). A bundle may hold whole GPUs: a task
or actor placed in it with ``num_gpus=`` gets a worker bound to GPUs of
the bundle's node.

    pg = placement_group([{"GPU": 1, "CPU": 1}], strategy="STRICT_PACK")
    pg.wait(30)
    Scorer.options(num_gpus=1, placement_group=pg).remote()
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

from .._private import worker as worker_mod

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    def __init__(self, pg_id: str, bundles: List[Dict[str, float]],
                 strategy: str):
        self.id = pg_id
        self.bundles = bundles
        self.strategy = strategy

    def ready(self) -> bool:
        w = _worker()
        return bool(w.conductor.call("placement_group_ready", self.id,
                                     timeout=30.0))

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout_seconds
        while time.monotonic() < deadline:
            if self.ready():
                return True
            time.sleep(0.05)
        return False

    @property
    def bundle_count(self) -> int:
        return len(self.bundles)

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundles, self.strategy))


def placement_group(bundles: List[Dict[str, float]],
                    strategy: str = "PACK",
                    name: Optional[str] = None) -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"strategy must be one of {VALID_STRATEGIES}")
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be a non-empty list of non-empty "
                         "resource dicts")
    w = _worker()
    pg_id = w.conductor.call("create_placement_group", list(bundles),
                             strategy, name, timeout=60.0)
    return PlacementGroup(pg_id, list(bundles), strategy)


def remove_placement_group(pg: PlacementGroup) -> None:
    w = _worker()
    w.conductor.call("remove_placement_group",
                     getattr(pg, "id", pg), timeout=30.0)


def _worker():
    w = worker_mod.global_worker
    if w is None:
        raise RuntimeError("ray_tpu_torch.init() must be called first")
    return w
