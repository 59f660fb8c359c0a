"""Scheduling strategies for tasks and actors.

Reference surface: python/ray/util/scheduling_strategies.py
(NodeAffinitySchedulingStrategy) and
src/ray/raylet/scheduling/policy/node_affinity_scheduling_policy.cc for
the semantics: a hard affinity runs ONLY on the named node (waiting if
it is merely busy, failing if it is dead or can never fit the request);
a soft affinity prefers the node and falls back to the default policy
when it is gone or infeasible.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple, Union


@dataclass
class NodeAffinitySchedulingStrategy:
    """Pin a task/actor to `node_id` (from ``ray_tpu_torch.nodes()`` /
    ``list_nodes``). ``soft=True`` degrades to DEFAULT placement when the
    node is dead or can never satisfy the resource request."""

    node_id: str
    soft: bool = False


WireStrategy = Union[str, Tuple[str, str, bool]]


def to_wire(strategy: Any) -> WireStrategy:
    """Normalize a user-facing strategy to its RPC-safe form: the plain
    policy strings pass through; strategy objects become tagged tuples."""
    if strategy is None:
        return "DEFAULT"
    if isinstance(strategy, NodeAffinitySchedulingStrategy):
        return ("NODE_AFFINITY", str(strategy.node_id), bool(strategy.soft))
    if isinstance(strategy, str):
        if strategy not in ("DEFAULT", "SPREAD"):
            raise ValueError(f"unknown scheduling_strategy {strategy!r} "
                             "(expected 'DEFAULT', 'SPREAD', or a "
                             "NodeAffinitySchedulingStrategy)")
        return strategy
    raise TypeError(f"unsupported scheduling_strategy: {strategy!r}")
