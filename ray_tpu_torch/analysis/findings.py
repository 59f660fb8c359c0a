"""Structured findings for the shardlint static analyzer (port of
ray_tpu/analysis/findings.py).

Every check in ray_tpu_torch.analysis reports `Finding` records instead of
raising: a finding names the RULE that fired (a stable kebab-case id the
tests and CI assert on), a SEVERITY, a human location (file:line for AST
lint, layout/param path for shard analysis), the message, and a fix hint.
The callers decide policy — the CLI exits nonzero on errors, the dryrun
path refuses to run a layout with errors/warnings, TrainStep raises on
errors only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Sequence

# Severity levels, most severe first. Plain strings (not an Enum) so
# findings serialize to JSON without adapters.
ERROR = "error"
WARNING = "warning"
INFO = "info"
SEVERITIES: Sequence[str] = (ERROR, WARNING, INFO)
_RANK: Dict[str, int] = {s: i for i, s in enumerate(SEVERITIES)}

# Rule registry: id -> one-line description (the README table is derived
# from this). Default severities are noted where fixed; collective-over-dcn
# severity depends on which axes are involved.
RULES: Dict[str, str] = {
    "unknown-axis": "PartitionSpec names an axis the mesh does not have",
    "rank-exceeds-ndim": "PartitionSpec has more entries than array dims",
    "non-dividing-dim": "mesh axis size does not divide the array dim",
    "duplicate-axis": "same mesh axis used on two dims of one spec",
    "replicated-large-param":
        "large param fully replicated on every device (HBM blow-up)",
    "collective-over-dcn":
        "bandwidth-heavy collective spans a slow DCN axis",
    "unmodeled-collective":
        "collective primitive without a cost-model entry; byte and "
        "step-time estimates fall back to its raw input size",
    "pipeline-bubble":
        "pipeline schedule's analytic bubble fraction (S-1)/(M+S-1); "
        "warning past 20%",
    "blocking-in-async":
        "blocking call (time.sleep / ray_tpu_torch.get / Queue.get) inside "
        "an async def",
    "unsupervised-actor-call":
        "bare call on a serve tier-replica target bypasses the "
        "failover wrapper (replica death raises unsupervised)",
    "unkeyed-tenant-cache":
        "prefix-cache lookup in LoRA-aware code without the tenant in "
        "the key (one tenant's cached KV could serve another)",
    "undonated-pool-write":
        "write into a pool-shaped device stack outside a donated jit "
        "(copies the whole pool per write instead of O(row) in place)",
    "host-sync-in-jit":
        "host synchronization (.item() / device_get / print) inside a "
        "jitted function",
    "sync-io-in-gateway-handler":
        "synchronous decode call (.generate(...) / .decode_from(...)) "
        "inside an async HTTP handler freezes every stream on the "
        "gateway's event loop",
    "lock-discipline":
        "in a lock-using class, a self._* attribute mutated both "
        "under `with self._lock` and outside it — a data race "
        "candidate, both sites cited",
    "surface-parity":
        "a conductor subsystem missing part of the full surface "
        "treatment (state accessor == CLI == dashboard == Prometheus "
        "== timeline lane)",
    "env-knob-inconsistent-default":
        "one RAY_TPU_* knob parsed with different literal defaults at "
        "different sites",
    "env-knob-hot-path":
        "RAY_TPU_* knob parsed inside a loop / per-tick path without "
        "the cached-env pattern",
    "env-knob-undocumented":
        "RAY_TPU_* knob read in code but absent from the README knob "
        "table",
    "undonated-jit-pool-arg":
        "jitted function updates a pool/cache/slab-shaped argument "
        "without donate_argnums (O(pool) copy per call instead of "
        "O(row) in place)",
}


@dataclass(frozen=True)
class Finding:
    """One analyzer finding. `rule` is the stable id from RULES."""

    rule: str
    severity: str
    location: str
    message: str
    fix_hint: str = ""

    def __post_init__(self):
        if self.severity not in _RANK:
            raise ValueError(
                f"severity must be one of {SEVERITIES}, got "
                f"{self.severity!r}")

    def to_dict(self) -> Dict[str, str]:
        return {"rule": self.rule, "severity": self.severity,
                "location": self.location, "message": self.message,
                "fix_hint": self.fix_hint}

    def __str__(self) -> str:
        hint = f"  [fix: {self.fix_hint}]" if self.fix_hint else ""
        return (f"{self.severity.upper():<7} {self.rule:<22} "
                f"{self.location}: {self.message}{hint}")


def at_least(findings: Iterable[Finding], severity: str) -> List[Finding]:
    """Findings at `severity` or more severe."""
    cut = _RANK[severity]
    return [f for f in findings if _RANK[f.severity] <= cut]


def errors(findings: Iterable[Finding]) -> List[Finding]:
    return at_least(findings, ERROR)


def max_severity(findings: Iterable[Finding]) -> str:
    """Most severe level present; INFO for an empty list."""
    ranks = [_RANK[f.severity] for f in findings]
    return SEVERITIES[min(ranks)] if ranks else INFO


def sort_findings(findings: Iterable[Finding]) -> List[Finding]:
    return sorted(findings,
                  key=lambda f: (_RANK[f.severity], f.location, f.rule))


def format_report(findings: Sequence[Finding]) -> str:
    """Human report: findings most-severe first plus a summary line."""
    lines = [str(f) for f in sort_findings(findings)]
    counts = {s: sum(1 for f in findings if f.severity == s)
              for s in SEVERITIES}
    lines.append(f"{len(findings)} finding(s): {counts[ERROR]} error, "
                 f"{counts[WARNING]} warning, {counts[INFO]} info")
    return "\n".join(lines)


__all__ = ["Finding", "RULES", "SEVERITIES", "ERROR", "WARNING", "INFO",
           "at_least", "errors", "max_severity", "sort_findings",
           "format_report"]
