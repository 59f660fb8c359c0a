"""ray_tpu_torch.analysis: the structured findings of the JAX package's
static analyzer and its schedule-aware pipeline lint (part of the port
of ray_tpu/analysis/).

Only `findings` and `pipelines` are ported so far; the AST lint, the
sharding and collective checks and the built-in layouts wait for
ROADMAP Queue 1 item 7 (the port's spec check is
`parallel.shardcheck`).
"""
from .findings import (  # noqa: F401
    ERROR,
    Finding,
    INFO,
    RULES,
    SEVERITIES,
    WARNING,
    at_least,
    errors,
    format_report,
    max_severity,
    sort_findings,
)
from .pipelines import (  # noqa: F401
    BUBBLE_WARN_FRACTION,
    PIPELINE_SCHEDULES,
    check_pipeline_schedule,
    estimate_bubble_fraction,
)
