"""Workload-facing alias of the stage-marker protocol (as
`dstack_tpu.workloads.stages` is for the JAX package).

The implementation lives in `dstack_tpu_torch.utils.stagemarkers`;
workloads use this module for the natural spelling
(`from dstack_tpu_torch.workloads.stages import emit_stage`).
"""

from dstack_tpu_torch.utils.stagemarkers import (  # noqa: F401
    STAGE_MARKER_PREFIX,
    auto_stage,
    emit_stage,
    parse_stage_marker,
    traceparent,
)

__all__ = [
    "STAGE_MARKER_PREFIX",
    "auto_stage",
    "emit_stage",
    "parse_stage_marker",
    "traceparent",
]
