"""Lifecycle stage markers: the workload -> runner wire format (a copy of
`dstack_tpu.utils.stagemarkers`, which the port may not import).

A workload process cannot reach the server, but its stdout already flows
through the runner's log pump, so stage transitions ride that channel as
single marker lines. `emit_stage("tpu_init")` prints

    ::dstack-tpu-stage::tpu_init

and the runner (dstack_tpu/agents/runner.py) recognises the line, turns
it into a run-timeline event and keeps it out of the job's log stream.

The stage names are the reference's, letter for letter, so the runner
parses the port's markers unchanged: a trainer emits tpu_init,
compile_start, compile_end and first_step; a serving engine
compile_start, compile_end, warmup_end and first_token; the model server
weights_start and weights_end. On the GPU `tpu_init` keeps its name and
marks the same point, the first touch of the card; `compile_*` brackets
the port's build (the nvcc kernel library at its first launch) and the
first step. `DSTACK_TPU_TRACEPARENT` (injected by the runner) carries the
run's trace context for workloads that keep their own spans.
"""

import os
import sys
from typing import Optional

STAGE_MARKER_PREFIX = "::dstack-tpu-stage::"


def emit_stage(stage: str, stream=None) -> None:
    """Print one stage marker line, flushed so the runner's pump sees it
    at once (a buffered marker arriving late would skew every stage
    duration behind it)."""
    out = stream if stream is not None else sys.stdout
    out.write(f"{STAGE_MARKER_PREFIX}{stage}\n")
    out.flush()


def auto_stage(stage: str) -> None:
    """`emit_stage`, but only inside an orchestrated run, detected by the
    DSTACK_RUN_NAME env var the runner injects. Library code calls this
    unconditionally; direct use in tests or benchmarks stays silent."""
    if os.environ.get("DSTACK_RUN_NAME"):
        emit_stage(stage)


def parse_stage_marker(line: str) -> Optional[str]:
    """Stage name if `line` is a marker (surrounding whitespace ignored),
    else None."""
    text = line.strip()
    if not text.startswith(STAGE_MARKER_PREFIX):
        return None
    stage = text[len(STAGE_MARKER_PREFIX):].strip()
    return stage or None


def traceparent() -> Optional[str]:
    """The run's trace context as injected by the runner, if any."""
    return os.environ.get("DSTACK_TPU_TRACEPARENT")
