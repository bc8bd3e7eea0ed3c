"""W3C Trace Context (`traceparent`) helpers (a copy of
`dstack_tpu.utils.tracecontext`, which the port may not import).

One run = one trace. The SDK/CLI generates a traceparent at submit time
and sends it as the `traceparent` header; the server persists it on the
run row (runs.trace_context), stamps it on every runner-client HTTP call,
and the runner injects it into the workload as `DSTACK_TPU_TRACEPARENT` —
so FSM spans, agent spans, and trainer/serving spans all share the run's
trace_id. Format per https://www.w3.org/TR/trace-context/:

    00-<32 hex trace-id>-<16 hex parent-id>-<2 hex flags>

Only version 00 is produced; parsing accepts any two-digit version except
the forbidden `ff`, matching the spec's forward-compat rule.
"""

import re
import secrets
from typing import Dict, NamedTuple, Optional, Tuple

TRACEPARENT_HEADER = "traceparent"
TRACEPARENT_ENV = "DSTACK_TPU_TRACEPARENT"
REQUEST_ID_HEADER = "x-request-id"

_TRACEPARENT_RE = re.compile(
    r"^(?P<version>[0-9a-f]{2})-(?P<trace_id>[0-9a-f]{32})"
    r"-(?P<span_id>[0-9a-f]{16})-(?P<flags>[0-9a-f]{2})$"
)


class TraceContext(NamedTuple):
    version: str
    trace_id: str
    span_id: str
    flags: str

    def to_header(self) -> str:
        return f"{self.version}-{self.trace_id}-{self.span_id}-{self.flags}"


def generate_traceparent(sampled: bool = True) -> str:
    """New root context: fresh random trace_id + span_id."""
    return TraceContext(
        version="00",
        trace_id=secrets.token_hex(16),
        span_id=secrets.token_hex(8),
        flags="01" if sampled else "00",
    ).to_header()


def parse_traceparent(value: Optional[str]) -> Optional[TraceContext]:
    """Parse a traceparent header; None on any malformation (the spec says
    a receiver that cannot parse MUST restart the trace, so callers treat
    None as "generate a new one")."""
    if not value:
        return None
    m = _TRACEPARENT_RE.match(value.strip().lower())
    if m is None:
        return None
    ctx = TraceContext(**m.groupdict())
    # All-zero ids and version ff are explicitly invalid per the spec.
    if ctx.version == "ff" or ctx.trace_id == "0" * 32 or ctx.span_id == "0" * 16:
        return None
    return ctx


_REQUEST_ID_RE = re.compile(r"^[A-Za-z0-9._:-]{1,128}$")


def ensure_request_trace(
    state: Dict[str, object], headers: Dict[str, str]
) -> Tuple[str, str]:
    """Per-request trace identity at an HTTP ingress: parse the inbound
    `traceparent` (minting a fresh root when absent or malformed — the
    spec's restart rule) and the client's `X-Request-ID` (generating one
    when absent or junk), cached in the request's `state` dict so every
    consumer on the request path sees the same pair.

    Returns (traceparent, request_id)."""
    cached = state.get("trace_identity")
    if cached is not None:
        return cached  # type: ignore[return-value]
    inbound = headers.get(TRACEPARENT_HEADER)
    if parse_traceparent(inbound) is not None:
        tp = inbound.strip().lower()
    else:
        tp = generate_traceparent()
    rid = headers.get(REQUEST_ID_HEADER, "").strip()
    if not _REQUEST_ID_RE.match(rid):
        # A hostile/garbage id never reaches logs or response headers.
        rid = secrets.token_hex(8)
    state["trace_identity"] = (tp, rid)
    return tp, rid


def child_traceparent(parent: str) -> str:
    """Derive a child context: same trace_id (the run), new span_id (this
    hop — router, FSM tick, runner call). Invalid parents restart the
    trace, per spec."""
    ctx = parse_traceparent(parent)
    if ctx is None:
        return generate_traceparent()
    return TraceContext(
        version="00",
        trace_id=ctx.trace_id,
        span_id=secrets.token_hex(8),
        flags=ctx.flags,
    ).to_header()
