"""Continuous-batching decode engine in PyTorch (port of
`dstack_tpu.workloads.serving`: the single-device engine with speculative
decoding, the host KV tier and slot preemption, multi-tenant LoRA
adapters, prefill/decode disaggregation, the cache-affinity sketch, and
the dense reference it is held to).

A fixed batch of B slots steps together so new requests join mid-flight
and finished ones free their slot at once. The KV cache is paged
(workloads/kv_blocks.py): slots index a shared block pool through block
tables, requests sharing a prompt prefix share its blocks (copy-on-write
on divergence), and prompt admission is chunked — each loop iteration
dispatches at most `prefill_chunk_tokens` prompt tokens before the decode
chunk, so a long prompt never stalls in-flight decodes for more than one
chunk budget. Every chunk prefill and decode step runs its attention
through `paged_attention.ragged_attention` (the CUDA kernel on the card).

Speculative decoding (`spec_enable`): a drafter (by default the int8
quantization of the target) proposes k tokens per slot against its own
pool, indexed through the target's block tables by the one allocator,
and the target verifies all k+1 positions in one forward
(kv_blocks.make_spec_draft / make_spec_verify); k adapts per slot to its
acceptance, and a batch that keeps rejecting falls back to plain decode
chunks for a while. Host tier (`kv_host_budget_bytes`): prefix blocks
that eviction takes spill to page-locked host memory and swap back on a
later hit; a live slot can be preempted (its chain parked host-side,
resumed later token-exact at temperature 0) when the pool starves, when a
heavier tenant (`qos_weights`) finds every resident slot taken, or on
`preempt()`; `max_resident_slots` caps the slots resident on the card.
Multi-tenant LoRA (`lora_max_adapters`): a refcounted registry over a
device adapter bank (workloads/lora_serving.py); a request names its
adapter at `submit` and holds a ref until it ends, its adapter's name
namespaces its prefix-cache blocks (device and host tier), and the LoRA
twins of the programs add each slot's delta while any request holds an
adapter ref (the plain programs run otherwise).

Disaggregation (`role`): a prefill engine never activates decode slots.
At a request's final chunk the loop thread gathers its blocks (and the
drafter's) into page-locked host tensors behind a CUDA event, and a
sender thread ships them with the first token through `kv_transfer`
(workloads/kv_transfer.py), then releases the blocks. A decode engine
takes handoffs at `submit_prefilled`, scatters them into fresh blocks of
its own pool and decodes from there. Both tiers' chunk prefill, decode
and verify run the paged kernel.

Tensor-parallel serving (`mesh`, sharding.make_mesh over the ranks of a
process group): rank r holds its column slices of every weight and its
KV heads (sharding.SERVING_PARAM_SPECS, SERVING_KV_POOL_SPEC), and every
program gathers activations at the column-parallel layout's points
(kv_blocks.py), so a rank computes its columns as the unsharded program
does. The host loop runs on rank 0 only. Every device program call and
every host write into device state goes through one op layer (`_op`):
rank 0 broadcasts the op and its host inputs, then runs it itself; each
follower rank (`run_follower`) builds the same state from its shards and
runs the ops it receives until a shutdown op. Every rank samples from the
same gathered logits with the same seeded generator, so the ranks' token
ids agree; followers never read a result back. Each rank launches the
paged kernel on its own KV/n heads; the JAX engine runs `lax_ragged`
under a model mesh (`pallas_call` has no SPMD rule), so the port's
`attn_path` stays "cuda" there: a divergence, recorded in ROADMAP.

Host syncs: one readback per decode chunk of `steps_per_sync` tokens (or
per speculation round, plus one between its draft and verify that splits
their times), and one per finalized prefill's first token, which a
reader thread waits for on its own CUDA event so the loop never blocks
on it. A spill and a swap-out wait for their device-to-host copies.

The dense primitives (DecodeState / make_prefill / make_insert /
make_decode_step) are the reference semantics: the paged decode body
shares `_select_next_token` with the dense body.
"""

import logging
import math
import queue
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from dstack_tpu_torch.utils.flight_recorder import FlightRecorder
from dstack_tpu_torch.utils.histogram import HistogramData
from dstack_tpu_torch.utils.stagemarkers import auto_stage
from dstack_tpu_torch.workloads import compile_cache
from dstack_tpu_torch.workloads.attention import decode_attention
from dstack_tpu_torch.workloads.config import ModelConfig
from dstack_tpu_torch.workloads.device import (
    DeviceLike,
    host_to_device,
    resolve_device,
)
from dstack_tpu_torch.workloads.generate import (
    KVCache,
    _categorical,
    _forward_cached,
    _nucleus_filter,
    sample_logits_row,
)
from dstack_tpu_torch.workloads.kv_blocks import (
    BlockAllocator,
    init_paged_state,
    make_chunk_prefill,
    make_copy_block,
    make_paged_decode_step,
    make_spec_draft,
    make_spec_verify,
)
from dstack_tpu_torch.workloads.kv_host_tier import HostKVTier, payload_bytes
from dstack_tpu_torch.workloads.kv_transfer import KVHandoff, StaleEpochError
from dstack_tpu_torch.workloads.lora_serving import AdapterRegistry
from dstack_tpu_torch.workloads.paged_attention import (
    dispatch_path as attn_dispatch_path,
)
from dstack_tpu_torch.workloads.quant import quantize_params
from dstack_tpu_torch.workloads.sharding import (
    SERVING_KV_POOL_SPEC,
    all_gather,
    broadcast_object,
    check_heads,
    model_shards,
    rank_params,
    shard,
    to_host,
)
from dstack_tpu_torch.workloads.transformer import (
    copy_params,
    detach_params,
    ffn_block,
    layer_params,
    linear,
    logits_linear,
    params_device,
    project_qkv,
    rms_norm,
)
from dstack_tpu_torch.workloads.weights import flatten_params

Params = Dict[str, Any]
ATTN_PATHS = ("cuda", "plain")
# A mesh leader idle this long sends its followers a no-op, so a follower
# waiting for its next op never meets the process group's timeout.
HEARTBEAT_S = 30.0
# The key of a mesh host-tier payload's id (a host int64 scalar beside its
# arrays), which names the followers' shards of the same payload.
PAYLOAD_ID = "payload_id"


# -- dense reference -----------------------------------------------------------


@dataclass
class DecodeState:
    """Shared slot state: k/v (L, B, max_len, KV, hd), per-slot scalars."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor      # (B,) int32 filled cache positions
    last_token: torch.Tensor   # (B,) int32 next token to feed
    active: torch.Tensor       # (B,) bool
    remaining: torch.Tensor    # (B,) int32 new tokens still budgeted
    temperature: torch.Tensor  # (B,) f32 per-request temp; 0 = greedy
    top_p: torch.Tensor        # (B,) f32 nucleus cutoff; 1 = no filtering


def init_decode_state(config: ModelConfig, batch: int, max_len: int,
                      device: torch.device) -> DecodeState:
    c = config
    shape = (c.n_layers, batch, max_len, c.n_kv_heads, c.head_dim)

    def z(dtype, fill=0):
        return torch.full((batch,), fill, dtype=dtype, device=device)

    return DecodeState(
        k=torch.zeros(shape, dtype=c.activation_dtype, device=device),
        v=torch.zeros(shape, dtype=c.activation_dtype, device=device),
        lengths=z(torch.int32), last_token=z(torch.int32),
        active=z(torch.bool, False), remaining=z(torch.int32),
        temperature=z(torch.float32), top_p=z(torch.float32, 1.0),
    )


def make_prefill(config: ModelConfig):
    """prefill(params, tokens (1, S), temp, top_p, generator) ->
    (k (L, 1, S, KV, hd), v, first_token 0-d int32). The dense reference
    prefill; the engine admits through the chunked paged path
    (kv_blocks.make_chunk_prefill), which must sample identically."""
    c = config

    def prefill(params, tokens, temp, top_p, generator):
        dev = params_device(params)
        tokens = torch.as_tensor(tokens, device=dev)
        shape = (c.n_layers, 1, tokens.shape[1], c.n_kv_heads, c.head_dim)
        cache = KVCache(
            k=torch.zeros(shape, dtype=c.activation_dtype, device=dev),
            v=torch.zeros(shape, dtype=c.activation_dtype, device=dev),
            length=0,
        )
        logits, cache = _forward_cached(c, params, tokens, cache)
        first = sample_logits_row(logits[0], temp, top_p, generator)
        return cache.k, cache.v, first

    return prefill


def make_insert():
    """insert(state, slots (N,), k_rows (L, N, S, KV, hd), v_rows,
    seq_lens (N,), tokens (N,), budgets (N,), temps (N,), top_ps (N,)) —
    write N prefilled requests of the same prompt length S into their
    slots, in place."""

    def insert(state: DecodeState, slots, k_rows, v_rows, seq_lens, tokens,
               budgets, temps, top_ps) -> DecodeState:
        dev = state.k.device
        slots = torch.as_tensor(slots, dtype=torch.int64, device=dev)
        s_len = k_rows.shape[2]
        state.k[:, slots, :s_len] = k_rows.to(state.k.dtype)
        state.v[:, slots, :s_len] = v_rows.to(state.v.dtype)

        def put(field, values, dtype):
            field[slots] = torch.as_tensor(values, dtype=dtype, device=dev)

        put(state.lengths, seq_lens, torch.int32)
        put(state.last_token, tokens, torch.int32)
        state.active[slots] = True
        put(state.remaining, budgets, torch.int32)
        put(state.temperature, temps, torch.float32)
        put(state.top_p, top_ps, torch.float32)
        return state

    return insert


def _select_next_token(state, logits, generator, *,
                       sampling: Optional[bool] = None,
                       nucleus: Optional[bool] = None):
    """Per-slot next-token selection: scale by each slot's temperature
    (guarded so greedy slots don't divide by 0 — their sampled value is
    unused), nucleus-filter by each slot's top_p, then select greedy vs
    sampled per slot. Shared by the dense and the paged decode bodies
    (same field names), so the two cannot drift.

    The reference gates the sampling and the vocab sort on whether any
    LIVE slot samples / filters. Here that gate is a host value: the
    engine passes what its live requests asked for; None reads it off the
    device state (one sync)."""
    temps = state.temperature
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if sampling is None:
        sampling = bool((state.active & (temps > 0.0)).any())
    if not sampling:
        return greedy
    scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
    if nucleus is None:
        nucleus = bool(
            (state.active & (state.top_p < 1.0) & (temps > 0.0)).any())
    if nucleus:
        scaled = _nucleus_filter(scaled, state.top_p[:, None])
    sampled = _categorical(scaled, generator)
    return torch.where(temps > 0, sampled, greedy)


def _decode_body(config: ModelConfig):
    """one_step(params, state, generator) -> tokens (B,) — the
    single-token dense decode body, state updated in place."""
    c = config

    def one_step(params, state: DecodeState, generator, sampling=None,
                 nucleus=None):
        B, ml = state.lengths.shape[0], state.k.shape[2]
        lengths = state.lengths
        positions = lengths[:, None]
        x = params["embed"][state.last_token[:, None]]
        rows = torch.arange(B, device=lengths.device)
        # Every in-bounds lane writes its row (as the reference); a full
        # slot's out-of-bounds lane keeps the old value instead (the
        # reference's scatter drops it).
        ok = lengths < ml
        at = torch.clamp(lengths, max=ml - 1).to(torch.int64)
        for layer in range(c.n_layers):
            p = layer_params(params, layer)
            q, k, v = project_qkv(c, x, p, positions)
            ck, cv = state.k[layer], state.v[layer]
            ck[rows, at] = torch.where(ok[:, None, None], k[:, 0].to(ck.dtype), ck[rows, at])
            cv[rows, at] = torch.where(ok[:, None, None], v[:, 0].to(cv.dtype), cv[rows, at])
            attn = decode_attention(q, ck, cv, lengths + 1)
            x = x + linear(attn, p["wo"])
            x = ffn_block(c, x, p)
        h = rms_norm(x, params["final_norm"], c.norm_eps)
        logits = logits_linear(h[:, -1], params["lm_head"])
        next_token = _select_next_token(state, logits, generator,
                                        sampling=sampling, nucleus=nucleus)
        act = state.active
        remaining = state.remaining - act.to(torch.int32)
        # A slot also retires when its cache is full (the NEXT write would
        # land at row lengths+1, which must stay < max_len).
        new_active = act & (remaining > 0) & (lengths + 2 <= ml)
        emitted = torch.where(act, next_token, torch.full_like(next_token, -1))
        state.last_token = torch.where(act, next_token, state.last_token)
        state.lengths = lengths + act.to(torch.int32)
        state.remaining = remaining
        state.active = new_active
        return emitted

    return one_step


def make_decode_step(config: ModelConfig, steps: int = 1):
    """decode_step(params, state, generator, sampling=None, nucleus=None)
    -> (state, tokens (B, steps), active): `steps` tokens for every active
    slot per call, state updated in place."""
    one_step = _decode_body(config)

    def decode_steps(params, state: DecodeState, generator, sampling=None,
                     nucleus=None):
        toks = [one_step(params, state, generator, sampling, nucleus)
                for _ in range(steps)]
        return state, torch.stack(toks, dim=1), state.active

    return decode_steps


# -- engine --------------------------------------------------------------------


class EngineOverloadedError(RuntimeError):
    """submit() rejected because the pending queue is at max_pending.
    `retry_after` is the engine's estimate (seconds) of when a slot is
    likely to free up — callers surface it as an HTTP Retry-After."""

    def __init__(self, pending: int, retry_after: float):
        super().__init__(
            f"serving engine overloaded: {pending} requests already queued"
        )
        self.pending = pending
        self.retry_after = retry_after


class _Request(NamedTuple):
    tokens: List[int]
    max_new_tokens: int
    # Yields int tokens; None = clean end; an Exception = engine failure
    # (consumers must re-raise, not treat partial output as complete).
    out: "queue.Queue[object]"
    temperature: float
    top_p: float
    t_submit: float
    request_id: Optional[int] = None
    trace: Optional[Any] = None
    # QoS identity: keys the engine's qos_weights, which decide who
    # preempts whom on a host-tier engine. None weighs 1.0.
    tenant: Optional[str] = None
    # Multi-tenant LoRA: the adapter this request selected (None = base
    # model) and its bank slot (-1 = none). The name also namespaces the
    # prefix cache, so tenants never share blocks.
    adapter: Optional[str] = None
    adapter_ix: int = -1
    # The caller's W3C trace context, carried on a KV handoff so the
    # decode tier continues the same trace.
    traceparent: Optional[str] = None


def _namespace(req: _Request) -> bytes:
    """The request's prefix-cache namespace: its adapter's name (the base
    model's is empty), so tenants never share cached KV."""
    return (req.adapter or "").encode()


class _SwappedSlot:
    """A preempted request parked in host memory: the KV of its whole
    block chain (target and drafter pools, host tensors) and the device
    sampling scalars at the boundary it left, everything readmission
    needs to resume it token-exact at temperature 0 with the budget it
    had left. `nbytes` stays reserved in the host tier until readmission
    or a terminal path unreserves it."""

    __slots__ = ("req", "length", "last_token", "remaining", "arrays",
                 "nbytes", "t0")

    def __init__(self, req: _Request, length: int, last_token: int,
                 remaining: int, arrays: Dict[str, torch.Tensor],
                 nbytes: int, t0: float):
        self.req = req
        self.length = length          # filled cache positions at swap
        self.last_token = last_token  # next token to feed
        self.remaining = remaining    # decode budget left
        self.arrays = arrays          # k/v (+draft_k/draft_v), (L, n, bs, KV, hd)
        self.nbytes = nbytes          # reserved against the host budget
        self.t0 = t0                  # original slot admission time


class _FirstToken:
    """A finalized prefill's first token: a 0-d device tensor copied to
    pinned host memory behind a CUDA event, so the reader thread waits for
    that prefill alone, not for work queued after it."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.is_cuda:
            self._host = torch.empty((), dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t

    def get(self) -> int:
        if self._event is not None:
            self._event.synchronize()
        return int(self._host)


class _HostPayload:
    """A prefill-role task's KV blocks gathered on the loop thread into
    page-locked host tensors behind a CUDA event: later chunks may rewrite
    the blocks at once (the device gather ran before them in stream
    order), and the sender thread waits on this event alone."""

    def __init__(self, arrays: Dict[str, torch.Tensor], keep: List[torch.Tensor]):
        self.arrays = arrays
        self._keep = keep  # device gathers, alive until their copies land
        self._event = None
        if keep:
            self._event = torch.cuda.Event()
            self._event.record()

    def get(self) -> Dict[str, torch.Tensor]:
        if self._event is not None:
            self._event.synchronize()
            self._event, self._keep = None, []
        return self.arrays


class _PrefillTask:
    """A request mid-chunked-prefill: owns a slot and a growing block
    table from admission until its final chunk dispatches (a prefill-role
    task keeps its blocks until its handoff resolves)."""

    __slots__ = ("req", "slot", "pos", "table", "first", "t_pop",
                 "delivered", "kv_payload")

    def __init__(self, req: _Request, slot: int, pos: int, table: List[int],
                 t_pop: float):
        self.req = req
        self.slot = slot
        self.pos = pos          # prompt tokens already in cache (prefix hits)
        self.table = table      # host copy of the slot's block table
        self.first: Optional[_FirstToken] = None
        self.t_pop = t_pop
        self.delivered = threading.Event()
        self.kv_payload: Optional[_HostPayload] = None


class ServingEngine:
    """Continuous-batching host loop around the chunk-prefill, decode and
    speculation programs. submit() returns a queue yielding generated
    token ids as they decode (None terminates); a decode-role engine's
    submit_prefilled() does the same for a handed-off request.

    `mesh` (sharding.make_mesh over ranks) serves tensor-parallel: this
    object is rank 0's leader, and every other rank runs `run_follower`
    with the same arguments. An object that is not a mesh of the port
    raises NotImplementedError; heads that do not divide the model axis
    raise ValueError, as the reference's."""

    def __init__(
        self,
        config: ModelConfig,
        params: Params,
        *,
        slots: int = 8,
        max_len: Optional[int] = None,
        temperature: float = 0.0,
        seed: int = 0,
        steps_per_sync: int = 4,
        max_pending: Optional[int] = None,
        max_prefills_per_chunk: int = 4,
        prefill_chunk_tokens: int = 128,
        kv_block_size: int = 16,
        kv_pool_blocks: Optional[int] = None,
        prefix_cache: bool = True,
        trace_ring: int = 256,
        trace_slow_ms: Optional[float] = None,
        device: DeviceLike = None,
        spec_enable: bool = False,
        spec_max_draft: int = 4,
        spec_draft_params: Optional[Params] = None,
        spec_draft_config: Optional[ModelConfig] = None,
        spec_min_accept: float = 0.3,
        kv_budget_bytes: Optional[int] = None,
        mesh: Optional[Any] = None,
        role: str = "unified",
        kv_transfer: Optional[Any] = None,
        lora_max_adapters: int = 0,
        lora_rank: int = 8,
        lora_targets: Optional[Tuple[str, ...]] = None,
        kv_host_budget_bytes: Optional[int] = None,
        max_resident_slots: Optional[int] = None,
        qos_weights: Optional[Dict[str, float]] = None,
    ):
        if role not in ("unified", "prefill", "decode"):
            raise ValueError(
                f"role must be unified/prefill/decode, got {role!r}"
            )
        if lora_max_adapters > 0 and role != "unified":
            raise ValueError(
                "adapter multiplexing requires role='unified' (KV"
                " handoffs do not carry adapter identity yet)"
            )
        # -- tensor-parallel serving (mesh over ranks) ----------------------
        # `_tp` is the mesh whose ranks the op layer drives (a world of 1
        # too); None on one device. Only rank 0 leads: it runs the host
        # loop and the reader threads, the others follow ops.
        model_shards(mesh)  # NotImplementedError for an object that is not a mesh
        if mesh is not None and any(n > 1 for a, n in mesh.shape.items() if a != "model"):
            raise NotImplementedError(
                f"serving over mesh {mesh.shape}: the engine serves over a model"
                " axis only (tensor parallelism); a seq axis is the ring's, for"
                " training")
        if mesh is not None and mesh.ranked and mesh.layout != "serving":
            raise ValueError(
                f"mesh cut for the {mesh.layout!r} layout: the engine serves on the"
                " column-parallel layout (make_mesh(model=n))")
        self.mesh = mesh
        self._tp = mesh if mesh is not None and mesh.ranked else None
        self._leader = self._tp is None or mesh.rank == 0
        if mesh is not None:
            check_heads(mesh, config, "target")
            if spec_enable:
                check_heads(mesh, spec_draft_config or config, "drafter")
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh rank's {mesh.device}")
            device = mesh.device
        if role == "prefill" and kv_transfer is None and self._leader:
            raise ValueError(
                "role='prefill' requires a kv_transfer client to ship"
                " finished prefills to (see workloads/kv_transfer.py)"
            )
        self._op_lock = threading.Lock()
        self._op_broken = False
        self._last_op = time.monotonic()
        # Host-tier payloads by rank: rank 0 keeps its shard in the tier,
        # with its payload id beside the arrays (PAYLOAD_ID); a follower
        # keeps its shard of each live payload here. A payload rank 0
        # drops is dropped on the followers with the next op.
        self._next_payload = 0
        self._dead_payloads: List[int] = []
        self._rank_payloads: Dict[int, Dict[str, torch.Tensor]] = {}
        self.device = resolve_device(device)
        # The kernel cache (workloads/compile_cache.py) honours
        # DSTACK_TPU_COMPILE_CACHE before warmup or a first request builds
        # the kernel library, so a repeat boot on the same volume loads it
        # instead of running nvcc. Only the card builds anything.
        self._compile_cache_dir = (compile_cache.enable_from_env()
                                   if self.device.type == "cuda" else None)
        if params_device(params) != self.device:
            raise ValueError(
                f"params live on {params_device(params)}, engine device is"
                f" {self.device}"
            )
        self.config = config
        # The engine's own copy, cut from autograd: params straight from a
        # train state carry requires_grad, and the port's optimizer updates
        # them in place, so a view would let a learner step rewrite the
        # weights under a live request. refresh_params copies into these
        # tensors; their addresses never change. A mesh rank copies only
        # its slices of the whole params it was given.
        self.params = copy_params(params if mesh is None else rank_params(mesh, params))
        self.slots = slots
        self.max_len = max_len or config.max_seq_len
        self.role = role
        self.recorder = FlightRecorder(
            capacity=trace_ring, slow_ms=trace_slow_ms, role=self.role
        )
        if max_prefills_per_chunk < 1:
            raise ValueError(
                f"max_prefills_per_chunk must be >= 1, got {max_prefills_per_chunk}"
            )
        if prefill_chunk_tokens < 1:
            raise ValueError(
                f"prefill_chunk_tokens must be >= 1, got {prefill_chunk_tokens}"
            )
        if kv_block_size < 1:
            raise ValueError(f"kv_block_size must be >= 1, got {kv_block_size}")
        if self.max_len % kv_block_size != 0:
            raise ValueError(
                f"kv_block_size {kv_block_size} must divide"
                f" max_len {self.max_len}"
            )
        self._block_size = kv_block_size
        self._max_blocks = self.max_len // kv_block_size
        # Default pool = dense-equivalent: every slot can grow to max_len
        # with zero sharing, so allocation cannot fail at the defaults.
        self._num_blocks = (
            kv_pool_blocks if kv_pool_blocks is not None
            else slots * self._max_blocks
        )
        if self._num_blocks < self._max_blocks:
            raise ValueError(
                f"kv_pool_blocks {self._num_blocks} must fit one max_len"
                f" request ({self._max_blocks} blocks)"
            )
        # -- host tier and slot preemption ---------------------------------
        # With a host budget, evicted prefix blocks spill to host memory
        # instead of dying, and whole slots can swap out under pressure or
        # QoS preemption. Off, the engine is the tier-less engine.
        self._host_tier: Optional[HostKVTier] = None
        if kv_host_budget_bytes:
            self._host_tier = HostKVTier(kv_host_budget_bytes)
        if max_resident_slots is None:
            self._max_resident = slots
        else:
            if not (1 <= max_resident_slots <= slots):
                raise ValueError(
                    f"max_resident_slots {max_resident_slots} must be in"
                    f" [1, slots={slots}]"
                )
            if max_resident_slots < slots and self._host_tier is None:
                raise ValueError(
                    "max_resident_slots < slots requires a host tier to"
                    " park swapped slots in (set kv_host_budget_bytes)"
                )
            self._max_resident = max_resident_slots
        self._qos_weights: Dict[str, float] = dict(qos_weights or {})
        # Preempted requests parked in the host tier, readmitted
        # heaviest-tenant first; guarded by _lock.
        self._swapped: List[_SwappedSlot] = []
        # Out-queues whose live slot preempt() asked to swap out at the
        # next boundary; guarded by _lock.
        self._preempt_requests: set = set()
        self._preemptions = 0
        self._slot_swap_ins = 0
        self._swap_in_hist = HistogramData()
        tiered = self._host_tier is not None
        self._alloc = BlockAllocator(
            self._num_blocks, kv_block_size, cache=prefix_cache,
            spill=self._spill_block if tiered else None,
            swap_in=self._swap_in_block if tiered else None,
        )
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self._chunk_cache: Dict[Any, Any] = {}
        self.state = init_paged_state(
            self._rank_config(config), slots, self.max_len, kv_block_size,
            self._num_blocks, self.device,
        )
        self._step = make_paged_decode_step(config, steps=steps_per_sync, mesh=mesh)
        # -- multi-tenant LoRA (lora_max_adapters > 0) ----------------------
        # A refcounted host registry over a device adapter bank. The LoRA
        # twins of the programs run while any request holds an adapter ref
        # (registry.inflight > 0); the plain programs otherwise.
        self._lora: Optional[AdapterRegistry] = None
        self._step_lora = None
        if lora_max_adapters > 0:
            # The bank is made from this rank's base columns, so its B
            # leaves hold the rank's output columns (SERVING_LORA_SPECS);
            # every bank write goes through the op layer.
            self._lora = AdapterRegistry(
                config, self.params, max_adapters=lora_max_adapters,
                rank=lora_rank, targets=lora_targets or ("wq", "wv"),
                writer=self._write_adapter,
            )
            self._step_lora = make_paged_decode_step(config, steps=steps_per_sync,
                                                     lora=True, mesh=mesh)
        # out-queue -> adapter name of every in-flight adapter request;
        # _release_adapter pops it once, on whichever terminal path.
        self._adapter_holds: Dict[Any, str] = {}
        # The stream the loop dispatches on: bank writes from other
        # threads go on it, behind every step already queued (None, a
        # no-op stream context, on the CPU).
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        self._copy_block = make_copy_block()
        # Which ragged-attention implementation this engine runs (decided
        # by its device) and how many chunk/decode/spec dispatches ran it.
        # Under a model mesh it is still the kernel, on each rank's heads
        # (the JAX engine answers lax_ragged there; see the docstring).
        self._attn_path = attn_dispatch_path(self.device, config.head_dim)
        self._attn_dispatch = {p: 0 for p in ATTN_PATHS}
        # -- speculative decoding ------------------------------------------
        self._spec = bool(spec_enable)
        if spec_max_draft < 1:
            raise ValueError(f"spec_max_draft must be >= 1, got {spec_max_draft}")
        self._spec_max_draft = spec_max_draft
        self._spec_min_accept = spec_min_accept

        def _pool_bytes(cfg: ModelConfig) -> int:
            row = 2 * cfg.n_kv_heads * cfg.head_dim  # k + v
            return (cfg.n_layers * self._num_blocks * kv_block_size * row
                    * cfg.dtype_bytes)

        self._draft_config = spec_draft_config or config
        if self._spec:
            if self._draft_config.vocab_size != config.vocab_size:
                raise ValueError(
                    "drafter vocab_size"
                    f" {self._draft_config.vocab_size} must match the"
                    f" target's {config.vocab_size} (one tokenizer)"
                )
            target_cover = min(self.max_len, config.max_seq_len)
            if self._draft_config.max_seq_len < target_cover:
                raise ValueError(
                    f"drafter max_seq_len {self._draft_config.max_seq_len}"
                    f" must cover the engine window {target_cover}"
                    f" (min of engine max_len {self.max_len} and target"
                    f" max_seq_len {config.max_seq_len})"
                )
        if kv_budget_bytes is not None:
            need_bytes = _pool_bytes(config)
            if self._spec:
                need_bytes += _pool_bytes(self._draft_config)
            if need_bytes > kv_budget_bytes:
                what = ("a drafter KV pool alongside the target pool"
                        if self._spec else "the KV pool")
                raise ValueError(
                    f"cannot fit {what}: {need_bytes} bytes needed but"
                    f" kv_budget_bytes is {kv_budget_bytes}"
                    + (" (disable speculation or shrink the pool)"
                       if self._spec else "")
                )
        if self._spec:
            # Default drafter: weight-only int8 of the target (QTensor
            # leaves dispatch in transformer.linear), so every program runs
            # unchanged on it.
            # On a mesh rank the int8 drafter quantizes the rank's columns,
            # which gives the columns of the whole model's quantization
            # (the scales are per output column).
            self._draft_params = detach_params(
                quantize_params(self.params) if spec_draft_params is None
                else spec_draft_params if mesh is None
                else rank_params(mesh, spec_draft_params))
            if params_device(self._draft_params) != self.device:
                raise ValueError(
                    f"drafter params live on {params_device(self._draft_params)},"
                    f" engine device is {self.device}"
                )
            # The drafter's pool has the target pool's geometry and is
            # indexed through the same block tables: one allocator drives
            # both. Its own table and scalar fields are unused.
            self._draft_state = init_paged_state(
                self._rank_config(self._draft_config), slots, self.max_len,
                kv_block_size, self._num_blocks, self.device,
            )
            self._draft_chunk_cache: Dict[int, Any] = {}
            self._spec_draft_fns: Dict[int, Any] = {}
            self._spec_verify_fns: Dict[Any, Any] = {}
        # Per-slot adaptive draft length: starts mid, grows toward
        # spec_max_draft while the slot's acceptance EWMA stays high,
        # shrinks toward 1 when it drops. None EWMA = unseeded.
        self._spec_init_k = min(2, spec_max_draft)
        self._slot_k: List[int] = [self._spec_init_k] * slots
        self._accept_ewma: List[Optional[float]] = [None] * slots
        self._spec_accept_ewma = 0.0
        self._spec_tokens_round_ewma = 0.0
        self._spec_rounds = 0
        self._spec_fallback_rounds = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_rejected = 0
        self._t_spec_draft = 0.0
        self._t_spec_verify = 0.0
        # Whole-batch fallback: after 3 consecutive rounds whose batch-mean
        # acceptance is below spec_min_accept, plain decode chunks for 50
        # boundaries, then a re-probe at k=1.
        self._spec_low_streak = 0
        self._spec_cooldown = 0
        self._temperature = temperature
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        # The drafter's own stream: at temperature 0 neither is drawn
        # from, and the target's stream stays the plain engine's.
        self._gen_draft = torch.Generator(device=self.device).manual_seed(seed + 0x5bec)
        self.max_pending = max_pending
        self.rejected = 0
        self._steps_per_sync = steps_per_sync
        self.max_prefills_per_chunk = max_prefills_per_chunk
        self._chunk_s = 0.05  # EWMA wall time per decode chunk (seeded)
        self._turn_s = 1.0    # EWMA slot occupancy admit->retire (seeded)
        self._ttft_s = 0.0
        self._queue_wait_s = 0.0
        self._prefill_s = 0.0
        self._n_admitted = 0
        self._sum_ttft = 0.0
        self._sum_queue_wait = 0.0
        self._sum_prefill = 0.0
        self._ttft_hist = HistogramData()
        # TTFT samples land under role="cold_start" until warmup() ran or
        # a first token was delivered (the sample that paid kernel build).
        self._ttft_cold_hist = HistogramData()
        self._cold_over = False
        self._first_token_emitted = False
        self._warmup_done = False
        self._warmup_seconds: Optional[float] = None
        self._warmup_programs = 0
        self._warmup_hist = HistogramData()
        self._t_decode = 0.0
        self._t_prefill = 0.0
        self._t_idle = 0.0
        self._prefill_chunks = 0
        self._prefill_tokens_computed = 0
        self._tpt_hist = HistogramData()
        self._last_chunk_s = 0.0
        self._slot_t0: List[float] = [0.0] * slots
        self._pending: "queue.Queue[_Request]" = queue.Queue()
        self._next_req: Optional[_Request] = None
        self._live: List[Optional[_Request]] = [None] * slots
        # Host mirrors of per-slot cache length and block table (loop
        # thread only).
        self._lengths_host: List[int] = [0] * slots
        self._slot_tables: List[Optional[List[int]]] = [None] * slots
        # Requests popped for prefill but not yet live; guarded by _lock.
        self._admitting: List[_Request] = []
        self._tasks: List[_PrefillTask] = []
        self._pending_activation: List[_PrefillTask] = []
        self._deliver_q: "queue.Queue[Optional[_PrefillTask]]" = queue.Queue()
        self._cancelled: set = set()
        self._inflight: set = set()
        self._wake = threading.Event()
        self._hold_admission = False
        self._stop = False
        self._failed: Optional[BaseException] = None
        self._lock = threading.Lock()
        # -- prefill/decode disaggregation (role != "unified") -------------
        # A prefill engine's finalized tasks divert to _handoff_q, where a
        # sender thread ships them through `kv_transfer` (a
        # kv_transfer.TransferClient or anything with .send(KVHandoff)). A
        # decode engine queues handoffs from submit_prefilled() under
        # _prefilled_pending; the loop thread admits them into fresh blocks
        # of its own pool. Epoch fencing: a payload whose stamp is not the
        # decode side's handoff_epoch is rejected (bump_handoff_epoch).
        self._kv_transfer = kv_transfer
        self.handoff_epoch = 1
        self._handoff_seq = 0
        self._handoff_q: "queue.Queue[Optional[_PrefillTask]]" = queue.Queue()
        # (handoff, out queue, receipt time, trace) awaiting a slot and
        # blocks on the decode side; guarded by _lock.
        self._prefilled_pending: List[Tuple[KVHandoff, Any, float, Any]] = []
        self._handoffs_sent = 0
        self._handoffs_received = 0
        self._handoff_stale_rejected = 0
        self._kv_transfer_bytes = 0
        self._kv_transfer_hist = HistogramData()
        self._handoff_thread: Optional[threading.Thread] = None
        if not self._leader:
            return  # a follower runs ops (_follow), no loop or reader threads
        self._deliver_thread = threading.Thread(
            target=self._deliver_loop, daemon=True
        )
        self._deliver_thread.start()
        if role == "prefill":
            self._handoff_thread = threading.Thread(
                target=self._handoff_loop, daemon=True
            )
            self._handoff_thread.start()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- the op layer (tensor-parallel serving) --------------------------------

    def _rank_config(self, config: ModelConfig) -> ModelConfig:
        """The geometry of this rank's KV pools: its KV/n heads."""
        n = model_shards(self.mesh)
        return config if n == 1 else config.with_(n_kv_heads=config.n_kv_heads // n)

    def _op(self, name: str, *args, **local):
        """Run device op `name` (method `_op_<name>`) with host inputs
        `args`. On a mesh, rank 0 first broadcasts the op, its inputs and
        the host-tier payloads that died since the last op, under one lock
        so that every rank sees the ops of all threads in one order; the
        keyword `local` inputs stay on rank 0. On one device it is the
        call itself."""
        fn = getattr(self, "_op_" + name)
        if self._tp is None:
            return fn(*args, **local)
        with self._op_lock:
            if self._op_broken:
                raise RuntimeError("the engine's mesh is closed or failed mid-op")
            dead = []
            while self._dead_payloads:  # pops race no finalizer's append
                dead.append(self._dead_payloads.pop())
            try:
                broadcast_object((name, args, dead), self._tp)
                self._last_op = time.monotonic()
                return fn(*args, **local)
            except BaseException:
                # The ranks may be out of step: no op follows.
                self._op_broken = True
                raise

    def _follow(self) -> None:
        """A follower rank's loop: run rank 0's ops in its order until the
        shutdown op. A leader that disappears fails the next collective,
        which raises here."""
        while True:
            name, args, dead = broadcast_object(None, self._tp)
            for pid in dead:
                self._rank_payloads.pop(pid, None)
            if name == "shutdown":
                return
            getattr(self, "_op_" + name)(*args)

    def _op_noop(self) -> None:
        pass

    def _op_shutdown(self) -> None:
        self._op_broken = True  # rank 0: no op follows the shutdown

    def _op_decode(self, lora: bool, sampling: bool, nucleus: bool, has_lora: bool):
        if lora:
            _, tokens, active = self._step_lora(
                self.params, self.state, self._gen, self._lora.bank,
                sampling=sampling, nucleus=nucleus, has_lora=has_lora)
        else:
            _, tokens, active = self._step(self.params, self.state, self._gen,
                                           sampling=sampling, nucleus=nucleus)
        return tokens, active

    def _op_chunk(self, n_padded: int, slot: int, row: List[int], tokens: List[int],
                  n: int, pos: int, budget: int, temp: float, top_p: float,
                  final: bool, adapter_ix: int):
        args = (self.params, self.state, slot, row, tokens, n, pos, budget, temp,
                top_p, self._gen, final)
        if adapter_ix >= 0:
            _, first, _ = self._chunk_fn(n_padded, lora=True)(*args, adapter_ix,
                                                              self._lora.bank)
        else:
            _, first, _ = self._chunk_fn(n_padded)(*args)
        return first

    def _op_draft_chunk(self, n_padded: int, slot: int, row: List[int],
                        tokens: List[int], n: int, pos: int, budget: int,
                        temp: float, top_p: float) -> None:
        # The drafter never samples here: its first token is unused.
        self._draft_chunk_fn(n_padded)(self._draft_params, self._draft_state, slot, row,
                                       tokens, n, pos, budget, temp, top_p,
                                       self._gen_draft, False)

    def _op_spec_draft(self, k: int, sampling: bool, nucleus: bool):
        st = self.state
        self._drafts = self._spec_draft_fn(k)(
            self._draft_params, self._draft_state, st.block_tables, st.lengths,
            st.last_token, st.active, st.temperature, st.top_p, self._gen_draft,
            sampling=sampling, nucleus=nucleus)
        return self._drafts

    def _op_spec_verify(self, k: int, lora: bool, sampling: bool, nucleus: bool,
                        has_lora: bool):
        drafts, qlogits = self._drafts
        if lora:
            _, emitted, accepted, active = self._spec_verify_fn(k, lora=True)(
                self.params, self.state, drafts, qlogits, self._gen, self._lora.bank,
                sampling=sampling, nucleus=nucleus, has_lora=has_lora)
        else:
            _, emitted, accepted, active = self._spec_verify_fn(k)(
                self.params, self.state, drafts, qlogits, self._gen,
                sampling=sampling, nucleus=nucleus)
        return emitted, accepted, active

    def _op_copy_block(self, src: int, dst: int) -> None:
        """Copy-on-write's device half, in every pool the allocator
        indexes (the drafter's moves with the target's)."""
        self._copy_block(self.state, src, dst)
        if self._spec:
            self._copy_block(self._draft_state, src, dst)

    def _op_set_table(self, slot: int, row: List[int]) -> None:
        self.state.block_tables[slot] = host_to_device(row, torch.int32, self.device)

    def _op_place_slot(self, slot: int, row: List[int], length: int, last_token: int,
                       remaining: int, temperature: float, top_p: float,
                       adapter_ix: int) -> None:
        st = self.state
        st.block_tables[slot] = host_to_device(row, torch.int32, self.device)
        st.lengths[slot] = length
        st.last_token[slot] = last_token
        st.active[slot] = remaining > 0
        st.remaining[slot] = remaining
        st.temperature[slot] = temperature
        st.top_p[slot] = top_p
        st.adapter_ix[slot] = adapter_ix

    def _op_retire(self, slot: int) -> None:
        # adapter_ix too: the plain chunk program of a request that reuses
        # the slot resets it only at its finalize.
        self.state.active[slot] = False
        self.state.remaining[slot] = 0
        self.state.adapter_ix[slot] = -1

    def _op_gather_chain(self, table: List[int], pid: Optional[int]):
        """Device -> host copy of a block chain out of every pool, this
        rank's heads, page-locked on CUDA; returns after the copies land.
        A follower keeps its shard under payload id `pid`."""
        ids = torch.tensor(table, dtype=torch.int64, device=self.device)
        out = {}
        for name, pool in self._pools():
            rows = pool[:, ids]
            if self.device.type == "cuda":
                host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
                host.copy_(rows, non_blocking=True)
                rows = host
            out[name] = rows
        self._sync()
        if not self._leader:
            self._rank_payloads[pid] = out
        return out

    def _op_gather_payload(self, table: List[int]):
        """The prefill tier's handoff gather: every pool's rows of the chain
        with all KV heads (gathered across ranks on the head dim), copied
        into page-locked host tensors behind a CUDA event on rank 0."""
        ids = torch.tensor(table, dtype=torch.int64, device=self.device)
        arrays, keep = {}, []
        for name, pool in self._pools():
            rows = all_gather(pool[:, ids], 3, self.mesh)
            if not self._leader:
                continue
            if self.device.type == "cuda":
                host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
                host.copy_(rows, non_blocking=True)
                keep.append(rows)
                rows = host
            arrays[name] = rows
        return _HostPayload(arrays, keep) if self._leader else None

    def _op_inject(self, table: List[int], arrays: Dict[str, torch.Tensor],
                   heads: bool) -> None:
        """Host -> device: scatter a gathered chain into the blocks of
        `table` in every pool `arrays` has; with `heads` the arrays carry
        every KV head and each rank takes its own (SERVING_KV_POOL_SPEC)."""
        ids = torch.tensor(table, dtype=torch.int64, device=self.device)
        for name, pool in self._pools():
            if name in arrays:
                a = shard(arrays[name], SERVING_KV_POOL_SPEC, self.mesh) if heads \
                    else arrays[name]
                pool[:, ids] = a.to(self.device, pool.dtype, non_blocking=True)

    def _op_inject_stored(self, table: List[int], pid: Optional[int],
                          arrays: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """The host tier's swap-in: rank 0 scatters `arrays`, a follower
        its own shard of payload `pid`."""
        self._op_inject(table, arrays if arrays is not None else self._rank_payloads[pid],
                        False)

    def _op_refresh(self, params: Params) -> None:
        src = params if self.mesh is None else rank_params(self.mesh, params)
        with torch.no_grad():
            for (_, dst), (_, s) in zip(flatten_params(self.params), flatten_params(src)):
                dst.copy_(s)

    def _op_adapter(self, ix: int, layers: Optional[Params], scale: float) -> None:
        """Write bank slot `ix` (layers None zeroes it): A whole, B this
        rank's columns."""
        if layers is not None and self.mesh is not None:
            layers = rank_params(self.mesh, {"layers": layers})["layers"]
        self._lora._write_bank(ix, layers, scale)

    def _write_adapter(self, ix: int, layers: Optional[Params], scale: float) -> None:
        """The registry's bank writer, through the op layer (whole adapter
        host tensors on a mesh; each rank cuts its columns)."""
        if layers is not None and self._tp is not None:
            layers = to_host(layers)
        self._op("adapter", ix, layers, scale)

    # -- public surface -----------------------------------------------------

    def _observe_ttft(self, dt: float) -> None:
        if self._cold_over:
            self._ttft_hist.observe(dt)
        else:
            self._ttft_cold_hist.observe(dt)
            self._cold_over = True

    def _busy(self) -> bool:
        """Whether anything is in flight or queued (caller holds _lock):
        a live slot, a prefill task, an admission, a parked or swapped
        slot, a handoff awaiting admission, or a pending submit."""
        return bool(any(r is not None for r in self._live) or self._tasks
                    or self._admitting or self._pending_activation
                    or self._swapped or self._next_req is not None
                    or self._prefilled_pending or not self._pending.empty())

    def idle(self) -> bool:
        """Whether nothing is in flight or queued (a draining server waits
        for this before it closes the engine)."""
        with self._lock:
            return not self._busy()

    def hold_admission(self) -> None:
        """Gate new-request admission (in-flight work continues).

        A gang-synchronous caller (the RL actor, workloads/rl.py) wraps
        each rollout round's submits in hold/release so the whole round
        enters prefill as ONE admission wave. Without the gate the loop
        thread races the submitting thread: a round may split across
        admission waves, which changes how many prefill/decode chunks —
        and therefore how many sampler draws — the round consumes, the
        difference between a bit-reproducible seeded rollout and not.
        submit() keeps enqueueing normally while held. Over a model mesh it
        raises: RL across ranks belongs to the training slice."""
        if model_shards(self.mesh) > 1:
            raise NotImplementedError(
                "hold_admission over a model mesh: RL across ranks belongs to"
                " the next sharding slice (ROADMAP Queue 1 item 3)")
        self._hold_admission = True

    def release_admission(self) -> None:
        self._hold_admission = False
        self._wake.set()

    def refresh_params(self, params: Params) -> int:
        """Adopt fresh parameter values (RL weight refresh), copied into
        the engine's own tensors under no_grad: their addresses stay
        fixed, and the caller's tensors are never aliased.

        Legal only at an idle boundary: a live slot's KV (and any
        finalized prefill's first token) was computed under the old
        weights, so decoding its continuation under new ones yields a
        sequence that belongs to NEITHER policy — the RL actor's
        post-hoc behavior-logprob scorer would silently mis-score it.
        Raises RuntimeError while anything is in flight; callers drain
        first (the RL actor refreshes between rollout rounds, where the
        engine is idle by construction).

        The prefix cache is dropped on both tiers — device entries and
        host-RAM spills — because cached KV embeds the old weights and
        a post-swap prefix hit would graft stale keys/values under the
        new policy. LoRA engines refuse: the AdapterRegistry holds
        base-param references fixed at load time. A speculating engine's
        default int8 drafter stays on the weights it was quantized from
        at init, as the reference's does. Returns the number of cache
        entries dropped."""
        if self._lora is not None:
            raise RuntimeError(
                "refresh_params on a LoRA engine would orphan the"
                " adapter registry's base-param bindings; rebuild the"
                " engine instead"
            )
        new = flatten_params(params if self.mesh is None
                             else rank_params(self.mesh, params))
        old = flatten_params(self.params)
        if [k for k, _ in new] != [k for k, _ in old] or any(
                a.shape != b.shape or a.dtype != b.dtype
                for (_, a), (_, b) in zip(new, old)):
            raise ValueError(
                "refreshed params do not match the engine's parameter"
                " tree (structure / leaf shapes / dtypes must be equal)"
            )
        with self._lock:
            if self._busy():
                raise RuntimeError(
                    "refresh_params requires an idle engine: drain"
                    " in-flight requests first (a mid-request swap"
                    " would decode a continuation no single policy"
                    " generated)"
                )
            # On a mesh every rank cuts its slices of the whole params.
            self._op("refresh", params if self._tp is None else to_host(params))
            dropped = self._alloc.drop_cache()
            if self._host_tier is not None:
                dropped += self._host_tier.clear()
        return dropped

    def warmup(self) -> Dict[str, Any]:
        """Build the kernel and run every program the scheduler can
        dispatch once — the decode step, every chunk bucket, and with
        speculation the drafter's chunk buckets, the draft and verify for
        every k in 1..spec_max_draft and the drafter's block copy, and the
        role's side of the KV-transfer seam (a prefill engine's gather into
        page-locked host tensors, a decode engine's scatter, at each pow-2
        block count up to max_blocks, on the discard block) — so the first
        request meets no build, kernel plan or allocation that warmup did
        not make. Each run is a no-op on an idle engine: an
        all-inactive decode step or round and n_valid=0 chunks write only
        to the discard block and touch no slot field. Only legal on an
        idle engine (RuntimeError otherwise).

        Emits the compile_start / compile_end / warmup_end stage markers
        and returns {"seconds", "programs", "compiles", "cache_hits",
        "cache_misses", "compile_seconds"}, the last four the kernel
        cache's counters moved by this warmup (workloads/compile_cache.py:
        a build, or a library found on disk, or neither when an earlier
        call in the process loaded it)."""
        with self._lock:
            if self._failed is not None:
                raise RuntimeError("engine already failed") from self._failed
            if self._busy():
                raise RuntimeError(
                    "warmup requires an idle engine: call it before serving"
                    " traffic (readiness gating) or after a drain"
                )
            self._hold_admission = True
        t0 = time.monotonic()
        before = compile_cache.snapshot()
        auto_stage("compile_start")
        programs = 0
        lora = self._lora is not None
        try:
            self._op("decode", False, False, False, False)
            programs += 1
            if lora:
                # The LoRA twins with the delta on (the bank's zero slot:
                # an all-inactive batch writes only the discard block).
                self._op("decode", True, False, False, True)
                programs += 1
            row = self._pad_table([])
            buckets = sorted({self._pad_chunk(n)
                              for n in range(1, self.prefill_chunk_tokens + 1)})
            for b in buckets:
                self._op("chunk", b, 0, row, [0] * b, 0, 0, 0, 1.0, 1.0, False, -1)
                programs += 1
                if lora:
                    self._op("chunk", b, 0, row, [0] * b, 0, 0, 0, 1.0, 1.0, False,
                             self._lora.max_adapters)
                    programs += 1
                if self._spec:
                    self._op("draft_chunk", b, 0, row, [0] * b, 0, 0, 0, 1.0, 1.0)
                    programs += 1
            self._op("set_table", 0, row)
            if self._spec:
                # The speculation ladder: every draft length adaptation
                # can reach, on the all-inactive batch.
                for k in range(1, self._spec_max_draft + 1):
                    self._op("spec_draft", k, False, False)
                    self._op("spec_verify", k, False, False, False, False)
                    programs += 2
                    if lora:
                        self._op("spec_verify", k, True, False, False, True)
                        programs += 1
                programs += 1  # the drafter's block copy, with the target's
            self._op("copy_block", 0, 0)
            programs += 1
            if self.role != "unified":
                n = model_shards(self.mesh)
                n_pad = 1
                while True:
                    ids = [self._num_blocks] * n_pad
                    if self.role == "prefill":
                        self._gather_payload(ids).get()
                    else:
                        # A handoff's payload carries every KV head.
                        self._inject_handoff(
                            {name: torch.zeros((pool.shape[0], n_pad) + pool.shape[2:3]
                                               + (pool.shape[3] * n,) + pool.shape[4:],
                                               dtype=pool.dtype)
                             for name, pool in self._pools()}, ids)
                    programs += 1
                    if n_pad >= self._max_blocks:
                        break
                    n_pad *= 2
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            auto_stage("compile_end")
        finally:
            with self._lock:
                self._hold_admission = False
            self._wake.set()
        dt = time.monotonic() - t0
        after = compile_cache.snapshot()
        self._warmup_seconds = dt
        self._warmup_programs = programs
        self._warmup_hist.observe(dt)
        self._warmup_done = True
        self._cold_over = True
        auto_stage("warmup_end")
        return {
            "seconds": dt,
            "programs": programs,
            **{k: after[k] - before[k] for k in ("compiles", "cache_hits", "cache_misses")},
            "compile_seconds": round(after["compile_seconds"] - before["compile_seconds"], 4),
        }

    def submit(self, tokens: List[int], max_new_tokens: int,
               temperature: Optional[float] = None, top_p: float = 1.0,
               request_id: Optional[int] = None,
               traceparent: Optional[str] = None,
               x_request_id: Optional[str] = None,
               tenant: Optional[str] = None,
               adapter: Optional[str] = None,
               t_arrival: Optional[float] = None) -> "queue.Queue[object]":
        """Enqueue a request; returns its output queue (ints, then None;
        an Exception on engine failure). `temperature` (0 = greedy) and
        `top_p` override the engine defaults for this request.
        `traceparent` and `x_request_id` thread the caller's trace
        identity into the flight recorder (and onto a KV handoff);
        `t_arrival` backdates the timeline to HTTP arrival, so the
        server's QoS admission shows as its own `qos_admission` phase.
        `tenant`
        keys qos_weights: on a host-tier engine a heavier tenant's request
        may preempt a lighter one's live slot instead of queueing.
        `adapter` selects a loaded LoRA adapter by name: ValueError on an
        engine without LoRA, KeyError for an unknown adapter, both before
        anything is queued; the request holds a registry ref until it
        ends (retire, cancel, close, an engine error), across a swap."""
        if not tokens:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if temperature is None:
            temperature = self._temperature
        if not (temperature >= 0) or math.isinf(temperature):
            raise ValueError(
                f"temperature must be a finite number >= 0, got {temperature}"
            )
        if not (0 < top_p <= 1):  # also rejects NaN
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        # The last decode write lands at cache row len + max_new - 2.
        if len(tokens) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {len(tokens)} + max_new_tokens {max_new_tokens}"
                f" must not exceed max_len {self.max_len}"
            )
        need = (len(tokens) + max_new_tokens - 2) // self._block_size + 1
        if need > self._num_blocks:
            raise ValueError(
                f"request needs up to {need} KV blocks but the pool has"
                f" {self._num_blocks} (raise kv_pool_blocks)"
            )
        out: "queue.Queue[object]" = queue.Queue()
        rec = None
        if self.recorder.enabled:
            t_sub = time.monotonic()
            rec = self.recorder.begin(
                request_id, x_request_id=x_request_id, traceparent=traceparent,
                first_phase="queue_wait" if t_arrival is None else "qos_admission",
                t0=t_sub if t_arrival is None else t_arrival)
            if t_arrival is not None:
                rec.mark("queue_wait", t_sub)
        with self._lock:
            if self._failed is not None:
                raise RuntimeError(f"serving engine failed: {self._failed}")
            if self._stop:
                raise RuntimeError("serving engine is closed")
            depth = self._pending.qsize() + (self._next_req is not None)
            # Shed on the WAITING backlog: a request that will land in a
            # free slot is not overload.
            free = sum(r is None for r in self._live) - len(self._admitting)
            if self.max_pending is not None and depth - free >= self.max_pending:
                self.rejected += 1
                self.recorder.finish(rec, "shed")
                raise EngineOverloadedError(depth, self._retry_after(depth))
            adapter_ix = -1
            if adapter is not None:
                if self._lora is None:
                    raise ValueError(
                        "engine has no adapter support"
                        " (construct with lora_max_adapters > 0)"
                    )
                # KeyError for an unknown adapter, before anything queues;
                # the ref pins the bank slot until the request ends.
                adapter_ix = self._lora.acquire(adapter)
                self._adapter_holds[out] = adapter
            self._pending.put(_Request(
                list(tokens), max_new_tokens, out, float(temperature),
                float(top_p), time.monotonic(), request_id, rec, tenant,
                adapter, adapter_ix, traceparent,
            ))
            self._inflight.add(out)
        self._wake.set()
        return out

    def _retry_after(self, depth: int) -> float:
        turns_ahead = (depth + 1) / max(1, self.slots)
        return max(1.0, round(turns_ahead * self._turn_s, 1))

    def cancel(self, out: "queue.Queue[object]") -> None:
        """Abandon the request whose submit() returned `out`: a queued one
        is purged and answered at once, a live one is freed at the next
        chunk boundary. Safe from any thread; idempotent."""
        with self._lock:
            if out not in self._inflight:
                return
            drained, found = [], None
            while True:
                try:
                    r = self._pending.get_nowait()
                except queue.Empty:
                    break
                if r.out is out:
                    found = r
                else:
                    drained.append(r)
            for r in drained:
                self._pending.put(r)
            if found is None and self._next_req is not None \
                    and self._next_req.out is out:
                found, self._next_req = self._next_req, None
            if found is None:
                # Swapped out: purge the parked payload and unpin its host
                # bytes here, so the tier keeps no residue.
                for i, sw in enumerate(self._swapped):
                    if sw.req.out is out:
                        found = self._swapped.pop(i).req
                        self._host_tier.unreserve(sw.nbytes)
                        break
            if found is not None:
                self._inflight.discard(out)
                self._release_adapter(out)
                self.recorder.finish(found.trace, "cancelled")
                out.put(None)
                return
            self._cancelled.add(out)
        self._wake.set()

    def preempt(self, out: "queue.Queue[object]") -> None:
        """Ask the engine to preempt the live request whose submit()
        returned `out` at the next chunk boundary: its block chain swaps
        out to the host tier and the request readmits later (token-exact
        at temperature 0). Advisory: a request that is not live, an engine
        without a host tier, or a host budget that cannot pin the payload
        leaves the request running. Safe from any thread; idempotent."""
        if self._host_tier is None:
            return
        with self._lock:
            if out in self._inflight:
                self._preempt_requests.add(out)
        self._wake.set()

    def affinity_sketch(self, limit: int = 512) -> Dict[str, Any]:
        """Cache-affinity sketch for fleet routing: the bounded set of
        resident prefix chain-head digests (device pool, then host tier;
        namespace-seeded as BlockAllocator._ns_seed chains them) and the
        loaded adapters, taken under the engine lock as one consistent
        snapshot. A router that recomputes the same chain over the same
        block boundaries scores this replica by expected matched blocks."""
        with self._lock:
            device = self._alloc.affinity_digests(limit)
            host = (self._host_tier.affinity_digests(limit)
                    if self._host_tier is not None else [])
            adapters = [] if self._lora is None else sorted(self._lora.loaded())
        # Device digests win the bound (they match without a swap-in);
        # host digests fill the room left. The router scores by set
        # membership, so order carries nothing.
        seen = set(device)
        merged = (device + [d for d in host if d not in seen])[:limit]
        return {"block_size": self._block_size, "digests": merged,
                "adapters": adapters}

    # -- multi-tenant adapters ----------------------------------------------

    @property
    def lora_enabled(self) -> bool:
        return self._lora is not None

    def _require_lora(self) -> AdapterRegistry:
        if self._lora is None:
            raise RuntimeError(
                "engine has no adapter support"
                " (construct with lora_max_adapters > 0)"
            )
        return self._lora

    def load_adapter(self, name: str, adapter: Params, *, alpha: float = 16.0) -> int:
        """Install (or replace) a LoRA adapter under `name`; returns its bank
        slot. May LRU-evict an idle adapter; AdapterBusyError /
        AdapterPoolFullError when in-flight refs forbid it
        (lora_serving.py). Under the engine lock, on the engine's stream:
        a step already queued reads the bank as it was."""
        with self._lock, torch.cuda.stream(self._stream):
            return self._require_lora().load(name, adapter, alpha=alpha)

    def unload_adapter(self, name: str) -> None:
        with self._lock, torch.cuda.stream(self._stream):
            self._require_lora().unload(name)

    def adapters(self) -> Dict[str, Dict[str, Any]]:
        """Loaded adapters: name -> {slot, refs, alpha, rank}."""
        with self._lock:
            return {} if self._lora is None else self._lora.loaded()

    def _release_adapter(self, out) -> None:
        """Drop a request's adapter ref (idempotent; caller holds _lock)."""
        name = self._adapter_holds.pop(out, None)
        if name is not None and self._lora is not None:
            self._lora.release(name)

    def _lora_live(self):
        """(run the LoRA programs, whether a live slot carries an adapter):
        host values, no sync. A request holding a ref may still be queued
        or prefilling; the live slots decide what the batch computes."""
        if self._lora is None:
            return False, False
        with self._lock:
            on = self._lora.inflight > 0
        return on, on and any(r is not None and r.adapter_ix >= 0 for r in self._live)

    def stats(self) -> Dict[str, Any]:
        """Live load snapshot (feeds /metrics): queue and shed counters,
        scheduler gauges, the paged-KV pool and prefix-cache counters,
        chunked-prefill counters, latency histograms, warmup, the kernel
        cache's process-wide counters, and which attention path ran how
        often. Key names follow the JAX engine's for every feature
        ported."""
        busy = self._t_decode + self._t_prefill + self._t_idle
        a = self._alloc
        tier = self._host_tier.stats() if self._host_tier is not None else {}
        cc = compile_cache.snapshot()
        return {
            "slots": self.slots,
            "active": sum(r is not None for r in self._live),
            "pending": self._pending.qsize() + (self._next_req is not None),
            "max_pending": self.max_pending,
            "rejected_total": self.rejected,
            "chunk_seconds_ewma": round(self._chunk_s, 4),
            "slot_turn_seconds_ewma": round(self._turn_s, 3),
            "steps_per_sync": self._steps_per_sync,
            "max_prefills_per_chunk": self.max_prefills_per_chunk,
            "prefill_chunk_tokens": self.prefill_chunk_tokens,
            "kv_block_size": self._block_size,
            "kv_blocks_total": a.num_blocks,
            "kv_blocks_in_use": a.in_use,
            "kv_blocks_cached": a.cached,
            "prefix_cache_hits_total": a.hits,
            "prefix_cache_misses_total": a.misses,
            # A host hit is a match that pulled at least one block back
            # from the host tier; device + host + misses partition probes.
            "prefix_cache_device_hits_total": a.hits - a.host_hits,
            "prefix_cache_host_hits_total": a.host_hits,
            "prefix_tokens_reused_total": a.tokens_reused,
            "kv_cow_copies_total": a.cow_copies,
            "kv_block_evictions_total": a.evictions,
            "kv_host_enabled": self._host_tier is not None,
            "kv_host_budget_bytes": tier.get("budget_bytes", 0),
            "kv_host_blocks": tier.get("blocks", 0),
            "kv_host_bytes": tier.get("spill_bytes", 0) + tier.get("pinned_bytes", 0),
            "kv_spills_total": tier.get("spills_total", 0),
            "kv_host_evictions_total": tier.get("evictions_total", 0),
            "kv_swap_ins_total": tier.get("swap_ins_total", 0),
            "max_resident_slots": self._max_resident,
            "slots_swapped": len(self._swapped),
            "slot_preemptions_total": self._preemptions,
            "slot_swap_ins_total": self._slot_swap_ins,
            "swap_in_hist": self._swap_in_hist.to_dict(),
            "prefill_chunks_total": self._prefill_chunks,
            "prefill_tokens_computed_total": self._prefill_tokens_computed,
            "ttft_seconds_ewma": round(self._ttft_s, 4),
            "queue_wait_seconds_ewma": round(self._queue_wait_s, 4),
            "prefill_seconds_ewma": round(self._prefill_s, 4),
            "util_decode": round(self._t_decode / busy, 4) if busy else 0.0,
            "util_prefill": round(self._t_prefill / busy, 4) if busy else 0.0,
            "util_idle": round(self._t_idle / busy, 4) if busy else 0.0,
            "decode_seconds_total": round(self._t_decode, 4),
            "prefill_seconds_total": round(self._t_prefill, 4),
            "idle_seconds_total": round(self._t_idle, 4),
            "admitted_total": self._n_admitted,
            "ttft_seconds_sum": round(self._sum_ttft, 4),
            "queue_wait_seconds_sum": round(self._sum_queue_wait, 4),
            "prefill_seconds_sum": round(self._sum_prefill, 4),
            "ttft_hist": self._ttft_hist.to_dict(),
            "ttft_cold_hist": self._ttft_cold_hist.to_dict(),
            "warmup_done": self._warmup_done,
            "warmup_seconds": (
                None if self._warmup_seconds is None
                else round(self._warmup_seconds, 4)
            ),
            "warmup_programs": self._warmup_programs,
            "warmup_hist": self._warmup_hist.to_dict(),
            "compile_cache_dir": self._compile_cache_dir,
            "compiles_total": cc["compiles"],
            "compile_cache_hits_total": cc["cache_hits"],
            "compile_cache_misses_total": cc["cache_misses"],
            "compile_seconds_total": round(cc["compile_seconds"], 4),
            # Disaggregation: which half of the split this engine is (the
            # TTFT/TPT series carry it as a label: a split request's legs
            # are different quantities) and the handoff counters on both
            # sides of the transfer seam.
            "role": self.role,
            "handoff_epoch": self.handoff_epoch,
            "kv_handoffs_sent_total": self._handoffs_sent,
            "kv_handoffs_received_total": self._handoffs_received,
            "kv_handoffs_stale_rejected_total": self._handoff_stale_rejected,
            "kv_transfer_bytes_total": self._kv_transfer_bytes,
            "kv_transfer_hist": self._kv_transfer_hist.to_dict(),
            "kv_transfer_queue_depth": (self._handoff_q.qsize()
                                        + len(self._prefilled_pending)),
            "tpt_hist": self._tpt_hist.to_dict(),
            # Speculative decoding: draft/verify seconds, token fates
            # (proposed = accepted + rejected; the correction or bonus token
            # of each round is not proposed) and the acceptance EWMAs that
            # drive draft-length adaptation and the fallback.
            "spec_enabled": self._spec,
            "spec_max_draft": self._spec_max_draft,
            "spec_rounds_total": self._spec_rounds,
            "spec_fallback_rounds_total": self._spec_fallback_rounds,
            "spec_tokens_proposed_total": self._spec_proposed,
            "spec_tokens_accepted_total": self._spec_accepted,
            "spec_tokens_rejected_total": self._spec_rejected,
            "spec_accept_rate_ewma": round(self._spec_accept_ewma, 4),
            "spec_tokens_per_round_ewma": round(self._spec_tokens_round_ewma, 4),
            "spec_draft_len_mean": round(sum(self._slot_k) / len(self._slot_k), 4),
            "spec_draft_seconds_total": round(self._t_spec_draft, 4),
            "spec_verify_seconds_total": round(self._t_spec_verify, 4),
            "attn_path": self._attn_path,
            "model_shards": model_shards(self.mesh),
            **{f"attn_dispatch_{p}_total": n
               for p, n in self._attn_dispatch.items()},
            # Multi-tenant LoRA: bank occupancy for the adapters_loaded gauge.
            "lora_enabled": self._lora is not None,
            "lora_max_adapters": 0 if self._lora is None else self._lora.max_adapters,
            "adapters_loaded": 0 if self._lora is None else self._lora.loaded_count,
            "trace": self.recorder.stats(),
            "phase_hists": self.recorder.phase_histograms(),
            # Resident prefix chain-head digests and loaded adapters, the
            # payload fleet routers score replicas by (GET /v1/affinity).
            "affinity": self.affinity_sketch(),
        }

    def request_trace(self, key: Any) -> Optional[Dict[str, Any]]:
        """Phase-timeline snapshot of one request, by engine request id or
        client X-Request-ID (None when unknown, recycled, or the recorder
        is off): the payload of GET /v1/requests/<id>/trace."""
        return self.recorder.get(key)

    def close(self) -> None:
        with self._lock:
            self._stop = True
        self._wake.set()
        self._thread.join(timeout=10)
        self._deliver_q.put(None)
        self._deliver_thread.join(timeout=10)
        if self._handoff_thread is not None:
            self._handoff_q.put(None)
            self._handoff_thread.join(timeout=10)
        # In-flight requests get an exception, not the clean-end None: a
        # truncated generation must not read as a complete one.
        self._flush_all(RuntimeError("serving engine closed mid-generation"))
        # The followers leave their op loops. After a failed op the ranks
        # may be out of step; they exit when this process's group goes.
        if self._tp is not None and not self._op_broken:
            self._op("shutdown")

    def _flush_all(self, error: Optional[BaseException]) -> None:
        """Terminate every consumer so no out.get() hangs forever."""
        sentinel: object = error
        with self._lock:
            self._cancelled.clear()
            self._inflight.clear()
            for slot, req in enumerate(self._live):
                if req is not None:
                    self.recorder.finish(req.trace, "error")
                    req.out.put(sentinel)
                    self._live[slot] = None
            for req in self._admitting:
                self.recorder.finish(req.trace, "error")
                req.out.put(sentinel)
            self._admitting.clear()
            self._tasks.clear()
            self._pending_activation.clear()
            for sw in self._swapped:
                self.recorder.finish(sw.req.trace, "error")
                sw.req.out.put(sentinel)
                self._host_tier.unreserve(sw.nbytes)
            self._swapped.clear()
            self._preempt_requests.clear()
            if self._next_req is not None:
                self.recorder.finish(self._next_req.trace, "error")
                self._next_req.out.put(sentinel)
                self._next_req = None
            # Handoffs queued but not yet admitted (decode role). A
            # prefill-role request whose handoff is in flight is still in
            # _admitting, answered above.
            for _h, h_out, _t, h_rec in self._prefilled_pending:
                self.recorder.finish(h_rec, "error")
                h_out.put(sentinel)
            self._prefilled_pending.clear()
            # Every in-flight adapter ref dies with its consumer.
            for out in list(self._adapter_holds):
                self._release_adapter(out)
            while True:
                try:
                    r = self._pending.get_nowait()
                except queue.Empty:
                    return
                self.recorder.finish(r.trace, "error")
                r.out.put(sentinel)

    # -- chunked prefill admission -----------------------------------------

    def _chunk_fn(self, n_padded: int, lora: bool = False):
        """The chunk-prefill program for padded length `n_padded`, or its
        LoRA twin (prefill is per request: an adapter-free request on a
        LoRA engine takes the plain one). Tests wrap this to gate or spy on
        chunk dispatches."""
        fn = self._chunk_cache.get((n_padded, lora))
        if fn is None:
            fn = make_chunk_prefill(self.config, n_padded, lora=lora, mesh=self.mesh)
            self._chunk_cache[(n_padded, lora)] = fn
        return fn

    def _draft_chunk_fn(self, n_padded: int):
        """The drafter's twin of _chunk_fn."""
        fn = self._draft_chunk_cache.get(n_padded)
        if fn is None:
            fn = make_chunk_prefill(self._draft_config, n_padded, mesh=self.mesh)
            self._draft_chunk_cache[n_padded] = fn
        return fn

    def _spec_draft_fn(self, k: int):
        fn = self._spec_draft_fns.get(k)
        if fn is None:
            fn = make_spec_draft(self._draft_config, k, mesh=self.mesh)
            self._spec_draft_fns[k] = fn
        return fn

    def _spec_verify_fn(self, k: int, lora: bool = False):
        """The verify program for draft length k, or its LoRA twin (tests
        wrap this to gate or spy on rounds)."""
        fn = self._spec_verify_fns.get((k, lora))
        if fn is None:
            fn = make_spec_verify(self.config, k, lora=lora, mesh=self.mesh)
            self._spec_verify_fns[(k, lora)] = fn
        return fn

    def _copy_both(self, src: int, dst: int) -> None:
        self._op("copy_block", src, dst)

    def _pad_chunk(self, n: int) -> int:
        """Pow-2 bucket (min 8) capped at the chunk budget, as the JAX
        engine, so both run the same chunk shapes."""
        c = 8
        while c < n:
            c *= 2
        return max(min(c, self.prefill_chunk_tokens), n)

    def _pad_table(self, table: List[int]) -> List[int]:
        """Pad a host table to the device row width with the sentinel."""
        return table + [self._num_blocks] * (self._max_blocks - len(table))

    def _drop_task(self, task: _PrefillTask) -> None:
        with self._lock:
            for b in task.table:
                self._alloc.release(b)
            task.table.clear()
            self._cancelled.discard(task.req.out)
            self._inflight.discard(task.req.out)
            self._release_adapter(task.req.out)
            if task.req in self._admitting:
                self._admitting.remove(task.req)
        self._tasks.remove(task)
        self.recorder.finish(task.req.trace, "cancelled")
        task.req.out.put(None)

    def _ensure_task_blocks(self, task: _PrefillTask, upto: int) -> bool:
        """Make blocks [pos//bs, (upto-1)//bs] of the task's table
        writable: fresh-allocate missing ones, copy-on-write shared ones.
        False when the pool is exhausted (refs taken are kept)."""
        bs = self._block_size
        with self._lock:
            for idx in range(task.pos // bs, (upto - 1) // bs + 1):
                if idx < len(task.table):
                    b, needs_copy = self._alloc.ensure_writable(task.table[idx])
                    if b is None:
                        return False
                    if needs_copy:
                        self._copy_both(task.table[idx], b)
                        task.table[idx] = b
                else:
                    b = self._alloc.alloc()
                    if b is None:
                        return False
                    task.table.append(b)
        return True

    def _advance_prefills(self) -> bool:
        """One admission boundary: pull new requests into prefill tasks
        (up to `max_prefills_per_chunk`, prefix-cache matched on entry),
        then dispatch prompt chunks round-robin within a TOTAL budget of
        `prefill_chunk_tokens` valid tokens. Dispatch only: the final
        chunk samples the first token and flips the slot live on the
        device; the reader thread delivers it. Returns True if anything
        moved."""
        progressed = False
        while (not self._hold_admission
               and len(self._tasks) < self.max_prefills_per_chunk):
            busy = {t.slot for t in self._tasks}
            with self._lock:
                req, self._next_req = self._next_req, None
            if req is None:
                try:
                    req = self._pending.get_nowait()
                except queue.Empty:
                    break
            with self._lock:
                dead = req.out in self._cancelled
                if dead:
                    self._cancelled.discard(req.out)
                    self._inflight.discard(req.out)
                    self._release_adapter(req.out)
            if dead:
                self.recorder.finish(req.trace, "cancelled")
                req.out.put(None)
                progressed = True
                continue

            def _room():
                # Residency cap: a prefilling task goes live the moment it
                # finalizes, so it counts against max_resident_slots now.
                # Swapped-out slots do not count: their KV is host-side.
                live_n = sum(r is not None for r in self._live)
                if live_n + len(busy) >= self._max_resident:
                    return []
                return [s for s in range(self.slots)
                        if self._live[s] is None and s not in busy]

            free = _room()
            if not free and self._try_queue_jump(req):
                # A heavier tenant swapped the lightest live slot out.
                progressed = True
                free = _room()
            if not free:
                with self._lock:
                    self._next_req = req
                break
            with self._lock:
                self._admitting.append(req)
                blocks, matched = self._alloc.match(req.tokens,
                                                    namespace=_namespace(req))
            slot = free[0]
            t_pop = time.monotonic()
            self._slot_t0[slot] = t_pop
            self._queue_wait_s = self._ewma_seed(
                self._queue_wait_s, t_pop - req.t_submit
            )
            self._sum_queue_wait += t_pop - req.t_submit
            if req.trace is not None:
                req.trace.mark("prefill", t_pop)
            self._tasks.append(_PrefillTask(req, slot, matched, blocks, t_pop))
            progressed = True
        budget = self.prefill_chunk_tokens
        for task in list(self._tasks):
            if budget <= 0:
                break
            with self._lock:
                dead = task.req.out in self._cancelled
            if dead:
                self._drop_task(task)
                progressed = True
                continue
            n = min(len(task.req.tokens) - task.pos, budget)
            if not self._ensure_task_blocks(task, task.pos + n):
                continue  # pool exhausted; retry next boundary
            final = task.pos + n == len(task.req.tokens)
            n_padded = self._pad_chunk(n)
            chunk = task.req.tokens[task.pos:task.pos + n]
            args = (n_padded, task.slot, self._pad_table(task.table),
                    chunk + [0] * (n_padded - n), n, task.pos,
                    task.req.max_new_tokens, task.req.temperature, task.req.top_p)
            # Target only takes the adapter: the drafter never applies LoRA.
            first = self._op("chunk", *args, final, task.req.adapter_ix)
            self._attn_dispatch[self._attn_path] += 1
            if self._spec:
                # The drafter prefills the same chunk into its pool through
                # the same table (a prefix hit skips both models' prefill
                # alike).
                self._op("draft_chunk", *args)
                self._attn_dispatch[self._attn_path] += 1
            task.pos += n
            budget -= n
            self._prefill_chunks += 1
            self._prefill_tokens_computed += n
            if task.req.trace is not None:
                task.req.trace.prefill_chunks += 1
                task.req.trace.prefill_tokens += n
            progressed = True
            if final:
                task.first = _FirstToken(first)
                # Prefill role: a request with decode budget left never
                # goes live here; it hands off and decodes on the other
                # tier. One-token requests complete locally.
                handoff = self.role == "prefill" and task.req.max_new_tokens > 1
                with self._lock:
                    # Publish the prompt's full blocks now: stream order
                    # puts these writes before any later matcher's reads.
                    self._alloc.insert_full(task.req.tokens, task.table,
                                            namespace=_namespace(task.req))
                    if task.req.max_new_tokens > 1 and not handoff:
                        self._live[task.slot] = task.req
                        self._admitting.remove(task.req)
                        self._lengths_host[task.slot] = len(task.req.tokens)
                        self._slot_tables[task.slot] = task.table
                        # A fresh request restarts draft-length adaptation.
                        self._slot_k[task.slot] = self._spec_init_k
                        self._accept_ewma[task.slot] = None
                    # One-token requests never go live: the reader thread
                    # completes them and releases their blocks.
                self._tasks.remove(task)
                if handoff:
                    # Gather the blocks now, on the loop thread and in
                    # stream order, before a later chunk can rewrite them.
                    # The request stays in _admitting (capacity and
                    # _flush_all) until its handoff resolves.
                    task.kv_payload = self._gather_payload(task.table)
                    self._handoff_q.put(task)
                else:
                    self._pending_activation.append(task)
                    self._deliver_q.put(task)
        return progressed

    def _deliver_loop(self) -> None:
        """Reader thread: waits for each finalized prefill's first token
        and delivers it the moment it lands, decoupled from the loop,
        which may still be waiting on a decode chunk."""
        while True:
            task = self._deliver_q.get()
            if task is None:
                return
            req = task.req
            try:
                first = task.first.get()
            except Exception:  # engine failure mid-flight: the loop flushes
                task.delivered.set()
                continue
            now = time.monotonic()
            with self._lock:
                dead = req.out in self._cancelled
                if not dead:
                    req.out.put(first)
                    if req.trace is not None and req.max_new_tokens > 1:
                        req.trace.mark("decode", now)
                self._ttft_s = self._ewma_seed(self._ttft_s, now - req.t_submit)
                self._prefill_s = self._ewma_seed(self._prefill_s, now - task.t_pop)
                self._n_admitted += 1
                self._sum_ttft += now - req.t_submit
                self._sum_prefill += now - task.t_pop
                self._observe_ttft(now - req.t_submit)
                if not self._first_token_emitted:
                    # The serving cold start's end, as first_step is the
                    # trainer's: once per engine lifetime.
                    self._first_token_emitted = True
                    auto_stage("first_token")
                if req.max_new_tokens <= 1:
                    self._cancelled.discard(req.out)
                    self._inflight.discard(req.out)
                    self._release_adapter(req.out)
                    if req in self._admitting:
                        self._admitting.remove(req)
                    for b in task.table:
                        self._alloc.release(b)
                    task.table.clear()
                    self.recorder.finish(
                        req.trace, "cancelled" if dead else "ok", now
                    )
                    req.out.put(None)
            task.delivered.set()

    def _wait_activations(self) -> None:
        """Order barrier: a decode chunk's tokens never overtake the first
        tokens of the prefills dispatched before it."""
        for task in self._pending_activation:
            task.delivered.wait(timeout=60)
        self._pending_activation.clear()

    # -- prefill/decode disaggregation ----------------------------------------

    def _gather_payload(self, table: List[int]) -> _HostPayload:
        """Dispatch the device -> host copy of a block chain out of every
        pool (the drafter's too when speculating, so the decode tier's
        drafter starts from real KV) into page-locked host tensors behind
        one CUDA event; no host sync. On a mesh the ranks' heads are
        gathered first, so the frame is the unsharded tier's."""
        return self._op("gather_payload", table)

    def _handoff_loop(self) -> None:
        """Prefill-role sender thread: ships each finalized task's KV to
        the decode tier, then releases its blocks, so transfer time never
        stalls the loop's next admission boundary."""
        while True:
            task = self._handoff_q.get()
            if task is None:
                return
            try:
                self._do_handoff(task)
            except BaseException:
                logging.getLogger(__name__).exception("kv handoff failed")
                task.delivered.set()

    def _do_handoff(self, task: _PrefillTask) -> None:
        req = task.req

        def _finish(result: object) -> None:
            # Resolved (shipped, cancelled or failed): the prefill side's
            # claim on the blocks ends here either way.
            with self._lock:
                for b in task.table:
                    self._alloc.release(b)
                task.table.clear()
                self._cancelled.discard(req.out)
                self._inflight.discard(req.out)
                if req in self._admitting:
                    self._admitting.remove(req)
                self._release_adapter(req.out)
            req.out.put(result)
            task.delivered.set()

        if self._stop or self._failed is not None:
            task.delivered.set()  # _flush_all answers the consumer
            return
        try:
            first = task.first.get()  # waits for the final chunk alone
        except Exception:
            # An engine failure mid-flight: the loop's own sync fails too
            # and _flush_all answers the consumer.
            task.delivered.set()
            return
        with self._lock:
            dead = req.out in self._cancelled
        if dead:
            # Cancel mid-handoff: release everything, ship nothing.
            self.recorder.finish(req.trace, "cancelled")
            _finish(None)
            return
        t0 = time.monotonic()
        if req.trace is not None:
            req.trace.mark("kv_ship", t0)  # prefill closes here
        try:
            arrays = task.kv_payload.get()
            if req.request_id is not None:
                rid = req.request_id
            else:
                with self._lock:
                    self._handoff_seq += 1
                    rid = self._handoff_seq
            h = KVHandoff(
                request_id=rid, epoch=0,  # the transfer client stamps it
                prompt=list(req.tokens), first_token=first,
                max_new_tokens=req.max_new_tokens,
                temperature=req.temperature, top_p=req.top_p,
                k=arrays["k"], v=arrays["v"],
                draft_k=arrays.get("draft_k"), draft_v=arrays.get("draft_v"),
                traceparent=req.traceparent,
            )
            self._kv_transfer.send(h)
        except Exception as e:
            # The decode side is gone or churning: fail this request
            # loudly; "prefilled but never decoded" must not read as a
            # complete empty generation.
            self.recorder.finish(req.trace, "error")
            _finish(e)
            return
        now = time.monotonic()
        with self._lock:
            self._handoffs_sent += 1
            self._kv_transfer_bytes += h.payload_bytes
            self._kv_transfer_hist.observe(now - t0)
            # Prefill-role TTFT: submit -> handoff acked (the decode tier
            # owns the first token from here).
            self._ttft_s = self._ewma_seed(self._ttft_s, now - req.t_submit)
            self._n_admitted += 1
            self._sum_ttft += now - req.t_submit
            self._observe_ttft(now - req.t_submit)
        if req.trace is not None:
            req.trace.kv_payload_bytes += h.payload_bytes
            self.recorder.finish(req.trace, "ok", now)
        # The prefill tier's consumer gets no tokens, just the clean end:
        # the decode tier streams them.
        _finish(None)

    def submit_prefilled(self, handoff: KVHandoff) -> "queue.Queue[object]":
        """Decode-role admission of a prefill tier's finished KV blocks and
        metadata; returns the token stream queue (the protocol of submit(),
        the first token taken from the handoff). A payload stamped with
        anything but the current `handoff_epoch` raises StaleEpochError.
        Thread-safe (the transfer server's connection threads call it):
        it only queues; the loop thread allocates and injects."""
        if self.role != "decode":
            raise RuntimeError(
                f"submit_prefilled requires role='decode', engine has"
                f" role={self.role!r}"
            )
        prompt = list(handoff.prompt)
        if not prompt:
            raise ValueError("empty handoff prompt")
        if handoff.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {handoff.max_new_tokens}"
            )
        if len(prompt) + handoff.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {len(prompt)} + max_new_tokens"
                f" {handoff.max_new_tokens} must not exceed max_len"
                f" {self.max_len}"
            )
        c = self.config
        want = (c.n_layers, self._block_size, c.n_kv_heads, c.head_dim)
        got = (handoff.k.shape[0],) + tuple(handoff.k.shape[2:])
        if got != want or handoff.k.shape != handoff.v.shape:
            raise ValueError(
                f"handoff KV geometry {tuple(handoff.k.shape)} does not match"
                f" this engine's pool (L, n, bs, KV, hd) ="
                f" ({c.n_layers}, n, {self._block_size}, {c.n_kv_heads},"
                f" {c.head_dim})"
            )
        expected = (len(prompt) - 1) // self._block_size + 1
        if handoff.n_blocks != expected:
            raise ValueError(
                f"handoff carries {handoff.n_blocks} blocks but the"
                f" prompt needs {expected}"
            )
        out: "queue.Queue[object]" = queue.Queue()
        with self._lock:
            if self._failed is not None:
                raise RuntimeError(f"serving engine failed: {self._failed}")
            if self._stop:
                raise RuntimeError("serving engine is closed")
            if handoff.epoch != self.handoff_epoch:
                self._handoff_stale_rejected += 1
                raise StaleEpochError(handoff.epoch, self.handoff_epoch)
            t_recv = time.monotonic()
            # The decode leg of the request's trace shares the prefill
            # tier's trace_id through the handoff's traceparent.
            rec = None
            if self.recorder.enabled:
                rec = self.recorder.begin(
                    handoff.request_id, traceparent=handoff.traceparent,
                    first_phase="queue_wait", t0=t_recv,
                )
            self._prefilled_pending.append((handoff, out, t_recv, rec))
            self._inflight.add(out)
        self._wake.set()
        return out

    def bump_handoff_epoch(self) -> int:
        """Start a new handoff generation (decode role): payloads stamped
        before the bump are rejected on arrival. A co-located
        kv_transfer.TransferServer bumps in lockstep (its hello announces
        the epoch)."""
        with self._lock:
            self.handoff_epoch += 1
            return self.handoff_epoch

    def _admit_prefilled(self) -> bool:
        """Decode-role admission boundary (loop thread): queued handoffs in
        arrival order into free slots — fresh blocks from this pool, the
        payload scattered in, the prompt published to the prefix cache (in
        the default namespace), the slot placed with the first token as
        its next input, and that token delivered. A starved pool leaves
        the handoff queued for the next boundary."""
        progressed = False
        while True:
            with self._lock:
                if not self._prefilled_pending:
                    return progressed
                h, out, t_recv, rec = self._prefilled_pending[0]
                dead = out in self._cancelled
                if dead:
                    self._prefilled_pending.pop(0)
                    self._cancelled.discard(out)
                    self._inflight.discard(out)
            if dead:
                self.recorder.finish(rec, "cancelled")
                out.put(None)
                progressed = True
                continue
            busy = {t.slot for t in self._tasks}
            live_n = sum(r is not None for r in self._live)
            free = [s for s in range(self.slots)
                    if self._live[s] is None and s not in busy]
            if not free or live_n + len(busy) >= self._max_resident:
                return progressed
            with self._lock:
                table: List[int] = []
                for _ in range(h.n_blocks):
                    b = self._alloc.alloc()
                    if b is None:
                        break
                    table.append(b)
                if len(table) < h.n_blocks:
                    for b in table:
                        self._alloc.release(b)
                    return progressed  # pool starved: retry next boundary
                self._prefilled_pending.pop(0)
            if rec is not None:
                rec.mark("kv_adopt")  # queue_wait closes here
            arrays = {"k": h.k, "v": h.v}
            if h.draft_k is not None:
                arrays.update(draft_k=h.draft_k, draft_v=h.draft_v)
            # A speculating engine fed by a prefill tier without a drafter
            # decodes this slot's drafts from stale rows: verification
            # keeps the stream exact, acceptance sinks.
            self._inject_handoff(arrays, table)
            prompt = list(h.prompt)
            first = int(h.first_token)
            slot = free[0]
            req = _Request(prompt, h.max_new_tokens, out, float(h.temperature),
                           float(h.top_p), t_recv, h.request_id, rec,
                           traceparent=h.traceparent)
            with self._lock:
                self._alloc.insert_full(prompt, table)
                self._handoffs_received += 1
                self._kv_transfer_bytes += h.payload_bytes
                if rec is not None:
                    rec.kv_payload_bytes += h.payload_bytes
                if h.max_new_tokens > 1:
                    self._live[slot] = req
                    self._lengths_host[slot] = len(prompt)
                    self._slot_tables[slot] = table
                    self._slot_k[slot] = self._spec_init_k
                    self._accept_ewma[slot] = None
                    self._slot_t0[slot] = t_recv
                else:
                    # The prefill tier completes one-token requests itself;
                    # a direct caller's budget is spent by the first token.
                    for b in table:
                        self._alloc.release(b)
                    self._inflight.discard(out)
            if h.max_new_tokens > 1:
                self._place_slot(slot, table, len(prompt), first,
                                 h.max_new_tokens - 1, h.temperature, h.top_p, -1)
            now = time.monotonic()
            with self._lock:
                if out not in self._cancelled:
                    out.put(first)
                    if rec is not None:
                        if h.max_new_tokens > 1:
                            rec.mark("decode", now)  # kv_adopt closes here
                        else:
                            self.recorder.finish(rec, "ok", now)
                    if h.max_new_tokens <= 1:
                        out.put(None)
                elif h.max_new_tokens <= 1:
                    # Cancelled inside the admission window; a live slot
                    # takes the fan-out's cancel path instead.
                    self._cancelled.discard(out)
                    self.recorder.finish(rec, "cancelled", now)
                    out.put(None)
                # Decode-role TTFT: handoff receipt -> first delivery.
                self._ttft_s = self._ewma_seed(self._ttft_s, now - t_recv)
                self._n_admitted += 1
                self._sum_ttft += now - t_recv
                self._observe_ttft(now - t_recv)
                if not self._first_token_emitted:
                    self._first_token_emitted = True
                    auto_stage("first_token")
            progressed = True

    # -- host tier and slot preemption --------------------------------------

    def _weight(self, req: _Request) -> float:
        """QoS weight for preemption decisions (unknown tenants weigh 1)."""
        return float(self._qos_weights.get(req.tenant, 1.0))

    def _pools(self):
        """(name, pool) of every pool the allocator indexes."""
        pools = [("k", self.state.k), ("v", self.state.v)]
        if self._spec:
            pools += [("draft_k", self._draft_state.k), ("draft_v", self._draft_state.v)]
        return pools

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _gather_chain(self, table: List[int]) -> Dict[str, torch.Tensor]:
        """Device -> host copy of a block chain out of every pool, as host
        tensors (L, n, bs, KV, hd), page-locked on CUDA. Returns after the
        copies have landed, so the blocks may be freed and rewritten at
        once. On a mesh each rank parks its own heads: rank 0's shard
        comes back with its payload id under PAYLOAD_ID, and when that
        dies the followers drop theirs."""
        if self._tp is None:
            return self._op("gather_chain", table, None)
        pid, self._next_payload = self._next_payload, self._next_payload + 1
        out = self._op("gather_chain", table, pid)
        out[PAYLOAD_ID] = torch.tensor(pid, dtype=torch.int64)
        weakref.finalize(out[PAYLOAD_ID], self._dead_payloads.append, pid)
        return out

    def _inject_chain(self, arrays: Dict[str, torch.Tensor],
                      table: List[int]) -> None:
        """Host -> device: scatter a host-tier payload (`_gather_chain`'s)
        into the blocks of `table`, in every pool, each rank its own
        shard. A payload that lacks a pool's rows raises: the drafter must
        never decode from stale rows of its own engine."""
        missing = [name for name, _ in self._pools() if name not in arrays]
        if missing:
            raise RuntimeError(f"host KV payload lacks {missing}")
        pid = int(arrays[PAYLOAD_ID]) if self._tp is not None else None
        self._op("inject_stored", table, pid, arrays=arrays)

    def _inject_handoff(self, arrays: Dict[str, torch.Tensor], table: List[int]) -> None:
        """Scatter a handoff's chain (every KV head) into the blocks of
        `table`; each rank of a mesh keeps its heads. A handoff may come
        without the drafter's rows."""
        self._op("inject", table, arrays, True)

    def _spill_block(self, key: tuple, b: int) -> None:
        """Allocator eviction hook: ship the victim block's KV to the host
        tier before the block recycles, keyed by its prefix-chain key. A
        payload the budget cannot hold just dies."""
        self._host_tier.put(key, list(self._gather_chain([b]).items()))

    def _swap_in_block(self, key: tuple) -> Optional[int]:
        """Allocator miss hook: bring a spilled block back into a fresh
        device block. The alloc may itself evict and spill (depth one; a
        spill never allocates). None when the key is not spilled or no
        block frees up; the payload then stays host-side."""
        tier = self._host_tier
        payload = tier.get(key)
        if payload is None:
            return None
        t0 = time.monotonic()
        b = self._alloc.alloc()
        if b is None:
            return None
        self._inject_chain(payload, [b])
        tier.pop(key)
        self._swap_in_hist.observe(time.monotonic() - t0)
        return b

    def _place_slot(self, slot: int, table: List[int], length: int,
                    last_token: int, remaining: int, temperature: float,
                    top_p: float, adapter_ix: int) -> None:
        """The device state a final prefill chunk would leave in `slot`:
        table row, length, next token, the budget left, sampling params,
        adapter identity."""
        self._op("place_slot", slot, self._pad_table(table), length, last_token,
                 remaining, temperature, top_p, adapter_ix)

    def _preempt_slot(self, slot: int) -> bool:
        """Swap a live slot's whole chain out to the host tier at a chunk
        boundary: KV and sampling scalars park host-side, the slot and its
        blocks free at once, and readmission resumes the request. The
        request keeps its adapter ref while parked, so the adapter can be
        neither evicted nor unloaded under it. False (the slot keeps
        decoding) when the host budget cannot pin it."""
        req = self._live[slot]
        table = self._slot_tables[slot]
        if req is None or table is None or self._host_tier is None:
            return False
        t0 = time.monotonic()
        if req.trace is not None:
            req.trace.mark("kv_swap_out", t0)
        # The device scalars, not the host mirrors: resume restarts from
        # the state the last program left.
        st = self.state
        length, last, rem = torch.stack(
            [st.lengths[slot], st.last_token[slot], st.remaining[slot]]).tolist()
        # Only the filled chain ships; blocks past `length` re-grow later.
        n_keep = (length - 1) // self._block_size + 1
        arrays = self._gather_chain(table[:n_keep])
        nbytes = payload_bytes(list(arrays.items()))
        if not self._host_tier.reserve(nbytes):
            if req.trace is not None:
                req.trace.mark("decode")
            return False
        sw = _SwappedSlot(req, length, last, rem, arrays, nbytes,
                          self._slot_t0[slot])
        with self._lock:
            self._live[slot] = None
            self._release_slot_blocks(slot, cache_tail=False)
            self._swapped.append(sw)
            self._preempt_requests.discard(req.out)
        self._retire(slot)
        self._preemptions += 1
        if req.trace is not None:
            req.trace.mark("queue_wait")
        return True

    def _try_queue_jump(self, req: _Request) -> bool:
        """QoS preemption at admission: with every resident slot busy, a
        request whose tenant weight strictly exceeds the lightest live
        request's swaps that victim out. Ties go to the resident; among
        equal-weight victims the longest-resident one goes."""
        if self._host_tier is None or not self._qos_weights:
            return False
        w = self._weight(req)
        victim: Optional[int] = None
        vw = 0.0
        for slot, r in enumerate(self._live):
            if r is None:
                continue
            rw = self._weight(r)
            if (victim is None or rw < vw
                    or (rw == vw and self._slot_t0[slot] < self._slot_t0[victim])):
                victim, vw = slot, rw
        if victim is None or not w > vw:
            return False
        return self._preempt_slot(victim)

    def _process_preempt_requests(self) -> None:
        """Serve preempt() asks at a boundary. Asks for requests no longer
        in flight are dropped; asks for requests not yet live wait."""
        with self._lock:
            self._preempt_requests &= self._inflight
            wanted = set(self._preempt_requests)
        if not wanted:
            return
        for slot, req in enumerate(self._live):
            if req is not None and req.out in wanted:
                self._preempt_slot(slot)

    def _readmit_swapped(self) -> bool:
        """Admission boundary for swapped-out requests: heaviest tenant
        first (FIFO within a weight), each into a free slot and fresh
        blocks (whose allocation may evict and spill cached ones). Entries
        stay parked while slots, residency or blocks are short."""
        progressed = False
        while True:
            with self._lock:
                keep = []
                for sw in self._swapped:
                    if sw.req.out in self._cancelled:
                        self._cancelled.discard(sw.req.out)
                        self._inflight.discard(sw.req.out)
                        self._release_adapter(sw.req.out)
                        self._host_tier.unreserve(sw.nbytes)
                        self.recorder.finish(sw.req.trace, "cancelled")
                        sw.req.out.put(None)
                        progressed = True
                    else:
                        keep.append(sw)
                self._swapped[:] = keep
                if not self._swapped:
                    return progressed
                busy = {t.slot for t in self._tasks}
                live_n = sum(r is not None for r in self._live)
                free = [s for s in range(self.slots)
                        if self._live[s] is None and s not in busy]
                if not free or live_n + len(busy) >= self._max_resident:
                    return progressed
                pick = min(range(len(self._swapped)),
                           key=lambda i: (-self._weight(self._swapped[i].req), i))
                sw = self._swapped[pick]
                n = int(sw.arrays["k"].shape[1])
                table: List[int] = []
                for _ in range(n):
                    b = self._alloc.alloc()
                    if b is None:
                        break
                    table.append(b)
                if len(table) < n:
                    for b in table:
                        self._alloc.release(b)
                    return progressed  # pool starved; retry next boundary
                self._swapped.pop(pick)
            slot = free[0]
            t0 = time.monotonic()
            if sw.req.trace is not None:
                sw.req.trace.mark("kv_swap_in", t0)
            self._inject_chain(sw.arrays, table)
            self._place_slot(slot, table, sw.length, sw.last_token, sw.remaining,
                             sw.req.temperature, sw.req.top_p, sw.req.adapter_ix)
            with self._lock:
                self._live[slot] = sw.req
                self._lengths_host[slot] = sw.length
                self._slot_tables[slot] = table
                self._slot_k[slot] = self._spec_init_k
                self._accept_ewma[slot] = None
                self._slot_t0[slot] = sw.t0
                self._host_tier.unreserve(sw.nbytes)
            self._slot_swap_ins += 1
            self._swap_in_hist.observe(time.monotonic() - t0)
            if sw.req.trace is not None:
                sw.req.trace.mark("decode")
            progressed = True

    # -- decode ---------------------------------------------------------------

    def _ensure_decode_blocks(self, lookahead: Optional[int] = None) -> None:
        """Grow live slots' tables to cover the next chunk's writes,
        `lookahead` rows past each slot's length (the decode chunk's
        steps_per_sync by default; a speculation round passes k+1). A slot
        the pool cannot feed is preempted to the host tier where there is
        one, else force-retired with an error — silently dropping its KV
        writes would corrupt the stream."""
        if lookahead is None:
            lookahead = self._steps_per_sync
        bs = self._block_size
        for slot in range(self.slots):
            table = self._slot_tables[slot]
            if self._live[slot] is None or table is None:
                continue
            need = min(
                (self._lengths_host[slot] + lookahead - 1) // bs + 1,
                self._max_blocks,
            )
            grew = starved = False
            while len(table) < need:
                with self._lock:
                    b = self._alloc.alloc()
                if b is None:
                    starved = True
                    break
                table.append(b)
                grew = True
            if starved:
                if self._host_tier is not None and self._preempt_slot(slot):
                    continue
                self._force_retire(slot, RuntimeError(
                    "kv block pool exhausted mid-decode (raise kv_pool_blocks)"
                ))
                continue
            if grew:
                self._op("set_table", slot, self._pad_table(table))

    def _ensure_spec_writable(self, k: int) -> None:
        """Copy-on-write over each live slot's speculation window (rows
        length..length+k) in both pools, before any draft or verify write:
        a block still shared with the prefix cache or another slot must be
        private first, or rejected drafts would corrupt every holder. A
        slot the pool cannot feed is preempted, else force-retired."""
        bs = self._block_size
        for slot in range(self.slots):
            table = self._slot_tables[slot]
            if self._live[slot] is None or table is None:
                continue
            first_blk = self._lengths_host[slot] // bs
            last_blk = min((self._lengths_host[slot] + k) // bs, len(table) - 1)
            changed = False
            for idx in range(first_blk, last_blk + 1):
                with self._lock:
                    b, needs_copy = self._alloc.ensure_writable(table[idx])
                if b is None:
                    if self._host_tier is not None and self._preempt_slot(slot):
                        break
                    self._force_retire(slot, RuntimeError(
                        "kv block pool exhausted during speculative"
                        " copy-on-write (raise kv_pool_blocks)"
                    ))
                    break
                if needs_copy:
                    self._copy_both(table[idx], b)
                    table[idx] = b
                    changed = True
            if changed and self._slot_tables[slot] is table:
                self._op("set_table", slot, self._pad_table(table))

    def _force_retire(self, slot: int, error: BaseException) -> None:
        req = self._live[slot]
        with self._lock:
            self._live[slot] = None
            if req is not None:
                self._cancelled.discard(req.out)
                self._inflight.discard(req.out)
                self._release_adapter(req.out)
                self.recorder.finish(req.trace, "error")
            self._release_slot_blocks(slot, cache_tail=False)
        self._retire(slot)
        if req is not None:
            req.out.put(error)

    def _release_slot_blocks(self, slot: int, cache_tail: bool,
                             req: Optional[_Request] = None) -> None:
        """Return a retired slot's blocks to the pool (caller holds
        _lock), first publishing the prompt's partial tail block under the
        request's adapter namespace."""
        table = self._slot_tables[slot]
        if table is None:
            return
        if cache_tail and req is not None:
            self._alloc.insert_tail(req.tokens, table, namespace=_namespace(req))
        for b in table:
            self._alloc.release(b)
        self._slot_tables[slot] = None
        self._lengths_host[slot] = 0

    def _retire(self, slot: int) -> None:
        self._op("retire", slot)

    def _ewma(self, prev: float, sample: float, alpha: float = 0.2) -> float:
        return prev + alpha * (sample - prev)

    def _ewma_seed(self, prev: float, sample: float, alpha: float = 0.2) -> float:
        return sample if prev == 0.0 else prev + alpha * (sample - prev)

    # -- loop ---------------------------------------------------------------

    def _sampling_flags(self):
        """(sampling, nucleus): whether any live request samples, and
        whether any of those filters by top_p (host values, no sync)."""
        live = [r for r in self._live if r is not None]
        return (any(r.temperature > 0 for r in live),
                any(r.temperature > 0 and r.top_p < 1 for r in live))

    def _decode_chunk(self):
        """Dispatch one decode chunk and read it back: the one host sync
        per `steps_per_sync` tokens."""
        sampling, nucleus = self._sampling_flags()
        lora, has_lora = self._lora_live()
        tokens, active = self._op("decode", lora, sampling, nucleus, has_lora)
        self._attn_dispatch[self._attn_path] += 1
        both = torch.cat([tokens, active[:, None].to(tokens.dtype)], dim=1).cpu()
        return both[:, :-1].tolist(), [bool(x) for x in both[:, -1]]

    def _loop(self) -> None:
        while not self._stop:
            try:
                has_live = any(r is not None for r in self._live)
                if not has_live and not self._tasks:
                    with self._lock:
                        waiting = (bool(self._swapped) or self._next_req is not None
                                   or bool(self._prefilled_pending))
                    if self._pending.empty() and not waiting:
                        t_w = time.monotonic()
                        self._wake.wait(timeout=0.2)
                        self._wake.clear()
                        self._t_idle += time.monotonic() - t_w
                        if (self._tp is not None
                                and time.monotonic() - self._last_op > HEARTBEAT_S):
                            self._op("noop")
                        continue
                if not has_live:
                    # Nothing decoding: admission runs alone; the next
                    # iteration decodes the freshly activated slots.
                    # Swapped-out requests get first claim on capacity.
                    t_p = time.monotonic()
                    progressed = self._readmit_swapped()
                    progressed |= self._advance_prefills()
                    progressed |= self._admit_prefilled()
                    self._wait_activations()
                    self._t_prefill += time.monotonic() - t_p
                    if not progressed and (self._tasks or self._swapped
                                           or self._prefilled_pending):
                        time.sleep(0.001)  # pool starved, nothing live
                    continue
                # 1) Prefill chunks first, so first-token readbacks land
                #    while the decode chunk runs; block growth after, so
                #    a prefill that went live above gets its decode rows.
                t0 = time.monotonic()
                self._readmit_swapped()
                self._process_preempt_requests()
                self._advance_prefills()
                self._admit_prefilled()
                if self._spec and self._spec_cooldown == 0:
                    toks, still, t_pf = self._spec_round()
                    if toks is None:
                        continue  # every slot left during provisioning
                else:
                    self._ensure_decode_blocks()
                    t_pf = time.monotonic()
                    # 2) The decode chunk, and its one readback.
                    toks, still = self._decode_chunk()
                    t_sync = time.monotonic()
                    self._chunk_s = self._ewma(self._chunk_s, t_sync - t_pf)
                    self._t_decode += t_sync - t_pf
                    self._last_chunk_s = t_sync - t_pf
                    if self._spec:
                        self._spec_fallback_rounds += 1
                        self._spec_cooldown -= 1
                        if self._spec_cooldown == 0:
                            # Re-probe cautiously: shortest drafts, fresh
                            # acceptance estimates.
                            self._slot_k = [1] * self.slots
                            self._accept_ewma = [None] * self.slots
                            self._spec_low_streak = 0
                self._t_prefill += t_pf - t0
                # 3) First-token order barrier, then fan out the chunk.
                self._wait_activations()
                self._fan_out(toks, still)
            except Exception as e:  # fail every consumer loudly, not by
                # wedging them on a dead queue
                if self._stop:
                    return
                with self._lock:
                    self._failed = e
                self._flush_all(e)
                logging.getLogger(__name__).exception("serving engine loop failed")
                return

    def _spec_round(self):
        """One speculation boundary: the drafter proposes k tokens per
        slot, the target verifies all k+1 positions in one forward, and
        the host adapts each slot's draft length to what survived. Returns
        (toks, still, t_pf) shaped like a decode chunk's (rows of k+1,
        -1-padded) so the fan-out is shared, or (None, None, t) when no
        slot survived block provisioning."""
        k_cur = max((self._slot_k[s] for s in range(self.slots)
                     if self._live[s] is not None), default=self._spec_init_k)
        self._ensure_decode_blocks(k_cur + 1)
        self._ensure_spec_writable(k_cur)
        if not any(r is not None for r in self._live):
            return None, None, time.monotonic()
        t_pf = time.monotonic()
        sampling, nucleus = self._sampling_flags()
        self._op("spec_draft", k_cur, sampling, nucleus)
        self._sync()  # splits the draft's time from the verify's
        t_draft = time.monotonic()
        lora, has_lora = self._lora_live()
        emitted, accepted, active = self._op("spec_verify", k_cur, lora, sampling,
                                             nucleus, has_lora)
        both = torch.cat([emitted, accepted[:, None], active[:, None].to(emitted.dtype)],
                         dim=1).cpu().tolist()
        t_sync = time.monotonic()
        toks = [row[:-2] for row in both]
        acc = [row[-2] for row in both]
        still = [bool(row[-1]) for row in both]
        self._attn_dispatch[self._attn_path] += 2  # draft + verify programs
        self._chunk_s = self._ewma(self._chunk_s, t_sync - t_pf)
        self._t_decode += t_sync - t_pf
        self._last_chunk_s = t_sync - t_pf
        self._t_spec_draft += t_draft - t_pf
        self._t_spec_verify += t_sync - t_draft
        self._spec_rounds += 1
        live_rates = []
        n_round_tokens = 0
        for slot in range(self.slots):
            if self._live[slot] is None:
                continue
            a = acc[slot]
            self._spec_proposed += k_cur
            self._spec_accepted += a
            self._spec_rejected += k_cur - a
            n_round_tokens += sum(t >= 0 for t in toks[slot])
            tr = self._live[slot].trace
            if tr is not None:
                tr.spec_rounds += 1
                tr.spec_drafted += k_cur
                tr.spec_accepted += a
                tr.spec_rejected += k_cur - a
            rate = a / k_cur
            prev = self._accept_ewma[slot]
            ewma = rate if prev is None else prev + 0.3 * (rate - prev)
            self._accept_ewma[slot] = ewma
            live_rates.append(ewma)
            if ewma > 0.8 and self._slot_k[slot] < self._spec_max_draft:
                self._slot_k[slot] += 1
            elif ewma < 0.4 and self._slot_k[slot] > 1:
                self._slot_k[slot] -= 1
        if live_rates:
            mean_rate = sum(live_rates) / len(live_rates)
            self._spec_accept_ewma = self._ewma_seed(self._spec_accept_ewma, mean_rate)
            self._spec_tokens_round_ewma = self._ewma_seed(
                self._spec_tokens_round_ewma, n_round_tokens / len(live_rates))
            # Speculation that keeps missing is a strict loss (k drafter
            # steps and a (k+1)-row verify for about one token): after
            # three low rounds, plain decode chunks for a cooldown.
            if mean_rate < self._spec_min_accept:
                self._spec_low_streak += 1
                if self._spec_low_streak >= 3:
                    self._spec_cooldown = 50
            else:
                self._spec_low_streak = 0
        return toks, still, t_pf

    def _fan_out(self, toks, still) -> None:
        """Deliver one chunk's tokens (decode chunk or speculation round;
        rows -1-padded past each slot's emissions) and retire slots that
        finished or were cancelled."""
        with self._lock:
            cancelled = set(self._cancelled)
        total_emitted = 0
        for slot, req in enumerate(self._live):
            if req is None:
                continue
            row = [t for t in toks[slot] if t >= 0]
            self._lengths_host[slot] += len(row)
            total_emitted += len(row)
            if req.trace is not None:
                req.trace.decode_steps += 1
                req.trace.decode_tokens += len(row)
            if req.out in cancelled:
                with self._lock:
                    self._cancelled.discard(req.out)
                    self._inflight.discard(req.out)
                    self._live[slot] = None
                    self._release_slot_blocks(slot, cache_tail=True, req=req)
                    self._release_adapter(req.out)
                self._retire(slot)
                self.recorder.finish(req.trace, "cancelled")
                req.out.put(None)
                continue
            if not still[slot]:
                # Free the slot (under the submit lock) BEFORE the final
                # tokens + clean end: a client that resubmits at once must
                # find the capacity it just released.
                with self._lock:
                    self._live[slot] = None
                    self._cancelled.discard(req.out)
                    self._inflight.discard(req.out)
                    self._release_slot_blocks(slot, cache_tail=True, req=req)
                    self._release_adapter(req.out)
                # The device retired the slot itself; this also clears its
                # adapter_ix, so no later batch gathers the old tenant's.
                self._retire(slot)
                for tok in row:
                    req.out.put(tok)
                t_done = time.monotonic()
                self.recorder.finish(req.trace, "ok", t_done)
                req.out.put(None)
                self._turn_s = self._ewma(self._turn_s, t_done - self._slot_t0[slot])
                continue
            for tok in row:
                req.out.put(tok)
        if total_emitted:
            self._tpt_hist.observe(self._last_chunk_s / total_emitted)


def run_follower(mesh, config: ModelConfig, params: Params, **engine_kw) -> "ServingEngine":
    """A follower rank of a tensor-parallel engine: build the engine's
    state from this rank's slices of `params` (the whole params, as rank
    0 was given them) with the leader's `engine_kw`, then run the leader's
    ops until it closes. Returns the follower's engine (its state is this
    rank's) when the leader sends shutdown; raises when the leader's
    process disappears (the next collective fails)."""
    if mesh is None or not mesh.ranked or mesh.rank == 0:
        raise ValueError("run_follower runs ranks 1.. of a mesh over ranks;"
                         " rank 0 is the ServingEngine(mesh=) leader")
    engine = ServingEngine(config, params, mesh=mesh, **engine_kw)
    engine._follow()
    return engine


def prometheus_metrics(stats: Dict[str, Any]) -> str:
    """Render a stats() snapshot in Prometheus text exposition format,
    under the same series names as the JAX engine. The latency histograms
    carry the engine's role as a label: a split request's prefill leg
    (submit -> handoff acked), decode leg (receipt -> first delivery) and
    a unified engine's TTFT are different quantities."""
    series = [
        ("dstack_tpu_serving_slots_active", "gauge", stats["active"]),
        ("dstack_tpu_serving_pending_requests", "gauge", stats["pending"]),
        ("dstack_tpu_serving_kv_blocks_in_use", "gauge", stats["kv_blocks_in_use"]),
        ("dstack_tpu_serving_kv_blocks_cached", "gauge", stats["kv_blocks_cached"]),
        ("dstack_tpu_serving_prefix_cache_hits_total", "counter",
         stats["prefix_cache_hits_total"]),
        ("dstack_tpu_serving_prefix_cache_misses_total", "counter",
         stats["prefix_cache_misses_total"]),
        ("dstack_tpu_serving_prefix_cache_device_hits_total", "counter",
         stats["prefix_cache_device_hits_total"]),
        ("dstack_tpu_serving_prefix_cache_host_hits_total", "counter",
         stats["prefix_cache_host_hits_total"]),
        ("dstack_tpu_serving_prefix_tokens_reused_total", "counter",
         stats["prefix_tokens_reused_total"]),
        ("dstack_tpu_serving_kv_cow_copies_total", "counter",
         stats["kv_cow_copies_total"]),
        # The host tier and slot preemption (zero without a host budget).
        ("dstack_tpu_serving_kv_host_blocks", "gauge", stats["kv_host_blocks"]),
        ("dstack_tpu_serving_kv_host_bytes", "gauge", stats["kv_host_bytes"]),
        ("dstack_tpu_serving_kv_spills_total", "counter", stats["kv_spills_total"]),
        ("dstack_tpu_serving_kv_host_evictions_total", "counter",
         stats["kv_host_evictions_total"]),
        ("dstack_tpu_serving_kv_swap_ins_total", "counter", stats["kv_swap_ins_total"]),
        ("dstack_tpu_serving_slots_swapped", "gauge", stats["slots_swapped"]),
        ("dstack_tpu_serving_slot_preemptions_total", "counter",
         stats["slot_preemptions_total"]),
        ("dstack_tpu_serving_slot_swap_ins_total", "counter",
         stats["slot_swap_ins_total"]),
        ("dstack_tpu_serving_prefill_chunks_total", "counter",
         stats["prefill_chunks_total"]),
        ("dstack_tpu_serving_prefill_tokens_total", "counter",
         stats["prefill_tokens_computed_total"]),
        ("dstack_tpu_serving_admitted_total", "counter", stats["admitted_total"]),
        ("dstack_tpu_serving_rejected_total", "counter", stats["rejected_total"]),
        # Speculative decoding (zero without spec_enable).
        ("dstack_tpu_serving_spec_rounds_total", "counter", stats["spec_rounds_total"]),
        ("dstack_tpu_serving_spec_fallback_rounds_total", "counter",
         stats["spec_fallback_rounds_total"]),
        ("dstack_tpu_serving_spec_tokens_proposed_total", "counter",
         stats["spec_tokens_proposed_total"]),
        ("dstack_tpu_serving_spec_tokens_accepted_total", "counter",
         stats["spec_tokens_accepted_total"]),
        ("dstack_tpu_serving_spec_tokens_rejected_total", "counter",
         stats["spec_tokens_rejected_total"]),
        ("dstack_tpu_serving_spec_draft_seconds_total", "counter",
         stats["spec_draft_seconds_total"]),
        ("dstack_tpu_serving_spec_verify_seconds_total", "counter",
         stats["spec_verify_seconds_total"]),
        ("dstack_tpu_serving_spec_accept_rate_ewma", "gauge",
         stats["spec_accept_rate_ewma"]),
        ("dstack_tpu_serving_spec_draft_len_mean", "gauge", stats["spec_draft_len_mean"]),
        # Prefill/decode disaggregation (zero on a unified engine).
        ("dstack_tpu_serving_kv_handoffs_sent_total", "counter",
         stats["kv_handoffs_sent_total"]),
        ("dstack_tpu_serving_kv_handoffs_received_total", "counter",
         stats["kv_handoffs_received_total"]),
        ("dstack_tpu_serving_kv_handoffs_stale_rejected_total", "counter",
         stats["kv_handoffs_stale_rejected_total"]),
        ("dstack_tpu_serving_kv_transfer_bytes_total", "counter",
         stats["kv_transfer_bytes_total"]),
        ("dstack_tpu_serving_kv_transfer_queue_depth", "gauge",
         stats["kv_transfer_queue_depth"]),
        # Multi-tenant LoRA (zero without lora_max_adapters).
        ("dstack_tpu_serving_adapters_loaded", "gauge", stats["adapters_loaded"]),
        # The kernel cache: library loads found on disk, nvcc builds, and
        # the builds' seconds (process-wide).
        ("dstack_tpu_compile_cache_hits_total", "counter",
         stats["compile_cache_hits_total"]),
        ("dstack_tpu_compile_cache_misses_total", "counter",
         stats["compile_cache_misses_total"]),
        ("dstack_tpu_compile_seconds_total", "counter", stats["compile_seconds_total"]),
    ]
    lines = []
    for name, mtype, value in series:
        lines.append(f"# TYPE {name} {mtype}")
        lines.append(f"{name} {value}")
    attn = "dstack_tpu_serving_attn_dispatch_total"
    lines.append(f"# TYPE {attn} counter")
    for path in ATTN_PATHS:
        lines.append(f'{attn}{{path="{path}"}}'
                     f' {stats.get(f"attn_dispatch_{path}_total", 0)}')
    role = stats.get("role", "unified")

    def _render_hist(base: str, hist: Dict[str, Any], hist_role: str = "",
                     emit_type: bool = True) -> None:
        r = hist_role or role
        if emit_type:
            lines.append(f"# TYPE {base} histogram")
        for le, cumulative in hist["buckets"]:
            lines.append(f'{base}_bucket{{le="{le}",role="{r}"}} {cumulative}')
        lines.append(f'{base}_bucket{{le="+Inf",role="{r}"}} {hist["count"]}')
        lines.append(f'{base}_sum{{role="{r}"}} {hist["sum"]}')
        lines.append(f'{base}_count{{role="{r}"}} {hist["count"]}')

    _render_hist("dstack_tpu_serving_ttft_seconds", stats["ttft_hist"])
    if stats["ttft_cold_hist"]["count"]:
        _render_hist("dstack_tpu_serving_ttft_seconds", stats["ttft_cold_hist"],
                     hist_role="cold_start", emit_type=False)
    _render_hist("dstack_tpu_serving_tpt_seconds", stats["tpt_hist"])
    _render_hist("dstack_tpu_serving_kv_transfer_seconds", stats["kv_transfer_hist"])
    # Host-tier swap-in latency (block swap-ins and slot readmissions).
    _render_hist("dstack_tpu_serving_kv_swap_in_seconds", stats["swap_in_hist"])
    wh = stats["warmup_hist"]
    wb = "dstack_tpu_serving_warmup_seconds"
    lines.append(f"# TYPE {wb} histogram")
    for le, cumulative in wh["buckets"]:
        lines.append(f'{wb}_bucket{{le="{le}"}} {cumulative}')
    lines.append(f'{wb}_bucket{{le="+Inf"}} {wh["count"]}')
    lines.append(f'{wb}_sum {wh["sum"]}')
    lines.append(f'{wb}_count {wh["count"]}')
    phase_hists = stats.get("phase_hists") or {}
    if phase_hists:
        base = "dstack_tpu_serving_phase_seconds"
        lines.append(f"# TYPE {base} histogram")
        for phase in sorted(phase_hists):
            hist = phase_hists[phase]
            labels = f'phase="{phase}",role="{role}"'
            for le, cumulative in hist["buckets"]:
                lines.append(f'{base}_bucket{{le="{le}",{labels}}} {cumulative}')
            lines.append(f'{base}_bucket{{le="+Inf",{labels}}} {hist["count"]}')
            lines.append(f'{base}_sum{{{labels}}} {hist["sum"]}')
            lines.append(f'{base}_count{{{labels}}} {hist["count"]}')
    return "\n".join(lines) + "\n"
