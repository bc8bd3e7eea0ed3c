"""Paged KV cache: block pool + prefix sharing + chunked prefill +
speculative draft/verify (port of `dstack_tpu.workloads.kv_blocks`).

`k`/`v` are per-layer block pools and each slot owns a block-table row
mapping its logical cache positions to pool blocks. A host-side
`BlockAllocator` refcounts blocks and keeps a hash-chained prefix cache;
`make_chunk_prefill` writes one prompt chunk straight into the pool and
`make_paged_decode_step` decodes every live slot against it;
`make_spec_draft` / `make_spec_verify` are the two halves of a
speculation round. Every attention goes through
`paged_attention.ragged_attention`, which on the card is the
hand-written CUDA kernel.

LoRA. `lora=True` builds the multi-tenant twin of the chunk, decode and
verify programs: each takes the adapter bank (lora_serving.py) and adds
each row's unmerged adapter delta inside the q/k/v projection
(`lora_serving.project_qkv_lora`). The chunk program takes its request's
bank slot; finalize writes it to `state.adapter_ix[slot]`, which the
batched programs gather by (-1 = no adapter, the bank's zero slot). The
batched programs take `has_lora`, whether any live slot carries an
adapter, as a host value (the engine knows it from its requests; None
reads it off the device, one sync); without one they run the plain
projection. The drafter stays adapter-free.

Writes. The JAX programs donate the pools and scatter with
`mode="drop"`, so a lane aimed at the out-of-range sentinel vanishes.
torch has no dropping scatter (an out-of-range index raises or corrupts
memory), so the pools are updated in place with `index_put_` and every
lane is masked before it writes: a lane that must not write (padding,
an inactive slot, a table entry that is the sentinel) is redirected to
the pool's discard block. The pools are allocated with one block more
than the tables can name — block `num_blocks`, never handed out and
never read — so that redirect needs no host sync to filter lanes.
Attention sees only the first `num_blocks` blocks.
"""

import hashlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from dstack_tpu_torch.workloads.config import ModelConfig, require_dense
from dstack_tpu_torch.workloads.device import host_to_device
from dstack_tpu_torch.workloads.generate import (
    _categorical,
    _nucleus_filter,
    sample_logits_row,
)
from dstack_tpu_torch.workloads.paged_attention import ragged_attention
from dstack_tpu_torch.workloads.transformer import (
    layer_params,
    linear,
    logits_linear,
    mlp_block,
    project_qkv,
    rms_norm,
)

Params = Dict[str, Any]


@dataclass
class PagedDecodeState:
    """Block-pool decode state. Per-slot fields carry the same names as
    serving.DecodeState so the sampling tail works on either."""

    k: torch.Tensor            # (L, num_blocks + 1, block_size, KV, hd)
    v: torch.Tensor            # block num_blocks is the discard block
    block_tables: torch.Tensor  # (B, max_blocks) int32; pad = num_blocks
    lengths: torch.Tensor      # (B,) int32 filled cache positions
    last_token: torch.Tensor   # (B,) int32 next token to feed
    active: torch.Tensor       # (B,) bool
    remaining: torch.Tensor    # (B,) int32 new tokens still budgeted
    temperature: torch.Tensor  # (B,) f32; 0 = greedy
    top_p: torch.Tensor        # (B,) f32; 1 = no filtering
    adapter_ix: torch.Tensor   # (B,) int32 LoRA bank slot; -1 = none

    @property
    def num_blocks(self) -> int:
        return self.k.shape[1] - 1

    def pools(self, layer: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Layer `layer`'s pools without the discard block (what
        attention reads)."""
        nb = self.num_blocks
        return self.k[layer, :nb], self.v[layer, :nb]


def init_paged_state(config: ModelConfig, batch: int, max_len: int,
                     block_size: int, num_blocks: int,
                     device: torch.device) -> PagedDecodeState:
    c = config
    if max_len % block_size != 0:
        raise ValueError(
            f"kv_block_size {block_size} must divide max_len {max_len}"
        )
    max_blocks = max_len // block_size
    shape = (c.n_layers, num_blocks + 1, block_size, c.n_kv_heads, c.head_dim)

    def z(dtype, fill=0):
        return torch.full((batch,), fill, dtype=dtype, device=device)

    return PagedDecodeState(
        k=torch.zeros(shape, dtype=c.activation_dtype, device=device),
        v=torch.zeros(shape, dtype=c.activation_dtype, device=device),
        block_tables=torch.full((batch, max_blocks), num_blocks,
                                dtype=torch.int32, device=device),
        lengths=z(torch.int32),
        last_token=z(torch.int32),
        active=z(torch.bool, False),
        remaining=z(torch.int32),
        temperature=z(torch.float32),
        top_p=z(torch.float32, 1.0),
        adapter_ix=z(torch.int32, -1),
    )


# -- host-side allocator ------------------------------------------------------


def _chain_hash(parent: bytes, block_tokens) -> bytes:
    """sha1 chain over block contents: a block's key commits to every
    token before it, so equal hashes mean equal logical prefixes."""
    return hashlib.sha1(parent + repr(tuple(block_tokens)).encode()).digest()


class BlockAllocator:
    """Refcounted free-list over the pool + LRU prefix cache (a copy of
    the JAX package's allocator, which is pure Python; its affinity
    digests come with that slice).

    NOT thread-safe — the engine serializes calls under its own lock.
    Refcount convention: `_ref[b]` counts holders (one per task/slot
    table referencing b, plus one if the prefix cache retains it). A
    block leaves the free list only via `alloc()` and returns only when
    its refcount hits zero; cached blocks therefore never free until
    evicted. Cache keys: `("F", h)` for a full block (h = chain hash
    through that block), `("P", h, tail_tokens)` for a partial tail
    whose parent chain is h. Evicting a parent leaves children
    unreachable (the match walk stops at the gap); they age out via LRU.

    `match`/`insert_full`/`insert_tail` take a `namespace`: a non-empty
    namespace seeds the hash chain, so two tenants with identical prompts
    but different KV contents never share a prefix block.

    Host tier (optional): `spill(key, block)` is called at the eviction
    seam in `alloc()` while the victim block's device contents are still
    intact, so the owner can ship its KV to host memory before the block
    is recycled. `swap_in(key) -> Optional[block]` is called on a cache
    miss in `match()`: the owner pulls the payload back into a freshly
    allocated block and returns it (ref=1, which becomes the cache's
    hold), or None. A swap-in may reenter `alloc()` and so spill (depth
    one); a spill never allocates, and neither hook reenters `match()`.
    """

    def __init__(self, num_blocks: int, block_size: int, cache: bool = True,
                 spill=None, swap_in=None):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.cache_enabled = cache
        self._spill = spill
        self._swap_in = swap_in
        self._free: List[int] = list(range(num_blocks))
        self._ref = [0] * num_blocks
        self._cache: "OrderedDict[tuple, int]" = OrderedDict()
        self._block_key: Dict[int, tuple] = {}
        self.hits = 0
        self.misses = 0
        self.host_hits = 0       # matches that pulled >=1 block from host
        self.tokens_reused = 0
        self.cow_copies = 0
        self.evictions = 0
        self._last_lookup_swapped = False

    @property
    def in_use(self) -> int:
        return self.num_blocks - len(self._free)

    @property
    def cached(self) -> int:
        return len(self._cache)

    def alloc(self) -> Optional[int]:
        """Pop a free block (ref=1), evicting the LRU cache entry whose
        block is solely cache-held if that's what it takes; None when
        every block is pinned by a live table."""
        if not self._free:
            victim = next((k for k, b in self._cache.items()
                           if self._ref[b] == 1), None)
            if victim is None:
                return None
            b = self._cache.pop(victim)
            del self._block_key[b]
            self.evictions += 1
            if self._spill is not None:
                # Nothing has written block b since the cache published it.
                self._spill(victim, b)
            self._ref[b] -= 1
            self._free.append(b)
        b = self._free.pop()
        self._ref[b] = 1
        return b

    def release(self, b: int) -> None:
        self._ref[b] -= 1
        if self._ref[b] < 0:
            raise RuntimeError(f"double release of block {b}")
        if self._ref[b] == 0:
            self._free.append(b)

    def retain(self, b: int) -> None:
        self._ref[b] += 1

    def ensure_writable(self, b: int) -> Tuple[Optional[int], bool]:
        """(block, needs_copy): a privately held block is returned as-is;
        a shared one is swapped for a fresh allocation the caller must
        copy-on-write into (our share of the old block is released)."""
        if self._ref[b] <= 1:
            return b, False
        nb = self.alloc()
        if nb is None:
            return None, False
        self._ref[b] -= 1
        self.cow_copies += 1
        return nb, True

    def match(self, tokens: List[int],
              namespace: bytes = b"") -> Tuple[List[int], int]:
        """Longest cached prefix of `tokens`: full blocks down the hash
        chain, then the longest partial tail. Matched blocks are RETAINED
        for the caller. At least one trailing token is always left
        uncovered — the prefill must compute the last prompt position's
        logits to sample the first token."""
        if not self.cache_enabled:
            return [], 0
        bs = self.block_size
        limit = len(tokens) - 1
        blocks: List[int] = []
        h = self._ns_seed(namespace)
        matched = 0
        swapped_in = False
        while (len(blocks) + 1) * bs <= limit:
            h2 = _chain_hash(h, tokens[matched:matched + bs])
            b = self._lookup(("F", h2))
            if b is None:
                break
            swapped_in = swapped_in or self._last_lookup_swapped
            self._ref[b] += 1
            blocks.append(b)
            matched += bs
            h = h2
        for f in range(min(limit - matched, bs - 1), 0, -1):
            b = self._lookup(("P", h, tuple(tokens[matched:matched + f])))
            if b is not None:
                swapped_in = swapped_in or self._last_lookup_swapped
                self._ref[b] += 1
                blocks.append(b)
                matched += f
                break
        if matched:
            self.hits += 1
            if swapped_in:
                self.host_hits += 1
        else:
            self.misses += 1
        self.tokens_reused += matched
        return blocks, matched

    def _lookup(self, key: tuple) -> Optional[int]:
        """Cache probe with the host-tier fallback: a device hit bumps the
        entry to most-recently-used; a miss asks `swap_in` to bring the
        block back from host memory and republishes it under `key`."""
        self._last_lookup_swapped = False
        b = self._cache.get(key)
        if b is not None:
            self._cache.move_to_end(key)
            return b
        if self._swap_in is None:
            return None
        b = self._swap_in(key)
        if b is None:
            return None
        self._cache[key] = b
        self._block_key[b] = key
        self._last_lookup_swapped = True
        return b

    @staticmethod
    def _ns_seed(namespace: bytes) -> bytes:
        """Chain seed for a tenant namespace. Hashed (not raw) so a crafted
        name can't alias another namespace's 20-byte chain digest; the
        empty namespace keeps the un-namespaced chain."""
        if not namespace:
            return b""
        return hashlib.sha1(b"ns:" + namespace).digest()

    def insert_full(self, tokens: List[int], table: List[int],
                    namespace: bytes = b"") -> None:
        """Publish every complete prompt block of a finalized prefill.
        Called at finalize dispatch: stream order guarantees the chunk
        writes run before any later matcher's attention reads them."""
        if not self.cache_enabled:
            return
        bs = self.block_size
        h = self._ns_seed(namespace)
        for i in range(len(tokens) // bs):
            h = _chain_hash(h, tokens[i * bs:(i + 1) * bs])
            key = ("F", h)
            if key in self._cache:
                self._cache.move_to_end(key)
                continue
            if i >= len(table) or table[i] in self._block_key:
                continue
            b = table[i]
            self._cache[key] = b
            self._block_key[b] = key
            self._ref[b] += 1

    def insert_tail(self, tokens: List[int], table: List[int],
                    namespace: bytes = b"") -> None:
        """Publish the partial-tail prompt block at RETIRE time (no live
        writer left). The block also holds this request's decode KV past
        the tail — harmless: a matcher's valid region ends at the tail."""
        if not self.cache_enabled:
            return
        bs = self.block_size
        nfull = len(tokens) // bs
        f = len(tokens) - nfull * bs
        if f == 0 or nfull >= len(table):
            return
        h = self._ns_seed(namespace)
        for i in range(nfull):
            h = _chain_hash(h, tokens[i * bs:(i + 1) * bs])
        key = ("P", h, tuple(tokens[nfull * bs:]))
        if key in self._cache or table[nfull] in self._block_key:
            return
        b = table[nfull]
        self._cache[key] = b
        self._block_key[b] = key
        self._ref[b] += 1

    def drop_cache(self) -> int:
        """Forget every cached prefix entry (the cached KV became invalid
        wholesale — e.g. a weight refresh: old-policy keys/values must
        never graft under new params). Cache-only holds return to the
        free list; table-held blocks just lose their cache entry and
        free when the table retires. Nothing is spilled — KV that no
        longer matches the model is not worth host RAM either. Returns
        the number of entries dropped."""
        n = len(self._cache)
        for b in self._cache.values():
            del self._block_key[b]
            self.release(b)
        self._cache.clear()
        return n

    # Affinity-sketch digest width: 16 hex chars (64 bits) of the sha1
    # chain hash, as the reference and the fleet router cut them.
    DIGEST_HEX = 16

    def affinity_digests(self, limit: int = 512) -> List[str]:
        """Resident full-block chain-head digests for the routing affinity
        sketch, most recently used last, bounded to the `limit` hottest
        (the OrderedDict's order is the LRU order). Partial-tail entries
        are left out: a router cannot rebuild their tail-token keys. The
        digests commit to the tenant namespace (insert_full seeds the
        chain with _ns_seed): equal digests need equal namespace and
        tokens."""
        digests = [key[1].hex()[: self.DIGEST_HEX]
                   for key in self._cache if key[0] == "F"]
        return digests[-limit:]

    def stats(self) -> Dict[str, int]:
        return {
            "blocks_total": self.num_blocks,
            "blocks_in_use": self.in_use,
            "blocks_cached": self.cached,
            "hits": self.hits,
            "misses": self.misses,
            "host_hits": self.host_hits,
            "tokens_reused": self.tokens_reused,
            "cow_copies": self.cow_copies,
            "evictions": self.evictions,
        }


# -- device programs ----------------------------------------------------------


def _write_rows(pool: torch.Tensor, blk: torch.Tensor, off: torch.Tensor,
                rows: torch.Tensor) -> None:
    """pool[blk[i], off[i]] = rows[i], in place (the JAX programs donate
    the pool). Lanes that must not write already point at the discard
    block."""
    pool.index_put_((blk.to(torch.int64), off.to(torch.int64)),
                    rows.to(pool.dtype))


def _window_lanes(tables: torch.Tensor, positions: torch.Tensor,
                  ok: torch.Tensor, nb: int, bs: int):
    """(blk, off) write lanes for cache `positions` (B, S) through the
    slots' block tables; a lane that must not write (`ok` false, or a
    sentinel table entry) is aimed at the discard block `nb`."""
    mb = tables.shape[1]
    blk = torch.gather(tables, 1,
                       torch.clamp(positions // bs, 0, mb - 1).to(torch.int64))
    blk = torch.where(ok & (blk < nb), blk, torch.full_like(blk, nb))
    return blk, positions % bs


def _lora_qkv(c: ModelConfig, bank, adapter_ix, has_lora: bool):
    """qkv(x, p, layer, positions) for a program: `project_qkv`, or with a
    bank and an adapter in the batch `lora_serving.project_qkv_lora` on the
    layer's bank slice with the sanitised index and scale (computed once
    per program call)."""
    if bank is None or not has_lora:
        return lambda x, p, layer, positions: project_qkv(c, x, p, positions)
    from dstack_tpu_torch.workloads.lora_serving import (
        bank_layer,
        project_qkv_lora,
        safe_index,
    )

    ix, scale = safe_index(bank, adapter_ix)
    return lambda x, p, layer, positions: project_qkv_lora(
        c, x, p, positions, bank_layer(bank, layer), ix, scale, has_lora)


def _has_lora(state: "PagedDecodeState", active: torch.Tensor,
              has_lora: Optional[bool]) -> bool:
    """Whether any live slot carries an adapter: the caller's host value,
    or read off the device (one sync)."""
    if has_lora is None:
        has_lora = bool((active & (state.adapter_ix >= 0)).any())
    return has_lora


def make_chunk_prefill(config: ModelConfig, chunk: int, lora: bool = False):
    """chunk_prefill(params, state, slot, table_row (MB,), tokens (C,),
    n_valid, start, budget, temp, top_p, generator, finalize) ->
    (state, first, logits).

    Runs ONE padded chunk (C = `chunk` tokens, the first `n_valid` real)
    of one prompt at cache positions [start, start + n_valid) straight
    into the slot's pool blocks; `state` is updated in place and returned.
    Scalars and the table row arrive from the host. With `finalize` (the
    last chunk) it samples the first token from the last prompt
    position's logits — `first` is a 0-d int32 device tensor, read back
    by the caller when it needs it — and flips the slot live on the
    device (lengths, last_token, active, ...); `logits` is the f32
    last-position logits row `first` was sampled from. Without finalize
    both are None and the lm-head is skipped.

    With `lora=True` the program takes two trailing args, the request's
    bank slot (an int, -1 = none) and the adapter bank, and applies the
    request's delta in the q/k/v projection; finalize records the slot in
    `state.adapter_ix` (the plain program's finalize records -1, so a slot
    reused by an adapter-free request resets).
    """
    c = config
    require_dense(c)

    def _impl(params, state: PagedDecodeState, slot: int,
              table_row: Sequence[int], tokens: Sequence[int],
              n_valid: int, start: int, budget: int, temp: float,
              top_p: float, generator: Optional[torch.Generator],
              finalize: bool, adapter_ix: int, bank):
        if len(tokens) != chunk:
            raise ValueError(f"chunk program for {chunk} tokens got {len(tokens)}")
        dev = state.k.device
        nb = state.num_blocks
        bs = state.k.shape[2]
        mb = state.block_tables.shape[1]
        row = host_to_device(table_row, torch.int32, dev)       # (MB,)
        toks = host_to_device([tokens], torch.int32, dev)       # (1, C)
        positions = start + torch.arange(chunk, device=dev)     # (C,)
        # Pool write targets for the n_valid real rows: masked first
        # (sentinel table entries -> discard block), then written.
        pos_w = positions[:n_valid]
        blk = row[torch.clamp(pos_w // bs, max=mb - 1)]
        blk = torch.where(blk < nb, blk, torch.full_like(blk, nb))
        off = pos_w % bs
        # Row i of the chunk attends cache positions <= start + i.
        valid_len = (positions + 1).to(torch.int32)[None]       # (1, C)
        tables = row[None]

        x = params["embed"][toks]                               # (1, C, d)
        qkv = _lora_qkv(c, bank, int(adapter_ix), adapter_ix >= 0)
        for layer in range(c.n_layers):
            p = layer_params(params, layer)
            q, k, v = qkv(x, p, layer, positions)
            # Write the chunk's rows FIRST, then attend: row i sees the
            # rows just written up to its own position.
            _write_rows(state.k[layer], blk, off, k[0, :n_valid])
            _write_rows(state.v[layer], blk, off, v[0, :n_valid])
            kp, vp = state.pools(layer)
            attn = ragged_attention(q, kp, vp, tables, valid_len)
            x = x + linear(attn, p["wo"])
            x = mlp_block(c, x, p)

        state.block_tables[slot] = row
        if not finalize:
            return state, None, None
        h_last = rms_norm(x[0, max(min(n_valid - 1, chunk - 1), 0)],
                          params["final_norm"], c.norm_eps)
        logits = logits_linear(h_last[None], params["lm_head"])[0]
        first = sample_logits_row(logits, temp, top_p, generator)
        state.lengths[slot] = start + n_valid
        state.last_token[slot] = first
        state.active[slot] = budget > 1
        state.remaining[slot] = budget - 1
        state.temperature[slot] = temp
        state.top_p[slot] = top_p
        state.adapter_ix[slot] = adapter_ix
        return state, first, logits

    if lora:
        def chunk_prefill_lora(params, state, slot, table_row, tokens, n_valid,
                               start, budget, temp, top_p, generator, finalize,
                               adapter_ix: int, bank):
            return _impl(params, state, slot, table_row, tokens, n_valid, start,
                         budget, temp, top_p, generator, finalize, adapter_ix, bank)

        return chunk_prefill_lora

    def chunk_prefill(params, state, slot, table_row, tokens, n_valid, start,
                      budget, temp, top_p, generator, finalize):
        return _impl(params, state, slot, table_row, tokens, n_valid, start,
                     budget, temp, top_p, generator, finalize, -1, None)

    return chunk_prefill


def make_paged_decode_step(config: ModelConfig, steps: int = 1, lora: bool = False):
    """decode_steps(params, state, generator, sampling=None, nucleus=None)
    -> (state, tokens (B, steps) int32, active (B,)) over a
    PagedDecodeState, updated in place — the paged twin of
    serving.make_decode_step. With `lora=True`:
    decode_steps_lora(params, state, generator, bank, sampling=None,
    nucleus=None, has_lora=None), each slot adding the delta of its
    `state.adapter_ix` (has_lora: whether any live slot carries one, a
    host value; None reads it off the device).

    Each of the `steps` iterations writes the new row's K/V straight into
    each slot's current block and attends raggedly over the block tables.
    Inactive slots never write: their table rows may be stale (blocks
    freed to the cache or another slot at retire), so their lanes are
    aimed at the discard block. Nothing here reads the device from the
    host: the caller reads the returned tokens once per call.
    `sampling` / `nucleus` say whether any live slot samples / filters
    (the engine knows from its requests); None reads it off the state,
    which costs one sync.
    """
    c = config
    require_dense(c)
    from dstack_tpu_torch.workloads import serving as _serving

    def one_step(params, state: PagedDecodeState, generator, sampling, nucleus,
                 qkv):
        nb, bs = state.num_blocks, state.k.shape[2]
        B, mb = state.block_tables.shape
        ml = mb * bs
        lengths = state.lengths
        positions = lengths[:, None]                          # (B, 1)
        x = params["embed"][state.last_token[:, None]]        # (B, 1, d)
        blk, off = _window_lanes(state.block_tables, positions,
                                 (state.active & (lengths < ml))[:, None], nb, bs)
        blk, off = blk[:, 0], off[:, 0]
        valid_len = (lengths + 1)[:, None]                    # (B, 1) int32
        for layer in range(c.n_layers):
            p = layer_params(params, layer)
            q, k, v = qkv(x, p, layer, positions)
            _write_rows(state.k[layer], blk, off, k[:, 0])
            _write_rows(state.v[layer], blk, off, v[:, 0])
            kp, vp = state.pools(layer)
            attn = ragged_attention(q, kp, vp, state.block_tables, valid_len)
            x = x + linear(attn, p["wo"])
            x = mlp_block(c, x, p)
        h = rms_norm(x, params["final_norm"], c.norm_eps)
        logits = logits_linear(h[:, -1], params["lm_head"])
        next_token = _serving._select_next_token(
            state, logits, generator, sampling=sampling, nucleus=nucleus)

        act = state.active
        remaining = state.remaining - act.to(torch.int32)
        new_active = act & (remaining > 0) & (lengths + 2 <= ml)
        emitted = torch.where(act, next_token, torch.full_like(next_token, -1))
        state.last_token = torch.where(act, next_token, state.last_token)
        state.lengths = lengths + act.to(torch.int32)
        state.remaining = remaining
        state.active = new_active
        return emitted

    def _run(params, state, generator, sampling, nucleus, qkv):
        toks = [one_step(params, state, generator, sampling, nucleus, qkv)
                for _ in range(steps)]
        return state, torch.stack(toks, dim=1), state.active

    if lora:
        def decode_steps_lora(params, state: PagedDecodeState, generator, bank,
                              sampling: Optional[bool] = None,
                              nucleus: Optional[bool] = None,
                              has_lora: Optional[bool] = None):
            # One decision for the whole chunk: a slot only retires inside
            # it, so the chunk's first state over-approximates the rest.
            qkv = _lora_qkv(c, bank, state.adapter_ix,
                            _has_lora(state, state.active, has_lora))
            return _run(params, state, generator, sampling, nucleus, qkv)

        return decode_steps_lora

    plain_qkv = _lora_qkv(c, None, None, False)

    def decode_steps(params, state: PagedDecodeState, generator,
                     sampling: Optional[bool] = None,
                     nucleus: Optional[bool] = None):
        return _run(params, state, generator, sampling, nucleus, plain_qkv)

    return decode_steps


# -- speculative decoding (draft k cheap tokens, verify in one forward) -------


def _sampling_probs(logits: torch.Tensor, temps: torch.Tensor,
                    top_ps: torch.Tensor,
                    nucleus: Optional[bool] = None) -> torch.Tensor:
    """Per-slot sampling distributions under the engine's semantics:
    logits (B, S, V), temps / top_ps (B,) -> probs (B, S, V). Temperature
    scale guarded like `_select_next_token` (greedy slots do not divide
    by 0), nucleus filter through the shared `generate._nucleus_filter`,
    gated so traffic where no sampling slot filters never pays the vocab
    sort. Rejection sampling is exact only if the drafter's q and the
    target's p both come from this function. `nucleus` is the gate as a
    host value; None reads it off the device (one sync)."""
    scaled = logits / torch.clamp(temps, min=1e-6)[:, None, None]
    if nucleus is None:
        nucleus = bool(((temps > 0.0) & (top_ps < 1.0)).any())
    if nucleus:
        scaled = _nucleus_filter(scaled, top_ps[:, None, None])
    return torch.softmax(scaled, dim=-1)


def make_spec_draft(config: ModelConfig, k: int):
    """spec_draft(params, draft_state, block_tables, lengths, last_token,
    active, temps, top_ps, generator, sampling=None, nucleus=None) ->
    (drafts (B, k) int32, qlogits (B, k, V) f32).

    The drafter's half of a speculation round: k+1 single-token drafter
    steps against the DRAFTER's pools (`draft_state.k` / `.v`, updated in
    place), through the TARGET's block tables — one allocator indexes
    both pools, so prefix sharing and copy-on-write apply to both. Step i
    feeds the previous token at position lengths+i and proposes the next:
    steps 0..k-1 yield d_1..d_k; step k's token is thrown away, but its
    KV write (row lengths+k, the KV of d_k) is what lets a fully accepted
    round go on without a catch-up pass — the drafter's rows always
    cover the target's new length, whatever the acceptance count.
    Inactive slots (their tables may be stale) and rows past max_len
    write to the discard block. `qlogits` are the logits behind each
    draft, from which the verify recomputes q with `_sampling_probs`.
    `sampling` / `nucleus` say whether any live slot samples / filters
    (host values; None reads them off the device)."""
    c = config
    require_dense(c)

    def spec_draft(params, draft_state: PagedDecodeState, block_tables,
                   lengths, last_token, active, temps, top_ps,
                   generator: Optional[torch.Generator],
                   sampling: Optional[bool] = None,
                   nucleus: Optional[bool] = None):
        nb, bs = draft_state.num_blocks, draft_state.k.shape[2]
        mb = block_tables.shape[1]
        ml = mb * bs
        if sampling is None:
            sampling = bool((active & (temps > 0.0)).any())
        pos, token = lengths, last_token
        toks, logits_k = [], []
        for _ in range(k + 1):
            x = params["embed"][token[:, None]]                 # (B, 1, d)
            blk, off = _window_lanes(block_tables, pos[:, None],
                                     (active & (pos < ml))[:, None], nb, bs)
            valid_len = (pos + 1).to(torch.int32)[:, None]
            for layer in range(c.n_layers):
                p = layer_params(params, layer)
                q, kk, vv = project_qkv(c, x, p, pos[:, None])
                _write_rows(draft_state.k[layer], blk[:, 0], off[:, 0], kk[:, 0])
                _write_rows(draft_state.v[layer], blk[:, 0], off[:, 0], vv[:, 0])
                kp, vp = draft_state.pools(layer)
                attn = ragged_attention(q, kp, vp, block_tables, valid_len)
                x = x + linear(attn, p["wo"])
                x = mlp_block(c, x, p)
            h = rms_norm(x, params["final_norm"], c.norm_eps)
            logits = logits_linear(h[:, -1], params["lm_head"])  # (B, V)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            if sampling:
                probs = _sampling_probs(logits[:, None], temps, top_ps, nucleus)[:, 0]
                sampled = _categorical(torch.log(probs.clamp_min(1e-38)), generator)
                nxt = torch.where(temps > 0, sampled, nxt)
            toks.append(nxt)
            logits_k.append(logits)
            pos, token = pos + 1, nxt
        return torch.stack(toks[:k], dim=1), torch.stack(logits_k[:k], dim=1)

    return spec_draft


def make_spec_verify(config: ModelConfig, k: int, lora: bool = False):
    """spec_verify(params, state, drafts (B, k), qlogits (B, k, V),
    generator, sampling=None, nucleus=None) -> (state, emitted (B, k+1),
    accepted (B,), active (B,)), state updated in place.

    The target's half: a (B, k+1) forward over [last_token, d_1..d_k] at
    positions lengths..lengths+k, every row written into the slot's pool
    blocks first and attended raggedly with valid lengths positions+1,
    so logits[:, j] conditions on the drafts up to d_j as the sequential
    decode body would. Temperature-0 slots accept the leading run of
    drafts that match the target's argmax (token-exact with plain
    decode); sampling slots accept d_j where u_j * q_j(d_j) < p_j(d_j),
    draw the correction token from norm(max(p_m - q_m, 0)) (p_m when that
    sum is 0) and the bonus token from p_k when all k are accepted, which
    keeps the target's distribution (arXiv:2211.17192). Emission caps
    (`remaining`, and no write past max_len - 1) and the retire rules are
    `make_paged_decode_step`'s. Rollback is length gating over a window
    the engine made private before the round (`_ensure_spec_writable`):
    rejected rows sit past the new length, masked, until overwritten.
    `emitted` is -1-padded past each slot's emissions; `accepted` is the
    uncapped accepted count m.

    With `lora=True`: spec_verify_lora(params, state, drafts, qlogits,
    generator, bank, sampling=None, nucleus=None, has_lora=None). The
    TARGET applies each slot's adapter delta (`state.adapter_ix`), so the
    accept test scores the tenant's own distribution; the drafter stays
    adapter-free, which lowers acceptance, never correctness."""
    c = config
    require_dense(c)
    S = k + 1

    def _impl(params, state: PagedDecodeState, drafts, qlogits,
              generator: Optional[torch.Generator], sampling: Optional[bool],
              nucleus: Optional[bool], bank, has_lora: Optional[bool]):
        nb, bs = state.num_blocks, state.k.shape[2]
        B, mb = state.block_tables.shape
        ml = mb * bs
        dev = state.k.device
        lens, act0 = state.lengths, state.active
        offs = torch.arange(S, dtype=torch.int32, device=dev)
        drafts = drafts.to(torch.int32)
        tokens = torch.cat([state.last_token[:, None], drafts], dim=1)  # (B, S)
        positions = lens[:, None] + offs[None, :]
        blk, off = _window_lanes(state.block_tables, positions,
                                 act0[:, None] & (positions < ml), nb, bs)
        blk, off = blk.reshape(-1), off.reshape(-1)
        valid_len = (positions + 1).to(torch.int32)
        x = params["embed"][tokens]                                     # (B, S, d)
        qkv = _lora_qkv(c, bank, state.adapter_ix,
                        bank is not None and _has_lora(state, act0, has_lora))
        for layer in range(c.n_layers):
            p = layer_params(params, layer)
            q, kk, vv = qkv(x, p, layer, positions)
            _write_rows(state.k[layer], blk, off, kk.reshape(B * S, *kk.shape[2:]))
            _write_rows(state.v[layer], blk, off, vv.reshape(B * S, *vv.shape[2:]))
            kp, vp = state.pools(layer)
            attn = ragged_attention(q, kp, vp, state.block_tables, valid_len)
            x = x + linear(attn, p["wo"])
            x = mlp_block(c, x, p)
        h = rms_norm(x, params["final_norm"], c.norm_eps)
        logits = logits_linear(h, params["lm_head"])                    # (B, S, V)

        temps = state.temperature
        if sampling is None:
            sampling = bool((act0 & (temps > 0.0)).any())
        greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)       # (B, S)
        ok = greedy_tok[:, :k] == drafts
        if sampling:
            samp = temps > 0
            p_probs = _sampling_probs(logits, temps, state.top_p, nucleus)
            q_probs = _sampling_probs(qlogits, temps, state.top_p, nucleus)
            idx = drafts.to(torch.int64)[:, :, None]
            p_at = torch.gather(p_probs[:, :k], 2, idx)[:, :, 0]
            q_at = torch.gather(q_probs, 2, idx)[:, :, 0]
            u = torch.rand((B, k), generator=generator, device=dev)
            ok = torch.where(samp[:, None], u * q_at < p_at, ok)
        m = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1).to(torch.int32)
        m64 = m.to(torch.int64)
        bonus = torch.gather(greedy_tok, 1, m64[:, None])[:, 0]
        if sampling:
            rows = torch.arange(B, device=dev)
            p_m = p_probs[rows, m64]
            q_pad = torch.cat([q_probs, torch.zeros_like(q_probs[:, :1])], dim=1)
            q_m = q_pad[rows, m64]
            resid = torch.clamp(p_m - q_m, min=0.0)
            r_sum = resid.sum(dim=-1, keepdim=True)
            resid = torch.where(r_sum > 0, resid / torch.clamp(r_sum, min=1e-38), p_m)
            bonus_samp = _categorical(torch.log(resid.clamp_min(1e-38)), generator)
            bonus = torch.where(samp, bonus_samp, bonus)

        cap = torch.clamp(ml - 1 - lens, min=0)
        n_emit = torch.where(act0, torch.minimum(torch.minimum(m + 1, state.remaining), cap),
                             torch.zeros_like(m)).to(torch.int32)
        seq = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
        seq = torch.where(offs[None, :] == m[:, None], bonus[:, None], seq)
        emitted = torch.where(offs[None, :] < n_emit[:, None], seq, torch.full_like(seq, -1))
        new_len = lens + n_emit
        new_rem = state.remaining - n_emit
        new_act = act0 & (new_rem > 0) & (new_len + 2 <= ml)
        last_emitted = torch.gather(
            emitted, 1, torch.clamp(n_emit - 1, 0, k).to(torch.int64)[:, None])[:, 0]
        state.last_token = torch.where(n_emit > 0, last_emitted, state.last_token)
        state.lengths = new_len
        state.remaining = new_rem
        state.active = new_act
        accepted = torch.where(act0, m, torch.zeros_like(m))
        return state, emitted, accepted, new_act

    if lora:
        def spec_verify_lora(params, state: PagedDecodeState, drafts, qlogits,
                             generator: Optional[torch.Generator], bank,
                             sampling: Optional[bool] = None,
                             nucleus: Optional[bool] = None,
                             has_lora: Optional[bool] = None):
            return _impl(params, state, drafts, qlogits, generator, sampling,
                         nucleus, bank, has_lora)

        return spec_verify_lora

    def spec_verify(params, state: PagedDecodeState, drafts, qlogits,
                    generator: Optional[torch.Generator],
                    sampling: Optional[bool] = None,
                    nucleus: Optional[bool] = None):
        return _impl(params, state, drafts, qlogits, generator, sampling,
                     nucleus, None, None)

    return spec_verify


def make_copy_block():
    """copy_block(state, src, dst) -> state: copy one pool block across
    every layer, in place — the device half of copy-on-write (the
    allocator's `ensure_writable` picks dst)."""

    def copy_block(state: PagedDecodeState, src: int, dst: int) -> PagedDecodeState:
        state.k[:, dst] = state.k[:, src]
        state.v[:, dst] = state.v[:, src]
        return state

    return copy_block
