"""Paged KV cache: block pool + prefix sharing + chunked prefill (port of
`dstack_tpu.workloads.kv_blocks`, serving slice).

`k`/`v` are per-layer block pools and each slot owns a block-table row
mapping its logical cache positions to pool blocks. A host-side
`BlockAllocator` refcounts blocks and keeps a hash-chained prefix cache;
`make_chunk_prefill` writes one prompt chunk straight into the pool and
`make_paged_decode_step` decodes every live slot against it. Every
attention goes through `paged_attention.ragged_attention`, which on the
card is the hand-written CUDA kernel.

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
from dstack_tpu_torch.workloads.generate import sample_logits_row
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
    )


# -- host-side allocator ------------------------------------------------------


def _chain_hash(parent: bytes, block_tokens) -> bytes:
    """sha1 chain over block contents: a block's key commits to every
    token before it, so equal hashes mean equal logical prefixes."""
    return hashlib.sha1(parent + repr(tuple(block_tokens)).encode()).digest()


class BlockAllocator:
    """Refcounted free-list over the pool + LRU prefix cache (a copy of
    the JAX package's allocator, which is pure Python; its host-tier
    spill/swap-in hooks and affinity digests come with those slices).

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
    """

    def __init__(self, num_blocks: int, block_size: int, cache: bool = True):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.cache_enabled = cache
        self._free: List[int] = list(range(num_blocks))
        self._ref = [0] * num_blocks
        self._cache: "OrderedDict[tuple, int]" = OrderedDict()
        self._block_key: Dict[int, tuple] = {}
        self.hits = 0
        self.misses = 0
        self.tokens_reused = 0
        self.cow_copies = 0
        self.evictions = 0

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
        while (len(blocks) + 1) * bs <= limit:
            h2 = _chain_hash(h, tokens[matched:matched + bs])
            b = self._lookup(("F", h2))
            if b is None:
                break
            self._ref[b] += 1
            blocks.append(b)
            matched += bs
            h = h2
        for f in range(min(limit - matched, bs - 1), 0, -1):
            b = self._lookup(("P", h, tuple(tokens[matched:matched + f])))
            if b is not None:
                self._ref[b] += 1
                blocks.append(b)
                matched += f
                break
        if matched:
            self.hits += 1
        else:
            self.misses += 1
        self.tokens_reused += matched
        return blocks, matched

    def _lookup(self, key: tuple) -> Optional[int]:
        """Cache probe; a hit bumps the entry to most-recently-used."""
        b = self._cache.get(key)
        if b is not None:
            self._cache.move_to_end(key)
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

    def stats(self) -> Dict[str, int]:
        return {
            "blocks_total": self.num_blocks,
            "blocks_in_use": self.in_use,
            "blocks_cached": self.cached,
            "hits": self.hits,
            "misses": self.misses,
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


def make_chunk_prefill(config: ModelConfig, chunk: int):
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
    """
    c = config
    require_dense(c)

    def chunk_prefill(params, state: PagedDecodeState, slot: int,
                      table_row: Sequence[int], tokens: Sequence[int],
                      n_valid: int, start: int, budget: int, temp: float,
                      top_p: float, generator: Optional[torch.Generator],
                      finalize: bool):
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
        for layer in range(c.n_layers):
            p = layer_params(params, layer)
            q, k, v = project_qkv(c, x, p, positions)
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
        return state, first, logits

    return chunk_prefill


def make_paged_decode_step(config: ModelConfig, steps: int = 1):
    """decode_steps(params, state, generator, sampling=None, nucleus=None)
    -> (state, tokens (B, steps) int32, active (B,)) over a
    PagedDecodeState, updated in place — the paged twin of
    serving.make_decode_step.

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

    def one_step(params, state: PagedDecodeState, generator, sampling, nucleus):
        nb, bs = state.num_blocks, state.k.shape[2]
        B, mb = state.block_tables.shape
        ml = mb * bs
        lengths = state.lengths
        positions = lengths[:, None]                          # (B, 1)
        x = params["embed"][state.last_token[:, None]]        # (B, 1, d)
        write_ok = state.active & (lengths < ml)
        blk = torch.gather(
            state.block_tables, 1,
            torch.clamp(lengths // bs, 0, mb - 1)[:, None].to(torch.int64),
        )[:, 0]
        blk = torch.where(write_ok & (blk < nb), blk, torch.full_like(blk, nb))
        off = lengths % bs
        valid_len = (lengths + 1)[:, None]                    # (B, 1) int32
        for layer in range(c.n_layers):
            p = layer_params(params, layer)
            q, k, v = project_qkv(c, x, p, positions)
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

    def decode_steps(params, state: PagedDecodeState, generator,
                     sampling: Optional[bool] = None,
                     nucleus: Optional[bool] = None):
        toks = [one_step(params, state, generator, sampling, nucleus)
                for _ in range(steps)]
        return state, torch.stack(toks, dim=1), state.active

    return decode_steps


def make_copy_block():
    """copy_block(state, src, dst) -> state: copy one pool block across
    every layer, in place — the device half of copy-on-write (the
    allocator's `ensure_writable` picks dst)."""

    def copy_block(state: PagedDecodeState, src: int, dst: int) -> PagedDecodeState:
        state.k[:, dst] = state.k[:, src]
        state.v[:, dst] = state.v[:, src]
        return state

    return copy_block
