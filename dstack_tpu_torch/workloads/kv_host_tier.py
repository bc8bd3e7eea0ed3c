"""Host-memory KV block tier: the spill target behind `BlockAllocator`
(port of `dstack_tpu.workloads.kv_host_tier`).

With a host tier attached, a prefix-cache block that LRU eviction takes
from the device pool ships its KV to host RAM instead of dying, and its
chain key stays matchable: a later prefix hit on a spilled key swaps the
block back onto the device, which beats a re-prefill whenever the copy
beats a prefill chunk through the model.

The tier also pins whole swapped-out SLOTS for engine preemption: a
preempted request's live block chain (KV + sampling state) parks here
until readmission. Pinned bytes are reserved capacity: spilled blocks are
best-effort LRU and may be dropped to make room, but a pinned slot is
never evicted (dropping it would corrupt a live request), so `reserve`
refuses when dropping spills cannot free enough.

Payloads are host tensors: the engine copies them off the card into
page-locked memory and waits for the copy before it hands them over, so
a block the tier holds never changes after `put`. They are kept as
tensors, never routed through numpy (torch hands no bf16 tensor to
numpy). A payload's byte count is the sum of its tensors' raw bytes, as
the reference counts its packed buffers; the reference's array frames
(`pack_arrays`) belong to KV transfer, which is not ported.
"""

from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import torch


def payload_bytes(named: List[Tuple[str, torch.Tensor]]) -> int:
    return sum(t.numel() * t.element_size() for _, t in named)


class HostKVTier:
    """Budgeted LRU store of spilled KV blocks, keyed by allocator
    prefix-cache chain keys, plus a reservation ledger for pinned
    swapped-slot payloads. Not thread-safe on its own: every call site is
    the engine loop thread under the engine lock (or a test)."""

    def __init__(self, budget_bytes: int):
        if budget_bytes <= 0:
            raise ValueError("host tier budget must be positive")
        self.budget_bytes = int(budget_bytes)
        # key -> (name -> host tensor, nbytes); insertion order is LRU.
        self._spilled: "OrderedDict[Any, Tuple[Dict[str, torch.Tensor], int]]" = (
            OrderedDict()
        )
        self.spill_bytes = 0
        self.pinned_bytes = 0
        self.spills_total = 0        # blocks accepted into the tier
        self.swap_ins_total = 0      # blocks pulled back to device
        self.evictions_total = 0     # spilled blocks LRU-dropped
        self.dropped_total = 0       # put() refused (payload over budget)

    # -- spilled prefix-cache blocks -------------------------------------

    def _evict_lru(self) -> bool:
        if not self._spilled:
            return False
        _, (_, nbytes) = self._spilled.popitem(last=False)
        self.spill_bytes -= nbytes
        self.evictions_total += 1
        return True

    def _make_room(self, nbytes: int) -> bool:
        while self.spill_bytes + self.pinned_bytes + nbytes > self.budget_bytes:
            if not self._evict_lru():
                return False
        return True

    def put(self, key: Any, named: List[Tuple[str, torch.Tensor]]) -> bool:
        """Spill one block's tensors under `key`. Returns False (and counts
        a drop) when the payload cannot fit even after evicting every
        unpinned entry; the block then just dies, as it did before the
        tier existed. Every tensor must already live in host memory."""
        if any(t.device.type != "cpu" for _, t in named):
            raise ValueError("host tier payloads must be host tensors")
        nbytes = payload_bytes(named)
        if key in self._spilled:
            self._drop(key)
        if not self._make_room(nbytes):
            self.dropped_total += 1
            return False
        self._spilled[key] = (dict(named), nbytes)
        self.spill_bytes += nbytes
        self.spills_total += 1
        return True

    def has(self, key: Any) -> bool:
        return key in self._spilled

    def get(self, key: Any) -> Optional[Dict[str, torch.Tensor]]:
        """Peek a spilled payload (marks it most-recently-used). The entry
        stays in the tier until `pop`: a swap-in that finds no device block
        must not lose the data. Callers read the tensors, never write them."""
        entry = self._spilled.get(key)
        if entry is None:
            return None
        self._spilled.move_to_end(key)
        return dict(entry[0])

    def pop(self, key: Any) -> None:
        """Drop a spilled entry after a successful swap-in."""
        if self._drop(key):
            self.swap_ins_total += 1

    def discard(self, key: Any) -> None:
        """Drop a spilled entry without counting a swap-in."""
        self._drop(key)

    def clear(self) -> int:
        """Drop every spilled prefix block (all cached KV became worthless
        at once). Reserved swapped-slot bytes are untouched: those belong
        to live requests. Returns the entries dropped."""
        n = 0
        for key in list(self._spilled.keys()):
            if self._drop(key):
                n += 1
        return n

    def _drop(self, key: Any) -> bool:
        entry = self._spilled.pop(key, None)
        if entry is None:
            return False
        self.spill_bytes -= entry[1]
        return True

    # -- pinned swapped-slot payloads ------------------------------------

    def reserve(self, nbytes: int) -> bool:
        """Claim `nbytes` of pinned capacity for a swapped-out slot,
        evicting spilled entries to make room. False when the budget
        cannot cover it: the caller keeps the slot resident instead."""
        nbytes = int(nbytes)
        if not self._make_room(nbytes):
            return False
        self.pinned_bytes += nbytes
        return True

    def unreserve(self, nbytes: int) -> None:
        self.pinned_bytes -= int(nbytes)
        if self.pinned_bytes < 0:
            raise AssertionError("host tier pinned bytes went negative")

    # -- observability ---------------------------------------------------

    @property
    def blocks(self) -> int:
        return len(self._spilled)

    def affinity_digests(self, limit: int = 512) -> List[str]:
        """Spilled full-block chain-head digests for the affinity sketch
        (the allocator's key space and truncation: the tier is keyed by
        its chain keys), most recently used last."""
        digests = [key[1].hex()[:16] for key in self._spilled
                   if isinstance(key, tuple) and key and key[0] == "F"]
        return digests[-limit:]

    def stats(self) -> Dict[str, int]:
        return {
            "budget_bytes": self.budget_bytes,
            "blocks": len(self._spilled),
            "spill_bytes": self.spill_bytes,
            "pinned_bytes": self.pinned_bytes,
            "spills_total": self.spills_total,
            "swap_ins_total": self.swap_ins_total,
            "evictions_total": self.evictions_total,
            "dropped_total": self.dropped_total,
        }
