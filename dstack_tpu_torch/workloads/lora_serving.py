"""Multi-tenant LoRA serving: batched adapter multiplexing over one engine
(port of `dstack_tpu.workloads.lora_serving`).

`lora.merge_lora` bakes one adapter into a dedicated replica, one tenant
per engine. This module serves many tenants from one: a host-side
refcounted adapter registry over a device-side adapter bank, so one
batched decode step serves mixed tenants.

Layout: the bank holds `max_adapters + 1` slots per target projection,
`(L, P, d_in, r)` for A and `(L, P, r, d_out)` for B, the last slot zero
forever: requests without an adapter (`adapter_ix == -1`) gather it and
add an exact zero. Inside the chunk-prefill, decode and verify programs
(kv_blocks.py) each batch row gathers its own A/B pair by index and adds
`(alpha/r)·(h@A)@B` UNMERGED to the target projection's output in f32,
before reshape and rope: the place `merge_lora`'s delta lands. The delta
is two thin torch products per target, not a kernel; attention stays the
paged kernel's.

Whether a batch carries an adapter is a host value here (the JAX package
decides it on the device under `lax.cond`): the engine knows it from its
live requests, so the decision costs no sync. With no adapter in the
batch the LoRA programs run the plain projection, `project_qkv` byte for
byte; with no request holding an adapter ref at all
(`AdapterRegistry.inflight == 0`) the engine runs the plain programs.

Host side: `AdapterRegistry` maps adapter names to bank slots with
refcounts (every in-flight request holds a ref) and LRU eviction of idle
adapters under slot pressure; evicting or unloading an adapter with
in-flight requests is refused. The registry is NOT thread-safe on its
own: `ServingEngine` calls it under its scheduler lock, and writes the
bank in place on the engine's stream.
"""

from collections import OrderedDict
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dstack_tpu_torch.workloads.config import ModelConfig
from dstack_tpu_torch.workloads.lora import DEFAULT_TARGETS
from dstack_tpu_torch.workloads.transformer import (
    _rope,
    linear,
    params_device,
    rms_norm,
)

Params = Dict[str, Any]

# Attention projections the multiplexed path supports: the delta rides
# inside `project_qkv_lora`, which only recomputes the q/k/v projections.
SUPPORTED_TARGETS = ("wq", "wk", "wv")


class AdapterPoolFullError(RuntimeError):
    """Every pool slot is held by an adapter with in-flight requests."""


class AdapterBusyError(RuntimeError):
    """Unload/replace refused: the adapter has in-flight requests."""


def make_lora_bank(config: ModelConfig, base: Params, *, max_adapters: int,
                   rank: int, targets: Sequence[str] = DEFAULT_TARGETS) -> Params:
    """Zero-initialised bank on the base's device, in each target's dtype.
    Slot `max_adapters` (the +1) stays all-zero forever: gathers for
    adapter_ix -1 land there and contribute an exactly-zero delta."""
    if max_adapters < 1:
        raise ValueError(f"max_adapters must be >= 1, got {max_adapters}")
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    bad = [t for t in targets if t not in SUPPORTED_TARGETS]
    if bad:
        raise ValueError(
            f"unsupported LoRA serving targets {bad}; multiplexed serving"
            f" covers the attention projections {SUPPORTED_TARGETS}"
        )
    dev = params_device(base)
    pool = max_adapters + 1
    layers: Params = {}
    for t in targets:
        w = base["layers"][t]
        if not isinstance(w, torch.Tensor):
            raise ValueError(f"target {t!r} is not a plain weight (quantized base?)")
        n_layers, d_in, d_out = w.shape
        layers[f"{t}_a"] = torch.zeros((n_layers, pool, d_in, rank), dtype=w.dtype,
                                       device=dev)
        layers[f"{t}_b"] = torch.zeros((n_layers, pool, rank, d_out), dtype=w.dtype,
                                       device=dev)
    return {"scale": torch.zeros((pool,), dtype=torch.float32, device=dev),
            "layers": layers}


def bank_layer(bank: Params, layer: int) -> Params:
    """Layer `layer`'s slice of the bank, `(P, d_in, r)` / `(P, r, d_out)`
    per target (views)."""
    return {k: v[layer] for k, v in bank["layers"].items()}


def safe_index(bank: Params, adapter_ix: Union[int, torch.Tensor]):
    """(pool index, scale) for adapter_ix: -1 maps to the bank's all-zero
    last slot. An int (one request) stays an int; a (B,) tensor stays on
    its device."""
    pool = bank["scale"].shape[0] - 1
    if isinstance(adapter_ix, int):
        ix = adapter_ix if adapter_ix >= 0 else pool
        return ix, bank["scale"][ix]
    ix = torch.where(adapter_ix >= 0, adapter_ix,
                     torch.full_like(adapter_ix, pool)).to(torch.int64)
    return ix, bank["scale"][ix]


def lora_delta(hf: torch.Tensor, a_pool: torch.Tensor, b_pool: torch.Tensor,
               adapter_ix: Union[int, torch.Tensor], scale: torch.Tensor) -> torch.Tensor:
    """((hf·A)·B)·scale in f32 for each row's adapter: hf (B, S, d_in) f32,
    the layer's A/B pools `(P, d_in, r)` / `(P, r, d_out)`, a sanitised
    index (an int for one request, `(B,)` for a batch) and its scale."""
    a = a_pool[adapter_ix].to(torch.float32)
    bm = b_pool[adapter_ix].to(torch.float32)
    if isinstance(adapter_ix, int):  # chunked prefill: one request
        return ((hf @ a) @ bm) * scale
    return torch.bmm(torch.bmm(hf, a), bm) * scale[:, None, None]


def project_qkv_lora(c: ModelConfig, x: torch.Tensor, p: Params,
                     positions: torch.Tensor, lp: Params,
                     adapter_ix: Union[int, torch.Tensor], scale: torch.Tensor,
                     has_lora: bool):
    """`transformer.project_qkv` plus per-row unmerged LoRA deltas.

    `lp` is one layer's slice of the bank (`bank_layer`), `adapter_ix` the
    already-sanitised pool index (`safe_index`): an int for the
    one-request chunk prefill, `(B,)` for batched decode and verify, and
    `scale` the matching `alpha/r` (0-d or `(B,)`). `has_lora` (a host
    bool) False runs the plain projection, byte for byte `project_qkv`:
    no f32 casts, no zero adds. True gathers each row's A/B, upcasts them,
    and adds `((h·A)·B)·scale` to the projection's output in f32 before
    the cast back, reshape and rope."""
    b, s, _ = x.shape
    hd = c.head_dim
    h = rms_norm(x, p["attn_norm"], c.norm_eps)
    if not has_lora:
        q, k, v = linear(h, p["wq"]), linear(h, p["wk"]), linear(h, p["wv"])
    else:
        hf = h.to(torch.float32)

        def proj(name: str) -> torch.Tensor:
            y = linear(h, p[name])
            if f"{name}_a" in lp:
                delta = lora_delta(hf, lp[f"{name}_a"], lp[f"{name}_b"], adapter_ix, scale)
                y = (y.to(torch.float32) + delta).to(y.dtype)
            return y

        q, k, v = proj("wq"), proj("wk"), proj("wv")
    q = q.reshape(b, s, -1, hd)
    k = k.reshape(b, s, -1, hd)
    v = v.reshape(b, s, -1, hd)
    return _rope(q, positions, c.rope_theta), _rope(k, positions, c.rope_theta), v


class AdapterRegistry:
    """Name -> bank-slot map with refcounts and LRU slot eviction.

    Thread-unsafe by design: `ServingEngine` serialises scheduler state
    behind one lock, and the registry lives inside it. `load` and `unload`
    write the bank in place on the current CUDA stream (the engine's, under
    its lock), so a step already queued reads the bank as it was. They
    write through `writer(ix, layers, scale)` when one is given (layers
    None zeroes the slot): a tensor-parallel engine routes the write to
    every rank, each cutting its columns of B."""

    def __init__(self, config: ModelConfig, base: Params, *, max_adapters: int,
                 rank: int, targets: Sequence[str] = DEFAULT_TARGETS, writer=None):
        self.config = config
        self.max_adapters = max_adapters
        self.rank = rank
        self.targets = tuple(targets)
        self.bank = make_lora_bank(config, base, max_adapters=max_adapters,
                                   rank=rank, targets=targets)
        self._write = writer or self._write_bank
        self._slots: Dict[str, int] = {}
        self._refs: Dict[str, int] = {}
        self._alphas: Dict[str, float] = {}
        self._lru: "OrderedDict[str, None]" = OrderedDict()
        self._free = list(range(max_adapters))

    # ------------------------------------------------------------- queries

    @property
    def loaded_count(self) -> int:
        return len(self._slots)

    @property
    def inflight(self) -> int:
        """Requests holding an adapter ref. Zero means no batch slot can
        carry an adapter, so the engine dispatches the plain programs."""
        return sum(self._refs.values())

    def loaded(self) -> Dict[str, Dict[str, Any]]:
        return {
            name: {
                "slot": ix,
                "refs": self._refs.get(name, 0),
                "alpha": self._alphas.get(name, 0.0),
                "rank": self.rank,
            }
            for name, ix in self._slots.items()
        }

    def slot_of(self, name: str) -> Optional[int]:
        return self._slots.get(name)

    # ----------------------------------------------------------- lifecycle

    def load(self, name: str, adapter: Params, *, alpha: float = 16.0) -> int:
        """Install (or replace) an adapter; returns its bank slot. Leaves
        may be tensors on any device or numpy arrays; they are cast to the
        bank's dtype. Replacing weights under in-flight requests would
        change tokens mid-stream, so a busy adapter refuses the reload."""
        layers = adapter.get("layers") if isinstance(adapter, dict) else None
        if not layers:
            raise ValueError("adapter must be a {'layers': {...}} tree")
        expect = {f"{t}_{ab}" for t in self.targets for ab in ("a", "b")}
        if set(layers) != expect:
            raise ValueError(
                f"adapter targets {sorted(layers)} != engine targets"
                f" {sorted(expect)}"
            )
        for t in self.targets:
            a, b = layers[f"{t}_a"], layers[f"{t}_b"]
            pool_a = self.bank["layers"][f"{t}_a"]
            want_a = (pool_a.shape[0],) + tuple(pool_a.shape[2:])
            if tuple(a.shape) != want_a:
                raise ValueError(
                    f"{t}_a shape {tuple(a.shape)} != {want_a}"
                    f" (engine rank is {self.rank})"
                )
            if tuple(b.shape)[:2] != (pool_a.shape[0], self.rank):
                raise ValueError(
                    f"{t}_b shape {tuple(b.shape)} incompatible with"
                    f" rank {self.rank}"
                )
        if name in self._slots:
            if self._refs.get(name, 0) > 0:
                raise AdapterBusyError(
                    f"adapter {name!r} has {self._refs[name]} in-flight"
                    " request(s); reload refused"
                )
            ix = self._slots[name]
        else:
            ix = self._free.pop() if self._free else self._evict_one()
            self._slots[name] = ix
            self._refs[name] = 0
        self._write(ix, {key: layers[key] for key in expect}, float(alpha) / self.rank)
        self._alphas[name] = float(alpha)
        self._lru[name] = None
        self._lru.move_to_end(name)
        return ix

    def _evict_one(self) -> int:
        for name in self._lru:  # least-recently-used first
            if self._refs.get(name, 0) == 0:
                ix = self._slots.pop(name)
                del self._lru[name]
                self._refs.pop(name, None)
                self._alphas.pop(name, None)
                return ix
        raise AdapterPoolFullError(
            f"all {self.max_adapters} adapter slots have in-flight requests"
        )

    def unload(self, name: str) -> None:
        if name not in self._slots:
            raise KeyError(f"adapter {name!r} is not loaded")
        if self._refs.get(name, 0) > 0:
            raise AdapterBusyError(
                f"adapter {name!r} has {self._refs[name]} in-flight"
                " request(s); unload refused"
            )
        ix = self._slots.pop(name)
        self._refs.pop(name, None)
        self._alphas.pop(name, None)
        self._lru.pop(name, None)
        # Zero the vacated slot: a stale gather against a freed index must
        # read zeros, not the unloaded tenant's weights.
        self._write(ix, None, 0.0)
        self._free.append(ix)

    def _write_bank(self, ix: int, layers: Optional[Params], scale: float) -> None:
        """Bank slot `ix` := `layers` cast to the bank's dtype (zeros for
        None), and its scale."""
        with torch.no_grad():
            for key, leaf in self.bank["layers"].items():
                if layers is None:
                    leaf[:, ix].zero_()
                else:
                    leaf[:, ix].copy_(torch.as_tensor(layers[key]).to(leaf.device, leaf.dtype))
            self.bank["scale"][ix] = scale

    # ------------------------------------------------------------ refcounts

    def acquire(self, name: str) -> int:
        """Take an in-flight ref; returns the bank slot for the request."""
        if name not in self._slots:
            raise KeyError(f"adapter {name!r} is not loaded")
        self._refs[name] = self._refs.get(name, 0) + 1
        self._lru.move_to_end(name)
        return self._slots[name]

    def release(self, name: str) -> None:
        n = self._refs.get(name, 0)
        if n > 0:
            self._refs[name] = n - 1


# ------------------------------------------------------------------- I/O


def _f32_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32).numpy()
    return np.asarray(t, np.float32)


def save_adapter(path: str, adapter: Params, *, rank: int, alpha: float = 16.0) -> None:
    """Adapter-only export in the JAX package's npz format: f32 leaves
    under `layers.<t>_a|_b` plus `__rank__` and `__alpha__`, so either
    package loads what the other wrote. bf16 widens to f32 in torch first
    (f32 holds every bf16 value exactly); the registry casts back."""
    flat = {f"layers.{k}": _f32_numpy(v) for k, v in adapter["layers"].items()}
    np.savez(path, __rank__=rank, __alpha__=alpha, **flat)


def load_adapter_file(path: str) -> Tuple[Params, int, float]:
    """(adapter with f32 CPU tensor leaves, rank, alpha) from a
    `save_adapter` npz of either package."""
    z = np.load(path)
    layers = {k.split(".", 1)[1]: torch.from_numpy(np.array(z[k], np.float32))
              for k in z.files if k.startswith("layers.")}
    if not layers:
        raise ValueError(f"{path} holds no adapter layers")
    return {"layers": layers}, int(z["__rank__"]), float(z["__alpha__"])


def demo_adapter(config: ModelConfig, base: Params, seed: Union[int, torch.Generator],
                 *, rank: int, targets: Sequence[str] = DEFAULT_TARGETS,
                 scale: float = 0.05) -> Params:
    """Random NON-zero adapter (unlike `lora.lora_init`, B != 0) so demo
    tenants produce visibly different generations without a training run:
    A ~ N(0, 1)·d_in^-0.5 and B ~ N(0, 1)·scale, drawn in f32 from a torch
    generator on the base's device, per target A then B, cast to the
    weight's dtype."""
    dev = params_device(base)
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator(device=dev).manual_seed(int(seed))
    layers: Params = {}
    for t in targets:
        w = base["layers"][t]
        n_layers, d_in, d_out = w.shape
        a = torch.randn((n_layers, d_in, rank), generator=gen, device=dev,
                        dtype=torch.float32)
        b = torch.randn((n_layers, rank, d_out), generator=gen, device=dev,
                        dtype=torch.float32)
        layers[f"{t}_a"] = (a * d_in ** -0.5).to(w.dtype)
        layers[f"{t}_b"] = (b * scale).to(w.dtype)
    return {"layers": layers}
