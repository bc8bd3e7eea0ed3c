"""Meshes, the tensor-parallel serving layout and the training layout
for the port (port of `dstack_tpu.workloads.sharding`: `AXES`,
`make_mesh`, the spec tables, `_broadcast_specs`' structural rules,
`param_shardings` / `shard_tree` and `BATCH_SPEC`).

Three mesh shapes run here:

- one device with a `seq` axis of n, whose n sequence shards take turns
  on that device through the ring (`attention._ring_attention_local`). No
  process group is involved; every other axis above 1 raises.
- a serving mesh: a `model` axis over the ranks of a `torch.distributed`
  process group (`init_ranks`, then `make_mesh(model=n)`), one rank per
  device: the tensor-parallel serving engine (`serving.ServingEngine(mesh=)`).
  Rank r holds its slice of every weight and its KV heads, and the
  engine's host loop on rank 0 drives the same device programs on every
  rank.
- a training mesh (`make_mesh(data=, fsdp=, model=, layout="training")`
  over the ranks): the trainer (`train.make_train_step(config, mesh)`) on
  the reference's PARAM_SPECS. Rank r's coordinates are its row-major index
  in AXES order, the reference's `np.array(devices).reshape(shape)`, so rank
  r holds the slices JAX device r holds under the same `NamedSharding`.

The serving layout is the reference's column-parallel one: `model` rides
output dims only, so every contraction stays whole on each rank and the
collectives are all-gathers, which move bits and never re-reduce (the
reference's `SERVING_PARAM_SPECS` comment, `sharding.py:89-99`). A rank
computes its columns of every product as the unsharded program would, and
the gathered activations are the unsharded ones.

The training layout is the reference's scaling-book one, written out as
the collectives GSPMD would insert: batch rows over (data, fsdp); weights
cut over fsdp on their input dim and whole again at use (`gather_fsdp`,
whose backward is the reduce-scatter of the grads); wq/wk/wv/w_gate/w_up
column-parallel and wo/w_down row-parallel on `model` with Megatron's pair
around each (`enter_model`: identity forward, grads summed over model in
backward; `reduce_model`: partial sums summed over model forward, identity
backward); the data axis's grad all-reduce after the backward
(`reduce_grads`).

Specs are tuples of axis names (None: not sharded; a tuple of names: the
axes' combined index, row-major), one entry per dim; `()` is replicated.
There is no `PartitionSpec` in the port.

Transport. NCCL when each rank owns a card; gloo on the CPU and for ranks
that share one card (NCCL refuses two ranks on one device). gloo takes
only some collectives on CUDA tensors and has no reduce-scatter, so under
gloo the helpers here copy a CUDA tensor through pinned host memory and
back, and a reduce-scatter is an all-reduce of which each rank keeps its
block: the one-card transport, chosen by the backend the caller named,
never by catching an error.

A seq axis over ranks (the ring's hop) and an expert axis over ranks
(expert parallelism) are ROADMAP Queue 1 items 3c and 3d, and raise.
"""

import datetime
import itertools
import math
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field, fields, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dstack_tpu_torch.workloads.device import DeviceLike, resolve_device
from dstack_tpu_torch.workloads.quant import QTensor

AXES = ("data", "fsdp", "seq", "model", "expert")
BACKENDS = ("nccl", "gloo")
# What a mesh over ranks was cut for: the column-parallel serving engine,
# or the trainer's PARAM_SPECS.
LAYOUTS = ("serving", "training")
# How long a collective waits for the other ranks (a serving leader's idle
# heartbeat, serving.HEARTBEAT_S, keeps its followers well inside it).
GROUP_TIMEOUT = datetime.timedelta(minutes=30)

_NEXT_SLICE = ("a seq axis over ranks (the ring's hop) and an expert axis over ranks"
               " (expert parallelism) are ROADMAP Queue 1 items 3c and 3d, not ported"
               " yet")
_ONE_DEVICE = ("without a process group the port runs one device with a seq axis"
               " (the ring's shards take turns on it); the model, data and fsdp axes"
               " run over the ranks of sharding.init_ranks (the sharding slices,"
               " ROADMAP Queue 1 item 3), and " + _NEXT_SLICE)


def _stats() -> Dict[str, float]:
    return {"all_gathers": 0, "all_gather_seconds": 0.0, "broadcasts": 0,
            "all_reduces": 0, "all_reduce_seconds": 0.0,
            "reduce_scatters": 0, "reduce_scatter_seconds": 0.0}


@dataclass(frozen=True)
class Mesh:
    """A mesh of the port: this process's device, the size of each axis
    (`shape`, axis -> size, the field `make_attention_fn` and the remat
    estimate read), and for a mesh over ranks its process group, this
    rank's index in it (on a serving mesh, its index on the `model` axis),
    the group's backend, the layout it was cut for, and a training mesh's
    sub-group for each set of axes (`groups`, axes tuple -> group, every
    rank's line of ranks along those axes). `stats` counts the collectives
    this rank ran through the helpers below."""

    device: torch.device
    shape: Dict[str, int]
    group: Optional[Any] = None
    rank: int = 0
    backend: Optional[str] = None
    layout: str = "serving"
    groups: Dict[Tuple[str, ...], Any] = field(default_factory=dict, compare=False)
    stats: Dict[str, float] = field(default_factory=_stats, compare=False)

    def __post_init__(self):
        if set(self.shape) != set(AXES) or any(n < 1 for n in self.shape.values()):
            raise ValueError(f"mesh axes {AXES} must each be >= 1, got {self.shape}")
        if self.layout not in LAYOUTS:
            raise ValueError(f"layout must be one of {LAYOUTS}, got {self.layout!r}")
        if self.group is None:
            if any(n > 1 for a, n in self.shape.items() if a != "seq"):
                raise NotImplementedError(f"mesh {self.shape}: {_ONE_DEVICE}")
            return
        if self.shape["seq"] > 1 or self.shape["expert"] > 1:
            raise NotImplementedError(f"mesh {self.shape} over ranks: {_NEXT_SLICE}")
        if self.layout == "serving" and self.shape["data"] * self.shape["fsdp"] > 1:
            raise ValueError(f"mesh {self.shape}: the serving layout shards the model"
                             " axis only; a data or fsdp axis is the trainer's"
                             " (make_mesh(..., layout='training'))")

    @property
    def ranked(self) -> bool:
        """Whether this mesh spans the ranks of a process group (even a
        world of 1), so a serving engine drives its programs through ops."""
        return self.group is not None

    @property
    def training(self) -> bool:
        """A mesh over ranks cut for the trainer's layout."""
        return self.group is not None and self.layout == "training"

    @property
    def staged(self) -> bool:
        """gloo carries CUDA tensors through host memory (the one-card
        transport); NCCL takes them where they are."""
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's index on each axis: its rank, row-major in AXES order."""
        idx = np.unravel_index(self.rank, [self.shape[a] for a in AXES])
        return {a: int(i) for a, i in zip(AXES, idx)}


def check_backend(backend: str, world: int, device: Optional[torch.device]) -> None:
    """Refuse a backend that cannot carry `world` ranks: nccl off CUDA, or
    with fewer cards than ranks, or with every rank on the one `device`
    (NCCL refuses two ranks on one card); the message names gloo."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend != "nccl":
        return
    if device is not None and device.type != "cuda":
        raise ValueError(f"backend 'nccl' runs on CUDA devices, not {device};"
                         " use backend='gloo' on the CPU")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < world or (device is not None and world > 1):
        where = f"every rank on {device}" if device is not None else f"{cards} card(s)"
        raise ValueError(
            f"backend 'nccl' runs one rank per card: {world} ranks on {where};"
            " NCCL refuses two ranks on one device, pass backend='gloo' (the"
            " one-card transport) for ranks that share a card")


def init_ranks(world: int, rank: int, init_method: str, backend: Optional[str] = None,
               device: DeviceLike = None) -> torch.device:
    """Join a process group of `world` ranks as `rank`, rendezvous at
    `init_method` (`tcp://127.0.0.1:<port>` or `file://<path>`), and
    return this rank's device: `device` for every rank when one is named
    (the one-card smoke, the CPU tests), else `cuda:<rank>`. `backend`
    defaults to nccl for CUDA and gloo for the CPU; nccl with fewer cards
    than ranks, or with every rank on one named card, raises and names
    gloo. Nothing switches the backend on its own."""
    dev = torch.device(device) if device is not None else torch.device("cuda", rank)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    check_backend(backend, world, torch.device(device) if device is not None else None)
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, world_size=world,
                            rank=rank, timeout=GROUP_TIMEOUT, **kw)
    return dev


def make_mesh(devices: Optional[Sequence[DeviceLike]] = None, *, data: int = 1,
              fsdp: Optional[int] = None, seq: int = 1, model: int = 1,
              expert: int = 1, layout: str = "serving") -> Mesh:
    """A mesh over `devices`. Without a process group: one device
    (default: the CUDA device) with a seq axis. After `init_ranks`: a mesh
    over every rank of the group, cut for `layout` ("serving": a model
    axis, the tensor-parallel engine's; "training": data, fsdp and model,
    the trainer's), whose axis sizes multiply to the world; `devices` is
    None (`cuda:<rank>`) or one device for every rank. `fsdp=None` takes
    the factor left after the other axes, as the reference's (`:45-49`).
    A training mesh makes one sub-group per line of ranks along each set
    of its axes, every rank creating every group in the same order. (Two
    engines that serve at once over the same ranks each need a `Mesh` on
    a group of their own, from `torch.distributed.new_group`.)"""
    ranked = dist.is_available() and dist.is_initialized()
    if fsdp is None and ranked:
        n, denom = dist.get_world_size(), data * seq * model * expert
        if n % denom:
            raise ValueError(f"data*seq*model*expert = {denom} does not divide {n} ranks")
        fsdp = n // denom
    fsdp = 1 if fsdp is None else fsdp
    shape = dict(zip(AXES, (data, fsdp, seq, model, expert)))
    if not ranked:
        devices = [resolve_device(None)] if devices is None else [
            resolve_device(d) for d in devices]
        if len(devices) != 1:
            raise NotImplementedError(f"a mesh over {len(devices)} devices: {_ONE_DEVICE}")
        return Mesh(devices[0], shape, layout=layout)
    group = dist.group.WORLD
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if math.prod(shape.values()) != world:
        raise ValueError(f"mesh {shape} over a process group of {world} ranks")
    if devices is None:
        dev = resolve_device(torch.device("cuda", rank))
    elif len(devices) == 1:
        dev = resolve_device(devices[0])
    else:
        raise ValueError(f"{len(devices)} devices for {world} ranks: name none"
                         " (cuda:<rank>) or one for every rank")
    mesh = Mesh(dev, shape, group=group, rank=rank, backend=dist.get_backend(group),
                layout=layout)
    if layout == "training":
        mesh.groups.update(_line_groups(shape, rank))
    return mesh


def _line_groups(shape: Dict[str, int], rank: int) -> Dict[Tuple[str, ...], Any]:
    """For each set of the axes above 1, the group of ranks that differ
    from this one only along those axes (its ranks in ascending order,
    which is their row-major index over the set). Every rank calls
    `new_group` for every line in the same order; the whole world is the
    default group."""
    sizes = [shape[a] for a in AXES]
    world = math.prod(sizes)
    coords = [np.unravel_index(r, sizes) for r in range(world)]
    live = [a for a in AXES if shape[a] > 1]
    out = {}
    for k in range(1, len(live) + 1):
        for axes in itertools.combinations(live, k):
            lines: Dict[Tuple[int, ...], List[int]] = {}
            for r, c in enumerate(coords):
                key = tuple(int(c[i]) for i, a in enumerate(AXES) if a not in axes)
                lines.setdefault(key, []).append(r)
            for key in sorted(lines):
                ranks = lines[key]
                g = (dist.group.WORLD if len(ranks) == world
                     else dist.new_group(ranks, timeout=GROUP_TIMEOUT))
                if rank in ranks:
                    out[axes] = g
    return out


def model_shards(mesh: Optional[Mesh]) -> int:
    """The size of the `model` axis (1 without a mesh). Anything that is
    not a mesh of the port raises."""
    if mesh is None:
        return 1
    if not isinstance(mesh, Mesh):
        raise NotImplementedError(f"{type(mesh).__name__} is not a mesh of the port"
                                  f" (sharding.make_mesh): {_ONE_DEVICE}")
    return mesh.shape["model"]


def training_mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """`mesh` if the trainer can run on it (None, the one-device seq mesh
    or a training mesh over ranks); a mesh over ranks cut for serving
    raises ValueError."""
    model_shards(mesh)
    if mesh is not None and mesh.ranked and not mesh.training:
        raise ValueError(f"mesh {mesh.shape} was cut for {mesh.layout!r}; the trainer"
                         " runs on make_mesh(..., layout='training')")
    return mesh


def device_shards(mesh: Optional[Mesh]) -> Optional[Dict[str, int]]:
    """The device's real share of the work, as `resolve_remat`'s
    `shards`. The reference divides the activations by the seq axis, since
    each of its devices holds 1/n of the sequence; on the one-device mesh
    the n seq shards take turns on one device, which holds them all: a seq
    factor of 1. On a training mesh over ranks each rank holds 1/(data *
    fsdp) of the batch and 1/(fsdp * model) of the weights, the mesh's own
    shape (the caller sizes the activations by the global batch, as the
    reference's traced shapes are)."""
    if training_mesh(mesh) is None:
        return None
    if mesh.ranked:
        return dict(mesh.shape)
    return {**mesh.shape, "seq": 1}


def batch_shards(mesh: Optional[Mesh]) -> int:
    """How many ranks split the batch rows (data x fsdp; 1 off a mesh)."""
    return 1 if mesh is None else mesh.shape["data"] * mesh.shape["fsdp"]


# -- the column-parallel serving layout -----------------------------------------

# The reference's tables (`sharding.py:100-133`), entry for entry: "model"
# only on output dims; layer stacks lead with their layer dim.
SERVING_PARAM_SPECS: Dict[str, Any] = {
    "embed": (None, None),
    "layers": {
        "wq": (None, None, "model"),
        "wk": (None, None, "model"),
        "wv": (None, None, "model"),
        "wo": (None, None, "model"),
        "w_gate": (None, None, "model"),
        "w_up": (None, None, "model"),
        "w_down": (None, None, "model"),
        "router": (None, None, None),
        "we_gate": (None, "expert", None, "model"),
        "we_up": (None, "expert", None, "model"),
        "we_down": (None, "expert", None, "model"),
        "attn_norm": (None, None),
        "mlp_norm": (None, None),
    },
    "final_norm": (None,),
    "lm_head": (None, "model"),
}
# A replicated (whole) A keeps the x@A contraction whole; B's output dim
# rides "model" with its base weight's.
SERVING_LORA_SPECS: Dict[str, Tuple] = {
    "_a": (None, None, None),
    "_b": (None, None, "model"),
}
# Pools (L, num_blocks, block_size, KV, hd): the KV-head dim over "model",
# matching wk/wv's output columns. Tables, lengths and sampling fields are
# host-driven control state and replicate.
SERVING_KV_POOL_SPEC = (None, None, None, "model", None)

# -- the training layout ------------------------------------------------------------

# The reference's tables (`sharding.py:57-87`, `:136`), entry for entry:
# "fsdp" on a weight's input dim and "model" on its output dim, or the other
# way round for the second matmul of each pair (wo, w_down: row-parallel).
PARAM_SPECS: Dict[str, Any] = {
    "embed": (None, "fsdp"),
    "layers": {
        "wq": (None, "fsdp", "model"),
        "wk": (None, "fsdp", "model"),
        "wv": (None, "fsdp", "model"),
        "wo": (None, "model", "fsdp"),
        "w_gate": (None, "fsdp", "model"),
        "w_up": (None, "fsdp", "model"),
        "w_down": (None, "model", "fsdp"),
        "router": (None, None, None),
        "we_gate": (None, "expert", "fsdp", "model"),
        "we_up": (None, "expert", "fsdp", "model"),
        "we_down": (None, "expert", "model", "fsdp"),
        "attn_norm": (None, None),
        "mlp_norm": (None, None),
    },
    "final_norm": (None,),
    "lm_head": ("fsdp", "model"),
}
# A (L, in, r) on its input dim like the base weight's input, B (L, r, out)
# on its output dim; the rank dim replicates.
LORA_SPECS: Dict[str, Tuple] = {
    "_a": (None, "fsdp", None),
    "_b": (None, None, "model"),
}
# Batch rows over (data, fsdp), the sequence over seq.
BATCH_SPEC = (("data", "fsdp"), "seq")


def _path_str(path: Sequence[str]) -> str:
    return "".join(f"[{k!r}]" for k in path)


def serving_specs(tree: Any, specs: Dict[str, Any] = SERVING_PARAM_SPECS,
                  lora: Dict[str, Tuple] = SERVING_LORA_SPECS,
                  table: str = "SERVING_PARAM_SPECS") -> Any:
    """The spec of every leaf of a params-shaped tree (the reference's
    `_broadcast_specs`): a leaf named in the table takes its entry; a LoRA
    `f"{base}_a"` / `f"{base}_b"` beside a base weight with a rule takes
    the LoRA table's; a QTensor's `q` mirrors its parent and its `scale`
    replicates; scalars (optimizer step counts) replicate. A weight of two
    or more dims with no rule, or a leaf whose ndim differs from its rule,
    raises ValueError: an uncovered weight would silently replicate."""

    def spec_for(path: Tuple[str, ...], leaf: Any) -> Tuple:
        node: Any = specs
        for key in path:
            if isinstance(node, dict):
                if key in node:
                    node = node[key]
                elif isinstance(key, str) and key[-2:] in lora and key[:-2] in node:
                    node = lora[key[-2:]]
            elif key == "scale":
                return ()
        ndim = getattr(leaf, "ndim", 0)
        if isinstance(node, tuple):
            if ndim == len(node):
                return node
            if ndim == 0:
                return ()
            raise ValueError(f"param at {_path_str(path)} has ndim={ndim} but its"
                             f" {table} entry is {node} — update sharding rules")
        if ndim >= 2:
            raise ValueError(f"no {table} entry for weight at {_path_str(path)} (shape"
                             f" {tuple(getattr(leaf, 'shape', ()))}) — add a sharding rule")
        return ()

    def walk(node: Any, path: Tuple[str, ...]) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, QTensor):
            return QTensor(spec_for(path + ("q",), node.q), spec_for(path + ("scale",), node.scale))
        return spec_for(path, node)

    return walk(tree, ())


def _axes_of(entry: Any) -> Tuple[str, ...]:
    """A spec entry's axes: None -> (), a name -> (name,), a tuple as is."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _extent(mesh: Mesh, axes: Sequence[str]) -> Tuple[int, int]:
    """(shards, this rank's block index) over `axes`: the product of their
    sizes and the row-major index of this rank's coordinates on them."""
    n, idx, coords = 1, 0, mesh.coords
    for a in axes:
        n, idx = n * mesh.shape[a], idx * mesh.shape[a] + coords[a]
    return n, idx


def shard(x: torch.Tensor, spec: Tuple, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's block of `x` under `spec` (a view): each dim that
    carries axes cut into equal contiguous blocks, this rank's block by
    its row-major index on those axes, as `NamedSharding.devices_indices_map`
    places them; `x` itself when the spec replicates or there is one shard."""
    if model_shards(mesh) * batch_shards(mesh) == 1 or not any(spec):
        return x
    for dim, entry in enumerate(spec):
        n, idx = _extent(mesh, _axes_of(entry))
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} shards")
        size = x.shape[dim] // n
        x = x.narrow(dim, idx * size, size)
    return x


def _cut(mesh: Optional[Mesh], params: Any, scale_as_q: bool) -> Any:
    specs = serving_specs(params)

    def walk(node: Any, spec: Any) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if isinstance(node, QTensor):
            return QTensor(shard(node.q, spec.q, mesh),
                           shard(node.scale, spec.q if scale_as_q else spec.scale, mesh))
        return shard(node, spec, mesh)

    return walk(params, specs)


def serving_param_shards(mesh: Optional[Mesh], params: Any) -> Any:
    """This rank's slice of every leaf of a params tree (target, int8
    QTensor drafter, LoRA adapter, MoE) under the serving specs, as views:
    a QTensor's scale whole, as its spec says."""
    return _cut(mesh, params, scale_as_q=False)


def rank_params(mesh: Optional[Mesh], params: Any) -> Any:
    """The params a rank's programs compute on: `serving_param_shards`,
    with each QTensor's scale cut to its q's columns. The reference keeps
    the per-channel scale replicated and XLA slices it where the product
    meets it; here the rank multiplies its own columns, so it takes its
    columns of the scale too (views)."""
    return _cut(mesh, params, scale_as_q=True)


def serving_state_shards(mesh: Optional[Mesh], state: Any) -> Any:
    """A `PagedDecodeState` with this rank's KV heads of its k/v pools
    (SERVING_KV_POOL_SPEC, views); every other field replicates."""
    out = {}
    for f in fields(state):
        v = getattr(state, f.name)
        out[f.name] = (shard(v, SERVING_KV_POOL_SPEC, mesh)
                       if f.name in ("k", "v") and v.dim() == 5 else v)
    return replace(state, **out)


def check_heads(mesh: Any, config: Any, what: str = "target") -> None:
    """The reference engine's check: a config's q and KV heads must divide
    the model axis of `mesh` (or a count of shards) (ValueError)."""
    n = mesh if isinstance(mesh, int) else model_shards(mesh)
    if config.n_heads % n or config.n_kv_heads % n:
        raise ValueError(f"{what} heads ({config.n_heads} q / {config.n_kv_heads} kv)"
                         f" must divide the mesh's model axis ({n})")


def param_specs(tree: Any) -> Any:
    """The training spec of every leaf of a params-shaped tree (params,
    AdamW moments, LoRA adapters), by PARAM_SPECS and LORA_SPECS under
    `_broadcast_specs`' rules (the reference's `param_shardings`)."""
    return serving_specs(tree, PARAM_SPECS, LORA_SPECS, "PARAM_SPECS")


def _map_specs(fn, tree: Any, specs: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def shard_tree(mesh: Optional[Mesh], tree: Any) -> Any:
    """This rank's slice of every leaf of a params-shaped tree under
    PARAM_SPECS (the reference's `shard_tree`), as copies that own their
    storage, so the whole leaves they were cut from can be freed."""
    if mesh is None or not mesh.ranked:
        return tree
    return _map_specs(lambda t, sp: shard(t, sp, mesh).clone(), tree, param_specs(tree))


def global_shape(x: torch.Tensor, spec: Tuple, mesh: Optional[Mesh]) -> Tuple[int, ...]:
    """The whole leaf's shape of this rank's slice `x` under `spec`."""
    if mesh is None:
        return tuple(x.shape)
    return tuple(d * _extent(mesh, _axes_of(e))[0] for d, e in zip(x.shape, spec)) + \
        tuple(x.shape[len(spec):])


@torch.no_grad()
def unshard(x: torch.Tensor, spec: Tuple, mesh: Optional[Mesh]) -> torch.Tensor:
    """The whole leaf from every rank's slice `x` under `spec` (the
    inverse of `shard`, a collective every rank of the mesh runs)."""
    if mesh is None or not mesh.ranked:
        return x
    for dim, entry in enumerate(spec):
        if _extent(mesh, _axes_of(entry))[0] > 1:
            x = gather_axes(x, dim, mesh, _axes_of(entry))
    return x


def unshard_tree(mesh: Optional[Mesh], tree: Any) -> Any:
    """Every leaf of a params-shaped tree whole on every rank (a
    collective): what the checkpoint writes and the export serves."""
    if mesh is None or not mesh.ranked:
        return tree
    return _map_specs(lambda t, sp: unshard(t, sp, mesh), tree, param_specs(tree))


def shard_batch(batch: Dict[str, torch.Tensor], mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch under BATCH_SPEC (views)."""
    return {k: shard(v, BATCH_SPEC[:v.dim()], mesh) for k, v in batch.items()}


# -- collectives ------------------------------------------------------------------


def _group(mesh: Mesh, axes: Sequence[str]) -> Tuple[Any, int]:
    """The process group of this rank's line along `axes` (the axes above
    1, in AXES order) and its size: the whole group on a serving mesh."""
    live = tuple(a for a in AXES if a in axes and mesh.shape[a] > 1)
    n = math.prod(mesh.shape[a] for a in live)
    if n == 1:
        return None, 1
    if not mesh.training:
        if live != ("model",):
            raise ValueError(f"a serving mesh has no {live} axes")
        return mesh.group, n
    return mesh.groups[live], n


def _count(mesh: Mesh, kind: str, t0: float) -> None:
    mesh.stats[kind + "s"] += 1
    mesh.stats[kind + "_seconds"] += time.perf_counter() - t0


def _pinned_like(x: torch.Tensor) -> torch.Tensor:
    return torch.empty(x.shape, dtype=x.dtype, pin_memory=True)


def _gather(x: torch.Tensor, dim: int, mesh: Mesh, group: Any, n: int) -> torch.Tensor:
    t0 = time.perf_counter()
    src = x.contiguous()
    if mesh.staged:
        # Page-locked both ways: the copy out waits for `x`; the copy back
        # is queued behind it on the stream without a host wait.
        src = _pinned_like(src).copy_(src)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    if not mesh.staged:
        out = torch.cat(parts, dim=dim)
    else:
        shape = list(src.shape)
        shape[dim] *= n
        out = torch.cat(parts, dim=dim, out=torch.empty(shape, dtype=src.dtype,
                                                         pin_memory=True))
        out = out.to(x.device, non_blocking=True)
    _count(mesh, "all_gather", t0)
    return out


def all_gather(x: torch.Tensor, dim: int, mesh: Optional[Mesh]) -> torch.Tensor:
    """Concatenate every rank's `x` along `dim` in rank order over the
    `model` axis (the inverse of `shard`; the serving layout's gather).
    With no mesh or one shard it returns `x` itself: no copy, no launch.
    Under gloo a CUDA tensor goes through host memory and back (the
    one-card transport)."""
    if model_shards(mesh) == 1:
        return x
    return gather_axes(x, dim, mesh, ("model",))


def gather_axes(x: torch.Tensor, dim: int, mesh: Mesh, axes: Sequence[str]) -> torch.Tensor:
    """Every rank's `x` along `axes` concatenated on `dim`, in the ranks'
    row-major order over those axes (`x` itself over one shard)."""
    group, n = _group(mesh, axes)
    return x if n == 1 else _gather(x, dim, mesh, group, n)


def all_reduce(x: torch.Tensor, mesh: Optional[Mesh], axes: Sequence[str],
               op: str = "sum") -> torch.Tensor:
    """A new tensor: `x` summed (`op="sum"`) or maxed (`"max"`) over the
    ranks along `axes`, on `x`'s device (`x` itself over one shard)."""
    if mesh is None:
        return x
    group, n = _group(mesh, axes)
    if n == 1:
        return x
    t0 = time.perf_counter()
    red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
    buf = (_pinned_like(x).copy_(x) if mesh.staged
           else x.detach().clone(memory_format=torch.contiguous_format))
    dist.all_reduce(buf, op=red, group=group)
    out = buf.to(x.device, non_blocking=True) if mesh.staged else buf
    _count(mesh, "all_reduce", t0)
    return out


def reduce_scatter(x: torch.Tensor, dim: int, mesh: Mesh, axes: Sequence[str]) -> torch.Tensor:
    """This rank's block along `dim` of `x` summed over the ranks along
    `axes`. NCCL reduce-scatters; gloo has no reduce-scatter, so there it
    is an all-reduce of which each rank keeps its block (twice the bytes:
    the one-card transport)."""
    group, n = _group(mesh, axes)
    if n == 1:
        return x
    t0 = time.perf_counter()
    size = x.shape[dim] // n
    rank = dist.get_rank(group)
    if mesh.backend == "nccl":
        src = x.movedim(dim, 0).contiguous()
        out = torch.empty((size, *src.shape[1:]), dtype=src.dtype, device=src.device)
        dist.reduce_scatter_tensor(out, src, group=group)
        out = out.movedim(0, dim)
    else:
        buf = (_pinned_like(x).copy_(x) if mesh.staged
               else x.detach().clone(memory_format=torch.contiguous_format))
        dist.all_reduce(buf, group=group)
        out = buf.narrow(dim, rank * size, size)
        out = out.to(x.device, non_blocking=True) if mesh.staged else out.contiguous()
    _count(mesh, "reduce_scatter", t0)
    return out


class _GatherFsdp(torch.autograd.Function):
    """A weight's fsdp shards whole at use; the backward reduce-scatters
    its grad, so each rank keeps the sum over the fsdp axis of its block."""

    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return gather_axes(x, dim, mesh, ("fsdp",))

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.mesh, ("fsdp",)), None, None


class _EnterModel(torch.autograd.Function):
    """Megatron's f: identity forward; the backward sums the grad over the
    model axis (each rank's columns contribute their part of it)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ("model",)), None


class _ReduceModel(torch.autograd.Function):
    """Megatron's g: a row-parallel product's partial sums summed over the
    model axis forward; identity backward (the grad is whole on every rank)."""

    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce(x, mesh, ("model",))

    @staticmethod
    def backward(ctx, g):
        return g, None


def _splits(mesh: Optional[Mesh], axis: str) -> bool:
    """Whether a training mesh over ranks cuts along `axis` (False for no
    mesh and other meshes; an object that is not a mesh raises)."""
    model_shards(mesh)
    return mesh is not None and mesh.training and mesh.shape[axis] > 1


def gather_fsdp(x: torch.Tensor, dim: int, mesh: Optional[Mesh]) -> torch.Tensor:
    """`x` (a weight's fsdp shard) whole along `dim` on a training mesh,
    with the reduce-scatter of its grad as the backward; `x` itself
    elsewhere."""
    return _GatherFsdp.apply(x, dim, mesh) if _splits(mesh, "fsdp") else x


def enter_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The input of a column-parallel product on a training mesh's model
    axis (identity forward, grad summed over model); `x` itself elsewhere."""
    return _EnterModel.apply(x, mesh) if _splits(mesh, "model") else x


def reduce_model(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """A row-parallel product's partial sums summed over a training mesh's
    model axis (identity backward); `x` itself elsewhere."""
    return _ReduceModel.apply(x, mesh) if _splits(mesh, "model") else x


def gather_layer(p: Dict[str, Any], mesh: Optional[Mesh]) -> Dict[str, Any]:
    """A layer's weights (its slice of the stacks) whole over fsdp, each
    on the dim its PARAM_SPECS entry puts "fsdp" on."""
    if not _splits(mesh, "fsdp"):
        return p
    specs = PARAM_SPECS["layers"]
    return {k: gather_fsdp(w, specs[k].index("fsdp") - 1, mesh)
            if "fsdp" in specs[k] else w for k, w in p.items()}


def grad_axes(spec: Tuple) -> Tuple[str, ...]:
    """The axes a leaf's grad is still summed over after the backward:
    data always (each data row of ranks saw other rows), and fsdp for a
    leaf the fsdp gather's reduce-scatter did not reach. The model axis
    needs none: Megatron's pair leaves a leaf replicated over model with
    the same whole grad on every model rank."""
    return ("data",) if "fsdp" in spec else ("data", "fsdp")


def reduce_grads(grads: List[Tuple[str, torch.Tensor]], mesh: Optional[Mesh],
                 axes_of) -> List[Tuple[str, torch.Tensor]]:
    """[(path, grad)] with each grad all-reduced over `axes_of(path)` on
    a training mesh (the data axis's all-reduce); as given elsewhere."""
    if mesh is None or not mesh.training:
        return grads
    return [(k, all_reduce(g, mesh, axes_of(k))) for k, g in grads]


def batch_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """`x` summed over the batch axes (data, fsdp) of a training mesh."""
    if mesh is None or not mesh.training:
        return x
    return all_reduce(x, mesh, ("data", "fsdp"))


def replicas(spec: Tuple, mesh: Mesh) -> int:
    """How many ranks hold the same slice of a leaf under `spec`."""
    cut = math.prod(_extent(mesh, _axes_of(e))[0] for e in spec)
    return math.prod(mesh.shape.values()) // cut


def any_rank(flag: bool, mesh: Optional[Mesh]) -> bool:
    """Whether `flag` is set on any rank of the mesh (a collective every
    rank runs; `flag` itself off a mesh)."""
    if mesh is None or not mesh.ranked or dist.get_world_size(mesh.group) == 1:
        return flag
    dev = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
    t = torch.tensor([int(flag)], device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return bool(t.item())


def broadcast_object(obj: Any, mesh: Mesh) -> Any:
    """Rank 0's `obj` on every rank of the mesh's group (pickled; tensors
    in it should be host tensors). Ranks other than 0 pass anything."""
    box = [obj]
    kw = {"device": mesh.device} if mesh.backend == "nccl" else {}
    dist.broadcast_object_list(box, src=dist.get_global_rank(mesh.group, 0),
                               group=mesh.group, **kw)
    mesh.stats["broadcasts"] += 1
    return box[0]


def to_host(tree: Any) -> Any:
    """A params-shaped tree (tensors on any device, or numpy arrays) with
    host tensor leaves, for `broadcast_object`."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return QTensor(to_host(tree.q), to_host(tree.scale))
    return torch.as_tensor(tree).detach().cpu()


# -- follower processes --------------------------------------------------------------


def join_ranks(world: int, rank: int, init_method: str, backend: Optional[str],
               device: DeviceLike, argv: List[str], *, layout: str = "serving",
               **axes: Optional[int]) -> Tuple[Mesh, List[subprocess.Popen]]:
    """An entry point's ranks: rank 0 starts ranks 1..world-1 as `python
    <argv> --rank r --dist-init <rendezvous>` on a loopback rendezvous it
    picks, then every rank joins the group and builds the mesh for
    `layout` over `axes` (`make_mesh`'s; default: a model axis of the
    world), on `device` for every rank, else `cuda:<rank>`. A follower
    ends itself when its leader's process goes. Returns (mesh, the
    followers rank 0 started). The backend is checked before anything
    starts: nccl with ranks that share a card raises and names gloo."""
    dev = None if device is None else torch.device(device)
    if backend is None:
        backend = "gloo" if dev is not None and dev.type == "cpu" else "nccl"
    check_backend(backend, world, dev)
    followers = []
    if rank == 0:
        init_method = loopback_rendezvous()
        followers = spawn_followers(world, argv, init_method)
    else:
        exit_with_parent()
    try:
        init_ranks(world, rank, init_method, backend, dev)
        mesh = make_mesh(None if dev is None else [dev], layout=layout,
                         **(axes or {"model": world}))
        return mesh, followers
    except BaseException:
        stop_followers(followers, timeout=0)
        raise


def loopback_rendezvous() -> str:
    """A `tcp://127.0.0.1:<port>` rendezvous on a port free right now."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"tcp://127.0.0.1:{port}"


def spawn_followers(world: int, argv: List[str], init_method: str) -> List[subprocess.Popen]:
    """Start ranks 1..world-1 as fresh interpreters (never a fork of a
    process that may have initialised CUDA): `python <argv> --rank r
    --dist-init <init_method>`, in their own process group so a signal to
    the leader's terminal does not reach them before the leader stops
    them (`stop_followers`)."""
    return [subprocess.Popen([sys.executable, *argv, "--rank", str(r),
                              "--dist-init", init_method],
                             start_new_session=True)
            for r in range(1, world)]


def exit_with_parent(poll_s: float = 1.0) -> None:
    """In a follower: a daemon thread that ends this process when its
    parent (the leader that spawned it) is gone, whatever the backend
    would notice."""
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(poll_s)
        os._exit(1)

    threading.Thread(target=watch, daemon=True, name="exit-with-parent").start()


def stop_followers(procs: List[subprocess.Popen], timeout: float = 30.0) -> List[int]:
    """Wait for followers that were told to shut down, then kill what is
    left; returns their exit codes. No follower outlives this call."""
    deadline = time.monotonic() + timeout
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=max(0.1, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
            codes.append(p.wait())
    return codes
