"""Meshes, the tensor-parallel serving layout and the training layout
for the port (port of `dstack_tpu.workloads.sharding`: `AXES`,
`make_mesh`, the spec tables, `_broadcast_specs`' structural rules,
`param_shardings` / `shard_tree` and `BATCH_SPEC`).

Three mesh shapes run here:

- one device with a `seq` axis of n, whose n sequence shards take turns
  on that device through the ring (`attention._ring_attention_local`). No
  process group is involved; every other axis above 1 raises.
- a serving mesh: a `model` axis, and optionally an `expert` axis, over
  the ranks of a `torch.distributed` process group (`init_ranks`, then
  `make_mesh(model=m, expert=e)`), one rank per device: the
  tensor-parallel serving engine (`serving.ServingEngine(mesh=)`).
  Rank r holds its slice of every weight and its KV heads, and the
  engine's host loop on rank 0 drives the same device programs on every
  rank.
- a training mesh (`make_mesh(data=, fsdp=, seq=, model=, expert=,
  layout="training")` over the ranks): the trainer
  (`train.make_train_step(config, mesh)`) on the reference's PARAM_SPECS.
  Rank r's coordinates are its row-major index in AXES order, the
  reference's `np.array(devices).reshape(shape)`, so rank r holds the
  slices JAX device r holds under the same `NamedSharding`.

The serving layout is the reference's column-parallel one: `model` rides
output dims only, so every contraction stays whole on each rank and the
collectives are all-gathers, which move bits and never re-reduce (the
reference's `SERVING_PARAM_SPECS` comment, `sharding.py:89-99`). A rank
computes its columns of every product as the unsharded program would, and
the gathered activations are the unsharded ones.

The training layout is the reference's scaling-book one, written out as
the collectives GSPMD would insert: batch rows over (data, fsdp) and the
sequence over seq (BATCH_SPEC); weights cut over fsdp on their input dim
and whole again at use (`gather_fsdp`, whose backward is the
reduce-scatter of the grads); wq/wk/wv/w_gate/w_up column-parallel and
wo/w_down row-parallel on `model` with Megatron's pair around each
(`enter_model`: identity forward, grads summed over model in backward;
`reduce_model`: partial sums summed over model forward, identity
backward); attention over the seq axis as the ring across ranks
(`attention._RankRing`, its K/V hops through `ppermute`); the grad
all-reduce over data, seq and what fsdp's reduce-scatter did not cover
after the backward (`reduce_grads`, `grad_axes`). The expert axis holds
each rank's block of E/expert experts of every bank (`we_*` on "expert")
while the batch stays on (data, fsdp) only, as the reference's BATCH_SPEC
and its constraints around the expert FFN (`moe.py:150-154`) lay it out:
every rank of an expert line holds the same tokens, dispatches them to
its own experts behind `enter_expert` (identity forward, the tokens' grad
summed over expert in backward) and gathers every expert's output with
`gather_experts` (an all-gather forward whose backward takes this rank's
block and sums nothing). At that layout there is no token all-to-all.

Specs are tuples of axis names (None: not sharded; a tuple of names: the
axes' combined index, row-major), one entry per dim; `()` is replicated.
There is no `PartitionSpec` in the port.

Transport. NCCL when each rank owns a card; gloo on the CPU and for ranks
that share one card (NCCL refuses two ranks on one device). gloo takes
only some collectives on CUDA tensors and has no reduce-scatter, so under
gloo the helpers here copy a CUDA tensor through pinned host memory and
back, and a reduce-scatter is an all-reduce of which each rank keeps its
block: the one-card transport, chosen by the backend the caller named,
never by catching an error. `ppermute` is the reference's `lax.ppermute`
by a shift along one axis line (send to the next rank, receive from the
previous one, both posted before either waits); it has no autograd of its
own: the ring and the pipeline call it from explicit schedules that are
the same on every rank, forward and backward.

Hosts. An entry point's ranks start on one host (its rank 0 starts the
others) or, in a job the orchestrator spread over hosts, as a gang
(`Gang`, `gang_from_env`): from the variables the orchestrator injects
into every host (`JAX_COORDINATOR_ADDRESS`, `JAX_PROCESS_ID`,
`JAX_NUM_PROCESSES`, which `jax.distributed.initialize()` reads) each
host's process starts its host's ranks, rank = process id x ranks a host
+ the rank's index on its host, and every rank joins one group at the
coordinator's address (`start_ranks`). A rank's card is its index on its
host. Everything above holds across hosts as it does on one: groups,
rows and collectives follow global ranks.

A serving mesh may also carry an expert axis (`make_mesh(model=m,
expert=e)`, m x e ranks, the expert coordinate the faster): the banks
`we_*` ride "expert" on their expert dim and "model" on their output
columns (SERVING_PARAM_SPECS), every other weight and the KV pools are cut
on model only, so they replicate over expert. Every rank holds every
token; an MoE FFN runs the rank's block of E/e experts and gathers their
outputs over the expert line (`gather_experts`, with no autograd there), and
the combine runs whole on every rank. Such a mesh has a process group for
each line of ranks along its axes (`mesh.groups`), as a training mesh does.
"""

import datetime
import gc
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
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

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

_ONE_DEVICE = ("without a process group the port runs one device with a seq axis"
               " (the ring's shards take turns on it); the model, data, fsdp, seq and"
               " expert axes run over the ranks of sharding.init_ranks (the sharding"
               " slices, ROADMAP Queue 1 item 3)")


def _stats() -> Dict[str, float]:
    return {"all_gathers": 0, "all_gather_seconds": 0.0, "all_gather_bytes": 0,
            "broadcasts": 0, "all_reduces": 0, "all_reduce_seconds": 0.0,
            "all_reduce_bytes": 0, "reduce_scatters": 0, "reduce_scatter_seconds": 0.0,
            "reduce_scatter_bytes": 0, "hops": 0, "hop_seconds": 0.0, "hop_bytes": 0}


@dataclass(frozen=True)
class Mesh:
    """A mesh of the port: this process's device, the size of each axis
    (`shape`, axis -> size, the field `make_attention_fn` and the remat
    estimate read), and for a mesh over ranks its process group, this
    rank's index in it (row-major over the axes, the expert axis fastest),
    the group's backend, the layout it was cut for, and a training mesh's
    sub-group for each set of axes (`groups`, axes tuple -> group, every
    rank's line of ranks along those axes). `stats` counts the collectives
    this rank ran through the helpers below, their seconds and the bytes
    this rank put into them."""

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
        if self.layout == "serving" and (
                self.shape["data"] * self.shape["fsdp"] * self.shape["seq"] > 1):
            raise ValueError(f"mesh {self.shape}: the serving layout shards the model"
                             " and expert axes only; a data, fsdp or seq axis is the"
                             " trainer's (make_mesh(..., layout='training'))")

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
    def axes(self) -> Tuple[str, ...]:
        """The mesh's axis names, in the row-major order of its ranks."""
        return AXES

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's index on each axis: its rank, row-major in AXES order."""
        idx = np.unravel_index(self.rank, [self.shape[a] for a in AXES])
        return {a: int(i) for a, i in zip(AXES, idx)}


def check_backend(backend: str, world: int, device: Optional[torch.device],
                  gang: Optional["Gang"] = None) -> None:
    """Refuse a backend that cannot carry `world` ranks: nccl off CUDA, or
    with fewer cards than this host's ranks (all `world` of them on one
    host, `gang.per_host` in a gang), or with those ranks all on the one
    `device` (NCCL refuses two ranks on one card); the message names gloo."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend != "nccl":
        return
    if device is not None and device.type != "cuda":
        raise ValueError(f"backend 'nccl' runs on CUDA devices, not {device};"
                         " use backend='gloo' on the CPU")
    here = world if gang is None else gang.per_host
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < here or (device is not None and here > 1):
        where = f"every rank on {device}" if device is not None else f"{cards} card(s)"
        ranks = f"{here} ranks" + ("" if gang is None else " of this host")
        raise ValueError(
            f"backend 'nccl' runs one rank per card: {ranks} on {where};"
            " NCCL refuses two ranks on one device, pass backend='gloo' (the"
            " one-card transport) for ranks that share a card")


def init_ranks(world: int, rank: int, init_method: str, backend: Optional[str] = None,
               device: DeviceLike = None, gang: Optional["Gang"] = None) -> torch.device:
    """Join a process group of `world` ranks as `rank`, rendezvous at
    `init_method` (`tcp://<host>:<port>` or `file://<path>`), and
    return this rank's device: `device` for every rank when one is named
    (the one-card smoke, the CPU tests), else `cuda:<index>` by the rank's
    index on its host (`rank_device`; the rank itself on one host).
    `backend` defaults to nccl for CUDA and gloo for the CPU; nccl with
    fewer cards than this host's ranks, or with every rank on one named
    card, raises and names gloo. Nothing switches the backend on its own."""
    dev = rank_device(rank, gang, device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    check_backend(backend, world, torch.device(device) if device is not None else None, gang)
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, world_size=world,
                            rank=rank, timeout=GROUP_TIMEOUT, **kw)
    return dev


def make_mesh(devices: Optional[Sequence[DeviceLike]] = None, *, data: int = 1,
              fsdp: Optional[int] = None, seq: int = 1, model: int = 1,
              expert: int = 1, layout: str = "serving", group: Any = None) -> Mesh:
    """A mesh over `devices`. Without a process group: one device
    (default: the CUDA device) with a seq axis. After `init_ranks`: a mesh
    over every rank of `group` (default: the whole world), cut for
    `layout` ("serving": model and expert axes, the tensor-parallel
    engine's; "training": data, fsdp, seq, model and expert, the
    trainer's), whose axis sizes multiply to the group's size; `devices` is
    None (`cuda:<rank>`, one host) or this rank's one device (the same for
    every rank on one card; a gang's rank passes its own, `rank_device`). `fsdp=None` takes
    the factor left after the other axes, as the reference's (`:45-49`).
    A training mesh, and a serving mesh with an expert axis, makes one
    sub-group per line of ranks along each set of its axes, every rank of
    `group` creating every group in the same order. (Two engines that
    serve at once over the same ranks each need a mesh on a group of their
    own: `group=torch.distributed.new_group(...)`.)"""
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
    group = dist.group.WORLD if group is None else group
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
    if layout == "training" or expert > 1:
        mesh.groups.update(_line_groups(shape, rank, group=group))
    return mesh


def _line_groups(shape: Dict[str, int], rank: int, order: Sequence[str] = AXES,
                 group: Any = None) -> Dict[Tuple[str, ...], Any]:
    """For each set of the axes above 1, the group of ranks that differ
    from this one only along those axes (its ranks in ascending order,
    which is their row-major index over the set; ranks are row-major over
    `order` and numbered within `group`, the whole world by default).
    Every rank of `group` calls `new_group` for every line in the same
    order; a line that spans `group` is `group` itself."""
    group = dist.group.WORLD if group is None else group
    glob = ((lambda r: r) if group is dist.group.WORLD
            else (lambda r: dist.get_global_rank(group, r)))
    sizes = [shape[a] for a in order]
    world = math.prod(sizes)
    coords = [np.unravel_index(r, sizes) for r in range(world)]
    live = [a for a in order if shape[a] > 1]
    out = {}
    for k in range(1, len(live) + 1):
        for axes in itertools.combinations(live, k):
            lines: Dict[Tuple[int, ...], List[int]] = {}
            for r, c in enumerate(coords):
                key = tuple(int(c[i]) for i, a in enumerate(order) if a not in axes)
                lines.setdefault(key, []).append(r)
            for key in sorted(lines):
                ranks = lines[key]
                g = (group if len(ranks) == world
                     else dist.new_group([glob(r) for r in ranks], timeout=GROUP_TIMEOUT))
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
    fsdp) of the batch rows, 1/seq of the sequence and 1/(fsdp * model) of
    the weights (1/expert more of the expert banks, which the reference's
    estimate, `config.py:114`, spreads over every weight), the mesh's own
    shape (the caller sizes the activations by the global batch, as the
    reference's traced shapes are)."""
    if training_mesh(mesh) is None:
        return None
    if mesh.ranked:
        return dict(mesh.shape)
    return {**mesh.shape, "seq": 1}


def batch_shards(mesh: Optional[Mesh]) -> int:
    """How many ranks split the batch rows (data x fsdp; 1 off a mesh):
    every rank of an expert line holds the same rows."""
    return 1 if mesh is None else mesh.shape["data"] * mesh.shape["fsdp"]


def seq_ranks(mesh: Optional[Mesh]) -> int:
    """How many ranks split the sequence (a training mesh's seq axis; 1
    off a mesh and on the one-device seq mesh, whose device holds every
    shard). Anything that is not a mesh of the port raises."""
    model_shards(mesh)
    return mesh.shape["seq"] if mesh is not None and mesh.training else 1


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
    model_shards(mesh)
    if mesh is None or not mesh.ranked or not any(spec):
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
    """This rank's block of a global batch under BATCH_SPEC (views): its
    rows over (data, fsdp) and its stretch of the sequence over seq."""
    return {k: shard(v, BATCH_SPEC[:v.dim()], mesh) for k, v in batch.items()}


# -- collectives ------------------------------------------------------------------


def _group(mesh: Mesh, axes: Sequence[str]) -> Tuple[Any, int]:
    """The process group of this rank's line along `axes` (the axes above
    1, in the mesh's axis order) and its size: the mesh's own group where
    the line spans it (a serving mesh of one axis)."""
    live = tuple(a for a in mesh.axes if a in axes and mesh.shape[a] > 1)
    n = math.prod(mesh.shape[a] for a in live)
    if n == 1:
        return None, 1
    if not mesh.training:
        if any(a not in ("model", "expert") for a in live):
            raise ValueError(f"a serving mesh has no {live} axes")
        if n == math.prod(mesh.shape.values()):
            return mesh.group, n
        if live not in mesh.groups:
            raise ValueError(f"serving mesh {mesh.shape} has no group for its {live}"
                             " lines: build it with make_mesh(..., group=)")
    return mesh.groups[live], n


def _count(mesh: Mesh, kind: str, t0: float, x: torch.Tensor) -> None:
    mesh.stats[kind + "s"] += 1
    mesh.stats[kind + "_seconds"] += time.perf_counter() - t0
    mesh.stats[kind + "_bytes"] += x.numel() * x.element_size()


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
    _count(mesh, "all_gather", t0, src)
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


def _p2p(mesh: Mesh, group: Any, sends, recvs) -> List[torch.Tensor]:
    """Post every send [(tensor, group rank)] and every receive [(template,
    group rank)] of this rank on `group` (`batch_isend_irecv`), then wait
    for all of them; returns the received tensors on the mesh's device.
    Peers are named by their global ranks (`get_global_rank`). Under gloo a
    CUDA tensor goes through pinned host memory both ways. Counts one hop,
    its bytes sent and its seconds in `mesh.stats`."""
    t0 = time.perf_counter()
    out = [x.detach().contiguous() for x, _ in sends]
    if mesh.staged:
        out = [_pinned_like(x).copy_(x) for x in out]
    into = [_pinned_like(x) if mesh.staged else torch.empty_like(x) for x, _ in recvs]
    ops = ([dist.P2POp(dist.isend, x, dist.get_global_rank(group, r), group)
            for x, (_, r) in zip(out, sends)]
           + [dist.P2POp(dist.irecv, x, dist.get_global_rank(group, r), group)
              for x, (_, r) in zip(into, recvs)])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if mesh.staged:
        into = [x.to(mesh.device, non_blocking=True) for x in into]
    mesh.stats["hops"] += 1
    mesh.stats["hop_seconds"] += time.perf_counter() - t0
    mesh.stats["hop_bytes"] += sum(x.numel() * x.element_size() for x in out)
    return into


def ppermute(xs, mesh: Mesh, axis: str, shift: int = 1):
    """The reference's `lax.ppermute` by `shift` along `axis`: each tensor
    of `xs` (one tensor or a list) goes to the rank `shift` further on this
    rank's line of `axis` (wrapping), and the same-shaped tensors of the
    rank `shift` back arrive in their place. Every send and receive is
    posted before any is waited on, so a ring of any size, 2 included,
    cannot block on itself. No autograd: callers run it from an explicit
    schedule that every rank of the line follows in the same order."""
    single = torch.is_tensor(xs)
    xs = [xs] if single else list(xs)
    group, n = _group(mesh, (axis,))
    if n == 1:
        return xs[0] if single else xs
    me = mesh.coords[axis]
    got = _p2p(mesh, group, [(x, (me + shift) % n) for x in xs],
               [(x, (me - shift) % n) for x in xs])
    return got[0] if single else got


def exchange(mesh: Mesh, axis: str, *, send: Optional[torch.Tensor] = None,
             dst: Optional[int] = None, recv_like: Optional[torch.Tensor] = None,
             src: Optional[int] = None) -> Optional[torch.Tensor]:
    """A point-to-point exchange on this rank's line of `axis`: `send` to
    the rank at coordinate `dst` and/or a tensor shaped like `recv_like`
    from the rank at coordinate `src`, both posted before either waits;
    returns what arrived (None without `recv_like`). The pipeline's
    neighbour exchange; no autograd, as `ppermute`."""
    group, n = _group(mesh, (axis,))
    if n == 1:
        raise ValueError(f"no exchange on an {axis} axis of one rank")
    got = _p2p(mesh, group, [] if send is None else [(send, dst)],
               [] if recv_like is None else [(recv_like, src)])
    return got[0] if got else None


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
    _count(mesh, "all_reduce", t0, buf)
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
    _count(mesh, "reduce_scatter", t0, x)
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


class _EnterExpert(torch.autograd.Function):
    """The tokens that enter a rank's experts: identity forward; the
    backward sums the grad over the expert axis (each rank's experts
    contribute their part of the tokens' grad)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ("expert",)), None


class _GatherExperts(torch.autograd.Function):
    """Every rank's block of experts' outputs along `dim`, in expert order;
    the backward takes this rank's block of the grad and sums nothing: the
    combine that reads the gathered outputs runs alike on every rank of
    the expert line, so the grad that reaches here is the same whole grad
    on each of them."""

    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh, ctx.size = dim, mesh, x.shape[dim]
        return gather_axes(x, dim, mesh, ("expert",))

    @staticmethod
    def backward(ctx, g):
        start = ctx.mesh.coords["expert"] * ctx.size
        return g.narrow(ctx.dim, start, ctx.size), None, None


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


def enter_expert(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The tokens dispatched to this rank's experts on a training mesh's
    expert axis (identity forward, grad summed over expert); `x` itself
    elsewhere. Only what enters the experts goes through it, never the
    router's input, whose grad is already whole on every rank."""
    return _EnterExpert.apply(x, mesh) if _splits(mesh, "expert") else x


def gather_experts(x: torch.Tensor, dim: int, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every rank's experts' outputs concatenated along `dim` in expert
    order: on a training mesh's expert axis with its backward (this rank's
    block, unsummed); on a serving mesh's, a plain all-gather under no_grad
    (the serving programs take no grads); `x` itself elsewhere."""
    if serves_experts(mesh):
        with torch.no_grad():
            return gather_axes(x, dim, mesh, ("expert",))
    return _GatherExperts.apply(x, dim, mesh) if _splits(mesh, "expert") else x


def serves_experts(mesh: Optional[Mesh]) -> bool:
    """Whether `mesh` is a serving mesh over ranks whose expert axis cuts
    the banks (False for no mesh and other meshes)."""
    model_shards(mesh)
    return (mesh is not None and mesh.ranked and not mesh.training
            and mesh.shape["expert"] > 1)


def expert_block(n_experts: int, mesh: Optional[Mesh]) -> Tuple[int, int]:
    """[e0, e1): the experts this rank's banks hold, its block of
    `n_experts` by its expert coordinate on a training mesh or a serving
    mesh with an expert axis; all of them elsewhere. An expert axis that
    does not divide them raises ValueError."""
    if not (_splits(mesh, "expert") or serves_experts(mesh)):
        return 0, n_experts
    n = mesh.shape["expert"]
    if n_experts % n:
        raise ValueError(f"the expert axis ({n}) must divide n_experts ({n_experts})")
    size = n_experts // n
    return mesh.coords["expert"] * size, (mesh.coords["expert"] + 1) * size


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
    data and seq always (each data row of ranks saw other rows, each seq
    rank other positions; every leaf is replicated over seq), and fsdp for
    a leaf the fsdp gather's reduce-scatter did not reach. The model axis
    needs none: Megatron's pair leaves a leaf replicated over model with
    the same whole grad on every model rank. Nor does the expert axis: the
    ranks of an expert line hold the same rows, an expert bank's grad is
    its own block's (no other rank holds those experts), and a leaf
    replicated over expert gets the same whole grad on every expert rank
    once `enter_expert` has summed the tokens' grad over the line."""
    return ("data", "seq") if "fsdp" in spec else ("data", "fsdp", "seq")


def reduce_grads(grads: List[Tuple[str, torch.Tensor]], mesh: Optional[Mesh],
                 axes_of) -> List[Tuple[str, torch.Tensor]]:
    """[(path, grad)] with each grad all-reduced over `axes_of(path)` on
    a training mesh (the data axis's all-reduce); as given elsewhere."""
    if mesh is None or not mesh.training:
        return grads
    return [(k, all_reduce(g, mesh, axes_of(k))) for k, g in grads]


def batch_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """`x` summed over the axes that split the batch's tokens (data, fsdp
    and seq) of a training mesh."""
    if mesh is None or not mesh.training:
        return x
    return all_reduce(x, mesh, ("data", "fsdp", "seq"))


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


# -- the gang: one process per host ---------------------------------------------------

# The orchestrator's contract with every host of a gang, the variables
# `jax.distributed.initialize()` reads (the port's own copy of
# dstack_tpu/parallel/env.py's `make_cluster_env` and `jax_initialize_kwargs`).
COORDINATOR_ENV = "JAX_COORDINATOR_ADDRESS"
PROCESS_ID_ENV = "JAX_PROCESS_ID"
NUM_PROCESSES_ENV = "JAX_NUM_PROCESSES"


class Gang(NamedTuple):
    """A job the orchestrator spread over `hosts` hosts, one process each:
    this host's index (`JAX_PROCESS_ID`), the coordinator's `host:port`
    (`JAX_COORDINATOR_ADDRESS`) and how many ranks each host runs. Global
    rank = host_id x per_host + the rank's index on its host: JAX's device
    order, process 0's devices first."""

    hosts: int
    host_id: int
    coordinator: str
    per_host: int

    @property
    def ranks(self) -> range:
        """This host's global ranks."""
        return range(self.host_id * self.per_host, (self.host_id + 1) * self.per_host)

    @property
    def init_method(self) -> str:
        """The rendezvous every rank of every host joins; global rank 0
        hosts its store."""
        return f"tcp://{self.coordinator}"

    def local(self, rank: int) -> int:
        """`rank`'s index on this host; a rank of another host raises."""
        if rank not in self.ranks:
            raise ValueError(f"rank {rank} is not one of host {self.host_id}'s ranks"
                             f" {self.ranks.start}-{self.ranks.stop - 1}"
                             f" ({PROCESS_ID_ENV}={self.host_id})")
        return rank - self.ranks.start

    def describe(self, world: int) -> str:
        """A host leader's line, in the manner of the JAX trainer's."""
        return (f"process {self.host_id}/{self.hosts} runs ranks {self.ranks.start}-"
                f"{self.ranks.stop - 1} of {world}")


def gang_hosts(env: Mapping[str, str]) -> int:
    """The hosts of the gang, `JAX_NUM_PROCESSES` (1 when unset); a value
    that is not a count raises ValueError naming the variable."""
    raw = env.get(NUM_PROCESSES_ENV) or "1"
    if not raw.isdigit() or int(raw) < 1:
        raise ValueError(f"{NUM_PROCESSES_ENV}={raw!r} is not a number of hosts")
    return int(raw)


def gang_from_env(env: Mapping[str, str], world: int) -> Optional[Gang]:
    """The gang the orchestrator's variables describe for a world of
    `world` ranks, or None when `JAX_NUM_PROCESSES` is 1 or unset (the JAX
    trainers' own test). A missing or malformed `JAX_COORDINATOR_ADDRESS`
    (host:port), a `JAX_PROCESS_ID` missing or outside 0..N-1, or a world
    that is not a multiple of the hosts raises ValueError naming the
    variable, before anything starts."""
    hosts = gang_hosts(env)
    if hosts == 1:
        return None
    coordinator = env.get(COORDINATOR_ENV, "")
    host, _, port = coordinator.rpartition(":")
    if not host or not port.isdigit() or not 0 < int(port) < 65536:
        raise ValueError(f"{COORDINATOR_ENV}={coordinator!r}: a gang of {hosts} hosts"
                         " joins at the coordinator's host:port")
    raw = env.get(PROCESS_ID_ENV, "")
    if not raw.isdigit() or int(raw) >= hosts:
        raise ValueError(f"{PROCESS_ID_ENV}={raw!r}: this host's index must be one of"
                         f" 0..{hosts - 1} ({NUM_PROCESSES_ENV}={hosts})")
    if world < hosts or world % hosts:
        raise ValueError(f"{world} ranks over {NUM_PROCESSES_ENV}={hosts} hosts: the"
                         " ranks must be a multiple of the hosts")
    return Gang(hosts, int(raw), coordinator, world // hosts)


def gang_world(env: Mapping[str, str], ranks: Optional[int], device: DeviceLike,
               one_host: int) -> Tuple[int, Optional[Gang]]:
    """An entry point's world and its gang (`gang_from_env`): `ranks` when
    given; else in a gang every card of every host (the JAX trainer's
    `jax.device_count()`), or one rank a host when every rank runs on one
    named device; else `one_host`. Raises ValueError as `gang_from_env`."""
    hosts = gang_hosts(env)
    if ranks is None and hosts == 1:
        ranks = one_host
    elif ranks is None:
        cards = (1 if device is not None else
                 torch.cuda.device_count() if torch.cuda.is_available() else 0)
        if cards == 0:
            raise ValueError("no CUDA device on this host: name the ranks and their device")
        ranks = hosts * cards
    return ranks, gang_from_env(env, ranks)


def rank_device(rank: int, gang: Optional[Gang] = None,
                device: DeviceLike = None) -> torch.device:
    """A rank's device: `device` for every rank when one is named, else
    `cuda:<its index on its host>` (`cuda:<rank>` on one host)."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda", rank if gang is None else gang.local(rank))


def own_command(argv: Sequence[str]) -> List[str]:
    """An entry point's command less the rank flags its leader adds."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a in ("--rank", "--dist-init"):
            skip = True
        elif not a.startswith(("--rank=", "--dist-init=")):
            out.append(a)
    return out


def first_difference(a: Sequence[str], b: Sequence[str]) -> str:
    """The flag at which two commands first part: the flag itself, or the
    flag whose value differs."""
    for i, (x, y) in enumerate(itertools.zip_longest(a, b)):
        if x == y:
            continue
        for t in (x, y):
            if t is not None and t.startswith("-"):
                return t.split("=")[0]
        if i and a[i - 1].startswith("-"):
            return a[i - 1]
        return repr(x if x is not None else y)
    return ""


def same_command(argv: Sequence[str], gang: Gang) -> None:
    """Every rank's command against global rank 0's, in one gather of
    objects: hosts that run different commands would otherwise hang in
    mismatched collectives until GROUP_TIMEOUT. A mismatch raises
    ValueError on every rank, naming the first flag that differs."""
    every: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(every, own_command(argv))
    for r, cmd in enumerate(every):
        if cmd != every[0]:
            raise ValueError(
                f"the hosts run different commands: rank {r} (host {r // gang.per_host})"
                f" differs from rank 0 at {first_difference(every[0], cmd)}:"
                f" {' '.join(cmd)} against {' '.join(every[0])}")


def start_ranks(world: int, rank: int, init_method: str, backend: Optional[str],
                device: DeviceLike, argv: List[str], gang: Optional[Gang] = None
                ) -> Tuple[int, List[subprocess.Popen]]:
    """Join this process to an entry point's `world` ranks; returns (its
    global rank, the followers it started).

    On one host (`gang` None) rank 0 is the leader: it picks a loopback
    rendezvous and starts ranks 1..world-1. In a gang every host's process
    is its host's leader (started without `--dist-init`): it takes its
    host's first rank, starts the host's other ranks, and every rank of
    every host joins at `tcp://$JAX_COORDINATOR_ADDRESS`; a rank's card is
    its index on its host. Followers run `python <argv> --rank r
    --dist-init <rendezvous>`, inherit the environment, refuse a rank that
    is not their host's, and end themselves when their leader goes. In a
    gang every rank then checks that it runs global rank 0's command
    (`same_command`). The backend is checked before anything starts: nccl
    with ranks that share a card raises and names gloo."""
    dev = None if device is None else torch.device(device)
    if backend is None:
        backend = "gloo" if dev is not None and dev.type == "cpu" else "nccl"
    check_backend(backend, world, dev, gang)
    if gang is None:
        leader, ranks = rank == 0, range(1, world)
        if leader:
            init_method = loopback_rendezvous()
    else:
        leader, ranks = not init_method, gang.ranks[1:]
        if leader:
            rank, init_method = gang.ranks.start, gang.init_method
        gang.local(rank)  # a follower given another host's rank raises
    followers = spawn_followers(ranks, argv, init_method) if leader else []
    if not leader:
        exit_with_parent()
    try:
        init_ranks(world, rank, init_method, backend, dev, gang)
    except BaseException:
        stop_followers(followers, timeout=0)
        raise
    if gang is not None:
        try:
            same_command(argv, gang)
        except BaseException:
            # Every rank raises here: the followers end on their own.
            leave_ranks()
            stop_followers(followers)
            raise
    return rank, followers


def join_ranks(world: int, rank: int, init_method: str, backend: Optional[str],
               device: DeviceLike, argv: List[str], *, layout: str = "serving",
               gang: Optional[Gang] = None,
               **axes: Optional[int]) -> Tuple[Mesh, List[subprocess.Popen]]:
    """An entry point's ranks (`start_ranks`, on one host or over the
    hosts of `gang`), then the mesh for `layout` over `axes` (`make_mesh`'s;
    default: a model axis of the world), on `device` for every rank, else
    each rank's card on its host. Returns (mesh, the followers this
    process started)."""
    rank, followers = start_ranks(world, rank, init_method, backend, device, argv, gang)
    try:
        mesh = make_mesh([rank_device(rank, gang, device)], layout=layout,
                         **(axes or {"model": world}))
        return mesh, followers
    except BaseException:
        stop_followers(followers, timeout=0)
        raise


def leave_ranks(mesh: Optional[Mesh] = None) -> None:
    """Leave the process group for good, after the last collective: drop
    `mesh`'s handles on its groups (the mesh is unusable after), collect
    what else held one, then destroy every group. The backend joins a
    group's threads when the last handle on it goes, and destroying the
    groups does not drop a handle a Python object still holds; a gloo
    group whose last handle goes only at interpreter teardown aborts the
    process there ("terminate called without an active exception", exit
    134) one exit in a few dozen."""
    if mesh is not None:
        mesh.groups.clear()
        object.__setattr__(mesh, "group", None)
    gc.collect()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def loopback_rendezvous() -> str:
    """A `tcp://127.0.0.1:<port>` rendezvous on a port free right now."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"tcp://127.0.0.1:{port}"


def spawn_followers(ranks: Sequence[int], argv: List[str],
                    init_method: str) -> List[subprocess.Popen]:
    """Start `ranks` as fresh interpreters (never a fork of a process that
    may have initialised CUDA): `python <argv> --rank r --dist-init
    <init_method>`, in their own process group so a signal to the
    leader's terminal does not reach them before the leader stops them
    (`stop_followers`)."""
    return [subprocess.Popen([sys.executable, *argv, "--rank", str(r),
                              "--dist-init", init_method],
                             start_new_session=True)
            for r in ranks]


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
