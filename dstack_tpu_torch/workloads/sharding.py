"""Meshes and the tensor-parallel serving layout for the port (port of
`dstack_tpu.workloads.sharding`: `AXES`, `make_mesh`, the serving spec
tables and `_broadcast_specs`' structural rules).

Two mesh shapes run here:

- one device with a `seq` axis of n, whose n sequence shards take turns
  on that device through the ring (`attention._ring_attention_local`). No
  process group is involved; every other axis above 1 raises.
- a `model` axis over the ranks of a `torch.distributed` process group
  (`init_ranks`, then `make_mesh(model=n)`), one rank per device: the
  tensor-parallel serving engine (`serving.ServingEngine(mesh=)`). Rank r
  holds its slice of every weight and its KV heads, and the engine's host
  loop on rank 0 drives the same device programs on every rank.

The serving layout is the reference's column-parallel one: `model` rides
output dims only, so every contraction stays whole on each rank and the
collectives are all-gathers, which move bits and never re-reduce (the
reference's `SERVING_PARAM_SPECS` comment, `sharding.py:89-99`). A rank
computes its columns of every product as the unsharded program would, and
the gathered activations are the unsharded ones.

Specs are tuples of axis names (None: not sharded), one entry per dim;
`()` is replicated. There is no `PartitionSpec` in the port.

Transport. NCCL when each rank owns a card; gloo on the CPU and for ranks
that share one card (NCCL refuses two ranks on one device). gloo takes
only some collectives on CUDA tensors, so under gloo the helpers here copy
a CUDA tensor through host memory and back: the one-card transport, chosen
by the backend the caller named, never by catching an error.

Training across ranks (the `data`, `fsdp` and `expert` axes, a `model`
axis in `fine_tune`) and a `seq` axis over ranks are the next sharding
slice (ROADMAP Queue 1 item 3), and raise.
"""

import datetime
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field, fields, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from dstack_tpu_torch.workloads.device import DeviceLike, resolve_device
from dstack_tpu_torch.workloads.quant import QTensor

AXES = ("data", "fsdp", "seq", "model", "expert")
BACKENDS = ("nccl", "gloo")
# How long a collective waits for the other ranks (a serving leader's idle
# heartbeat, serving.HEARTBEAT_S, keeps its followers well inside it).
GROUP_TIMEOUT = datetime.timedelta(minutes=30)

_NEXT_SLICE = ("training across ranks (the data, fsdp and expert axes, a model axis"
               " in fine_tune) and a seq axis over ranks belong to the next sharding"
               " slice (ROADMAP Queue 1 item 3), not ported yet")
_ONE_DEVICE = ("without a process group the port runs one device with a seq axis"
               " (the ring's shards take turns on it); a model axis runs over the"
               " ranks of sharding.init_ranks, and " + _NEXT_SLICE)


@dataclass(frozen=True)
class Mesh:
    """A mesh of the port: this process's device, the size of each axis
    (`shape`, axis -> size, the field `make_attention_fn` and the remat
    estimate read), and for a mesh over ranks its process group, this
    rank's index on the `model` axis and the group's backend. `stats`
    counts the collectives this rank ran through the helpers below."""

    device: torch.device
    shape: Dict[str, int]
    group: Optional[Any] = None
    rank: int = 0
    backend: Optional[str] = None
    stats: Dict[str, float] = field(default_factory=lambda: {
        "all_gathers": 0, "all_gather_seconds": 0.0, "broadcasts": 0},
        compare=False)

    def __post_init__(self):
        if set(self.shape) != set(AXES) or any(n < 1 for n in self.shape.values()):
            raise ValueError(f"mesh axes {AXES} must each be >= 1, got {self.shape}")
        if self.group is None:
            if any(n > 1 for a, n in self.shape.items() if a != "seq"):
                raise NotImplementedError(f"mesh {self.shape}: {_ONE_DEVICE}")
        elif any(n > 1 for a, n in self.shape.items() if a != "model"):
            raise NotImplementedError(f"mesh {self.shape} over ranks: {_NEXT_SLICE}")

    @property
    def ranked(self) -> bool:
        """Whether this mesh spans the ranks of a process group (even a
        world of 1), so a serving engine drives its programs through ops."""
        return self.group is not None

    @property
    def staged(self) -> bool:
        """gloo carries CUDA tensors through host memory (the one-card
        transport); NCCL takes them where they are."""
        return self.backend == "gloo" and self.device.type == "cuda"


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
              expert: int = 1) -> Mesh:
    """A mesh over `devices`. Without a process group: one device
    (default: the CUDA device) with a seq axis. After `init_ranks`: a
    `model` axis over every rank of the group; `devices` is None
    (`cuda:<rank>`) or one device for every rank. `fsdp=None`
    takes the factor left after the other axes, which here is 1. (Two
    engines that serve at once over the same ranks each need a `Mesh` on
    a group of their own, from `torch.distributed.new_group`.)"""
    fsdp = 1 if fsdp is None else fsdp
    shape = dict(zip(AXES, (data, fsdp, seq, model, expert)))
    if not (dist.is_available() and dist.is_initialized()):
        devices = [resolve_device(None)] if devices is None else [
            resolve_device(d) for d in devices]
        if len(devices) != 1:
            raise NotImplementedError(f"a mesh over {len(devices)} devices: {_ONE_DEVICE}")
        return Mesh(devices[0], shape)
    group = dist.group.WORLD
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if model != world:
        raise ValueError(f"a model axis of {model} over a process group of {world} ranks")
    if devices is None:
        dev = resolve_device(torch.device("cuda", rank))
    elif len(devices) == 1:
        dev = resolve_device(devices[0])
    else:
        raise ValueError(f"{len(devices)} devices for {world} ranks: name none"
                         " (cuda:<rank>) or one for every rank")
    return Mesh(dev, shape, group=group, rank=rank, backend=dist.get_backend(group))


def model_shards(mesh: Optional[Mesh]) -> int:
    """The size of the `model` axis (1 without a mesh). Anything that is
    not a mesh of the port raises."""
    if mesh is None:
        return 1
    if not isinstance(mesh, Mesh):
        raise NotImplementedError(f"{type(mesh).__name__} is not a mesh of the port"
                                  f" (sharding.make_mesh): {_ONE_DEVICE}")
    return mesh.shape["model"]


def device_shards(mesh: Optional[Mesh]) -> Optional[Dict[str, int]]:
    """The device's real share of the activations, as `resolve_remat`'s
    `shards`. The reference divides the activations by the seq axis, since
    each of its devices holds 1/n of the sequence; here the n seq shards
    take turns on one device, which holds them all: a seq factor of 1.
    Training reads this, so a mesh over ranks raises (the next slice)."""
    if mesh is None:
        return None
    model_shards(mesh)
    if mesh.ranked:
        raise NotImplementedError(f"training on a mesh over ranks: {_NEXT_SLICE}")
    return {**mesh.shape, "seq": 1}


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


def shard(x: torch.Tensor, spec: Tuple, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's block of `x` under `spec` (a view): the dim that
    carries "model" cut into equal contiguous blocks in rank order, as
    `NamedSharding.devices_indices_map` places them; `x` itself when the
    spec replicates or there is one shard."""
    n = model_shards(mesh)
    if n == 1 or "model" not in spec:
        return x
    dim = spec.index("model")
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} shards")
    return x.chunk(n, dim=dim)[mesh.rank]


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


# -- collectives ------------------------------------------------------------------


def all_gather(x: torch.Tensor, dim: int, mesh: Optional[Mesh],
               axis: str = "model") -> torch.Tensor:
    """Concatenate every rank's `x` along `dim` in rank order (the
    inverse of `shard`). With no mesh or one shard it returns `x` itself:
    no copy, no launch. Under gloo a CUDA tensor goes through host memory
    and back (the one-card transport)."""
    if axis != "model":
        raise NotImplementedError(f"all_gather over {axis!r}: {_NEXT_SLICE}")
    n = model_shards(mesh)
    if n == 1:
        return x
    t0 = time.perf_counter()
    src = x.contiguous()
    if mesh.staged:
        # Page-locked both ways: the copy out waits for `x`; the copy back
        # is queued behind it on the stream without a host wait.
        host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        src = host.copy_(src)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=mesh.group)
    if not mesh.staged:
        out = torch.cat(parts, dim=dim)
    else:
        shape = list(src.shape)
        shape[dim] *= n
        out = torch.cat(parts, dim=dim, out=torch.empty(shape, dtype=src.dtype,
                                                         pin_memory=True))
        out = out.to(x.device, non_blocking=True)
    mesh.stats["all_gathers"] += 1
    mesh.stats["all_gather_seconds"] += time.perf_counter() - t0
    return out


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
               device: DeviceLike, argv: List[str]) -> Tuple[Mesh, List[subprocess.Popen]]:
    """An entry point's `--mesh-model` ranks: rank 0 starts ranks
    1..world-1 as `python <argv> --rank r --dist-init <rendezvous>` on a
    loopback rendezvous it picks, then every rank joins the group and
    builds the model mesh (`device` for every rank, else `cuda:<rank>`).
    A follower ends itself when its leader's process goes. Returns (mesh,
    the followers rank 0 started). The backend is checked before anything
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
        return make_mesh(None if dev is None else [dev], model=world), followers
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
