"""GPipe pipeline parallelism over a "pipe" axis of ranks, composed with
data parallelism over a "data" axis (port of
`dstack_tpu.workloads.pipeline`):

    mesh = make_pipeline_mesh(data=2, pipe=2)     # after sharding.init_ranks
    state = init_pipeline_state(config, 0, mesh)
    step = make_pipeline_train_step(config, mesh, n_microbatches=4)

The layer stack is cut into P equal stages (`stage_params`: (L, ...) ->
(P, L/P, ...)); rank r sits at (data r // P, pipe r % P), the reference's
`np.array(devices).reshape(data, pipe)`, and holds stage `pipe`'s (1, L/P,
...) slice of every layer leaf, with embed, final_norm and lm_head
replicated (the reference's `_param_specs`); AdamW's moments follow their
params. Batch rows split over data (`pipeline_batch`).

The schedule is explicit GPipe with stage-local autograd. Forward: for
each microbatch m in order, stage 0 embeds and injects it, every other
stage receives its input from the stage before (detached, then marked for
grad), runs its L/P layers through `make_attention_fn(None)` (the flash
kernels on the card, plain attention on the CPU) and sends its output on.
The last stage computes final_norm, lm_head and the CE over every
microbatch's output at once (the reference's `ce_from_logits` on the
data shard's B rows, full logits), then the backward takes the
microbatches in reverse: the last stage starts from the loss's grads,
every other stage receives the grad of its output, backpropagates through
its own layers, and a stage above 0 sends the grad of its input back;
stage 0's backward reaches the embedding. Every exchange is a
`sharding.exchange` between neighbouring stages at a point of this
schedule fixed by (stage, microbatch) alone; none is left to the autograd
engine to reach or skip.

Against the reference's tick scan (microbatch m at stage s on tick m + s,
collected from the last stage at tick m + P - 1; `pipeline.py:20-24`,
`:143-170`): every microbatch meets the same weights on every stage there
as here, so the loss and grads are GPipe's flush either way. The port
skips the reference's bubble ticks (a stage's tick before its first or
after its last microbatch), whose outputs never reach the loss.

Grads and metrics follow the reference exactly (`pipeline.py:224-253`):
embed, final_norm and lm_head grads are summed over pipe (each comes from
one stage; every stage's replica then takes the same AdamW step and the
replicas stay equal bit for bit), then every grad is averaged over data;
the loss is pmean_data(psum_pipe(loss)), a mean of the data shards'
masked means (not the trainer's global token mean, which differs under
an uneven mask); grad_norm is sqrt(psum_pipe(sum of the layer leaves'
squares) + the shared leaves' squares).

A pipeline axis combined with seq, fsdp or model is out of scope, as in
the reference (`pipeline.py:16-19`).
"""

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from dstack_tpu_torch.workloads.attention import make_attention_fn
from dstack_tpu_torch.workloads.config import ModelConfig
from dstack_tpu_torch.workloads.device import DeviceLike, resolve_device
from dstack_tpu_torch.workloads.sharding import (
    _line_groups,
    _stats,
    all_reduce,
    exchange,
)
from dstack_tpu_torch.workloads.train import (
    TrainState,
    ce_from_logits,
    make_optimizer,
    synthetic_batch,
)
from dstack_tpu_torch.workloads.transformer import (
    _block,
    _layer_slices,
    apply_remat,
    init_params,
    logits_linear,
    rms_norm,
)
from dstack_tpu_torch.workloads.weights import flatten_params, unflatten_params

Params = Dict[str, Any]

PIPE_AXES = ("data", "pipe")
# The leaves every stage holds whole (the reference's `shared`).
SHARED = ("embed", "final_norm", "lm_head")


@dataclass(frozen=True)
class PipelineMesh:
    """A (data, pipe) mesh over the ranks of a process group: this rank's
    device, the axis sizes, the group, this rank's index in it, the
    backend, and one sub-group per line of ranks along each set of axes
    (`groups`, as a training mesh's; sharding's collectives take it).
    `stats` counts the exchanges and collectives of this rank."""

    device: torch.device
    shape: Dict[str, int]
    group: Optional[Any] = None
    rank: int = 0
    backend: Optional[str] = None
    groups: Dict[Tuple[str, ...], Any] = field(default_factory=dict, compare=False)
    stats: Dict[str, float] = field(default_factory=_stats, compare=False)

    @property
    def axes(self) -> Tuple[str, ...]:
        return PIPE_AXES

    @property
    def training(self) -> bool:
        return True

    @property
    def staged(self) -> bool:
        """gloo carries CUDA tensors through host memory (as sharding.Mesh)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def coords(self) -> Dict[str, int]:
        """(data, pipe) = (rank // pipe, rank % pipe), the reference's reshape."""
        return {"data": self.rank // self.shape["pipe"], "pipe": self.rank % self.shape["pipe"]}


def make_pipeline_mesh(devices: Optional[Sequence[DeviceLike]] = None, *, data: int = 1,
                       pipe: int = 2) -> PipelineMesh:
    """A (data, pipe) mesh over every rank of the process group
    (sharding.init_ranks first; a mesh of one rank needs no group).
    `devices` is None (`cuda:<rank>`, one host) or this rank's one device
    (the same for every rank on one card; a gang's rank passes its own,
    `sharding.rank_device`). Every
    rank creates every line's sub-group in the same order."""
    shape = {"data": data, "pipe": pipe}
    if data < 1 or pipe < 1:
        raise ValueError(f"pipeline mesh axes must be >= 1, got {shape}")
    ranked = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if ranked else 1
    if data * pipe != world:
        raise ValueError(f"data*pipe = {data * pipe} != {world} ranks")
    rank = dist.get_rank() if ranked else 0
    if devices is None:
        dev = resolve_device(torch.device("cuda", rank) if ranked else None)
    elif len(devices) == 1:
        dev = resolve_device(devices[0])
    else:
        raise ValueError(f"{len(devices)} devices for {world} ranks: name none"
                         " (cuda:<rank>) or one for every rank")
    if not ranked:
        return PipelineMesh(dev, shape)
    mesh = PipelineMesh(dev, shape, group=dist.group.WORLD, rank=rank,
                        backend=dist.get_backend())
    mesh.groups.update(_line_groups(shape, rank, PIPE_AXES))
    return mesh


def stage_params(config: ModelConfig, params: Params, n_stages: int) -> Params:
    """The (L, ...) layer stacks as (P, L/P, ...) stage stacks (views);
    embed, final_norm and lm_head as they are."""
    L = config.n_layers
    if L % n_stages:
        raise ValueError(f"n_layers={L} not divisible by {n_stages} stages")
    return {"embed": params["embed"],
            "layers": {k: w.reshape(n_stages, L // n_stages, *w.shape[1:])
                       for k, w in params["layers"].items()},
            "final_norm": params["final_norm"], "lm_head": params["lm_head"]}


def stage_slice(staged: Params, stage: int) -> Params:
    """Stage `stage`'s share of staged params (or moments): its (1, L/P,
    ...) slice of every layer leaf and the shared leaves, as copies that own
    their storage (the whole tree can be freed)."""
    def own(x):
        return x.detach().clone()

    return {"embed": own(staged["embed"]),
            "layers": {k: own(w[stage:stage + 1]) for k, w in staged["layers"].items()},
            "final_norm": own(staged["final_norm"]), "lm_head": own(staged["lm_head"])}


def init_pipeline_state(config: ModelConfig, seed: int, mesh: PipelineMesh,
                        learning_rate: float = 3e-4, *,
                        params: Optional[Params] = None) -> TrainState:
    """This rank's stage of the staged params (random from `seed` on the
    mesh's device, or the given whole `params`, e.g. bridged from JAX)
    marked for grad, and zero AdamW moments shaped as them."""
    if params is None:
        params = init_params(config, seed, mesh.device)
    mine = stage_slice(stage_params(config, params, mesh.shape["pipe"]),
                       mesh.coords["pipe"])
    del params
    for _, p in flatten_params(mine):
        if p.device != mesh.device:
            raise ValueError(f"params live on {p.device}, the mesh's device is {mesh.device}")
        p.requires_grad_(True)
    return TrainState(0, mine, make_optimizer(learning_rate).init(mine))


def data_rows(batch: Dict[str, torch.Tensor], mesh: PipelineMesh) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch: rows over data (views)."""
    n, d = mesh.shape["data"], mesh.coords["data"]
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch of {v.shape[0]} rows does not split over data {n}")
        size = v.shape[0] // n
        out[k] = v.narrow(0, d * size, size)
    return out


def pipeline_batch(config: ModelConfig, batch_size: int, seq_len: int,
                   mesh: PipelineMesh, seed: int = 0) -> Dict[str, torch.Tensor]:
    """train.synthetic_batch on the mesh's device, this rank's rows of it
    (rows over data; every stage of a data line holds the same rows)."""
    batch = synthetic_batch(config, batch_size, seq_len, seed=seed, device=mesh.device)
    return data_rows(batch, mesh)


def sum_shared_grads(grads: List[Tuple[str, torch.Tensor]],
                     mesh: PipelineMesh) -> List[Tuple[str, torch.Tensor]]:
    """The shared leaves' grads summed over pipe (each comes from one
    stage; the others hold zeros), the layer leaves' as they are."""
    return [(k, all_reduce(g, mesh, ("pipe",)) if k.split("/")[0] in SHARED else g)
            for k, g in grads]


def collect(outs: List[torch.Tensor]) -> List[torch.Tensor]:
    """The last stage's outputs in microbatch order: microbatch m's output
    meets rows m*Bm..(m+1)*Bm of the targets (the reference's collection at
    tick m + P - 1)."""
    return outs


def _sumsq(grads) -> torch.Tensor:
    """The sum over leaves of each leaf's f32 sum of squares."""
    return sum(torch.sum(torch.square(g.to(torch.float32))) for g in grads)


def make_pipeline_train_step(config: ModelConfig, mesh: PipelineMesh,
                             n_microbatches: int = 4, learning_rate: float = 3e-4):
    """Returns `step(state, batch) -> (state, metrics)` for this rank's
    stage on the (data, pipe) mesh: the explicit GPipe schedule of the
    module docstring, then one AdamW update of the stage's params in place.
    `batch` is this rank's rows (`pipeline_batch`, `data_rows`); metrics are
    0-d device tensors `loss` and `grad_norm`, equal on every rank."""
    n_stages, n_micro = mesh.shape["pipe"], n_microbatches
    stage = mesh.coords["pipe"]
    first, last = stage == 0, stage == n_stages - 1
    if config.n_layers % n_stages:
        raise ValueError(f"n_layers={config.n_layers} not divisible by {n_stages} stages")
    # The remat estimate sees the stage: L/P layers, its share of the
    # weights, and every tick's residuals (the reference's `_run_stage`),
    # with the full logits the last stage builds (no chunked CE here).
    stage_cfg = config.with_(n_layers=config.n_layers // n_stages, ce_chunk=0)
    n_ticks = n_micro + n_stages - 1
    optimizer = make_optimizer(learning_rate)
    attention = make_attention_fn(None)
    quadratic = attention.memory_is_quadratic

    def run_stage(x, layers, positions):
        def body(x, p):
            return _block(stage_cfg, x, p, positions, attention)[0]

        s = x.shape[1]
        body = apply_remat(body, stage_cfg, x.shape[0] * s * n_ticks, seq_len=s,
                           attn_scores=quadratic(s, config.head_dim, config.dtype_bytes,
                                                 device=x.device))
        for p in _layer_slices({"layers": layers}, stage_cfg.n_layers):
            x = body(x, p)
        return x

    def local_grads(params: Params, batch: Dict[str, torch.Tensor]):
        """The stage's loss (0 off the last stage) and its grads of every
        leaf, each microbatch's summed in f32 and cast to the leaf's dtype."""
        inputs, targets = batch["inputs"], batch["targets"]
        b, s = inputs.shape
        if b % n_micro:
            raise ValueError(f"{b} rows do not split into {n_micro} microbatches")
        bm = b // n_micro
        positions = torch.arange(s, device=inputs.device)
        pairs = flatten_params(params)
        leaves = [p for _, p in pairs]
        sums = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        index = {id(p): i for i, p in enumerate(leaves)}

        def add(wrt, grads):
            for p, g in zip(wrt, grads):
                if g is not None:
                    sums[index[id(p)]].add_(g.to(torch.float32))

        like = torch.empty((bm, s, config.d_model), dtype=config.activation_dtype,
                           device=mesh.device)
        ins, outs = [], []
        for m in range(n_micro):
            if first:
                x = params["embed"][inputs[m * bm:(m + 1) * bm]]
            else:
                x = exchange(mesh, "pipe", recv_like=like, src=stage - 1).requires_grad_()
            layers = {k: w[0] for k, w in params["layers"].items()}
            y = run_stage(x, layers, positions)
            if not last:
                exchange(mesh, "pipe", send=y, dst=stage + 1)
            ins.append(x)
            outs.append(y)
        loss = torch.zeros((), dtype=torch.float32, device=mesh.device)
        if last:
            held = [y.detach().requires_grad_() for y in collect(outs)]
            h = rms_norm(torch.cat(held), params["final_norm"], config.norm_eps)
            loss = ce_from_logits(logits_linear(h, params["lm_head"]), targets,
                                  batch.get("loss_mask"))
            head = [params["final_norm"], params["lm_head"]]
            got = torch.autograd.grad(loss, head + held)
            add(head, got)
            out_grads = got[len(head):]
            loss = loss.detach()
        for m in reversed(range(n_micro)):
            g = out_grads[m] if last else exchange(mesh, "pipe", recv_like=like,
                                                   src=stage + 1)
            wrt = leaves if first else leaves + [ins[m]]
            got = torch.autograd.grad(outs[m], wrt, g, allow_unused=True)
            add(leaves, got)
            if not first:
                exchange(mesh, "pipe", send=got[-1], dst=stage - 1)
            ins[m] = outs[m] = None
        grads = [(k, acc.to(p.dtype)) for (k, p), acc in zip(pairs, sums)]
        return loss, grads

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        loss, grads = local_grads(state.params, batch)
        grads = sum_shared_grads(grads, mesh)
        n_data = mesh.shape["data"]
        grads = [(k, all_reduce(g, mesh, ("data",)) / n_data) for k, g in grads]
        loss = all_reduce(all_reduce(loss, mesh, ("pipe",)), mesh, ("data",)) / n_data
        layer_sq = _sumsq(g for k, g in grads if k.startswith("layers/"))
        shared_sq = _sumsq(g for k, g in grads if not k.startswith("layers/"))
        gnorm = torch.sqrt(all_reduce(layer_sq, mesh, ("pipe",)) + shared_sq)
        grads = unflatten_params(grads)
        opt_state = optimizer.apply(state.params, grads, state.opt_state)
        return (TrainState(state.step + 1, state.params, opt_state),
                {"loss": loss, "grad_norm": gnorm})

    return step
