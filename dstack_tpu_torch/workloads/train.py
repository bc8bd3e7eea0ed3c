"""Training step for the flagship workload on one device (port of
`dstack_tpu.workloads.train`), and the hooks of the orchestrator's
contract that rest on the train-state checkpoint.

`make_train_step(config, mesh)` returns `train_step(state, batch) ->
(state, metrics)`. With a seq mesh (sharding.make_mesh(seq=n)) attention
runs as the ring over n sequence shards that take turns on the device;
without one, the single-device flash path. Where the reference jits and donates the state, this step runs
eagerly and updates params and optimizer moments in place (the donated
JAX state is as dead after a step as the old tensors here are). Metrics
stay on the device: the step makes no host readback; callers read what
they print.

On a training mesh over ranks (sharding.make_mesh(data=, fsdp=, seq=,
model=, expert=, layout="training")) each rank holds its slices of the params and
AdamW moments under PARAM_SPECS (`init_train_state(mesh=)` draws the
whole params from the seed and cuts them, as the reference's `shard_tree`
after init) and its block of the batch, its rows and its stretch of the
sequence (`synthetic_batch(mesh=)`, `data.BatchLoader(mesh=)`), and the
step runs the collectives of sharding.py (module docstring) where GSPMD
puts them in the reference's jitted step, attention over seq as the ring
across the ranks. The loss is the global token mean: each rank
backpropagates its tokens' summed CE over the whole batch's mask count,
summed over data, fsdp and seq (`loss_fn`), never a mean of per-rank
means, which differ when `loss_mask` is uneven. (The reference's chunked
CE gathers each chunk off the seq shards; here each rank takes the CE of
its own tokens: the same sum in another order.) After the backward each
grad is summed over the axes the fsdp reduce-scatter did not cover, seq
included (`sharding.grad_axes`); AdamW then updates every shard in
place, its moments cut as their params. `global_norm` sums the shards'
squares and counts a replicated leaf once. `loss`, `grad_norm` and
`router_aux` come out equal on every rank. With `accum_steps` microbatch
j is the reference's, rows [j*B/accum, (j+1)*B/accum) of the global batch,
cut over (data, fsdp) as BATCH_SPEC cuts a batch: each rank gathers the
batch's rows over those axes (token ids, a few KB) and takes its block of
each microbatch, so every microbatch's mean CE and router aux group the
rows as the reference's `lax.scan` does. A mixture-of-experts config runs
its rank's block of experts on the expert axis (workloads/moe.py); its
router aux is a rank's share of the global batch's (moe.switch_aux), which
the loss adds as the CE's share is, and the `router_aux` metric is the
shares' sum. Over a seq axis of ranks an MoE layer routes each row over
its whole sequence as the reference's does: the capacity from the whole
length and each token's slot in the row's one choice-major cumsum
(workloads/moe.py, `row_capacity`, `slot_offsets`).

The optimizer is AdamW written out on tensors rather than
`torch.optim.AdamW`, because its state must match optax's: `mu` in f32,
`nu` in the param dtype, every scalar of optax's arithmetic rounded to the
dtype of the tensor it meets (a weakly-typed JAX scalar takes the array's
dtype), the f32 update added to the param and cast back to its dtype.

The contract with the runner, as the reference keeps it:

- stage markers (workloads/stages.py): `tpu_init` in `init_train_state`,
  and `compile_start`, `compile_end` and `first_step` around the first
  train step, which builds the kernel library (`_staged_step`);
- `DrainHandler` / `install_drain_handler`: on SIGTERM (a preemption or
  maintenance notice) the loop checkpoints (workloads/checkpoint.py) and
  exits DRAIN_EXIT_CODE, which the runner reports as a clean drain; the
  resubmitted gang resumes from that step;
- `read_resize_notice`: the elastic-resize notice the runner writes.
"""

import json
import os
import signal
import sys
import time
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from dstack_tpu_torch.utils.stagemarkers import auto_stage
from dstack_tpu_torch.workloads import compile_cache
from dstack_tpu_torch.workloads.attention import make_attention_fn
from dstack_tpu_torch.workloads.config import ModelConfig
from dstack_tpu_torch.workloads.device import DeviceLike, resolve_device
from dstack_tpu_torch.workloads.sharding import (
    AXES,
    BATCH_SPEC,
    all_reduce,
    batch_shards,
    batch_sum,
    gather_axes,
    gather_fsdp,
    grad_axes,
    param_specs,
    reduce_grads,
    reduce_model,
    replicas,
    shard,
    shard_batch,
    seq_ranks,
    shard_tree,
    training_mesh,
)
from dstack_tpu_torch.workloads.transformer import forward, init_params, logits_linear
from dstack_tpu_torch.workloads.weights import flatten_params, unflatten_params

Params = Dict[str, Any]

# The exit code of a trainer that checkpointed on SIGTERM, which the runner
# reports as a clean drain (the port's own copy of
# `dstack_tpu.agents.protocol.DRAIN_EXIT_CODE`).
DRAIN_EXIT_CODE = 113


class TrainState(NamedTuple):
    step: int
    params: Params
    opt_state: Any


def _weak(x: float, dtype: torch.dtype) -> float:
    """A Python scalar rounded to `dtype`, as a weakly-typed JAX scalar is
    before it meets an array of that dtype."""
    return float(torch.tensor(x, dtype=torch.float32).to(dtype))


class AdamState(NamedTuple):
    count: int
    mu: Params
    nu: Params


@dataclass(frozen=True)
class AdamW:
    """optax.adamw(lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay,
    mu_dtype=f32), weight decay on every leaf (optax's default mask), with
    the optional warmup-cosine schedule of
    `optax.warmup_cosine_decay_schedule` evaluated at the pre-increment
    count."""

    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 0
    decay_steps: int = 0
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8

    def lr(self, count: int) -> float:
        """The step size at optimizer count `count`, in f32 as optax
        computes it."""
        if not (self.warmup_steps or self.decay_steps):
            return self.learning_rate
        f32 = np.float32
        peak = self.learning_rate
        warm = max(self.warmup_steps, 1)
        decay = max(self.decay_steps, self.warmup_steps + 1) - warm
        if count < warm:
            c = f32(min(max(count, 0), warm))
            frac = f32(1) - c / f32(warm)
            return float(f32(0.0 - peak) * frac + f32(peak))
        alpha = f32(peak * 0.1 / peak)
        c = f32(min(float(count - warm), float(decay)))
        cos = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(decay)))
        return float(f32(peak) * ((f32(1) - alpha) * cos + alpha))

    def init(self, params: Params) -> AdamState:
        pairs = flatten_params(params)
        mu = unflatten_params((k, torch.zeros_like(p, dtype=torch.float32)) for k, p in pairs)
        nu = unflatten_params((k, torch.zeros_like(p)) for k, p in pairs)
        return AdamState(0, mu, nu)

    @torch.no_grad()
    def apply(self, params: Params, grads: Params, state: AdamState) -> AdamState:
        """One AdamW step, in place on params and moments, leaf by leaf and
        a large leaf in slices of its leading dim (the f32 temporaries of at
        most _SLICE_ELEMS elements are live at a time: an MoE expert bank
        stacked over 16 layers is 1.5 B elements, whose whole-leaf f32
        temporaries would take 18 GB). Every operation is elementwise, so
        the slices give the whole leaf's result bit for bit."""
        count = state.count + 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.b1) ** f32(count))
        bc2 = float(f32(1) - f32(self.b2) ** f32(count))
        step = -self.lr(state.count)
        for leaves in zip(*(flatten_params(t) for t in (params, grads, state.mu, state.nu))):
            for p, g, mu, nu in _slices(*(t for _, t in leaves)):
                self._update(p, g, mu, nu, bc1, bc2, step)
        return AdamState(count, state.mu, state.nu)

    def _update(self, p, g, mu, nu, bc1: float, bc2: float, step: float) -> None:
        gd = g.dtype
        mu.copy_(_weak(1 - self.b1, gd) * g + self.b1 * mu)
        nu.copy_(_weak(1 - self.b2, gd) * (g * g) + _weak(self.b2, nu.dtype) * nu)
        mu_hat = mu / bc1
        nu_hat = nu / _weak(bc2, nu.dtype)
        upd = mu_hat / (torch.sqrt(nu_hat + 0.0) + _weak(self.eps, nu_hat.dtype))
        upd = upd + _weak(self.weight_decay, p.dtype) * p
        upd = upd * step
        p.copy_((p + upd).to(p.dtype))


# The largest slice of a leaf whose f32 AdamW temporaries are live at once.
_SLICE_ELEMS = 1 << 27


def _slices(*leaves: torch.Tensor):
    """Equal-shaped leaves cut together into views along their leading dim,
    each slice of at most _SLICE_ELEMS elements where a row allows it."""
    lead = leaves[0]
    if lead.dim() == 0 or lead.numel() <= _SLICE_ELEMS:
        yield leaves
        return
    rows = max(1, _SLICE_ELEMS // (lead.numel() // lead.shape[0]))
    for i in range(0, lead.shape[0], rows):
        yield tuple(t[i:i + rows] for t in leaves)


def make_optimizer(learning_rate: float = 3e-4, weight_decay: float = 0.1, *,
                   warmup_steps: int = 0, decay_steps: int = 0) -> AdamW:
    """AdamW with f32 first moments; linear warmup then cosine decay to a
    tenth of the peak when warmup_steps/decay_steps are set."""
    return AdamW(learning_rate, weight_decay, warmup_steps, decay_steps)


def _device_of(device: DeviceLike, mesh) -> torch.device:
    """The mesh's device, or `device` without a mesh."""
    if mesh is None:
        return resolve_device(device)
    if device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    return mesh.device


def ranked_mesh(config: ModelConfig, mesh):
    """The training mesh over ranks `mesh` is (any of data, fsdp, seq,
    model and expert), or None for no mesh and the one-device seq mesh. A
    mesh cut for serving, or an expert axis that does not divide the
    config's experts, raises ValueError."""
    mesh = training_mesh(mesh)
    if mesh is None or not mesh.ranked:
        return None
    if config.n_experts % mesh.shape["expert"]:
        raise ValueError(f"the expert axis ({mesh.shape['expert']}) must divide the"
                         f" config's n_experts ({config.n_experts})")
    return mesh


def init_train_state(config: ModelConfig, seed: int = 0, device: DeviceLike = None,
                     learning_rate: float = 3e-4, *, warmup_steps: int = 0,
                     decay_steps: int = 0, params: Optional[Params] = None,
                     mesh=None) -> TrainState:
    """Params (random from `seed` on `device` or the mesh's, or the given
    whole `params`, e.g. bridged from JAX) marked for grad, and zero
    optimizer moments. On a training mesh over ranks each rank keeps its
    slices of the whole params (sharding.shard_tree), so a rank's params
    are the unsharded params' slices. On the card, the kernel cache
    (workloads/compile_cache.py) is enabled from DSTACK_TPU_COMPILE_CACHE
    before anything builds; the `tpu_init` stage marker marks the first
    touch of the device."""
    dev = _device_of(device, mesh)
    ranked = ranked_mesh(config, mesh)
    if dev.type == "cuda":
        compile_cache.enable_from_env()
    auto_stage("tpu_init")
    if params is None:
        params = init_params(config, seed, dev)
    params = shard_tree(ranked, params)
    for _, p in flatten_params(params):
        if p.device != dev:
            raise ValueError(f"params live on {p.device}, device is {dev}")
        p.requires_grad_(True)
    opt = make_optimizer(learning_rate, warmup_steps=warmup_steps,
                         decay_steps=decay_steps)
    return TrainState(0, params, opt.init(params))


def token_nll(logits: torch.Tensor, targets: torch.Tensor, mesh=None) -> torch.Tensor:
    """Per-token softmax cross-entropy from f32 logits in lse form: lse -
    logits[target], never the normalised log-probs. On a training mesh's
    model axis the logits are this rank's V/m vocab columns (lm_head is
    column-parallel), and the CE is vocab-parallel: the rows' max over
    model, their sum of exps and the target's logit summed over model."""
    if not _vocab_split(mesh):
        lse = torch.logsumexp(logits, dim=-1)
        return lse - torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    v = logits.shape[-1]
    local = targets.long() - mesh.coords["model"] * v
    mine = (local >= 0) & (local < v)
    tgt = torch.gather(logits, -1, local.clamp(0, v - 1)[..., None])[..., 0]
    return vocab_lse(logits, mesh) - reduce_model(
        torch.where(mine, tgt, torch.zeros_like(tgt)), mesh)


def _vocab_split(mesh) -> bool:
    """Whether logits are a training rank's columns of the vocab (a model
    axis above 1)."""
    return mesh is not None and mesh.training and mesh.shape["model"] > 1


def vocab_lse(logits: torch.Tensor, mesh=None) -> torch.Tensor:
    """logsumexp over the whole vocab of f32 logits: on a training mesh's
    model axis, from the rank's V/m columns, the rows' max over model (no
    grad) plus the log of their sums of exps summed over model (the grad
    of every column flows through `reduce_model`)."""
    if not _vocab_split(mesh):
        return torch.logsumexp(logits, dim=-1)
    m = all_reduce(logits.detach().amax(dim=-1), mesh, ("model",), op="max")
    return m + torch.log(reduce_model(torch.sum(torch.exp(logits - m[..., None]), dim=-1),
                                      mesh))


class _VocabEntropy(torch.autograd.Function):
    """The entropy of softmax over a model axis's vocab columns: forward
    the whole vocab's lse (`vocab_lse`) and each rank's partial sum of
    p log p over its columns summed over model; backward dH/dlogit_v =
    -p_v (log p_v + H), which needs only the rank's own columns and the
    global H (autograd through the partial sums would miss the other
    columns' share of the lse's grad)."""

    @staticmethod
    def forward(ctx, logits, mesh):
        with torch.no_grad():
            logp = logits - vocab_lse(logits, mesh)[..., None]
            p = torch.exp(logp)
            ent = -all_reduce(torch.sum(p * logp, dim=-1), mesh, ("model",))
        ctx.save_for_backward(p, logp, ent)
        return ent

    @staticmethod
    def backward(ctx, g):
        p, logp, ent = ctx.saved_tensors
        return -g[..., None] * p * (logp + ent[..., None]), None


def token_entropy(logits: torch.Tensor, mesh=None) -> torch.Tensor:
    """Per-token entropy of softmax(logits), -sum_v p_v log p_v with log p
    = logits - lse, from f32 logits (the reference's `-sum(exp(logp) *
    logp)`). On a training mesh's model axis it is vocab-parallel
    (`_VocabEntropy`): the lse over the whole vocab and each rank's partial
    sum over its columns summed over model."""
    if _vocab_split(mesh):
        return _VocabEntropy.apply(logits, mesh)
    logp = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
    return -torch.sum(torch.exp(logp) * logp, dim=-1)


def ce_from_logits(logits: torch.Tensor, targets: torch.Tensor,
                   mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Masked-mean softmax cross-entropy from (..., V) f32 logits, in lse
    form: logits[target] - lse, never the normalised log-probs."""
    nll = token_nll(logits, targets)
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def _chunked_ce(hidden: torch.Tensor, lm_head, targets: torch.Tensor,
                mask: Optional[torch.Tensor], chunk: int, mesh=None):
    """Softmax cross-entropy over sequence chunks -> (nll_sum, denom). Each
    chunk's head matmul and logsumexp run under torch.utils.checkpoint, so
    one (B, chunk, V) f32 logits buffer is live at a time and nothing
    vocab-sized is saved for backward (vocab-parallel on a training
    mesh's model axis, `token_nll`)."""
    b, s, _ = hidden.shape
    ms = (torch.ones((b, s), dtype=torch.float32, device=hidden.device)
          if mask is None else mask.to(torch.float32))

    def body(xi, ti, mi):
        return torch.sum(token_nll(logits_linear(xi, lm_head), ti, mesh) * mi)

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, chunk):
        sl = slice(i, i + chunk)
        total = total + checkpoint(body, hidden[:, sl], targets[:, sl], ms[:, sl],
                                   use_reentrant=False)
    return total, torch.sum(ms)


def loss_fn(config: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
            attention_fn=None, mesh=None):
    """Next-token cross-entropy -> (loss, router_aux). batch: inputs and
    targets (B, S) int, pre-shifted; optional loss_mask (B, S). `mesh`
    reaches the remat estimate; `attention_fn` carries the ring. On a
    training mesh over ranks the loss is this rank's share of the global
    mean: its rows' summed CE over the mask count of the whole batch
    (summed over data x fsdp x seq), so the shares summed over those axes
    (sharding.batch_sum) are the loss and their grads sum to its grad; the
    router aux it adds and returns is likewise the rank's share of the
    global one (moe.switch_aux). The chunked CE is chosen by the whole
    sequence's length, as the reference's; a seq rank chunks its own
    stretch."""
    inputs, targets = batch["inputs"], batch["targets"]
    mask = batch.get("loss_mask")
    s_whole = inputs.shape[1] * seq_ranks(mesh)
    if config.ce_chunk > 0 and s_whole % config.ce_chunk == 0:
        hidden, aux = forward(config, params, inputs, attention_fn=attention_fn,
                              mesh=mesh, return_aux=True, return_hidden=True)
        total, denom = _chunked_ce(hidden, gather_fsdp(params["lm_head"], 0, mesh),
                                   targets, mask, config.ce_chunk, mesh)
        ce = total / torch.clamp(batch_sum(denom, mesh), min=1.0)
        return ce + config.router_aux_coef * aux, aux
    logits, aux = forward(config, params, inputs, attention_fn=attention_fn,
                          mesh=mesh, return_aux=True)
    if mesh is None or not mesh.training:
        ce = ce_from_logits(logits, targets, mask)
        return ce + config.router_aux_coef * aux, aux
    nll = token_nll(logits, targets, mesh)
    if mask is None:
        total, denom = torch.sum(nll), torch.tensor(float(nll.numel()), device=nll.device)
    else:
        mask = mask.to(torch.float32)
        total, denom = torch.sum(nll * mask), torch.sum(mask)
    ce = total / torch.clamp(batch_sum(denom, mesh), min=1.0)
    return ce + config.router_aux_coef * aux, aux


def global_norm(tree: Params, mesh=None) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum over leaves (sorted order) of
    each leaf's sum of squares, each in its leaf's dtype. On a training
    mesh over ranks `tree` holds the rank's slices: each slice's sum of
    squares in f32, divided by the count of ranks that hold the same
    slice, summed over every rank, so a replicated leaf counts once."""
    if mesh is None or not mesh.training:
        total = 0
        for _, g in flatten_params(tree):
            total = total + torch.sum(g * g)
        return torch.sqrt(total)
    specs = dict(flatten_params(param_specs(tree)))
    total = 0
    for k, g in flatten_params(tree):
        gf = g.to(torch.float32)
        total = total + torch.sum(gf * gf) / replicas(specs[k], mesh)
    return torch.sqrt(all_reduce(total, mesh, AXES))


def make_train_step(config: ModelConfig, mesh=None, learning_rate: float = 3e-4, *,
                    accum_steps: int = 1, warmup_steps: int = 0, decay_steps: int = 0):
    """Returns `train_step(state, batch) -> (state, metrics)`; metrics are
    0-d device tensors `loss`, `grad_norm`, `router_aux`. accum_steps > 1
    cuts the batch into that many microbatches, sums their grads in f32 and
    makes one optimizer update with the mean. A seq `mesh` runs attention
    as the ring (make_attention_fn(mesh)); a training mesh over ranks runs
    the sharded step of the module docstring, attention on each rank's
    heads and rows through the one-device path, or with a seq axis as the
    ring across the ranks."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    ranked = ranked_mesh(config, mesh)
    optimizer = make_optimizer(learning_rate, warmup_steps=warmup_steps,
                               decay_steps=decay_steps)
    attention_fn = make_attention_fn(mesh)

    def grads_of(params, batch):
        pairs = flatten_params(params)
        loss, aux = loss_fn(config, params, batch, attention_fn, mesh)
        grads = torch.autograd.grad(loss, [p for _, p in pairs])
        return loss.detach(), aux.detach(), [(k, g) for (k, _), g in zip(pairs, grads)]

    def accumulated_grads(params, batch):
        loss_sum = aux_sum = 0.0
        sums = None
        for micro in _microbatches(batch, accum_steps, ranked):
            loss, aux, grads = grads_of(params, micro)
            loss_sum, aux_sum = loss_sum + loss, aux_sum + aux
            if sums is None:
                sums = [(k, g.to(torch.float32)) for k, g in grads]
            else:
                for (_, acc), (_, g) in zip(sums, grads):
                    acc.add_(g.to(torch.float32))
        dtypes = {k: p.dtype for k, p in flatten_params(params)}
        grads = [(k, (g / float(accum_steps)).to(dtypes[k])) for k, g in sums]
        return loss_sum / accum_steps, aux_sum / accum_steps, grads

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if accum_steps > 1:
            loss, aux, grads = accumulated_grads(state.params, batch)
        else:
            loss, aux, grads = grads_of(state.params, batch)
        if ranked is not None:
            specs = dict(flatten_params(param_specs(state.params)))
            grads = reduce_grads(grads, ranked, lambda k: grad_axes(specs[k]))
            loss, aux = batch_sum(loss, ranked), batch_sum(aux, ranked)
        grads = unflatten_params(grads)
        gnorm = global_norm(grads, ranked)
        opt_state = optimizer.apply(state.params, grads, state.opt_state)
        new_state = TrainState(state.step + 1, state.params, opt_state)
        return new_state, {"loss": loss, "grad_norm": gnorm, "router_aux": aux}

    return _staged_step(train_step)


def _microbatches(batch: Dict[str, torch.Tensor], accum_steps: int, mesh=None):
    """The reference's microbatches of a batch: microbatch j holds rows
    [j*B/accum, (j+1)*B/accum) of the global batch of B rows. On a mesh
    whose (data, fsdp) ranks split the rows, `batch` is this rank's block:
    the rows are gathered over those axes and each microbatch cut again by
    BATCH_SPEC's rows, so a rank yields its block of each."""
    dp = batch_shards(mesh)
    if dp > 1:
        batch = {k: gather_axes(v, 0, mesh, ("data", "fsdp")) for k, v in batch.items()}
    b = next(iter(batch.values())).shape[0]
    if b % accum_steps:
        raise ValueError(
            f"batch size {b} is not divisible by accum_steps {accum_steps};"
            " gradient accumulation needs equal microbatches")
    mb = b // accum_steps
    if mb % dp:
        raise ValueError(f"a microbatch of {mb} rows does not split over the {dp}"
                         " data x fsdp ranks")
    for i in range(accum_steps):
        yield {k: shard(v[i * mb:(i + 1) * mb], BATCH_SPEC[:1], mesh) for k, v in batch.items()}


def _staged_step(step_fn):
    """Bracket the FIRST call with the compile_start / compile_end and
    first_step markers (no-ops outside an orchestrated run). The first
    call builds the kernel library and runs one step; the device is
    synchronised before compile_end, so the bracket holds the build and
    the first step's execution, not their dispatch. Later calls go
    through untouched."""
    holder = {"first": True}

    def stepped(*args):
        if not holder["first"]:
            return step_fn(*args)
        holder["first"] = False
        auto_stage("compile_start")
        out = step_fn(*args)
        dev = out[1]["loss"].device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        auto_stage("compile_end")
        auto_stage("first_step")
        return out

    return stepped


class DrainHandler:
    """Graceful-preemption hook for training loops.

    When the provider announces a maintenance or preemption event, the
    runner SIGTERMs the job group and waits a grace window before killing
    it. A loop that installs this handler turns that window into a durable
    checkpoint:

        handler = install_drain_handler()
        for _ in range(start, steps):
            state, metrics = train_step(state, batch)
            if handler.draining:
                handler.checkpoint_and_exit(ckpt_dir, state)

    `checkpoint_and_exit` saves through workloads/checkpoint.py (blocking
    until the files are on disk) and exits DRAIN_EXIT_CODE, so the runner
    reports a clean drain and the resubmitted gang resumes from this step.
    `exec` the trainer from the job command so the exit code reaches the
    runner unwrapped by the shell.
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self._draining = False
        self._prior = {}
        for sig in signals:
            try:
                self._prior[sig] = signal.signal(sig, self._on_signal)
            except ValueError as e:
                # signal.signal works on the main thread only; a half
                # installed handler would promise drain coverage it lacks.
                raise RuntimeError(
                    "DrainHandler must be installed from the main thread"
                    " (signal handlers are process-global); install it"
                    " before spawning data-loader/metric threads"
                ) from e

    def _on_signal(self, signum, frame) -> None:
        self._draining = True
        # Chain what was installed before (a framework's own hook, an
        # earlier DrainHandler): replacing it would disable its cleanup.
        prior = self._prior.get(signum)
        if callable(prior):
            prior(signum, frame)

    @property
    def draining(self) -> bool:
        return self._draining

    def restore(self) -> None:
        """Put back the handlers this one replaced (a loop that returns
        instead of exiting, e.g. a trainer called in process)."""
        for sig, prior in self._prior.items():
            signal.signal(sig, signal.SIG_DFL if prior is None else prior)
        self._prior = {}

    def checkpoint_and_exit(self, directory, state,
                            grace_seconds: Optional[float] = None, mesh=None) -> None:
        """Save a checkpoint of `state` (a TrainState, or a lora.LoraState:
        the adapters and their moments), wait until it is on disk, and exit
        DRAIN_EXIT_CODE. On a training mesh over ranks every rank calls
        this at the same step (fine_tune agrees on it with
        sharding.any_rank): one checkpoint is written from every rank's
        shards (checkpoint.save(mesh=)), and every rank exits
        DRAIN_EXIT_CODE. `grace_seconds` is the drain window the runner
        allows; a save that overran it is reported on stderr (the runner
        may have killed sibling processes by then: size the grace to the
        checkpoint time)."""
        from dstack_tpu_torch.workloads import checkpoint as ckpt

        t0 = time.monotonic()
        step = ckpt.save(directory, state, wait=True, mesh=mesh)
        ckpt.close_all()
        elapsed = time.monotonic() - t0
        if grace_seconds is not None and elapsed > grace_seconds:
            print(f"WARNING: drain checkpoint took {elapsed:.1f}s, over the"
                  f" {grace_seconds:.0f}s grace window; the runner may have"
                  " hard-killed this job before the save completed. Raise the"
                  " drain grace or shrink the checkpoint",
                  file=sys.stderr, flush=True)
        if mesh is None or mesh.rank == 0:
            print(f"drain: checkpoint saved at step {step} in {elapsed:.3f}s; exiting",
                  flush=True)
        sys.exit(DRAIN_EXIT_CODE)


def install_drain_handler() -> DrainHandler:
    """Install SIGTERM-drain handling for the calling training process."""
    return DrainHandler()


def read_resize_notice(path: Optional[str] = None) -> Optional[Dict[str, int]]:
    """The pending elastic-resize notice from the runner, or None.

    The runner writes `{"width": W, "total": N}` atomically to
    DSTACK_TPU_RESIZE_FILE when the server resizes an elastic gang; an
    elastic loop polls this once per step and re-forms its mesh on a
    change. Malformed or partial content reads as None (the write is
    atomic, so that only means "no notice yet")."""
    p = path or os.environ.get("DSTACK_TPU_RESIZE_FILE")
    if not p:
        return None
    try:
        with open(p) as f:
            data = json.loads(f.read())
        return {"width": int(data["width"]), "total": int(data.get("total", 0))}
    except (OSError, ValueError, KeyError, TypeError):
        return None


def synthetic_batch(config: ModelConfig, batch_size: int, seq_len: Optional[int] = None,
                    seed: int = 0, device: DeviceLike = None,
                    mesh=None) -> Dict[str, torch.Tensor]:
    """Deterministic fake pre-shifted int32 batch: inputs/targets (B, S),
    drawn from a torch.Generator seeded with `seed` on `device` or the
    mesh's (not the reference's jax.random draw). On a training mesh over
    ranks: this rank's block (BATCH_SPEC: rows over data x fsdp, the
    sequence over seq) of the same global batch."""
    dev = _device_of(device, mesh)
    s = (seq_len or config.max_seq_len) + 1
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, config.vocab_size, (batch_size, s), generator=gen,
                           device=dev, dtype=torch.int32)
    return shard_batch({"inputs": tokens[:, :-1], "targets": tokens[:, 1:]},
                       training_mesh(mesh))
