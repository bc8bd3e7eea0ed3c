"""Podracer-style RL on the port's own serving and training stack (port of
`dstack_tpu.workloads.rl`).

Two architectures from the Podracer report (arXiv:2104.06272):

  Sebulba (split): N ACTOR processes generate rollouts through the
    `ServingEngine` batched-decode path (every chunk prefill and decode
    step on the paged kernel) and stream trajectory batches to a LEARNER
    process over the kv_transfer framing (`TrajectorySink`). The learner
    folds `accum_per_actor x gang_width` batches into one PPO update
    (`make_rl_train_step`, its forward and backward on the flash kernels)
    and pushes fresh policy weights back through the `WeightRefreshServer`
    — a versioned, epoch-fenced frame over the same framing. Actor-gang
    resize keeps accum-per-actor x width invariant (`utils.accum.
    rescale_accum_steps`), so the stacked update batch keeps its shape.
    See `workloads/rl_drill.py`.

  Anakin (colocated): `run_anakin` runs actor and learner synchronously
    in one process on one card — the deterministic harness behind the
    seeded learning smoke.

Weight refresh semantics (epoch fencing): the learner's `publish` bumps a
monotonically increasing weight epoch and swaps the snapshot (epoch,
manifest, arrays) as ONE tuple under a lock; a puller gets the complete
newest snapshot or `current`, never a torn mix of two epochs. Actors adopt
only strictly newer epochs (`poll(have_epoch)`), through
`ServingEngine.refresh_params`, which refuses unless the engine is idle
and drops the prefix cache on both tiers.

Aliasing, which the reference never had: JAX arrays are immutable, and
the port's optimizer updates params in place (train.AdamW.apply). So every
publish stores a COPY (host tensors for the socket and checkpoint
channels, a device clone for the in-process one), and the engine owns its
parameter tensors (ServingEngine copies them at init and `refresh_params`
copies new values into them): a learner step after a publish changes
neither the published snapshot nor the actor's weights until the actor
adopts the next epoch.

Behavior logprobs: actors re-score finished rollouts with a teacher-forced
forward under the SAME weights that generated them (`make_sequence_scorer`).
At top_p=1.0 the engine's sampler draws from exactly softmax(logits/T), so
the post-hoc score IS the behavior log-probability; actors pin top_p=1.0.
Rollout determinism rides the engine's admission gate (`hold_admission`):
one rollout round enters prefill as one admission wave, so the sampler's
draws are a pure function of the seed.

Divergences from the reference:

- The scorer and the PPO step run `forward` through
  `attention.make_attention_fn(None)`: the flash kernels on the card
  (forward, and dQ / dK-dV in the step's backward), plain attention on the
  CPU. The reference's no-mesh path calls `forward` without an
  attention_fn, which is its plain attention; the function is the same,
  and on the CPU so is the code.
- The step runs eagerly and updates params and optimizer moments in
  place (as `train.make_train_step`), where the reference jits and
  donates the state.
- Params and seeds: `init_rl_state` draws from a torch generator; parity
  tests pass JAX-initialised params (`params=`, through
  `weights.params_from_numpy`).
- Every entry takes `device`; None means the CUDA device, which raises
  without a card.

Meshes over ranks (sharding.py):

- The learner on a training mesh (`Learner(mesh=)`, `init_rl_state`,
  `make_rl_train_step`, `make_sequence_scorer` on `make_mesh(...,
  layout="training")`): data, fsdp, model and expert axes, as the trainer
  takes them. Each rank keeps its slices of the params and moments; the
  step runs `forward(..., mesh=)` on the rank's rows and the loss is the
  rank's share of the reference's loss over the global batch: the mask
  count, pg_loss, entropy and clip_fraction are the rank's sums over the
  global count (`batch_sum`), and on a model axis the target's log-prob
  and the entropy are vocab-parallel (`train.token_nll`,
  `train.token_entropy`); grads are summed over the axes each leaf owes
  (`reduce_grads`) and grad_norm is the global one. An MoE policy runs on
  an expert axis as the trainer's does; the RL loss adds no router aux, as
  the reference's does not. Rank 0 alone gathers trajectories, computes
  the advantages and broadcasts each step batch; every rank cuts its rows.
  `publish` gathers the whole params on every rank and rank 0 publishes
  them: the frame is the one-device learner's, byte for byte in layout.
- A seq axis raises ValueError: the reference's step cannot run one.
  BATCH_SPEC cuts both `tokens` (N, T) and the forward's (N, T-1) over
  seq, and no seq >= 2 divides two consecutive integers, so JAX raises on
  every seq mesh (from shard_map when T-1 is odd, from pjit when T is).
  Taking one here would be a feature the reference lacks.
- The actor on a serving mesh (`Actor(engine_kwargs={"mesh": mesh})` on
  rank 0 of `make_mesh(model=m, expert=e)`, `run_actor_follower` on the
  others, from the same arguments through `actor_engine_kwargs`): the
  engine's ops reach every rank in one order, so `hold_admission` holds a
  round there as on one device; the behavior scorer is the engine's own
  op (`ServingEngine.score`), every rank on its shards, so no rank builds
  a whole copy of the params; a refresh rebuilds the frame's tree on a
  template from the config (`transformer.param_template`) and every rank
  copies its slices of it in. The colocated Anakin loop stays on one
  device: the reference's `run_anakin` takes no mesh.
"""

import json
import os
import queue
import socket
import threading
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dstack_tpu_torch.utils.accum import rescale_accum_steps
from dstack_tpu_torch.utils.histogram import HistogramData
from dstack_tpu_torch.utils.stagemarkers import auto_stage
from dstack_tpu_torch.workloads.attention import make_attention_fn
from dstack_tpu_torch.workloads.config import ModelConfig
from dstack_tpu_torch.workloads.device import DeviceLike, resolve_device
from dstack_tpu_torch.workloads.kv_transfer import (
    array_manifest,
    encode_msg,
    max_frame_bytes,
    recv_msg,
    send_msg,
)
from dstack_tpu_torch.workloads.serving import ServingEngine, run_follower
from dstack_tpu_torch.workloads.sharding import (
    batch_sum,
    broadcast_object,
    grad_axes,
    model_shards,
    param_specs,
    reduce_grads,
    shard_batch,
    shard_tree,
    unshard_tree,
)
from dstack_tpu_torch.workloads.train import (
    TrainState,
    global_norm,
    make_optimizer,
    ranked_mesh,
    token_entropy,
    token_nll,
)
from dstack_tpu_torch.workloads.transformer import (
    forward,
    init_params,
    param_template,
    params_device,
)
from dstack_tpu_torch.workloads.weights import flatten_params, unflatten_params

Params = Dict[str, Any]

# Bumped whenever the weights frame layout changes; a version mismatch
# is a protocol error, never a silent misparse.
WEIGHT_REFRESH_VERSION = 1


def refresh_addr_from_env(
    env: Optional[Dict[str, str]] = None,
) -> Optional[Tuple[str, int]]:
    """(host, port) of the gang's weight-refresh channel, from the
    DSTACK_TPU_RL_REFRESH_ADDR the runner injects — the learner binds it,
    actors connect. None outside a gang run."""
    raw = (env if env is not None else os.environ).get("DSTACK_TPU_RL_REFRESH_ADDR")
    if not raw:
        return None
    host, _, port = raw.rpartition(":")
    return host, int(port)


def tiny_rl_config(**overrides) -> ModelConfig:
    """The toy-task policy shape: small enough that a CPU PPO loop
    visibly learns inside a test budget, f32 so the seeded trajectory
    is bit-stable run to run."""
    kw: Dict[str, Any] = dict(
        vocab_size=64, d_model=64, n_layers=1, n_heads=2, n_kv_heads=2,
        d_ff=128, max_seq_len=64, dtype="float32", remat=False,
    )
    kw.update(overrides)
    return ModelConfig(**kw)


_SEQ_REFUSAL = (
    "the reference's PPO step cannot take a seq axis: BATCH_SPEC cuts both"
    " the tokens (N, T) and the forward's (N, T-1) over seq, and no seq >= 2"
    " divides two consecutive lengths (JAX raises on every seq mesh); RL runs"
    " on data, fsdp, model and expert axes")


def rl_mesh(config: ModelConfig, mesh):
    """The training mesh over ranks the RL learner runs on, or None (no
    mesh, or a mesh of one device with every axis 1). A seq axis above 1
    raises ValueError (`_SEQ_REFUSAL`), as does a mesh cut for serving (the
    actor's: `Actor(engine_kwargs={"mesh": ...})`) or an expert axis that
    does not divide the experts; an object that is not a mesh of the port
    raises NotImplementedError."""
    model_shards(mesh)
    if mesh is None:
        return None
    if mesh.shape["seq"] > 1:
        raise ValueError(f"RL over mesh {dict(mesh.shape)}: {_SEQ_REFUSAL}")
    return ranked_mesh(config, mesh)


# -- toy environment ----------------------------------------------------------


class TargetTokenEnv:
    """Seeded token-level bandit: prompts are random token strings, the
    policy earns 1.0 for every generated token equal to `target` (and 0
    otherwise). Trivial on purpose — the optimum is a delta on one token,
    so a correct PPO loop improves within tens of updates on a tiny model,
    and any break in the weight-refresh path (actors stuck on a stale
    policy) shows up as a flat reward curve."""

    def __init__(self, vocab_size: int = 64, *, prompt_len: int = 4,
                 horizon: int = 16, target: int = 7, seed: int = 0):
        if not (0 <= target < vocab_size):
            raise ValueError(f"target {target} outside vocab {vocab_size}")
        self.vocab_size = vocab_size
        self.prompt_len = prompt_len
        self.horizon = horizon
        self.target = target
        self.seed = seed

    def prompts(self, batch: int, round_ix: int) -> List[List[int]]:
        """Deterministic per (seed, round): the same round index yields
        the same prompts on every run and every actor restart."""
        rng = np.random.default_rng([self.seed, round_ix])
        draw = rng.integers(1, self.vocab_size, size=(batch, self.prompt_len))
        return [[int(t) for t in row] for row in draw]

    def token_rewards(self, actions: np.ndarray) -> np.ndarray:
        """(B, H) generated tokens -> (B, H) f32 per-token rewards."""
        return (actions == self.target).astype(np.float32)


# -- trajectory batches -------------------------------------------------------


class TrajectoryBatch(NamedTuple):
    """One rollout round from one actor, learner-ready, as host numpy.

    tokens is the full (B, prompt_len + horizon) sequence; actions,
    behavior_logprob, rewards and mask are (B, horizon) aligned to the
    generated suffix. mask zeroes rows/steps that failed mid-decode.
    weight_epoch stamps which published policy generated the round — the
    learner derives refresh staleness from it."""

    tokens: np.ndarray
    actions: np.ndarray
    behavior_logprob: np.ndarray
    rewards: np.ndarray
    mask: np.ndarray
    prompt_len: int
    actor_id: int
    weight_epoch: int

    @property
    def env_steps(self) -> int:
        return int(self.mask.sum())


def compute_advantages(rewards: np.ndarray, mask: np.ndarray,
                       *, gamma: float = 0.7,
                       normalize: bool = True) -> np.ndarray:
    """Discounted return-to-go per generated token, batch-normalized.

    The toy task has per-token rewards, so return-to-go is the natural
    credit assignment; batch normalization (masked mean/std) is the
    baseline — with a near-zero-variance batch the centered returns are
    used unscaled rather than dividing by ~0."""
    b, h = rewards.shape
    g = np.zeros((b, h), np.float32)
    acc = np.zeros(b, np.float32)
    for t in range(h - 1, -1, -1):
        acc = rewards[:, t] + gamma * acc
        g[:, t] = acc
    if not normalize:
        return g * mask
    denom = max(float(mask.sum()), 1.0)
    mean = float((g * mask).sum()) / denom
    var = float((((g - mean) ** 2) * mask).sum()) / denom
    std = var ** 0.5
    adv = g - mean
    if std > 1e-6:
        adv = adv / std
    return (adv * mask).astype(np.float32)


# -- behavior-logprob scorer --------------------------------------------------


def token_logprobs(config: ModelConfig, params: Params, tokens: torch.Tensor,
                    temperature: float, attention_fn):
    """(log-softmax over the vocab (B, T-1, V), log-prob of tokens[:, 1:]
    (B, T-1)) under softmax(logits / temperature), f32."""
    logits = forward(config, params, tokens[:, :-1], attention_fn=attention_fn)
    logits = logits / max(float(temperature), 1e-6)
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = torch.gather(logp_all, -1, tokens[:, 1:].long()[..., None])[..., 0]
    return logp_all, logp


def make_sequence_scorer(config: ModelConfig, mesh=None):
    """Teacher-forced scorer: (params, tokens (B, T) int on the params'
    device, temperature) -> per-token log-probabilities (B, T-1) of
    tokens[:, 1:] under softmax(logits / temperature), f32, no autograd.

    This is the exact behavior distribution of the engine's sampler at
    top_p=1.0 (`_select_next_token` draws categorical over logits/T with
    no nucleus cut), so scoring a rollout under the weights that generated
    it yields the PPO denominator without touching the decode programs.
    Attention is `make_attention_fn(None)`: the flash forward kernel on
    the card, plain attention on the CPU. On a training mesh over ranks
    (`rl_mesh`) `params` are the rank's slices and `tokens` its rows, and
    it returns the rank's rows of the log-probs (the reference's
    `out_shardings=BATCH_SPEC`), vocab-parallel on a model axis."""
    ranked = rl_mesh(config, mesh)
    attention_fn = make_attention_fn(None)

    @torch.no_grad()
    def score(params, tokens, temperature):
        if ranked is None:
            return token_logprobs(config, params, tokens, temperature, attention_fn)[1]
        logits = forward(config, params, tokens[:, :-1], attention_fn=attention_fn,
                         mesh=ranked)
        return -token_nll(logits / max(float(temperature), 1e-6), tokens[:, 1:], ranked)

    return score


# -- PPO train step -----------------------------------------------------------


def init_rl_state(config: ModelConfig, seed: int = 0, mesh=None,
                  learning_rate: float = 1e-2, *, params: Optional[Params] = None,
                  device: DeviceLike = None) -> TrainState:
    """Fresh policy TrainState: params (random from `seed` on `device`, or
    the given whole `params`, e.g. bridged from JAX) marked for grad, and
    AdamW moments with no weight decay (decay drags a reward-shaped
    objective toward the uniform policy). On a training mesh over ranks
    (`rl_mesh`) each rank keeps its slices of the whole params
    (sharding.shard_tree) and its moments are cut as the params, as
    `train.init_train_state` does."""
    ranked = rl_mesh(config, mesh)
    if ranked is None:
        dev = resolve_device(device)
    elif device is not None and resolve_device(device) != ranked.device:
        raise ValueError(f"device {device} is not the mesh's {ranked.device}")
    else:
        dev = ranked.device
    if params is None:
        params = init_params(config, seed, dev)
    params = shard_tree(ranked, params)
    for _, p in flatten_params(params):
        if p.device != dev:
            raise ValueError(f"params live on {p.device}, device is {dev}")
        p.requires_grad_(True)
    opt_state = make_optimizer(learning_rate, weight_decay=0.0).init(params)
    return TrainState(0, params, opt_state)


METRIC_KEYS = ("loss", "pg_loss", "entropy", "clip_fraction", "grad_norm")


def mask_count(mask: torch.Tensor, mesh=None) -> torch.Tensor:
    """The PPO loss's denominator: the global batch's mask count (the
    rank's count summed over data and fsdp on a training mesh), at least 1."""
    return torch.clamp(batch_sum(torch.sum(mask), mesh), min=1.0)


def ppo_loss(config: ModelConfig, params: Params, batch, attention_fn, *,
             clip_eps: float = 0.2, entropy_coef: float = 0.0, mesh=None):
    """The PPO step's objective: (loss, (pg_loss, entropy, clip_fraction))
    for a step batch (see `make_rl_train_step`), with `attention_fn` in
    the forward. On a training mesh over ranks (`rl_mesh`) `params` are
    the rank's slices and `batch` its rows, and each value is the rank's
    share of the global batch's: its sums over the mask count of the
    whole batch (summed over data and fsdp), the target's log-prob and the
    entropy vocab-parallel on a model axis. The shares summed over data
    and fsdp (`sharding.batch_sum`) are the reference's values, and their
    grads sum to its grads."""
    tokens = batch["tokens"]
    behavior = batch["behavior_logprob"]
    adv = batch["advantage"]
    mask = batch["mask"]
    h = behavior.shape[1]
    p = tokens.shape[1] - h
    temperature = batch.get("temperature", 1.0)
    if mesh is None:
        logp_all, logp = token_logprobs(config, params, tokens, temperature, attention_fn)
        logp_all, logp = logp_all[:, p - 1:], logp[:, p - 1:]
        ent = -torch.sum(torch.exp(logp_all) * logp_all, dim=-1)
    else:
        logits = forward(config, params, tokens[:, :-1], attention_fn=attention_fn,
                         mesh=mesh)
        logits = logits[:, p - 1:] / max(float(temperature), 1e-6)
        logp = -token_nll(logits, tokens[:, p:], mesh)
        ent = token_entropy(logits, mesh)
    denom = mask_count(mask, mesh)
    ratio = torch.exp(logp - behavior)
    surr = torch.minimum(
        ratio * adv, torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps) * adv)
    pg_loss = -torch.sum(surr * mask) / denom
    entropy = torch.sum(ent * mask) / denom
    loss = pg_loss - entropy_coef * entropy
    clipped = torch.sum(
        (torch.abs(ratio - 1.0) > clip_eps).to(torch.float32) * mask) / denom
    return loss, (pg_loss, entropy, clipped)


def make_rl_train_step(config: ModelConfig, mesh=None,
                       learning_rate: float = 1e-2, *,
                       clip_eps: float = 0.2,
                       entropy_coef: float = 0.0):
    """PPO update: `step(state, batch) -> (state, metrics)`, params and
    moments updated in place (the state passed in is spent, as the
    reference's donated one).

    batch: tokens (N, T) int full sequences, behavior_logprob / advantage /
    mask all (N, H) f32 over the generated suffix (T - H is the prompt
    length, recovered from the shapes), all on the params' device, and
    `temperature` (a float, default 1). The clipped surrogate uses the
    ACTOR-side behavior logprobs as the ratio denominator, so
    off-policyness from refresh staleness is importance-corrected up to
    the clip radius. Metrics are 0-d device tensors (METRIC_KEYS).

    On a training mesh over ranks (`rl_mesh`: data, fsdp, model, expert)
    the state holds the rank's slices (`init_rl_state(mesh=)`) and the
    batch the rank's rows (`sharding.shard_batch`); the step runs the
    forward on them, sums the grads over the axes each leaf owes
    (`reduce_grads`, as `train.make_train_step`) and returns the global
    batch's metrics on every rank."""
    ranked = rl_mesh(config, mesh)
    optimizer = make_optimizer(learning_rate, weight_decay=0.0)
    attention_fn = make_attention_fn(None)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        pairs = flatten_params(state.params)
        loss, (pg, ent, clipped) = ppo_loss(config, state.params, batch, attention_fn,
                                            clip_eps=clip_eps, entropy_coef=entropy_coef,
                                            mesh=ranked)
        grads = torch.autograd.grad(loss, [p for _, p in pairs])
        grads = [(k, g) for (k, _), g in zip(pairs, grads)]
        if ranked is not None:
            specs = dict(flatten_params(param_specs(state.params)))
            grads = reduce_grads(grads, ranked, lambda k: grad_axes(specs[k]))
            loss, pg, ent, clipped = (batch_sum(v.detach(), ranked)
                                      for v in (loss, pg, ent, clipped))
        grads = unflatten_params(grads)
        gnorm = global_norm(grads, ranked)
        opt_state = optimizer.apply(state.params, grads, state.opt_state)
        metrics = {"loss": loss.detach(), "pg_loss": pg.detach(),
                   "entropy": ent.detach(), "clip_fraction": clipped,
                   "grad_norm": gnorm}
        return TrainState(state.step + 1, state.params, opt_state), metrics

    return train_step


# -- weight refresh channel ---------------------------------------------------
#
# The frame layout is kv_transfer's manifest + buffers format — the JAX
# package's, byte for byte — over the flattened policy tree, wrapped in a
# versioned header with the weight epoch. Pull-based: actors poll between
# rollout rounds (the only point an idle-engine swap is legal), so the
# server never has to chase actor liveness. The frame budget
# (kv_transfer.max_frame_bytes, 1 GiB by default) is checked per array:
# at smol-1b the largest leaf, a stacked (16, 2048, 5632) bf16 MLP weight,
# is 369 MB.


def _keystr(path: str) -> str:
    """`jax.tree_util.keystr` of a dict path ("layers/wq" ->
    "['layers']['wq']")."""
    return "".join(f"[{k!r}]" for k in path.split("/"))


def named_params(params: Params) -> List[Tuple[str, torch.Tensor]]:
    """Flatten a policy tree (nested dicts of tensors) to (path, tensor)
    pairs in canonical tree order — the manifest layout of a weights
    frame. Names are the reference's keystr paths (`['layers']['wq']`) in
    its order (sorted keys), so a JAX learner feeds a port actor and the
    reverse. The tensors are the params themselves, detached (no copy):
    each channel copies what it keeps."""
    return [(_keystr(k), t.detach()) for k, t in flatten_params(params)]


def params_from_named(template: Params, by_name: Dict[str, Any]) -> Params:
    """Rebuild a tree shaped like `template` from a named-array dict (the
    inverse of `named_params`; values are tensors). Missing or extra names
    raise — adopting a frame from a different model shape must fail
    loudly."""
    flat = flatten_params(template)
    want = [_keystr(path) for path, _ in flat]
    extra = set(by_name) - set(want)
    if extra:
        raise ValueError(f"weights frame has unknown params: {sorted(extra)}")
    leaves = []
    for name, (path, leaf) in zip(want, flat):
        if name not in by_name:
            raise ValueError(f"weights frame is missing param {name!r}")
        arr = by_name[name]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(
                f"param {name!r} shape {tuple(arr.shape)} != expected"
                f" {tuple(leaf.shape)}"
            )
        leaves.append((path, arr))
    return unflatten_params(leaves)


def _host_copies(params: Params) -> List[Tuple[str, torch.Tensor]]:
    """named_params as contiguous host copies (never views of the params,
    which the learner keeps updating in place)."""
    return [(name, t.to("cpu", copy=True).contiguous()) for name, t in named_params(params)]


class _Listener:
    """A listening socket, its accept thread and one handler thread per
    accepted connection (`handle(conn)`). `close()` ends them all before
    it returns: it shuts the listener and every connection down, which
    wakes each blocked accept and recv, and joins the threads. A daemon
    thread still inside torch (encoding or decoding a frame) when the
    interpreter exits aborts the process ("terminate called without an
    active exception")."""

    def __init__(self, host: str, port: int, handle: Callable[[socket.socket], None]):
        self._handle = handle
        self._lock = threading.Lock()
        self._conns: List[Tuple[socket.socket, threading.Thread]] = []
        self.stopped = False
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.port = self._sock.getsockname()[1]
        self._accept = threading.Thread(target=self._accept_loop, daemon=True)
        self._accept.start()

    def _accept_loop(self) -> None:
        while not self.stopped:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            t = threading.Thread(target=self._handle, args=(conn,), daemon=True)
            with self._lock:
                if self.stopped:
                    conn.close()
                    return
                self._conns.append((conn, t))
            t.start()

    def close(self, timeout: float = 10.0) -> None:
        with self._lock:
            self.stopped = True
            conns, self._conns = self._conns, []
        for sock in [self._sock] + [c for c, _ in conns]:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        try:
            self._sock.close()
        except OSError:
            pass
        for t in [self._accept] + [t for _, t in conns]:
            if t is not threading.current_thread():
                t.join(timeout)


class WeightRefreshServer:
    """Learner-side publisher. `publish(params)` copies the tree to host
    tensors once and swaps the (epoch, manifest, arrays) snapshot
    atomically under a lock; each puller request is answered from
    whichever snapshot was current when it arrived — complete or not at
    all, never a mix of epochs."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._lock = threading.Lock()
        self._snap: Optional[Tuple[int, List, List[torch.Tensor]]] = None
        self._epoch = 0
        self.publishes = 0
        self.pulls_served = 0
        self.bytes_sent = 0
        self._listener = _Listener(host, port, self._serve_conn)
        self.port = self._listener.port

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def publish(self, params: Params) -> int:
        named = _host_copies(params)
        manifest = array_manifest(named)
        arrays = [a for _, a in named]
        with self._lock:
            self._epoch += 1
            self._snap = (self._epoch, manifest, arrays)
            self.publishes += 1
            return self._epoch

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            with conn:
                send_msg(conn, {
                    "kind": "hello", "service": "weight_refresh",
                    "version": WEIGHT_REFRESH_VERSION, "epoch": self.epoch,
                })
                while not self._listener.stopped:
                    req = recv_msg(conn)
                    if req.get("kind") != "weight_pull":
                        send_msg(conn, {"kind": "error", "reason": "unexpected message"})
                        continue
                    have = int(req.get("have_epoch", 0))
                    with self._lock:
                        snap = self._snap
                    if snap is None or snap[0] <= have:
                        send_msg(conn, {"kind": "current", "epoch": self.epoch})
                        continue
                    epoch, manifest, arrays = snap
                    blob = encode_msg({
                        "kind": "weights",
                        "version": WEIGHT_REFRESH_VERSION,
                        "epoch": epoch, "arrays": manifest,
                    }, tuple(arrays))
                    # Counted before the send: a client that holds the
                    # frame finds it counted.
                    with self._lock:
                        self.pulls_served += 1
                        self.bytes_sent += len(blob)
                    conn.sendall(blob)
        except (ConnectionError, OSError, json.JSONDecodeError):
            return

    def close(self) -> None:
        """Stop serving: every handler thread has ended when this returns."""
        self._listener.close()


class WeightRefreshClient:
    """Actor-side puller. `poll(have_epoch)` returns (epoch, host tensors
    by name) only for a STRICTLY newer epoch — the fence: a slow frame
    that arrives after a fresher adoption is dropped, an actor's weight
    epoch never moves backwards. One reconnect per poll (a learner restart
    closed the stream); version mismatches are protocol errors, not parse
    attempts."""

    def __init__(self, host: str, port: int, *, timeout: float = 60.0,
                 max_bytes: Optional[int] = None):
        self._addr = (host, port)
        self._timeout = timeout
        self._max_bytes = max_frame_bytes(max_bytes)
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self.server_epoch = 0
        self.bytes_received = 0
        self.pulls = 0

    def _connect(self) -> None:
        sock = socket.create_connection(self._addr, timeout=self._timeout)
        sock.settimeout(self._timeout)
        hello = recv_msg(sock, max_bytes=self._max_bytes)
        if hello.get("kind") != "hello" or hello.get("service") != "weight_refresh":
            sock.close()
            raise ConnectionError(
                f"expected weight_refresh hello, got {hello.get('kind')!r}")
        if int(hello.get("version", -1)) != WEIGHT_REFRESH_VERSION:
            sock.close()
            raise ConnectionError(
                f"weight_refresh version {hello.get('version')} !="
                f" {WEIGHT_REFRESH_VERSION}")
        self._sock = sock
        self.server_epoch = int(hello["epoch"])

    def _poll_once(self, have_epoch: int) -> Dict[str, Any]:
        if self._sock is None:
            self._connect()
        send_msg(self._sock, {"kind": "weight_pull", "have_epoch": int(have_epoch)})
        return recv_msg(self._sock, max_bytes=self._max_bytes)

    def poll(self, have_epoch: int) -> Optional[Tuple[int, Dict[str, torch.Tensor]]]:
        with self._lock:
            try:
                reply = self._poll_once(have_epoch)
            except (ConnectionError, OSError):
                self._close_sock()
                self._connect()
                reply = self._poll_once(have_epoch)
            kind = reply.get("kind")
            if kind == "current":
                self.server_epoch = int(reply.get("epoch", self.server_epoch))
                return None
            if kind != "weights":
                raise ConnectionError(f"unexpected weight_refresh reply: {kind!r}")
            if int(reply.get("version", -1)) != WEIGHT_REFRESH_VERSION:
                raise ConnectionError(
                    f"weights frame version {reply.get('version')} !="
                    f" {WEIGHT_REFRESH_VERSION}")
            epoch = int(reply["epoch"])
            self.server_epoch = max(self.server_epoch, epoch)
            if epoch <= have_epoch:
                return None  # fence: raced a fresher adoption
            by_name = {spec["name"]: arr
                       for spec, arr in zip(reply.get("arrays", ()), reply["_arrays"])}
            self.pulls += 1
            self.bytes_received += sum(a.numel() * a.element_size()
                                       for a in by_name.values())
            return epoch, by_name

    def _close_sock(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        with self._lock:
            self._close_sock()


class CheckpointWeightRefresh:
    """File-based refresh baseline: publish writes the arrays to
    `weights.npz` and then the epoch sidecar `weights.json`, each
    atomically (tmp + rename, the runner's resize-notice recipe); poll
    reads the sidecar and reloads the whole file. Same publish/poll
    interface as the socket pair, and the reference's files for f32 (or
    any numpy-named dtype) leaves.

    numpy has no bfloat16: a bf16 leaf is stored as its raw bits (uint16),
    its name listed under the sidecar's "bfloat16" key, and poll views
    those bits back as bf16. (The reference's npz of a bf16 leaf carries
    the ml_dtypes type, which numpy writes as an unnamed 2-byte void.)"""

    def __init__(self, dirpath: str):
        self._dir = dirpath
        os.makedirs(dirpath, exist_ok=True)
        self._epoch = 0

    def _paths(self) -> Tuple[str, str]:
        return (os.path.join(self._dir, "weights.npz"),
                os.path.join(self._dir, "weights.json"))

    def publish(self, params: Params) -> int:
        npz, meta = self._paths()
        arrays, bf16 = {}, []
        for name, t in _host_copies(params):
            if t.dtype == torch.bfloat16:
                bf16.append(name)
                arrays[name] = t.view(torch.int16).numpy().view(np.uint16)
            else:
                arrays[name] = t.numpy()
        self._epoch += 1
        tmp = npz + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, npz)
        head: Dict[str, Any] = {"epoch": self._epoch, "version": WEIGHT_REFRESH_VERSION}
        if bf16:
            head["bfloat16"] = bf16
        tmp = meta + ".tmp"
        with open(tmp, "w") as f:
            json.dump(head, f)
        os.replace(tmp, meta)
        return self._epoch

    def poll(self, have_epoch: int) -> Optional[Tuple[int, Dict[str, torch.Tensor]]]:
        npz, meta = self._paths()
        try:
            with open(meta) as f:
                head = json.load(f)
        except (OSError, ValueError):
            return None
        epoch = int(head.get("epoch", 0))
        if epoch <= have_epoch:
            return None
        bf16 = set(head.get("bfloat16", ()))
        out = {}
        with np.load(npz) as z:
            for name in z.files:
                a = z[name]
                out[name] = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                             if name in bf16 else torch.from_numpy(a))
        return epoch, out


class InProcessWeightRefresh:
    """Refresh for colocated (Anakin) runs and unit tests: publish clones
    the params on their device (one device-to-device copy; a view would be
    rewritten by the next learner step), and the snapshot swap is one
    tuple assignment under the GIL."""

    def __init__(self):
        self._snap: Optional[Tuple[int, Dict[str, torch.Tensor]]] = None
        self._epoch = 0

    def publish(self, params: Params) -> int:
        self._epoch += 1
        self._snap = (self._epoch, {name: t.clone() for name, t in named_params(params)})
        return self._epoch

    def poll(self, have_epoch: int) -> Optional[Tuple[int, Dict[str, torch.Tensor]]]:
        snap = self._snap
        if snap is None or snap[0] <= have_epoch:
            return None
        return snap


# -- trajectory transport -----------------------------------------------------


def pack_trajectories(t: TrajectoryBatch
                      ) -> Tuple[Dict[str, Any], Tuple[torch.Tensor, ...]]:
    """A batch -> (header, host tensors) for `send_msg`, the reference's
    frame: int32 tokens/actions, f32 the rest."""
    named = [
        ("tokens", np.asarray(t.tokens, np.int32)),
        ("actions", np.asarray(t.actions, np.int32)),
        ("behavior_logprob", np.asarray(t.behavior_logprob, np.float32)),
        ("rewards", np.asarray(t.rewards, np.float32)),
        ("mask", np.asarray(t.mask, np.float32)),
    ]
    named = [(name, torch.from_numpy(np.ascontiguousarray(a))) for name, a in named]
    header = {
        "kind": "trajectories",
        "prompt_len": int(t.prompt_len),
        "actor_id": int(t.actor_id),
        "weight_epoch": int(t.weight_epoch),
        "arrays": array_manifest(named),
    }
    return header, tuple(a for _, a in named)


def unpack_trajectories(header: Dict[str, Any]) -> TrajectoryBatch:
    by_name = {
        spec["name"]: (arr.numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr))
        for spec, arr in zip(header.get("arrays", ()), header["_arrays"])
    }
    return TrajectoryBatch(
        tokens=by_name["tokens"],
        actions=by_name["actions"],
        behavior_logprob=by_name["behavior_logprob"],
        rewards=by_name["rewards"],
        mask=by_name["mask"],
        prompt_len=int(header["prompt_len"]),
        actor_id=int(header["actor_id"]),
        weight_epoch=int(header["weight_epoch"]),
    )


class TrajectorySink:
    """Learner-side listener for actor trajectory streams (one thread per
    actor connection, `on_batch` called in arrival order, ack after the
    callback returns so an actor that saw the ack knows the learner owns
    the round)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 on_batch: Callable[[TrajectoryBatch], None]):
        self._on_batch = on_batch
        self._lock = threading.Lock()
        self.batches_received = 0
        self.bytes_received = 0
        self._listener = _Listener(host, port, self._serve_conn)
        self.port = self._listener.port

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            with conn:
                send_msg(conn, {"kind": "hello", "service": "trajectories"})
                while not self._listener.stopped:
                    header = recv_msg(conn)
                    if header.get("kind") != "trajectories":
                        send_msg(conn, {"kind": "error", "reason": "unexpected message"})
                        continue
                    batch = unpack_trajectories(header)
                    self._on_batch(batch)
                    with self._lock:
                        self.batches_received += 1
                        self.bytes_received += sum(a.numel() * a.element_size()
                                                   for a in header["_arrays"])
                    send_msg(conn, {"kind": "ack"})
        except (ConnectionError, OSError, json.JSONDecodeError):
            return

    def close(self) -> None:
        """Stop listening: every handler thread has ended when this returns."""
        self._listener.close()


class TrajectoryClient:
    """Actor-side trajectory sender; blocking send with one reconnect
    (learner restart) per attempt."""

    def __init__(self, host: str, port: int, *, timeout: float = 60.0):
        self._addr = (host, port)
        self._timeout = timeout
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self.batches_sent = 0

    def _connect(self) -> None:
        sock = socket.create_connection(self._addr, timeout=self._timeout)
        sock.settimeout(self._timeout)
        hello = recv_msg(sock)
        if hello.get("kind") != "hello" or hello.get("service") != "trajectories":
            sock.close()
            raise ConnectionError("expected trajectories hello")
        self._sock = sock

    def _send_once(self, t: TrajectoryBatch) -> Dict[str, Any]:
        if self._sock is None:
            self._connect()
        header, payloads = pack_trajectories(t)
        send_msg(self._sock, header, payloads)
        return recv_msg(self._sock)

    def send(self, t: TrajectoryBatch) -> None:
        with self._lock:
            try:
                reply = self._send_once(t)
            except (ConnectionError, OSError):
                self._close_sock()
                self._connect()
                reply = self._send_once(t)
            if reply.get("kind") != "ack":
                raise ConnectionError(f"unexpected trajectory reply: {reply!r}")
            self.batches_sent += 1

    def _close_sock(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        with self._lock:
            self._close_sock()


# -- metrics ------------------------------------------------------------------


class RLStats:
    """Thread-safe counters/hists behind the RL Prometheus series. One
    instance per process (actor or learner); the drill's /metrics endpoint
    renders the learner-side instance."""

    def __init__(self):
        self._lock = threading.Lock()
        self.env_steps_total = 0
        self.episodes_total = 0
        self.learn_steps_total = 0
        self.gang_resizes_total = 0
        self.refresh_published_total = 0   # learner-side publishes
        self.refresh_adopted_total = 0     # actor-side adoptions
        self.learner_epoch = 0
        self.actor_epochs: Dict[int, int] = {}
        self.staleness_epochs: Dict[int, int] = {}
        self.reward_mean = 0.0
        self.rollout_hist = HistogramData()
        self.learn_step_hist = HistogramData()
        self.refresh_hist = HistogramData()

    def count_rollout(self, *, env_steps: int, episodes: int,
                      seconds: Optional[float] = None,
                      reward_mean: Optional[float] = None) -> None:
        """seconds is None when the counter lives in a different process
        than the rollout (the Sebulba learner accounts actor batches by
        their trajectory stamps and has no duration to observe)."""
        with self._lock:
            self.env_steps_total += env_steps
            self.episodes_total += episodes
            if reward_mean is not None:
                self.reward_mean = reward_mean
            if seconds is not None:
                self.rollout_hist.observe(seconds)

    def note_actor_epoch(self, actor_id: int, epoch: int) -> None:
        """Track an actor's weight epoch from its trajectory stamps
        (learner side — adoption latency is only known actor-side)."""
        with self._lock:
            prev = self.actor_epochs.get(actor_id)
            if prev is None or epoch > prev:
                self.actor_epochs[actor_id] = epoch

    def count_learn_step(self, seconds: float) -> None:
        with self._lock:
            self.learn_steps_total += 1
            self.learn_step_hist.observe(seconds)

    def count_publish(self, epoch: int) -> None:
        with self._lock:
            self.refresh_published_total += 1
            self.learner_epoch = max(self.learner_epoch, epoch)

    def count_adoption(self, actor_id: int, epoch: int, seconds: float) -> None:
        with self._lock:
            self.refresh_adopted_total += 1
            self.actor_epochs[actor_id] = epoch
            self.refresh_hist.observe(seconds)

    def observe_staleness(self, actor_id: int, lag: int) -> None:
        with self._lock:
            self.staleness_epochs[actor_id] = lag

    def count_gang_resize(self) -> None:
        with self._lock:
            self.gang_resizes_total += 1

    def note_learner_epoch(self, epoch: int) -> None:
        with self._lock:
            self.learner_epoch = max(self.learner_epoch, epoch)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "env_steps_total": self.env_steps_total,
                "episodes_total": self.episodes_total,
                "learn_steps_total": self.learn_steps_total,
                "gang_resizes_total": self.gang_resizes_total,
                "refresh_published_total": self.refresh_published_total,
                "refresh_adopted_total": self.refresh_adopted_total,
                "learner_epoch": self.learner_epoch,
                "actor_epochs": dict(self.actor_epochs),
                "staleness_epochs": dict(self.staleness_epochs),
                "reward_mean": self.reward_mean,
                "rollout_hist": self.rollout_hist.to_dict(),
                "learn_step_hist": self.learn_step_hist.to_dict(),
                "refresh_hist": self.refresh_hist.to_dict(),
            }


def rl_prometheus_metrics(stats: Dict[str, Any]) -> str:
    """Render an RLStats snapshot in Prometheus text exposition format,
    the reference's series and text (every series is declared in the
    orchestrator's metrics registry)."""
    series = [
        ("dstack_tpu_rl_env_steps_total", "counter", stats["env_steps_total"]),
        ("dstack_tpu_rl_episodes_total", "counter", stats["episodes_total"]),
        ("dstack_tpu_rl_learn_steps_total", "counter", stats["learn_steps_total"]),
        ("dstack_tpu_rl_gang_resizes_total", "counter", stats["gang_resizes_total"]),
        ("dstack_tpu_rl_reward_mean", "gauge", stats["reward_mean"]),
    ]
    lines = []
    for name, mtype, value in series:
        lines.append(f"# TYPE {name} {mtype}")
        lines.append(f"{name} {value}")
    # Publish/adoption split: one series, role-labeled, so a stuck
    # refresh path shows as publishes advancing while adoptions stall.
    refr = "dstack_tpu_rl_weight_refreshes_total"
    lines.append(f"# TYPE {refr} counter")
    lines.append(f'{refr}{{role="learner"}} {stats["refresh_published_total"]}')
    lines.append(f'{refr}{{role="actor"}} {stats["refresh_adopted_total"]}')
    epoch = "dstack_tpu_rl_weight_epoch"
    lines.append(f"# TYPE {epoch} gauge")
    lines.append(f'{epoch}{{role="learner"}} {stats["learner_epoch"]}')
    actor_epochs = stats.get("actor_epochs") or {}
    if actor_epochs:
        lines.append(f'{epoch}{{role="actor"}} {min(actor_epochs.values())}')
    stale = "dstack_tpu_rl_refresh_staleness_epochs"
    lines.append(f"# TYPE {stale} gauge")
    for actor_id, lag in sorted((stats.get("staleness_epochs") or {}).items()):
        lines.append(f'{stale}{{actor="{actor_id}"}} {lag}')

    def _render_hist(base: str, hist: Dict[str, Any]) -> None:
        lines.append(f"# TYPE {base} histogram")
        for le, cumulative in hist["buckets"]:
            lines.append(f'{base}_bucket{{le="{le}"}} {cumulative}')
        lines.append(f'{base}_bucket{{le="+Inf"}} {hist["count"]}')
        lines.append(f'{base}_sum {hist["sum"]}')
        lines.append(f'{base}_count {hist["count"]}')

    _render_hist("dstack_tpu_rl_rollout_seconds", stats["rollout_hist"])
    _render_hist("dstack_tpu_rl_learn_step_seconds", stats["learn_step_hist"])
    _render_hist("dstack_tpu_rl_refresh_seconds", stats["refresh_hist"])
    return "\n".join(lines) + "\n"


# -- actor --------------------------------------------------------------------


def actor_engine_kwargs(env: TargetTokenEnv, *, batch_size: int = 8,
                        temperature: float = 1.0, seed: int = 0,
                        engine_kwargs: Optional[Dict[str, Any]] = None,
                        device: DeviceLike = None) -> Dict[str, Any]:
    """The ServingEngine arguments of an actor: one slot per rollout, a
    window of the episode's length rounded up to a block, the round's
    prompts in one prefill chunk, the actor's sampling temperature and
    seed, then `engine_kwargs` over them. The leader (`Actor`) and the
    followers of a mesh actor (`run_actor_follower`) both build their
    engines from it."""
    need = env.prompt_len + env.horizon
    kwargs: Dict[str, Any] = dict(
        slots=batch_size,
        max_len=-(-need // 16) * 16,
        temperature=float(temperature),
        seed=seed,
        max_prefills_per_chunk=batch_size,
        prefill_chunk_tokens=max(batch_size * env.prompt_len, 1),
        device=device,
    )
    kwargs.update(engine_kwargs or {})
    return kwargs


def run_actor_follower(config: ModelConfig, params: Params, env: TargetTokenEnv, *,
                       mesh, batch_size: int = 8, temperature: float = 1.0, seed: int = 0,
                       engine_kwargs: Optional[Dict[str, Any]] = None,
                       device: DeviceLike = None) -> ServingEngine:
    """Ranks 1.. of an actor on a serving mesh (`Actor(engine_kwargs=
    {"mesh": mesh})` on rank 0): the leader's engine arguments
    (`actor_engine_kwargs`, from the actor's own), then the leader's ops
    (`serving.run_follower`) until its actor closes. `params` are the whole
    params, as the leader was given them; each rank keeps its slices."""
    kw = actor_engine_kwargs(env, batch_size=batch_size, temperature=temperature,
                             seed=seed, engine_kwargs=engine_kwargs, device=device)
    kw.pop("mesh", None)
    return run_follower(mesh, config, params, **kw)


class Actor:
    """One rollout worker: a ServingEngine over (its own copy of) the
    policy, a teacher-forced scorer for behavior logprobs, and a refresh
    poller.

    Rollouts are gang-synchronous and seeded: each round submits
    `batch_size` prompts under `hold_admission` (one admission wave →
    deterministic sampler draws), drains all streams, scores them under the
    weights that generated them, then polls for fresh weights at the idle
    boundary before the next round. `device` (None: the CUDA device) must
    be where `params` live. With `engine_kwargs={"mesh": mesh}` (a serving
    mesh over ranks) this is rank 0's actor and ranks 1.. run
    `run_actor_follower` with the same arguments: rollouts, scoring
    (`ServingEngine.score`) and refreshes run on every rank's shards."""

    def __init__(self, config: ModelConfig, params: Params, env: TargetTokenEnv, *,
                 actor_id: int = 0, batch_size: int = 8,
                 temperature: float = 1.0, seed: int = 0,
                 refresh=None, stats: Optional[RLStats] = None,
                 engine_kwargs: Optional[Dict[str, Any]] = None,
                 device: DeviceLike = None):
        self.config = config
        self.env = env
        self.actor_id = actor_id
        self.batch_size = batch_size
        self.temperature = float(temperature)
        if self.temperature <= 0:
            raise ValueError(
                "RL rollouts need temperature > 0 (greedy decode has no"
                " exploration and a degenerate behavior distribution)"
            )
        self._refresh = refresh
        self.stats = stats or RLStats()
        self.weight_epoch = 0
        self.engine = ServingEngine(config, params, **actor_engine_kwargs(
            env, batch_size=batch_size, temperature=self.temperature, seed=seed,
            engine_kwargs=engine_kwargs, device=device))
        self.device = self.engine.device
        # On a mesh the engine scores on every rank's shards (its op);
        # one device scores its own params with the flash forward.
        mesh = self.engine.mesh
        self._ranked = mesh is not None and mesh.ranked
        self._score = None if self._ranked else make_sequence_scorer(config)
        self.rounds = 0

    def maybe_refresh(self) -> bool:
        """Poll at the idle boundary; adopt only strictly newer weights
        (the client fences on epoch). Returns True when a new epoch was
        adopted."""
        if self._refresh is None:
            return False
        t0 = time.monotonic()
        got = self._refresh.poll(self.weight_epoch)
        if got is None:
            return False
        epoch, by_name = got
        # A mesh rank's params are its slices: the frame's whole tree is
        # checked against the config's shapes, and each rank cuts its own.
        template = param_template(self.config) if self._ranked else self.engine.params
        self.engine.refresh_params(params_from_named(template, by_name))
        self.weight_epoch = epoch
        auto_stage("weight_refresh")
        self.stats.count_adoption(self.actor_id, epoch, time.monotonic() - t0)
        return True

    def rollout(self, round_ix: Optional[int] = None) -> TrajectoryBatch:
        """One gang-synchronous round -> a learner-ready batch."""
        if round_ix is None:
            round_ix = self.rounds
        self.rounds = round_ix + 1
        auto_stage("rollout_start")
        t0 = time.monotonic()
        env = self.env
        prompts = env.prompts(self.batch_size, round_ix)
        self.engine.hold_admission()
        try:
            outs = [self.engine.submit(p, env.horizon, temperature=self.temperature,
                                       top_p=1.0)
                    for p in prompts]
        finally:
            self.engine.release_admission()
        b, h, p_len = self.batch_size, env.horizon, env.prompt_len
        actions = np.zeros((b, h), np.int32)
        mask = np.zeros((b, h), np.float32)
        for i, out in enumerate(outs):
            t = 0
            while True:
                tok = out.get()
                if tok is None:
                    break
                if isinstance(tok, BaseException):
                    mask[i, :] = 0.0
                    break
                if t < h:
                    actions[i, t] = tok
                    mask[i, t] = 1.0
                t += 1
        tokens = np.concatenate([np.asarray(prompts, np.int32), actions], axis=1)
        if self._ranked:
            logp = self.engine.score(tokens, self.temperature)
        else:
            logp = self._score(self.engine.params, torch.from_numpy(tokens).to(self.device),
                               self.temperature)
        logp = logp.cpu().numpy()[:, p_len - 1:]
        rewards = env.token_rewards(actions) * mask
        batch = TrajectoryBatch(
            tokens=tokens, actions=actions,
            behavior_logprob=logp.astype(np.float32),
            rewards=rewards, mask=mask, prompt_len=p_len,
            actor_id=self.actor_id, weight_epoch=self.weight_epoch,
        )
        steps = batch.env_steps
        self.stats.count_rollout(
            env_steps=steps, episodes=b,
            seconds=time.monotonic() - t0,
            reward_mean=float(rewards.sum() / max(steps, 1)),
        )
        return batch

    def close(self) -> None:
        self.engine.close()
        if self._refresh is not None and hasattr(self._refresh, "close"):
            self._refresh.close()


# -- learner ------------------------------------------------------------------


class Learner:
    """Consumes trajectory batches, runs the PPO step, publishes weights.

    Gang accounting: one update folds `accum_per_actor x gang_width` actor
    batches into a single stacked step batch. An elastic resize (width W ->
    W') applies `rescale_accum_steps(accum_per_actor, W, W')`, so
    batches-per-update — and therefore the stacked batch SHAPE — is
    invariant: survivors of a shrink just contribute more rounds each. Zero
    learner restarts by construction; the resize is a host-side integer
    swap. `params` (e.g. bridged from JAX) replaces the init from `seed`.

    On a training mesh over ranks (`rl_mesh`) every rank builds a Learner
    with the same arguments, but only rank 0 holds the refresh publisher
    (and is fed trajectories): `update_once` on rank 0 gathers the batches,
    computes the advantages and broadcasts the step batch, every rank cuts
    its rows and steps, and `publish` gathers the whole params on every
    rank (the same collectives in the same order) for rank 0 to publish.
    The caller ends a rank process with `sharding.leave_ranks`."""

    def __init__(self, config: ModelConfig, *, seed: int = 0, mesh=None,
                 learning_rate: float = 1e-2, gamma: float = 0.7,
                 clip_eps: float = 0.2, entropy_coef: float = 0.0,
                 accum_per_actor: int = 1, gang_width: int = 1,
                 refresh=None, stats: Optional[RLStats] = None,
                 params: Optional[Params] = None, device: DeviceLike = None):
        self.config = config
        self.gamma = gamma
        self.accum_per_actor = accum_per_actor
        self.gang_width = gang_width
        self.mesh = rl_mesh(config, mesh)
        self._lead = self.mesh is None or self.mesh.rank == 0
        if refresh is not None and not self._lead:
            raise ValueError("only rank 0 of a learner's mesh holds the refresh publisher")
        self._refresh = refresh
        self.stats = stats or RLStats()
        self.state = init_rl_state(config, seed, mesh, learning_rate,
                                   params=params, device=device)
        self.device = params_device(self.state.params)
        self._step = make_rl_train_step(config, mesh, learning_rate,
                                        clip_eps=clip_eps, entropy_coef=entropy_coef)
        self.weight_epoch = 0
        self.updates = 0
        self._q: "queue.Queue[TrajectoryBatch]" = queue.Queue()
        self._buf: List[TrajectoryBatch] = []

    @property
    def batches_per_update(self) -> int:
        return self.accum_per_actor * self.gang_width

    def ingest(self, batch: TrajectoryBatch) -> None:
        self._q.put(batch)

    def queued(self) -> int:
        return self._q.qsize() + len(self._buf)

    def rescale_gang(self, new_width: int) -> None:
        """Elastic actor-gang resize: preserve trajectories-per-update
        exactly (see rescale_accum_steps for the no-rounding contract)."""
        if new_width == self.gang_width:
            return
        self.accum_per_actor = rescale_accum_steps(
            self.accum_per_actor, self.gang_width, new_width)
        self.gang_width = new_width
        self.stats.count_gang_resize()

    def gather(self, *, timeout: float = 60.0,
               poll: Optional[Callable[[], None]] = None) -> List[TrajectoryBatch]:
        """Block until a full update's worth of batches is buffered.
        `poll` runs between queue waits (the drill wires the resize-notice
        check here, so a shrink mid-gather retargets the count without
        restarting anything)."""
        deadline = time.monotonic() + timeout
        while len(self._buf) < self.batches_per_update:
            if poll is not None:
                poll()
            try:
                self._buf.append(self._q.get(timeout=0.2))
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"learner starved: {len(self._buf)}/"
                        f"{self.batches_per_update} batches after"
                        f" {timeout:.0f}s")
        take, self._buf = (self._buf[:self.batches_per_update],
                           self._buf[self.batches_per_update:])
        return take

    def _host_batch(self, batches: List[TrajectoryBatch]) -> Tuple[Dict[str, np.ndarray], float]:
        """(the step batch of a gang round as host arrays, its mean reward
        per env step): the rounds stacked, advantages computed here."""
        tokens, behavior, rewards, mask = (
            np.concatenate([getattr(tb, f) for tb in batches])
            for f in ("tokens", "behavior_logprob", "rewards", "mask"))
        adv = compute_advantages(rewards, mask, gamma=self.gamma)
        arrays = {"tokens": tokens, "behavior_logprob": behavior, "advantage": adv,
                  "mask": mask}
        return arrays, float(rewards.sum() / max(mask.sum(), 1.0))

    def _device_batch(self, arrays: Dict[str, np.ndarray]) -> Dict[str, Any]:
        out: Dict[str, Any] = {k: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                               for k, a in arrays.items()}
        out["temperature"] = 1.0
        return out

    def step_batch(self, batches: List[TrajectoryBatch]) -> Tuple[Dict[str, Any], float]:
        """(the PPO step's device batch for a gang round, whole, its mean
        reward per env step): the rounds stacked, advantages computed on
        the host."""
        arrays, reward_mean = self._host_batch(batches)
        return self._device_batch(arrays), reward_mean

    def update_from(self, batches: Optional[List[TrajectoryBatch]]) -> Dict[str, float]:
        """One PPO update over a gathered gang round. On a mesh rank 0
        passes the round and broadcasts its step batch; the other ranks
        pass None and step on their rows of it."""
        if self._lead:
            for tb in batches:
                self.stats.observe_staleness(
                    tb.actor_id, max(self.weight_epoch - tb.weight_epoch, 0))
            arrays, reward_mean = self._host_batch(batches)
        if self.mesh is not None:
            arrays, reward_mean = broadcast_object(
                (arrays, reward_mean) if self._lead else None, self.mesh)
        step_batch = self._device_batch(arrays)
        if self.mesh is not None:
            rows = shard_batch({k: v for k, v in step_batch.items() if torch.is_tensor(v)},
                               self.mesh)
            step_batch = {**step_batch, **rows}
        t0 = time.monotonic()
        self.state, metrics = self._step(self.state, step_batch)
        # The one host readback, which also waits for the step to finish.
        values = torch.stack([metrics[k] for k in METRIC_KEYS]).tolist()
        dt = time.monotonic() - t0
        auto_stage("learn_step")
        self.stats.count_learn_step(dt)
        self.updates += 1
        out = dict(zip(METRIC_KEYS, values))
        out["step_seconds"] = dt
        out["reward_mean"] = reward_mean
        return out

    def update_once(self, *, timeout: float = 60.0,
                    poll: Optional[Callable[[], None]] = None) -> Dict[str, float]:
        """Gather an update's batches (rank 0 of a mesh; the others take
        its broadcast) and step."""
        return self.update_from(self.gather(timeout=timeout, poll=poll)
                                if self._lead else None)

    def whole_params(self) -> Params:
        """The policy's whole params: the state's own on one device; on a
        mesh gathered from every rank's slices (a collective every rank
        runs, in the same order)."""
        return unshard_tree(self.mesh, self.state.params)

    def publish(self) -> int:
        """Push the current policy; returns the new weight epoch. On a mesh
        every rank calls it: each gathers the whole params, rank 0
        publishes them and broadcasts the epoch."""
        if self._lead and self._refresh is None:
            raise RuntimeError("learner has no refresh channel")
        whole = self.whole_params()
        epoch = self._refresh.publish(whole) if self._lead else None
        if self.mesh is not None:
            epoch = broadcast_object(epoch, self.mesh)
        self.weight_epoch = epoch
        self.stats.count_publish(epoch)
        return epoch


# -- colocated (Anakin) harness -----------------------------------------------


def make_refresh_channel(refresh: str, checkpoint_dir: Optional[str] = None):
    """(publisher, client, server or None) for a refresh mode: "socket"
    (WeightRefreshServer over loopback — the frames the Sebulba gang
    uses), "checkpoint" (the npz file baseline) or "direct" (in-process
    snapshot)."""
    if refresh == "socket":
        server = WeightRefreshServer()
        return server, WeightRefreshClient("127.0.0.1", server.port), server
    if refresh == "checkpoint":
        if checkpoint_dir is None:
            raise ValueError("refresh='checkpoint' needs checkpoint_dir")
        publisher = CheckpointWeightRefresh(checkpoint_dir)
        return publisher, publisher, None
    if refresh == "direct":
        publisher = InProcessWeightRefresh()
        return publisher, publisher, None
    raise ValueError(f"unknown refresh mode {refresh!r}")


def run_anakin(config: Optional[ModelConfig] = None, *,
               updates: int = 30, batch_size: int = 16,
               prompt_len: int = 4, horizon: int = 16,
               target: int = 7, seed: int = 0,
               learning_rate: float = 2e-2, gamma: float = 0.7,
               clip_eps: float = 0.2, entropy_coef: float = 0.0,
               temperature: float = 1.0, publish_every: int = 1,
               refresh: str = "socket",
               checkpoint_dir: Optional[str] = None,
               stats: Optional[RLStats] = None,
               params: Optional[Params] = None,
               device: DeviceLike = None) -> Dict[str, Any]:
    """Single-card colocated actor+learner loop (Anakin): synchronous,
    deterministic for a fixed seed, and therefore the harness behind the
    seeded learning smoke. `refresh` picks the weight channel
    (`make_refresh_channel`). `params` replaces the learner's init from
    `seed`; the actor's engine starts on its own copy of them. Returns
    per-update reward/loss trajectories plus throughput and
    refresh-latency aggregates, and `metrics`, each update's PPO
    metrics."""
    config = config or tiny_rl_config()
    stats = stats or RLStats()
    env = TargetTokenEnv(config.vocab_size, prompt_len=prompt_len, horizon=horizon,
                         target=target, seed=seed)
    publisher, client, server = make_refresh_channel(refresh, checkpoint_dir)
    actor = None
    try:
        learner = Learner(
            config, seed=seed, learning_rate=learning_rate, gamma=gamma,
            clip_eps=clip_eps, entropy_coef=entropy_coef,
            accum_per_actor=1, gang_width=1, refresh=publisher, stats=stats,
            params=params, device=device,
        )
        actor = Actor(
            config, learner.state.params, env,
            actor_id=0, batch_size=batch_size, temperature=temperature,
            seed=seed, refresh=client, stats=stats, device=learner.device,
        )
        rewards: List[float] = []
        losses: List[float] = []
        per_update: List[Dict[str, float]] = []
        refresh_s: List[float] = []
        t_run = time.monotonic()
        for u in range(updates):
            t0 = time.monotonic()
            if actor.maybe_refresh():
                refresh_s.append(time.monotonic() - t0)
            for _ in range(learner.batches_per_update):
                learner.ingest(actor.rollout())
            metrics = learner.update_once(timeout=5.0)
            rewards.append(metrics["reward_mean"])
            losses.append(metrics["loss"])
            per_update.append(metrics)
            if (u + 1) % publish_every == 0:
                learner.publish()
    finally:
        if actor is not None:
            actor.close()
        if server is not None:
            server.close()
    elapsed = time.monotonic() - t_run
    snap = stats.snapshot()
    return {
        "rewards": rewards,
        "losses": losses,
        "metrics": per_update,
        "env_steps_total": snap["env_steps_total"],
        "elapsed_s": elapsed,
        "env_steps_per_s": snap["env_steps_total"] / max(elapsed, 1e-9),
        "learn_step_s_mean": (snap["learn_step_hist"]["sum"]
                              / max(snap["learn_step_hist"]["count"], 1)),
        "refresh_s": refresh_s,
        "refresh_s_mean": sum(refresh_s) / len(refresh_s) if refresh_s else 0.0,
        "final_weight_epoch": actor.weight_epoch,
        "learner_epoch": learner.weight_epoch,
        "stats": snap,
    }
