"""LoRA fine-tuning: low-rank adapters over the frozen base model (port of
`dstack_tpu.workloads.lora`).

Adapters are a separate tiny tree, `{"layers": {f"{t}_a": (L, in, r),
f"{t}_b": (L, r, out)}}`, and the train step MERGES them into the frozen
base (W + (alpha/r)·A@B) at the top of the step: `transformer.forward`
runs unchanged (attention through the flash kernels on the card, or the
ring over a seq mesh), gradients reach A/B through the merge, and the
optimizer (AdamW with its f32 first moments) covers only the adapter tree.

A is Gaussian, B is zero, so step 0 is exactly the base model: the merge
adds an f32 zero to `W.float()` and casts back, which returns W bit for
bit. Checkpoints hold the adapters and their moments (checkpoint.py);
`merge_lora` gives plain params for serving (and composes with int8
quantization: quantize the merged tree).

torch cannot reproduce `jax.random`: `lora_init` draws A from a
`torch.Generator`, so the two packages' adapters differ for one seed;
parity tests bridge a JAX LoraState (weights.lora_state_from_numpy).

On a training mesh over ranks the frozen base is cut by PARAM_SPECS
(sharding.shard_tree), A by LORA_SPECS' (None, "fsdp", None) and B by
(None, None, "model"). A target's base block (fsdp i, model j) plus
scale * A_i @ B_j is the merged weight's block (i, j), so the merge runs on
each rank's slices with no collective, and the merged slices go through
the sharded forward (train.py). A_i's grad sums G_ij @ B_j over the model
axis and B_j's A_i @ G_ij over fsdp, so after the backward A's grads are
summed over (data, model) and B's over (data, fsdp). Only column-parallel
targets (wq, wk, wv, w_gate, w_up: "fsdp" on the input dim, "model" on the
output) merge that way; a row-parallel target (wo, w_down) over ranks
raises.
"""

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from dstack_tpu_torch.utils.stagemarkers import auto_stage
from dstack_tpu_torch.workloads import compile_cache
from dstack_tpu_torch.workloads.attention import make_attention_fn
from dstack_tpu_torch.workloads.config import ModelConfig
from dstack_tpu_torch.workloads.sharding import (
    PARAM_SPECS,
    batch_sum,
    global_shape,
    reduce_grads,
    shard_tree,
)
from dstack_tpu_torch.workloads.train import (
    AdamState,
    _device_of,
    _staged_step,
    global_norm,
    loss_fn,
    make_optimizer,
    ranked_mesh,
)
from dstack_tpu_torch.workloads.transformer import detach_params, params_device
from dstack_tpu_torch.workloads.weights import flatten_params, unflatten_params

Params = Dict[str, Any]

DEFAULT_TARGETS = ("wq", "wv")  # the classic LoRA attention targets


class LoraState(NamedTuple):
    step: int
    lora: Params       # {"layers": {f"{t}_a": (L, in, r), f"{t}_b": (L, r, out)}}
    opt_state: AdamState


def _generator(seed: Union[int, torch.Generator], device: torch.device) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device=device).manual_seed(int(seed))


def lora_init(config: ModelConfig, base: Params, seed: Union[int, torch.Generator],
              *, rank: int = 8, targets: Sequence[str] = DEFAULT_TARGETS,
              mesh=None) -> Params:
    """Adapters for `targets`: A ~ N(0, 1)·d_in^-0.5 drawn in f32 from a
    generator (seeded with `seed`, or `seed` itself) on the base's device
    and cast to the weight's dtype, one target after the other; B zeros.
    Whole adapters, sized by the whole weights of a base cut for `mesh`."""
    dev = params_device(base)
    gen = _generator(seed, dev)
    layers: Params = {}
    for t in targets:
        w = base["layers"][t]
        if not isinstance(w, torch.Tensor):
            raise ValueError(f"target {t!r} is not a plain weight (quantized base?)")
        n_layers, d_in, d_out = global_shape(w, PARAM_SPECS["layers"][t], mesh)
        a = torch.randn((n_layers, d_in, rank), generator=gen, device=dev,
                        dtype=torch.float32)
        layers[f"{t}_a"] = (a * d_in ** -0.5).to(w.dtype)
        # B starts at zero: the merged model IS the base model at step 0.
        layers[f"{t}_b"] = torch.zeros((n_layers, rank, d_out), dtype=w.dtype, device=dev)
    return {"layers": layers}


def merge_lora(base: Params, lora: Params, *, rank: int, alpha: float = 16.0) -> Params:
    """base with W_t := W_t + (alpha/rank)·A_t@B_t for each target: A and B
    upcast to f32, their product in f32 and scaled, added to W in f32, the
    sum cast back to W's dtype (the reference's einsum with an f32 result).
    Differentiable in the adapters; the base's other leaves are shared."""
    scale = alpha / rank
    layers = dict(base["layers"])
    for name, a in lora["layers"].items():
        if not name.endswith("_a"):
            continue
        t = name[:-2]
        b = lora["layers"][t + "_b"]
        delta = torch.bmm(a.to(torch.float32), b.to(torch.float32)) * scale
        w = layers[t]
        layers[t] = (w.to(torch.float32) + delta).to(w.dtype)
    return {**base, "layers": layers}


def lora_param_count(lora: Params) -> int:
    return sum(t.numel() for _, t in flatten_params(lora))


def init_lora_state(config: ModelConfig, base: Params, seed: Union[int, torch.Generator],
                    *, rank: int = 8, targets: Sequence[str] = DEFAULT_TARGETS,
                    mesh=None, learning_rate: float = 1e-4,
                    lora: Optional[Params] = None) -> LoraState:
    """Adapters (from `seed`, or the given whole `lora`, e.g. bridged from
    JAX) on the base's device, marked for grad, and zero AdamW moments.
    `mesh` is None, the port's one-device seq mesh (sharding.make_mesh),
    whose device must hold the base, or a training mesh over ranks, on
    which `base` holds the rank's slices (sharding.shard_tree) and the
    whole adapters are drawn, then cut to the rank's slices. On the card
    the kernel cache is enabled from DSTACK_TPU_COMPILE_CACHE first;
    `tpu_init` marks the first touch of the device, as in
    train.init_train_state."""
    dev = _device_of(params_device(base), mesh)
    ranked = _column_targets(config, mesh, targets)
    if dev.type == "cuda":
        compile_cache.enable_from_env()
    auto_stage("tpu_init")
    if lora is None:
        lora = lora_init(config, base, seed, rank=rank, targets=targets, mesh=ranked)
    lora = shard_tree(ranked, lora)
    for _, t in flatten_params(lora):
        if t.device != dev:
            raise ValueError(f"adapters live on {t.device}, the base on {dev}")
        t.requires_grad_(True)
    return LoraState(0, lora, make_optimizer(learning_rate).init(lora))


def _column_targets(config: ModelConfig, mesh, targets: Sequence[str]):
    """`train.ranked_mesh(config, mesh)`, after checking that every target
    merges on a rank's slices (module docstring) when it is a mesh."""
    ranked = ranked_mesh(config, mesh)
    rows = [t for t in targets if PARAM_SPECS["layers"][t] != (None, "fsdp", "model")]
    if ranked is not None and rows:
        raise NotImplementedError(
            f"LoRA on the row-parallel {rows} over ranks: an A cut over fsdp meets a"
            " weight cut over model on its input dim (ROADMAP Queue 1 item 3)")
    return ranked


# The axes a LoRA grad is summed over after the backward (module docstring).
_LORA_GRAD_AXES = {"_a": ("data", "model"), "_b": ("data", "fsdp")}


def make_lora_train_step(config: ModelConfig, mesh=None, *, rank: int = 8,
                         alpha: float = 16.0, learning_rate: float = 1e-4):
    """step(state, base, batch) -> (state, metrics): merge, the port's
    `loss_fn` (the flash kernels, or the ring over a seq `mesh`, or the
    sharded forward on a training mesh over ranks), the gradients of the
    adapter leaves only, and one AdamW update of them in place (weight
    decay as the reference's default). The base is frozen: it is read
    through `detach_params`, so no autograd state reaches it. Metrics are
    0-d device tensors `loss` and `grad_norm`, equal on every rank of a
    mesh. The first call carries the compile/first-step stage markers, as
    the full step."""
    optimizer = make_optimizer(learning_rate)
    attention_fn = make_attention_fn(mesh)
    ranked = ranked_mesh(config, mesh)

    def step(state: LoraState, base: Params, batch) -> Tuple[LoraState, Dict]:
        _column_targets(config, mesh, [k[:-2] for k in state.lora["layers"]])
        pairs = flatten_params(state.lora)
        merged = merge_lora(detach_params(base), state.lora, rank=rank, alpha=alpha)
        loss, _ = loss_fn(config, merged, batch, attention_fn, mesh)
        grads = torch.autograd.grad(loss, [t for _, t in pairs])
        grads = reduce_grads([(k, g) for (k, _), g in zip(pairs, grads)], ranked,
                             lambda k: _LORA_GRAD_AXES[k[-2:]])
        loss = batch_sum(loss, ranked)
        grads = unflatten_params(grads)
        gnorm = global_norm(grads, ranked)
        opt_state = optimizer.apply(state.lora, grads, state.opt_state)
        return (LoraState(state.step + 1, state.lora, opt_state),
                {"loss": loss.detach(), "grad_norm": gnorm})

    return _staged_step(step)
