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
"""

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from dstack_tpu_torch.utils.stagemarkers import auto_stage
from dstack_tpu_torch.workloads import compile_cache
from dstack_tpu_torch.workloads.attention import make_attention_fn
from dstack_tpu_torch.workloads.config import ModelConfig
from dstack_tpu_torch.workloads.train import (
    AdamState,
    _device_of,
    _staged_step,
    global_norm,
    loss_fn,
    make_optimizer,
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
              *, rank: int = 8, targets: Sequence[str] = DEFAULT_TARGETS) -> Params:
    """Adapters for `targets`: A ~ N(0, 1)·d_in^-0.5 drawn in f32 from a
    generator (seeded with `seed`, or `seed` itself) on the base's device
    and cast to the weight's dtype, one target after the other; B zeros."""
    dev = params_device(base)
    gen = _generator(seed, dev)
    layers: Params = {}
    for t in targets:
        w = base["layers"][t]
        if not isinstance(w, torch.Tensor):
            raise ValueError(f"target {t!r} is not a plain weight (quantized base?)")
        n_layers, d_in, d_out = w.shape
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
    """Adapters (from `seed`, or the given `lora`, e.g. bridged from JAX)
    on the base's device, marked for grad, and zero AdamW moments. `mesh`
    is None or the port's one-device seq mesh (sharding.make_mesh), whose
    device must hold the base. On the card the kernel cache is enabled
    from DSTACK_TPU_COMPILE_CACHE first; `tpu_init` marks the first touch
    of the device, as in train.init_train_state."""
    dev = _device_of(params_device(base), mesh)
    if dev.type == "cuda":
        compile_cache.enable_from_env()
    auto_stage("tpu_init")
    if lora is None:
        lora = lora_init(config, base, seed, rank=rank, targets=targets)
    for _, t in flatten_params(lora):
        if t.device != dev:
            raise ValueError(f"adapters live on {t.device}, the base on {dev}")
        t.requires_grad_(True)
    return LoraState(0, lora, make_optimizer(learning_rate).init(lora))


def make_lora_train_step(config: ModelConfig, mesh=None, *, rank: int = 8,
                         alpha: float = 16.0, learning_rate: float = 1e-4):
    """step(state, base, batch) -> (state, metrics): merge, the port's
    `loss_fn` (the flash kernels, or the ring over a seq `mesh`), the
    gradients of the adapter leaves only, and one AdamW update of them in
    place (weight decay as the reference's default). The base is frozen:
    it is read through `detach_params`, so no autograd state reaches it.
    Metrics are 0-d device tensors `loss` and `grad_norm`. The first call
    carries the compile/first-step stage markers, as the full step."""
    optimizer = make_optimizer(learning_rate)
    attention_fn = make_attention_fn(mesh)

    def step(state: LoraState, base: Params, batch) -> Tuple[LoraState, Dict]:
        pairs = flatten_params(state.lora)
        merged = merge_lora(detach_params(base), state.lora, rank=rank, alpha=alpha)
        loss, _ = loss_fn(config, merged, batch, attention_fn, mesh)
        grads = torch.autograd.grad(loss, [t for _, t in pairs])
        grads = unflatten_params((k, g) for (k, _), g in zip(pairs, grads))
        gnorm = global_norm(grads)
        opt_state = optimizer.apply(state.lora, grads, state.opt_state)
        return (LoraState(state.step + 1, state.lora, opt_state),
                {"loss": loss.detach(), "grad_norm": gnorm})

    return _staged_step(step)
