"""Llama-family decoder in PyTorch (port of
`dstack_tpu.workloads.transformer`), dense or mixture-of-experts
(workloads/moe.py when `n_experts > 0`).

Params keep the JAX package's layout: one stacked tensor per weight kind
with a leading layer dim (`(L, in, out)`), so a checkpoint bridged from
JAX (workloads/weights.py) drops in unchanged. Where JAX scans over the
stack, callers here loop over layer slices (`layer_params`).

Numerics follow the reference: RMSNorm, rope and silu compute in f32 and
cast back; matmuls whose JAX form asks for an f32 result
(`preferred_element_type`) upcast their operands so the product is exact
and the accumulation is f32.

`forward` runs the full sequence through an injected `attention_fn`
(attention.make_attention_fn: the flash kernels on the card, or the ring
over a seq mesh), with the remat policy of `config.resolve_remat` mapped
to torch.utils.checkpoint.
Where JAX scans one traced block over the layer stack, this loops over
the layers eagerly.

On a training mesh over ranks (sharding.make_mesh(..., layout="training"))
`forward` runs on the rank's slices of the params (sharding.shard_tree) and
its rows of the batch, with the collectives GSPMD puts into the
reference's jitted step: each layer's weights are gathered whole over
`fsdp` inside the block body (`sharding.gather_layer`; embed and lm_head
likewise), wq/wk/wv/w_gate/w_up run column-parallel on `model` behind
Megatron's f (`enter_model` on the normed input) and wo/w_down
row-parallel with their partial sums summed over `model` (`reduce_model`),
so a rank attends with its H/m q and KV/m KV heads. Whether a gathered
weight is gathered again in backward follows the remat policy: with
"none" autograd keeps every layer's gathered weights from forward to
backward, so a rank holds its model shard of the params whole, 1/model of
the unsharded weights, for the step (fsdp then saves the grads' and
AdamW's memory, not the weights'); under "full" and "dots" (which saves
matmul outputs, not their weight operands) the block body is recomputed
in backward and gathers again, so one layer's gathered weights are live
at a time, for a second all-gather per layer. Rope positions are 0..S-1 on every rank:
there is no seq axis over ranks here.
"""

import functools
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from dstack_tpu_torch.workloads.attention import plain_attention
from dstack_tpu_torch.workloads.config import ModelConfig
from dstack_tpu_torch.workloads.device import DeviceLike, resolve_device
from dstack_tpu_torch.workloads.moe import moe_block
from dstack_tpu_torch.workloads.quant import QTensor
from dstack_tpu_torch.workloads.sharding import (
    all_gather,
    batch_shards,
    device_shards,
    enter_model,
    gather_fsdp,
    gather_layer,
    reduce_model,
)

Params = Dict[str, Any]
AttentionFn = Callable[..., torch.Tensor]


def init_params(config: ModelConfig, seed: int = 0,
                device: DeviceLike = None) -> Params:
    """Random params with the reference's shapes, scales and dtypes:
    N(0, 1/fan_in) drawn in f32 then cast, norms at 1 in f32. Drawn on
    `device` from a `torch.Generator` seeded with `seed` (the JAX package
    draws from `jax.random`, so the values differ; parity tests bridge
    JAX weights instead, see weights.py). An MoE config draws the
    reference's leaves in place of the dense MLP's: router (L, D, E) f32,
    then we_gate and we_up (L, E, D, F) and we_down (L, E, F, D)."""
    c = config
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = c.activation_dtype
    hd = c.head_dim
    L, D, F, V = c.n_layers, c.d_model, c.d_ff, c.vocab_size

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (w * fan_in ** -0.5).to(dt)

    def norm(shape):
        return torch.ones(shape, device=dev, dtype=torch.float32)

    embed = dense((V, D), D)
    layers = {
        "wq": dense((L, D, c.n_heads * hd), D),
        "wk": dense((L, D, c.n_kv_heads * hd), D),
        "wv": dense((L, D, c.n_kv_heads * hd), D),
        "wo": dense((L, c.n_heads * hd, D), c.n_heads * hd),
        "attn_norm": norm((L, D)),
        "mlp_norm": norm((L, D)),
    }
    if c.n_experts > 0:
        E = c.n_experts
        # The router stays f32: routing decisions are precision-sensitive.
        layers["router"] = torch.randn((L, D, E), generator=gen, device=dev,
                                       dtype=torch.float32) * D ** -0.5
        layers["we_gate"] = dense((L, E, D, F), D)
        layers["we_up"] = dense((L, E, D, F), D)
        layers["we_down"] = dense((L, E, F, D), F)
    else:
        layers["w_gate"] = dense((L, D, F), D)
        layers["w_up"] = dense((L, D, F), D)
        layers["w_down"] = dense((L, F, D), F)
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": norm((D,)),
        "lm_head": dense((D, V), D),
    }


def layer_params(params: Params, layer: int) -> Params:
    """Layer `layer`'s slice of the stacked weights (views, no copy)."""
    out = {}
    for k, w in params["layers"].items():
        out[k] = (QTensor(w.q[layer], w.scale[layer])
                  if isinstance(w, QTensor) else w[layer])
    return out


def detach_params(tree: Any) -> Any:
    """The same params as views cut from autograd (no copy): serving
    programs run on these so trained params build no graph."""
    if isinstance(tree, dict):
        return {k: detach_params(v) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return QTensor(tree.q.detach(), tree.scale.detach())
    return tree.detach()


def copy_params(tree: Any) -> Any:
    """Detached copies of the params (a QTensor's fields too), on their
    device: a serving engine owns the tensors it serves, so a trainer that
    updates its params in place never rewrites them under a request."""
    if isinstance(tree, dict):
        return {k: copy_params(v) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return QTensor(tree.q.detach().clone(), tree.scale.detach().clone())
    return tree.detach().clone()


def params_device(params: Params) -> torch.device:
    return params["embed"].device


def linear(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a raw tensor or an int8 QTensor. The QTensor path
    multiplies in f32 (int8 and x are exact there), applies the
    per-channel scale, and returns x.dtype — the reference's
    `matmul(..., preferred_element_type=f32) * scale`."""
    if isinstance(w, QTensor):
        y = torch.matmul(x.to(torch.float32), w.q.to(torch.float32))
        return (y * w.scale).to(x.dtype)
    return x @ w


def logits_linear(x: torch.Tensor, w) -> torch.Tensor:
    """The lm-head matmul: f32 logits from bf16/quantized weights."""
    if isinstance(w, QTensor):
        y = torch.matmul(x.to(torch.float32), w.q.to(torch.float32))
        return y * w.scale
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    rms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * rms * weight).to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, hd); positions: (S,) or (B, S)."""
    hd = x.shape[-1]
    exponent = torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd
    # Scalar base: a tensor made from `theta` would be a blocking
    # host-to-device copy on every call.
    inv_freq = 1.0 / torch.pow(theta, exponent)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * inv_freq  # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def project_qkv(c: ModelConfig, x: torch.Tensor, p: Params,
                positions: torch.Tensor, mesh=None):
    """Pre-norm QKV projection with rope, shared by every cached path.
    The head counts come from the weights' widths, so a rank of a model
    mesh projects its own heads (sharding.rank_params). On a training
    `mesh` the normed input enters the model axis (Megatron's f)."""
    b, s, _ = x.shape
    hd = c.head_dim
    h = enter_model(rms_norm(x, p["attn_norm"], c.norm_eps), mesh)
    q = linear(h, p["wq"]).reshape(b, s, -1, hd)
    k = linear(h, p["wk"]).reshape(b, s, -1, hd)
    v = linear(h, p["wv"]).reshape(b, s, -1, hd)
    return _rope(q, positions, c.rope_theta), _rope(k, positions, c.rope_theta), v


class _SiLU(torch.autograd.Function):
    """silu computed in f32, returned in x.dtype; backward saves only the
    pre-activation (in x.dtype) and recomputes the f32 sigmoid, as the
    reference's custom VJP (`transformer.py:141-166`), so autograd keeps no
    f32 (B, S, d_ff) intermediates."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.nn.functional.silu(x.to(torch.float32)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        xf = x.to(torch.float32)
        s = torch.sigmoid(xf)
        return (g.to(torch.float32) * (s * (1.0 + xf * (1.0 - s)))).to(x.dtype)


def _silu(x: torch.Tensor) -> torch.Tensor:
    return _SiLU.apply(x)


def mlp_block(c: ModelConfig, x: torch.Tensor, p: Params, mesh=None) -> torch.Tensor:
    """Pre-norm SwiGLU MLP with residual. On a model `mesh` (a serving
    rank's column slices) the activation is gathered before w_down and
    w_down's output before the residual; without one both are no-ops."""
    h = rms_norm(x, p["mlp_norm"], c.norm_eps)
    gate = _silu(linear(h, p["w_gate"]))
    up = linear(h, p["w_up"])
    act = all_gather(gate * up, -1, mesh)
    return x + all_gather(linear(act, p["w_down"]), -1, mesh)


def attn_out(attn: torch.Tensor, p: Params, mesh=None) -> torch.Tensor:
    """The attention half's output projection on a cached path: a rank's
    heads gathered before wo, wo's columns gathered after (no-ops
    without a model mesh)."""
    return all_gather(linear(all_gather(attn, -1, mesh), p["wo"]), -1, mesh)


def ffn_block(c: ModelConfig, x: torch.Tensor, p: Params, mesh=None) -> torch.Tensor:
    """The block's MLP half on a cached path: the dense MLP, or the MoE
    block with its router loss dropped. Capacity follows the call's own
    sequence length (a decode step's 1, a chunk's padded length), so a
    cached path drops tokens as the reference's does, not as `forward`
    over the whole sequence would."""
    if c.n_experts > 0:
        return moe_block(c, x, p, mesh)[0]
    return mlp_block(c, x, p, mesh)


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective checkpointing that keeps the outputs of matmuls without
    batch dims (the reference's `dots_with_no_batch_dims_saveable`) and
    recomputes everything else, attention included."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def apply_remat(body, c: ModelConfig, n_tokens: int, mesh=None,
                seq_len: Optional[int] = None, attn_scores: bool = False):
    """Wrap a block body per the resolved remat policy: "none" leaves it,
    "full" checkpoints the whole block, "dots" checkpoints it keeping the
    matmul outputs. `attn_scores` marks the plain O(S^2)-memory attention."""
    # A rank of a training mesh holds 1/(data*fsdp) of the batch; the
    # estimate, like the reference's, starts from the global batch.
    policy = c.resolve_remat(n_tokens * batch_shards(mesh), device_shards(mesh),
                             seq_len=seq_len, attn_scores=attn_scores)
    if policy == "none":
        return body
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)

    def remat_body(x, p):
        return checkpoint(body, x, p, use_reentrant=False, **kw)

    return remat_body


def _block(c: ModelConfig, x: torch.Tensor, p: Params, positions: torch.Tensor,
           attention_fn: AttentionFn, mesh=None):
    """One decoder block -> (x, router_aux); aux is None for dense models.
    On a training `mesh` the layer's fsdp shards are gathered first and
    the attention and MLP halves run Megatron's pair on `model` (both are
    no-ops elsewhere)."""
    b, s, _ = x.shape
    p = gather_layer(p, mesh)
    q, k, v = project_qkv(c, x, p, positions, mesh)
    attn = attention_fn(q, k, v).reshape(b, s, -1)
    x = x + reduce_model(linear(attn, p["wo"]), mesh)
    if c.n_experts > 0:
        return moe_block(c, x, p)
    h = enter_model(rms_norm(x, p["mlp_norm"], c.norm_eps), mesh)
    act = _silu(linear(h, p["w_gate"])) * linear(h, p["w_up"])
    return x + reduce_model(linear(act, p["w_down"]), mesh), None


def _layer_slices(params: Params, n_layers: int):
    """Per-layer param dicts. Raw stacked tensors are unbound once, so
    autograd stacks their grads in one op instead of summing one full-size
    zero-padded grad per layer."""
    cols = {}
    for k, w in params["layers"].items():
        if isinstance(w, QTensor):
            cols[k] = [QTensor(w.q[i], w.scale[i]) for i in range(n_layers)]
        else:
            cols[k] = w.unbind(0)
    return [{k: col[i] for k, col in cols.items()} for i in range(n_layers)]


def forward(config: ModelConfig, params: Params, tokens: torch.Tensor, *,
            attention_fn: Optional[AttentionFn] = None,
            positions: Optional[torch.Tensor] = None, mesh=None,
            return_aux: bool = False, return_hidden: bool = False):
    """tokens (B, S) int -> logits (B, S, V) in f32.

    With return_aux=True returns (logits, aux), aux the router loss
    summed over the layers (0 for dense models). With return_hidden=True
    the lm-head matmul is skipped and the final-norm hidden states
    (B, S, D) come back in place of logits (the chunked CE applies the
    head itself).

    A seq `mesh` (sharding.make_mesh) is read by the remat estimate; the
    ring itself lives inside `attention_fn` (make_attention_fn(mesh)), and
    positions stay 0..S-1 since the whole sequence is on the device. On a
    training mesh over ranks (module docstring) `params` are the rank's
    slices and `tokens` its rows, and the logits are the rank's vocab
    columns (lm_head is column-parallel on `model`)."""
    c = config
    attn = attention_fn or plain_attention
    dev = tokens.device
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=dev)
    x = gather_fsdp(params["embed"], 1, mesh)[tokens]

    quadratic = getattr(attn, "memory_is_quadratic", None)
    if quadratic is not None:
        attn_scores = quadratic(tokens.shape[1], c.head_dim, c.dtype_bytes,
                                device=params_device(params))
    else:
        attn_scores = attn is plain_attention

    def body(x, p):
        return _block(c, x, p, positions, attn, mesh)

    body = apply_remat(body, c, tokens.shape[0] * tokens.shape[1], mesh,
                       seq_len=tokens.shape[1], attn_scores=attn_scores)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    for p in _layer_slices(params, c.n_layers):
        x, layer_aux = body(x, p)
        if layer_aux is not None:
            aux = aux + layer_aux

    x = enter_model(rms_norm(x, params["final_norm"], c.norm_eps), mesh)
    if return_hidden:
        return (x, aux) if return_aux else x
    logits = logits_linear(x, gather_fsdp(params["lm_head"], 0, mesh))
    return (logits, aux) if return_aux else logits
