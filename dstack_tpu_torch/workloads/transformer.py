"""Llama-family decoder blocks in PyTorch (port of
`dstack_tpu.workloads.transformer`, serving subset).

Params keep the JAX package's layout: one stacked tensor per weight kind
with a leading layer dim (`(L, in, out)`), so a checkpoint bridged from
JAX (workloads/weights.py) drops in unchanged. Where JAX scans over the
stack, callers here loop over layer slices (`layer_params`).

Numerics follow the reference: RMSNorm, rope and silu compute in f32 and
cast back; matmuls whose JAX form asks for an f32 result
(`preferred_element_type`) upcast their operands so the product is exact
and the accumulation is f32.

The full-sequence `forward` is not here: on the TPU it dispatches to the
flash kernel, and it comes with the training slice and its kernel.
"""

from typing import Any, Dict

import torch

from dstack_tpu_torch.workloads.config import ModelConfig, require_dense
from dstack_tpu_torch.workloads.device import DeviceLike, resolve_device
from dstack_tpu_torch.workloads.quant import QTensor

Params = Dict[str, Any]


def init_params(config: ModelConfig, seed: int = 0,
                device: DeviceLike = None) -> Params:
    """Random params with the reference's shapes, scales and dtypes:
    N(0, 1/fan_in) drawn in f32 then cast, norms at 1 in f32. Drawn on
    `device` from a `torch.Generator` seeded with `seed` (the JAX package
    draws from `jax.random`, so the values differ; parity tests bridge
    JAX weights instead, see weights.py)."""
    c = config
    require_dense(c)
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
        "w_gate": dense((L, D, F), D),
        "w_up": dense((L, D, F), D),
        "w_down": dense((L, F, D), F),
    }
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
                positions: torch.Tensor):
    """Pre-norm QKV projection with rope, shared by every cached path."""
    b, s, _ = x.shape
    hd = c.head_dim
    h = rms_norm(x, p["attn_norm"], c.norm_eps)
    q = linear(h, p["wq"]).reshape(b, s, c.n_heads, hd)
    k = linear(h, p["wk"]).reshape(b, s, c.n_kv_heads, hd)
    v = linear(h, p["wv"]).reshape(b, s, c.n_kv_heads, hd)
    return _rope(q, positions, c.rope_theta), _rope(k, positions, c.rope_theta), v


def _silu(x: torch.Tensor) -> torch.Tensor:
    """silu computed in f32, returned in x.dtype (forward only: the
    reference's custom VJP comes with the training slice)."""
    return torch.nn.functional.silu(x.to(torch.float32)).to(x.dtype)


def mlp_block(c: ModelConfig, x: torch.Tensor, p: Params) -> torch.Tensor:
    """Pre-norm SwiGLU MLP with residual."""
    h = rms_norm(x, p["mlp_norm"], c.norm_eps)
    gate = _silu(linear(h, p["w_gate"]))
    up = linear(h, p["w_up"])
    return x + linear(gate * up, p["w_down"])
