"""Autoregressive generation with a dense KV cache (port of
`dstack_tpu.workloads.generate`).

The dense cache path is the reference the paged engine is held against:
prefill + decode here must reproduce the engine's token streams at
temperature 0. The cache is updated in place (the JAX version returns a
new cache from a functional update); `_forward_cached` still returns the
cache so call sites read the same in both packages.

MoE caveat (the reference's): capacity-based token dropping
(workloads/moe.py) follows each call's own sequence length. A decode step
(S 1) never drops, so MoE decode equals `transformer.forward` only when
forward's capacity admits every token (a capacity_factor of at least
n_experts / experts_per_token); the tests pin that regime.

Random draws: `jax.random` keys become `torch.Generator`s. The two give
different numbers, so sampled (temperature > 0) output matches the
reference in distribution, not token for token.
"""

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import torch

from dstack_tpu_torch.workloads.attention import NEG_INF, _repeat_kv
from dstack_tpu_torch.workloads.config import ModelConfig
from dstack_tpu_torch.workloads.transformer import (
    ffn_block,
    layer_params,
    linear,
    logits_linear,
    params_device,
    project_qkv,
    rms_norm,
)

Params = Dict[str, Any]


@dataclass
class KVCache:
    """Static-shape per-layer cache: k/v (L, B, max_len, KV, hd)."""

    k: torch.Tensor
    v: torch.Tensor
    length: int  # filled positions


def init_cache(config: ModelConfig, batch: int, max_len: int,
               device: torch.device, dtype=None) -> KVCache:
    c = config
    shape = (c.n_layers, batch, max_len, c.n_kv_heads, c.head_dim)
    dtype = dtype or c.activation_dtype
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=0,
    )


def _cached_attention(q, ck, cv, valid_len):
    """q (B, S, H, hd) against cache k/v (B, max_len, KV, hd); row i of
    the chunk attends cache positions < valid_len[i] (causal over the old
    and new tokens)."""
    b, s, h, hd = q.shape
    n_rep = h // ck.shape[2]
    k = _repeat_kv(ck, n_rep).to(torch.float32)
    v = _repeat_kv(cv, n_rep).to(torch.float32)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k) * (hd ** -0.5)
    kpos = torch.arange(ck.shape[1], device=q.device)
    mask = kpos[None, :] < valid_len[:, None]  # (S, max_len)
    logits = torch.where(mask[None, None], logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(q.dtype).to(torch.float32)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return out.to(q.dtype).reshape(b, s, h * hd)


def _forward_cached(config: ModelConfig, params: Params, tokens: torch.Tensor,
                    cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
    """Run `tokens` (B, S) starting at cache.length; returns the f32 logits
    of the LAST position (B, V) and the cache, extended in place. Used for
    both prefill (S = prompt len, cache empty) and decode (S = 1)."""
    c = config
    b, s = tokens.shape
    start = cache.length
    dev = tokens.device
    positions = start + torch.arange(s, device=dev)
    valid_len = start + 1 + torch.arange(s, device=dev)
    x = params["embed"][tokens]
    for layer in range(c.n_layers):
        p = layer_params(params, layer)
        q, k, v = project_qkv(c, x, p, positions)
        ck, cv = cache.k[layer], cache.v[layer]
        ck[:, start:start + s] = k.to(ck.dtype)
        cv[:, start:start + s] = v.to(cv.dtype)
        attn = _cached_attention(q, ck, cv, valid_len)
        x = x + linear(attn, p["wo"])
        x = ffn_block(c, x, p)
    x = rms_norm(x, params["final_norm"], c.norm_eps)
    logits = logits_linear(x[:, -1], params["lm_head"])
    cache.length = start + s
    return logits, cache


def _nucleus_filter(logits: torch.Tensor,
                    top_p: Union[float, torch.Tensor]) -> torch.Tensor:
    """Nucleus (top-p) filter over the last axis: strict `<` on the
    PRECEDING cumulative mass, so the top token always survives and
    top_p=1 keeps everything. `top_p` is a float or a tensor that
    broadcasts against logits[..., :1] (one cutoff per row)."""
    order = torch.argsort(-logits, dim=-1, stable=True)
    probs = torch.softmax(torch.gather(logits, -1, order), dim=-1)
    before = torch.cumsum(probs, dim=-1) - probs
    keep_sorted = before < top_p
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    return torch.where(keep, logits, torch.full_like(logits, float("-inf")))


def _categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Sample along the last axis by the Gumbel-max trick, as
    `jax.random.categorical` does (different random bits)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)


def sample_logits_row(logits: torch.Tensor, temp: float, top_p: float,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
    """First-token sampling over one logits row (V,): greedy argmax when
    temp == 0, else temperature-scaled categorical behind the shared
    `_nucleus_filter`. Returns a 0-d int32 tensor on logits' device (no
    host sync)."""
    if temp > 0.0:
        scaled = logits / max(temp, 1e-6)
        if top_p < 1.0:
            scaled = _nucleus_filter(scaled, top_p)
        return _categorical(scaled, generator)
    return torch.argmax(logits).to(torch.int32)


@torch.no_grad()
def generate(config: ModelConfig, params: Params, prompt: torch.Tensor, *,
             max_new_tokens: int, max_len: Optional[int] = None,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy (or temperature-sampled) generation: prompt (B, S) int ->
    (B, max_new_tokens) int32, on the params' device. Runs without
    autograd, so trained params that require grad build no graph."""
    c = config
    dev = params_device(params)
    prompt = torch.as_tensor(prompt, device=dev)
    b, s = prompt.shape
    # The last generated token is never fed back: s + max_new_tokens - 1
    # positions suffice.
    max_len = max_len or min(c.max_seq_len, s + max_new_tokens - 1)
    if s + max_new_tokens - 1 > max_len:
        raise ValueError(f"prompt {s} + {max_new_tokens} new tokens exceed"
                         f" max_len {max_len}")
    if temperature > 0.0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    cache = init_cache(c, b, max_len, dev)

    def pick(logits):
        if temperature > 0.0:
            return _categorical(logits / temperature, generator)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    logits, cache = _forward_cached(c, params, prompt, cache)
    out = [pick(logits)]
    for _ in range(max_new_tokens - 1):
        logits, cache = _forward_cached(c, params, out[-1][:, None], cache)
        out.append(pick(logits))
    return torch.stack(out, dim=1)
