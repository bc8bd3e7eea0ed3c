"""The Mistral family: Mistral-7B and, with experts, Mixtral-8x7B.

Every layer is alike: RMSNorm pre-norm, grouped-query attention with
rotary embedding (one theta) over the full causal past, then a SwiGLU MLP
or, with `num_local_experts`, a softmax router over that many SwiGLU
experts of which each token takes `num_experts_per_tok`; untied embedding
and lm-head. Both configurations give `sliding_window` null.

The configuration files hold the model's own `config.json` keys as it is
run, plus what the benchmark adds: `dtype`, and for a mixture of experts
the program's `capacity_factor` and `moe_impl`.
"""

from dataclasses import dataclass
from typing import Any, Dict

import torch

from portbench.reference.mistral import logits
from portbench.roofline import attention_pairs

__all__ = ["Shapes", "shapes", "port_config", "make_weights", "logits",
           "layer_matmul_flops", "prefill_flops", "decode_flops",
           "paged_prefill_work", "paged_decode_work"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class Shapes:
    vocab: int
    d_model: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    rope_theta: float
    norm_eps: float
    max_positions: int
    dtype: str
    experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 0.0
    moe_impl: str = "einsum"

    @property
    def dtype_bytes(self) -> int:
        return {"bfloat16": 2, "float32": 4}[self.dtype]

    def param_count(self) -> int:
        """Every parameter held (all experts, untied embedding and head)."""
        d, f, hd = self.d_model, self.d_ff, self.head_dim
        attn = d * (self.heads + 2 * self.kv_heads) * hd + self.heads * hd * d + 2 * d
        mlp = (3 * d * f * self.experts + d * self.experts) if self.experts else 3 * d * f
        return self.layers * (attn + mlp) + 2 * d * self.vocab + d


def shapes(conf: Dict[str, Any]) -> Shapes:
    heads = conf["num_attention_heads"]
    experts = conf.get("num_local_experts", 0)
    return Shapes(
        vocab=conf["vocab_size"],
        d_model=conf["hidden_size"],
        layers=conf["num_hidden_layers"],
        heads=heads,
        kv_heads=conf["num_key_value_heads"],
        head_dim=conf.get("head_dim") or conf["hidden_size"] // heads,
        d_ff=conf["intermediate_size"],
        rope_theta=float(conf["rope_theta"]),
        norm_eps=float(conf["rms_norm_eps"]),
        max_positions=conf["max_position_embeddings"],
        dtype=conf["dtype"],
        experts=experts,
        experts_per_token=conf.get("num_experts_per_tok", 0) if experts else 0,
        capacity_factor=float(conf.get("capacity_factor", 0.0)),
        moe_impl=conf.get("moe_impl", "einsum"),
    )


def port_config(s: Shapes):
    """The program's ModelConfig for these shapes."""
    from dstack_tpu_torch.workloads.config import ModelConfig

    if s.head_dim * s.heads != s.d_model:
        raise ValueError("the program derives head_dim as d_model / n_heads")
    kw = dict(
        vocab_size=s.vocab, d_model=s.d_model, n_layers=s.layers, n_heads=s.heads,
        n_kv_heads=s.kv_heads, d_ff=s.d_ff, rope_theta=s.rope_theta,
        norm_eps=s.norm_eps, max_seq_len=s.max_positions, dtype=s.dtype,
    )
    if s.experts:
        kw.update(n_experts=s.experts, experts_per_token=s.experts_per_token,
                  capacity_factor=s.capacity_factor, moe_impl=s.moe_impl)
    return ModelConfig(**kw)


def make_weights(s: Shapes, seed: int, device) -> Dict[str, Any]:
    """The tree the program's serving engine takes: one stacked tensor per
    weight kind with a leading layer dim; norms and the router in f32,
    everything else in the configuration's dtype. Each leaf is one
    `torch.randn` call on the device in the served dtype, scaled by
    fan_in^-0.5 in place, so making 14.5 GB takes a fraction of a second
    and no f32 copy."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed % (1 << 63))
    dt = _DTYPES[s.dtype]
    L, D, F, V, hd = s.layers, s.d_model, s.d_ff, s.vocab, s.head_dim

    def dense(shape, fan_in, dtype=dt):
        w = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
        return w.mul_(fan_in ** -0.5)

    def norm(shape):
        return torch.ones(shape, device=dev, dtype=torch.float32)

    layers = {
        "wq": dense((L, D, s.heads * hd), D),
        "wk": dense((L, D, s.kv_heads * hd), D),
        "wv": dense((L, D, s.kv_heads * hd), D),
        "wo": dense((L, s.heads * hd, D), s.heads * hd),
        "attn_norm": norm((L, D)),
        "mlp_norm": norm((L, D)),
    }
    if s.experts:
        E = s.experts
        layers["router"] = dense((L, D, E), D, torch.float32)
        layers["we_gate"] = dense((L, E, D, F), D)
        layers["we_up"] = dense((L, E, D, F), D)
        layers["we_down"] = dense((L, E, F, D), F)
    else:
        layers["w_gate"] = dense((L, D, F), D)
        layers["w_up"] = dense((L, D, F), D)
        layers["w_down"] = dense((L, F, D), F)
    return {
        "embed": dense((V, D), D),
        "layers": layers,
        "final_norm": norm((D,)),
        "lm_head": dense((D, V), D),
    }


# -- work counts: every layer alike, attention full causal --------------------


def layer_matmul_flops(s: Shapes) -> float:
    """One token's projection and MLP FLOPs in one layer (no attention):
    an MoE token through its k experts and the router's product."""
    d, hd = s.d_model, s.head_dim
    proj = 2 * d * (s.heads + 2 * s.kv_heads) * hd + 2 * s.heads * hd * d
    if s.experts:
        mlp = s.experts_per_token * 6 * d * s.d_ff + 2 * d * s.experts
    else:
        mlp = 6 * d * s.d_ff
    return float(proj + mlp)


def prefill_flops(s: Shapes, prompt: int, reused: int = 0) -> float:
    """Forward FLOPs to prefill positions [reused, prompt) and produce the
    first token's logits."""
    n = prompt - reused
    attn = 4 * s.heads * s.head_dim * attention_pairs(reused, prompt)
    return s.layers * (n * layer_matmul_flops(s) + attn) + 2.0 * s.d_model * s.vocab


def decode_flops(s: Shapes, context: int) -> float:
    """Forward FLOPs of one decode token that attends `context` keys."""
    attn = 4 * s.heads * s.head_dim * context
    return s.layers * (layer_matmul_flops(s) + attn) + 2.0 * s.d_model * s.vocab


def paged_prefill_work(s: Shapes, prompt: int, reused: int = 0):
    """(bytes, ops) of the paged kernel for a prompt's uncached positions:
    K/V rows [0, prompt) read once, q of the new rows read and their
    output written once; QK^T + PV on the causal pairs."""
    b = s.dtype_bytes
    kv = prompt * 2 * s.kv_heads * s.head_dim * b
    qo = (prompt - reused) * 2 * s.heads * s.head_dim * b
    ops = 4 * s.heads * s.head_dim * attention_pairs(reused, prompt)
    return float(s.layers * (kv + qo)), float(s.layers * ops)


def paged_decode_work(s: Shapes, context: int):
    """(bytes, ops) of the paged kernel for one decode token over
    `context` keys."""
    b = s.dtype_bytes
    kv = context * 2 * s.kv_heads * s.head_dim * b
    qo = 2 * s.heads * s.head_dim * b
    ops = 4 * s.heads * s.head_dim * context
    return float(s.layers * (kv + qo)), float(s.layers * ops)
