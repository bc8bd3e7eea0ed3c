"""A configuration file's published keys as the shapes the benchmark uses.

The files under `configs/` hold the model's own `config.json` keys
(hidden_size, num_hidden_layers, ...) as it is run, plus what the
benchmark adds: `dtype`, and for a mixture of experts the program's
`capacity_factor` and `moe_impl`. `Shapes` is what the yardstick reads
(weights, the reference, the operation counts); `port_config` turns it
into the program's ModelConfig.
"""

from dataclasses import dataclass
from typing import Any, Dict


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
