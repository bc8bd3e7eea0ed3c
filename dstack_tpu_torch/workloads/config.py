"""Model configuration (llama-family decoder), the PyTorch port's copy.

Mirrors `dstack_tpu.workloads.config` field for field so a preset name
means the same shapes in both packages. `resolve_remat` is not here yet:
it belongs to the training slice.
"""

from dataclasses import dataclass, replace
from typing import Dict, Union

import torch

_DTYPE = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32768
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 4  # grouped-query attention
    d_ff: int = 1536
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 2048
    dtype: str = "bfloat16"
    remat: Union[bool, str] = "auto"
    # Sparse MoE fields are kept so presets compare equal across the two
    # packages; the port serves dense models only (n_experts == 0).
    n_experts: int = 0
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_impl: str = "einsum"
    ce_chunk: int = 0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def activation_dtype(self) -> torch.dtype:
        return _DTYPE[self.dtype]

    @property
    def dtype_bytes(self) -> int:
        return torch.empty((), dtype=_DTYPE[self.dtype]).element_size()

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    def param_count(self) -> int:
        """Approximate parameter count (embedding + head untied)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * hd + self.n_heads * hd * d
        if self.n_experts > 0:
            mlp = 3 * d * f * self.n_experts + d * self.n_experts
        else:
            mlp = 3 * d * f
        return self.n_layers * (attn + mlp) + 2 * d * v

    def flops_per_token(self, seq_len: int = None) -> float:
        """Approximate forward+backward FLOPs per token (3x forward), the
        same accounting as the JAX package (PaLM appendix B)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        attn_proj = 2 * d * (self.n_heads + 2 * self.n_kv_heads) * hd + 2 * self.n_heads * hd * d
        if self.n_experts > 0:
            mlp = 3 * 2 * d * f * self.experts_per_token + 2 * d * self.n_experts
        else:
            mlp = 3 * 2 * d * f
        per_layer = attn_proj + mlp
        if seq_len:
            per_layer += 2 * seq_len * self.n_heads * hd  # causal QK^T + AV
        embed = 2 * d * v
        fwd = self.n_layers * per_layer + embed
        return 3.0 * fwd


PRESETS: Dict[str, ModelConfig] = {
    "tiny": ModelConfig(
        vocab_size=512, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=256, max_seq_len=256, remat=False,
    ),
    "smol-1b": ModelConfig(
        vocab_size=32768, d_model=2048, n_layers=16, n_heads=16, n_kv_heads=8,
        d_ff=5632, max_seq_len=2048,
    ),
    "smol-1b-8k": ModelConfig(
        vocab_size=32768, d_model=2048, n_layers=16, n_heads=16, n_kv_heads=8,
        d_ff=5632, max_seq_len=8192, rope_theta=1e6,
    ),
    "llama-8b": ModelConfig(
        vocab_size=128256, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        d_ff=14336, max_seq_len=8192,
    ),
    "llama-70b": ModelConfig(
        vocab_size=128256, d_model=8192, n_layers=80, n_heads=64, n_kv_heads=8,
        d_ff=28672, max_seq_len=8192,
    ),
    "tiny-moe": ModelConfig(
        vocab_size=512, d_model=128, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=256, max_seq_len=256, remat=False, n_experts=4,
        experts_per_token=2,
    ),
    "smol-moe": ModelConfig(
        vocab_size=32768, d_model=2048, n_layers=16, n_heads=16, n_kv_heads=8,
        d_ff=5632, max_seq_len=2048, n_experts=8, experts_per_token=2,
    ),
}


def require_dense(config: ModelConfig) -> None:
    """The port has no MoE block yet: refuse rather than run a dense MLP
    over weights that were never built."""
    if config.n_experts > 0:
        raise NotImplementedError(
            "MoE models (n_experts > 0) are not ported to PyTorch yet"
        )
