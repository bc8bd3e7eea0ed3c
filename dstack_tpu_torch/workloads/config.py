"""Model configuration (llama-family decoder), the PyTorch port's copy.

Mirrors `dstack_tpu.workloads.config` field for field so a preset name
means the same shapes in both packages, and `resolve_remat` keeps the
reference's formula; only the HBM budget's default differs (80 GB, the
H100, where the reference assumes a 16 GB TPU chip).
"""

import os
from dataclasses import dataclass, replace
from typing import Dict, Optional, Union

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
    # Sparse MoE (workloads/moe.py) when n_experts > 0; moe_impl picks the
    # dispatch, "einsum" or "gather" (anything else raises ValueError there).
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

    def resolve_remat(
        self,
        batch_tokens: int,
        shards: Optional[Dict[str, int]] = None,
        *,
        seq_len: Optional[int] = None,
        attn_scores: bool = False,
    ) -> str:
        """The remat policy ("none", "dots" or "full") for a training step
        of `batch_tokens` on a mesh of `shards` (axis -> size), by the
        reference's formula (`config.py:82-164`): "auto" compares the
        saved-activation estimate of the no-remat forward against the HBM
        left after the train state (12 B/param). Budget knob:
        DSTACK_TPU_HBM_GB, default 80 (one H100)."""
        r = self.remat
        if r is True or r == "full":
            return "full"
        if r is False or r == "none":
            return "none"
        if r == "dots":
            return "dots"
        if r != "auto":
            raise ValueError(
                f"remat={r!r}: expected 'auto', 'none', 'dots', 'full' or a bool"
            )
        shards = shards or {}
        hbm = float(os.environ.get("DSTACK_TPU_HBM_GB", "80")) * 2**30
        weight_shard = (
            shards.get("fsdp", 1) * shards.get("model", 1)
            * shards.get("pipe", 1) * shards.get("expert", 1)
        )
        state_bytes = 12 * self.param_count() / weight_shard
        budget = max(hbm - state_bytes, 0.15 * hbm)
        act_bytes = self.activation_bytes(batch_tokens, shards, seq_len=seq_len,
                                          attn_scores=attn_scores)
        return "none" if act_bytes < 0.6 * budget else "dots"

    def activation_bytes(self, batch_tokens: int,
                         shards: Optional[Dict[str, int]] = None, *,
                         seq_len: Optional[int] = None,
                         attn_scores: bool = False) -> float:
        """The reference's per-device estimate of what the no-remat
        backward keeps (the half of `resolve_remat` that sizes it).
        `shards` is the device's real share: the reference divides by its
        seq axis because each device holds 1/n of the sequence, while the
        port's one-device ring holds all n shards, so its callers pass a
        seq factor of 1 (sharding.device_shards). Dividing by n there would
        under-count by n and answer "none" where memory says otherwise."""
        shards = shards or {}
        act_shard = (
            shards.get("data", 1) * shards.get("fsdp", 1) * shards.get("seq", 1)
        )
        d, f = self.d_model, self.d_ff
        db = self.dtype_bytes
        kv = self.n_kv_heads * self.head_dim
        mlp_width = f * (
            self.experts_per_token * self.capacity_factor
            if self.n_experts > 0 else 1
        )
        # Per-layer residuals of the no-remat backward, as the reference
        # counts them. Eager autograd keeps more (the f32 copies inside
        # rms_norm and rope, the GQA-expanded K/V the flash Function saves):
        # PERF.md records the measured peak against this estimate.
        per_token = int((6 * d + 2 * kv) * db + mlp_width * 4 * db)
        if attn_scores and seq_len:
            # Plain attention keeps the f32 scores and probs for backward;
            # the flash kernels recompute them.
            per_token += 2 * seq_len * self.n_heads * 4
        if self.ce_chunk > 0 and seq_len and seq_len % self.ce_chunk == 0:
            head_per_token = d * db
        else:
            head_per_token = self.vocab_size * 4  # the f32 logits
        return (batch_tokens / max(act_shard, 1)
                * (per_token * self.n_layers + head_per_token))

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

