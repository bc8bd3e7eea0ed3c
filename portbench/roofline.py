"""The chip's peaks, and the operations and bytes the traffic's work needs.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, without
sparsity): 989 TFLOP/s in bf16, 3.35 TB/s of HBM. Every count is worked
out from the shapes and the requests the benchmark sent, never from the
program's internals, and counts what the work needs: each K/V row read
once, attention only over the (row, key) pairs the causal mask keeps, an
MoE token through its k experts (not the slots a dispatch computes), the
lm-head once per generated token.
"""

from portbench.model_config import Shapes

PEAK_FLOPS_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12


def layer_matmul_flops(s: Shapes) -> float:
    """One token's projection and MLP FLOPs in one layer (no attention)."""
    d, hd = s.d_model, s.head_dim
    proj = 2 * d * (s.heads + 2 * s.kv_heads) * hd + 2 * s.heads * hd * d
    if s.experts:
        mlp = s.experts_per_token * 6 * d * s.d_ff + 2 * d * s.experts
    else:
        mlp = 6 * d * s.d_ff
    return float(proj + mlp)


def attention_pairs(start: int, end: int) -> int:
    """(query, key) pairs of causal positions [start, end): sum of p + 1."""
    return (end * (end + 1) - start * (start + 1)) // 2


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


def least_seconds(nbytes: float, ops: float, peak: float = PEAK_FLOPS_BF16):
    """(seconds, bound_by): the larger of bytes over HBM bandwidth and
    operations over the peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
