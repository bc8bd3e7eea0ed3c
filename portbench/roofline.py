"""The chip's peaks, and the arithmetic every family's counts share.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, without
sparsity): 989 TFLOP/s in bf16, 3.35 TB/s of HBM. The operations and
bytes a model's work needs are counted by its family
(`families/<model_type>.py`), from the shapes and the requests the
benchmark sent, never from the program's internals.
"""

PEAK_FLOPS_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12


def attention_pairs(start: int, end: int) -> int:
    """(query, key) pairs of causal positions [start, end): sum of p + 1."""
    return (end * (end + 1) - start * (start + 1)) // 2


def least_seconds(nbytes: float, ops: float, peak: float = PEAK_FLOPS_BF16):
    """(seconds, bound_by): the larger of bytes over HBM bandwidth and
    operations over the peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
