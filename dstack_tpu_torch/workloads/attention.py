"""Attention (port of `dstack_tpu.workloads.attention`, single-device
part): the GQA head repeat, the per-row-masked decode attention of the
dense reference engine, the plain full-sequence attention, and
`make_attention_fn`, which picks the flash kernels on a CUDA device. The
ring path over a sequence-sharded mesh is not ported yet.

Products the reference computes with an f32 result
(`preferred_element_type=f32`) upcast their operands here: bf16 x bf16
products are exact in f32, so this is the same f32 accumulation.
"""

from typing import Any, Optional

import torch

NEG_INF = -1e30


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, KV, hd) -> (B, S, KV*n_rep, hd) for grouped-query attention."""
    if n_rep == 1:
        return x
    b, s, kv, hd = x.shape
    return x[:, :, :, None, :].expand(b, s, kv, n_rep, hd).reshape(
        b, s, kv * n_rep, hd
    )


def decode_attention(q, ck, cv, valid_len):
    """q (B, S, H, hd) against per-slot caches (B, max_len, KV, hd), each
    row b masked to its own `valid_len[b]`. Garbage (NaN included) at or
    beyond valid_len is discarded by the select before the softmax."""
    b, s, h, hd = q.shape
    k = _repeat_kv(ck, h // ck.shape[2]).to(torch.float32)
    v = _repeat_kv(cv, h // ck.shape[2]).to(torch.float32)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k) * (hd ** -0.5)
    kpos = torch.arange(ck.shape[1], device=q.device)
    mask = kpos[None, :] < valid_len[:, None]            # (B, max_len)
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(q.dtype).to(torch.float32)
    v = torch.where(mask[:, :, None, None], v, torch.zeros_like(v))
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return out.to(q.dtype).reshape(b, s, h * hd)


def plain_attention(q, k, v, *, causal: bool = True):
    """Reference-semantics attention: q (B, Sq, H, hd), k/v (B, Sk, KV, hd)
    -> (B, Sq, H, hd). Probabilities are rounded to q.dtype before the PV
    product, as the reference's `probs.astype(q.dtype)`."""
    n_rep = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, n_rep).to(torch.float32)
    v = _repeat_kv(v, n_rep)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril(sk - sq)
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(q.dtype).to(torch.float32)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(torch.float32))
    return out.to(q.dtype)


def make_attention_fn(mesh: Optional[Any] = None, *, seq_axis: str = "seq",
                      causal: bool = True):
    """The attention for a mesh. No mesh, or a `seq` axis of size 1: the
    single-device path, which runs the flash kernels on a CUDA device and
    `plain_attention` on the CPU (as the JAX package does off the TPU). A
    `seq` axis > 1 in `mesh.shape` (axis -> size) asks for ring attention,
    which is not ported yet."""
    if mesh is not None and dict(mesh.shape).get(seq_axis, 1) > 1:
        raise NotImplementedError(
            "ring attention over a sequence-sharded mesh is not ported to"
            " PyTorch yet"
        )

    def single_device(q, k, v):
        from dstack_tpu_torch.workloads.flash_attention import flash_attention, use_flash

        if q.shape[1] == k.shape[1] and use_flash(q.shape[1], q.shape[3], q.device):
            return flash_attention(q, k, v, causal=causal)
        return plain_attention(q, k, v, causal=causal)

    def _quadratic(seq_len: int, head_dim: int, dtype_bytes: int = 2,
                   device=None) -> bool:
        # The remat estimator asks whether this path saves O(S^2) scores for
        # backward: only where the flash kernels do not run. The device
        # decides, as the backend does in the reference.
        from dstack_tpu_torch.workloads.flash_attention import use_flash

        return not use_flash(seq_len, head_dim, device or "cpu")

    single_device.memory_is_quadratic = _quadratic
    return single_device
