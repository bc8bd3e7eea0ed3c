"""Dense attention primitives of the serving path (port of
`dstack_tpu.workloads.attention`, lines 30-62): the GQA head repeat and
the per-row-masked decode attention the dense reference engine runs.

Products the reference computes with an f32 result
(`preferred_element_type=f32`) upcast their operands here: bf16 x bf16
products are exact in f32, so this is the same f32 accumulation.
"""

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
