"""Ragged paged attention: attend straight over the block-table pool.

Port of `dstack_tpu.workloads.paged_attention`. The paged engine keeps
every slot's KV cache as scattered `(block_size, KV, hd)` blocks of one
shared `(num_blocks, block_size, KV, hd)` pool per layer, indexed by
per-slot block tables; attention walks those blocks directly and never
builds a dense per-slot view.

Two implementations behind one seam (`ragged_attention`), chosen by where
the tensors live, nothing else:

- `_ragged_attention_cuda`: the hand-written Hopper kernel
  (`csrc/paged_attention.cu`, built at first use by `_build.py`). It
  replaces the TPU kernel `_paged_kernel`
  (dstack_tpu/workloads/paged_attention.py:222). It is bound by the K/V
  bytes it reads from HBM; one CTA per (slot, KV head, query-row tile)
  carries all query heads of its KV head, so each block is read once per
  GQA group rather than once per query head as the TPU grid did. CUDA
  tensors always go here: it launches or raises, with no fallback and no
  switch that could route them elsewhere.
- `_ragged_attention_plain`: plain PyTorch, a mirror of the JAX
  `_ragged_attention_lax`, for CPU tensors (the tests) and as the
  reference `chip_smoke.py` holds the kernel against on the card.

Semantics: query row (b, i) attends cache positions p < valid_len[b, i];
position p lives at block tables[b, p // bs], row p % bs. Table entries
>= num_blocks (the pad sentinel) are masked, and so is everything at or
past each row's valid length.
"""

import ctypes
from typing import Dict

import torch

from dstack_tpu_torch.workloads.attention import NEG_INF, _repeat_kv

__all__ = ["ragged_attention", "dispatch_path", "LAUNCHES"]

# Kernel launches through `_ragged_attention_cuda`, counted where the
# kernel is launched and nowhere else (chip_smoke.py zeroes and reads it
# around the engine run to show the serving path went through the kernel).
LAUNCHES: Dict[str, int] = {"ragged_paged_attention": 0}

CUDA_HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def dispatch_path(device: torch.device, head_dim: int) -> str:
    """Which implementation `ragged_attention` runs for tensors on
    `device`: "cuda" (the kernel) on a CUDA device, else "plain". A
    head_dim the kernel does not take raises for CUDA rather than quietly
    running the plain version there."""
    if torch.device(device).type == "cuda":
        if head_dim not in CUDA_HEAD_DIMS:
            raise NotImplementedError(
                f"the CUDA paged-attention kernel takes head_dim in"
                f" {CUDA_HEAD_DIMS}, got {head_dim}"
            )
        return "cuda"
    return "plain"


def ragged_attention(q, k_pool, v_pool, tables, valid_len):
    """Ragged paged attention over one layer's block pool.

    q:        (B, S, H, hd)      queries (S=1 decode, S=C chunk)
    k_pool:   (NB, bs, KV, hd)   one layer of the shared block pool
    v_pool:   (NB, bs, KV, hd)
    tables:   (B, MB) int32      per-slot block tables, pad sentinel == NB
    valid_len:(B, S) int32       row (b, i) attends positions < valid_len[b, i]

    Returns (B, S, H*hd) in q.dtype.
    """
    if q.is_cuda:
        return _ragged_attention_cuda(q, k_pool, v_pool, tables, valid_len)
    return _ragged_attention_plain(q, k_pool, v_pool, tables, valid_len)


# ------------------------------------------------------------ plain version


def _ragged_attention_plain(q, k_pool, v_pool, tables, valid_len):
    """Two passes over table columns, as the JAX `_ragged_attention_lax`.

    Pass 1 streams the softmax stats (running max, rescaled denominator);
    pass 2 accumulates PV with the probabilities normalized at the FINAL
    (m, l) and rounded to q.dtype first — the rounding the dense
    references apply (`softmax(logits).astype(q.dtype)`), on which the
    temperature-0 exactness of the engine against them rests. Each step
    touches one (B, bs) block column; both loops stop at the columns any
    row needs. V rows no row of a slot may see (sentinel columns, past its
    longest row) are zeroed, so NaN garbage there cannot survive as
    0 * NaN; on finite inputs that changes nothing.
    """
    b, s, h, hd = q.shape
    nb, bs, kv, _ = k_pool.shape
    mb = tables.shape[1]
    n_rep = h // kv
    scale = hd ** -0.5
    dev = q.device
    tables = tables.to(torch.int64)
    valid_len = valid_len.to(torch.int64)
    n_cols = min(int((int(valid_len.max()) + bs - 1) // bs), mb) if valid_len.numel() else 0
    slot_len = valid_len.max(dim=1).values                 # (B,)
    qf = q.to(torch.float32)
    offs = torch.arange(bs, device=dev)

    def block(j):
        col = tables[:, j]
        safe = col.clamp(0, nb - 1)
        kb = _repeat_kv(k_pool[safe], n_rep).to(torch.float32)
        logits = torch.einsum("bshd,bthd->bhst", qf, kb) * scale  # (B, H, S, bs)
        pos = j * bs + offs
        ok = (pos[None, None, :] < valid_len[:, :, None]) & (
            col < nb)[:, None, None]                        # (B, S, bs)
        logits = torch.where(ok[:, None], logits, torch.full_like(logits, NEG_INF))
        seen = (pos[None, :] < slot_len[:, None]) & (col < nb)[:, None]  # (B, bs)
        return logits, safe, seen

    m = torch.full((b, h, s, 1), NEG_INF / 2, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, s, 1), dtype=torch.float32, device=dev)
    for j in range(n_cols):
        logits, _, _ = block(j)
        blk_m = torch.clamp(logits.amax(dim=-1, keepdim=True), min=NEG_INF / 2)
        m_new = torch.maximum(m, blk_m)
        blk_l = torch.exp(logits - m_new).sum(dim=-1, keepdim=True)
        l = l * torch.exp(m - m_new) + blk_l
        m = m_new
    l = torch.clamp(l, min=1e-30)

    o = torch.zeros((b, h, s, hd), dtype=torch.float32, device=dev)
    for j in range(n_cols):
        logits, safe, seen = block(j)
        vb = _repeat_kv(v_pool[safe], n_rep).to(torch.float32)  # (B, bs, H, hd)
        vb = torch.where(seen[:, :, None, None], vb, torch.zeros_like(vb))
        p = (torch.exp(logits - m) / l).to(q.dtype).to(torch.float32)
        o = o + torch.einsum("bhst,bthd->bhsd", p, vb)
    return o.to(q.dtype).transpose(1, 2).reshape(b, s, h * hd)


# ------------------------------------------------------------- CUDA kernel


def _check_cuda_args(q, k_pool, v_pool, tables, valid_len) -> None:
    b, s, h, hd = q.shape
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"pools must be (NB, bs, KV, hd) alike, got"
                         f" {tuple(k_pool.shape)} and {tuple(v_pool.shape)}")
    nb, bs, kv, hd_k = k_pool.shape
    if hd_k != hd or h % kv or h // kv > 32:
        raise ValueError(f"q heads {h} x {hd} do not fit pools KV {kv} x {hd_k}"
                         " (needs H % KV == 0, H / KV <= 32)")
    if hd not in CUDA_HEAD_DIMS:
        raise NotImplementedError(f"head_dim {hd} not in {CUDA_HEAD_DIMS}")
    if bs > 128:
        raise NotImplementedError(f"block size {bs} > 128")
    if q.dtype not in _DTYPE_CODE or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}/{k_pool.dtype}/{v_pool.dtype}:"
                        " all float32 or all bfloat16")
    if tables.dtype != torch.int32 or valid_len.dtype != torch.int32:
        raise TypeError("tables and valid_len must be int32")
    if tables.shape[0] != b or valid_len.shape != (b, s):
        raise ValueError(f"tables {tuple(tables.shape)} / valid_len"
                         f" {tuple(valid_len.shape)} do not match q {tuple(q.shape)}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("tables", tables), ("valid_len", valid_len)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    major, minor = torch.cuda.get_device_capability(q.device)
    if (major, minor) != (9, 0):
        raise RuntimeError(f"kernel built for sm_90a, device is sm_{major}{minor}")


def _ragged_attention_cuda(q, k_pool, v_pool, tables, valid_len):
    from dstack_tpu_torch.workloads import _build

    _check_cuda_args(q, k_pool, v_pool, tables, valid_len)
    b, s, h, hd = q.shape
    nb, bs, kv, _ = k_pool.shape
    out = torch.empty((b, s, h * hd), dtype=q.dtype, device=q.device)
    if b == 0 or s == 0:
        return out
    lib = _build.load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.dstack_ragged_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), valid_len.data_ptr(), out.data_ptr(),
        b, s, h, kv, hd, nb, bs, tables.shape[1],
        ctypes.c_float(hd ** -0.5), _DTYPE_CODE[q.dtype], stream,
    )
    if rc != 0:
        raise RuntimeError(
            "ragged paged-attention kernel launch failed: "
            + lib.dstack_cuda_error_string(rc).decode()
        )
    LAUNCHES["ragged_paged_attention"] += 1
    return out
