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
  bytes it reads from HBM; one CTA per (query-row tile, KV split, KV head,
  slot) carries all query heads of its KV head, so each block is read
  once per GQA group rather than once per query head as the TPU grid did,
  and the KV axis is split across CTAs (`_split_plan`, from shapes and
  dtype only) so that a few long slots still fill the card; a second kernel merges the
  splits' partials. CUDA tensors always go here: it launches or raises,
  with no fallback and no switch that could route them elsewhere.
- `_ragged_attention_plain`: plain PyTorch, a mirror of the JAX
  `_ragged_attention_lax`, for CPU tensors (the tests) and as the
  reference `chip_smoke.py` holds the kernel against on the card.

Semantics: query row (b, i) attends cache positions p < valid_len[b, i];
position p lives at block tables[b, p // bs], row p % bs. Table entries
>= num_blocks (the pad sentinel) are masked, and so is everything at or
past each row's valid length.
"""

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from dstack_tpu_torch.workloads.attention import NEG_INF, _repeat_kv

__all__ = ["ragged_attention", "dispatch_path", "LAUNCHES"]

# Kernel launches through `_ragged_attention_cuda`, counted where the
# kernel is launched and nowhere else (chip_smoke.py zeroes and reads it
# around the engine run to show the serving path went through the kernel).
LAUNCHES: Dict[str, int] = {"ragged_paged_attention": 0}

CUDA_HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# The split plan, as `csrc/paged_attention.cu` takes it. CTAs a
# full-length batch puts on each SM, by (dtype, decode step (S 1) or
# not): a bf16 chunk, on the tensor cores, takes 8, the rest 4. On the
# H100 each is the faster of 4 and 8 at its own case, which chip_smoke.py
# checks by timing the other (PERF.md).
CTAS_PER_SM = {(torch.bfloat16, True): 4, (torch.bfloat16, False): 8,
               (torch.float32, True): 4, (torch.float32, False): 4}
CTA_VECTORS = 64         # (row, head) query vectors one CTA carries
KEY_ALIGN = 64           # keys per split: a multiple of every stage's tile
MAX_TABLE_ENTRIES = 1024  # table entries one split may span


class SplitPlan(NamedTuple):
    rows_per_cta: int     # query rows of a CTA (each with its n_rep heads)
    row_tiles: int
    splits: int           # KV splits: CTAs per (row tile, KV head, slot)
    keys_per_split: int
    ctas: int             # grid size
    workspace: Optional[Tuple[int, int, int]]  # f32 (splits, B*S*H, hd + 2), or None


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=256)
def _split_plan(B, S, H, KV, MB, bs, hd, dtype, sms, per_sm=None) -> SplitPlan:
    """How the kernel cuts its grid, from shapes, dtype and the device's
    SM count `sms` alone (never from valid_len, which stays on the device,
    so the grid is fixed by shapes and a CUDA graph can capture the call).
    A CTA carries up to CTA_VECTORS query vectors; the MB * bs table
    columns are cut into splits of a multiple of KEY_ALIGN positions, as
    few as put `per_sm` CTAs on each SM when every slot is full (by
    default CTAS_PER_SM's), and short enough that one split spans at most
    MAX_TABLE_ENTRIES blocks. With more than one split, each CTA leaves an
    f32 partial (o, m, l) in the workspace and a second kernel merges
    them."""
    if per_sm is None:
        per_sm = CTAS_PER_SM[(dtype, S == 1)]
    n_rep = H // KV
    rows = min(S, max(1, CTA_VECTORS // n_rep))
    tiles = _cdiv(S, rows)
    cols = MB * bs
    want = max(1, _cdiv(sms * per_sm, tiles * KV * B))
    kps = _cdiv(_cdiv(cols, want), KEY_ALIGN) * KEY_ALIGN
    # (kps - 1) // bs + 2 blocks at most may hold a split's positions.
    cap = max(KEY_ALIGN, (bs * (MAX_TABLE_ENTRIES - 2) + 1) // KEY_ALIGN * KEY_ALIGN)
    kps = min(kps, cap)
    splits = _cdiv(cols, kps)
    ws = (splits, B * S * H, hd + 2) if splits > 1 else None
    return SplitPlan(rows, tiles, splits, kps, tiles * splits * KV * B, ws)


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


def _ragged_attention_split(q, k_pool, v_pool, tables, valid_len, keys_per_split):
    """The kernel's split-KV structure in plain PyTorch: each split of
    `keys_per_split` positions (a multiple of the block size) runs
    `_ragged_attention_plain`'s stats over its blocks alone and leaves an
    f32 partial (o unnormalised, m, l); `_merge_splits` merges the
    splits row (b, i) reads, s * keys_per_split < valid_len[b, i], as the
    combine kernel does. Probabilities stay f32 (no rounding to q.dtype),
    so in f32 it is the same function as `_ragged_attention_plain` up to
    summation order."""
    b, s, h, hd = q.shape
    nb, bs, kv, _ = k_pool.shape
    mb = tables.shape[1]
    if keys_per_split % bs:
        raise ValueError(f"keys_per_split {keys_per_split} is not whole blocks of {bs}")
    n_rep, scale = h // kv, hd ** -0.5
    cols = mb * bs
    splits = _cdiv(cols, keys_per_split)
    tables = tables.to(torch.int64)
    valid_len = valid_len.to(torch.int64)
    slot_len = valid_len.max(dim=1).values
    qf = q.to(torch.float32)
    offs = torch.arange(bs, device=q.device)
    parts = []
    for sp in range(splits):
        m = torch.full((b, h, s, 1), NEG_INF / 2, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        o = torch.zeros((b, h, s, hd), dtype=torch.float32, device=q.device)
        j0 = sp * keys_per_split // bs
        for j in range(j0, min(j0 + keys_per_split // bs, mb)):
            col = tables[:, j]
            safe = col.clamp(0, nb - 1)
            kb = _repeat_kv(k_pool[safe], n_rep).to(torch.float32)
            vb = _repeat_kv(v_pool[safe], n_rep).to(torch.float32)
            pos = j * bs + offs
            seen = (pos[None, :] < slot_len[:, None]) & (col < nb)[:, None]   # (B, bs)
            vb = torch.where(seen[:, :, None, None], vb, torch.zeros_like(vb))
            logits = torch.einsum("bshd,bthd->bhst", qf, kb) * scale
            ok = (pos[None, None, :] < valid_len[:, :, None]) & (col < nb)[:, None, None]
            logits = torch.where(ok[:, None], logits, torch.full_like(logits, NEG_INF))
            m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True).clamp(min=NEG_INF / 2))
            p = torch.exp(logits - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            o = o * alpha + torch.einsum("bhst,bthd->bhsd", p, vb)
            m = m_new
        parts.append((o, m, l))
    used = (torch.arange(splits, device=q.device)[:, None, None] * keys_per_split
            < valid_len.clamp(max=cols)[None])                         # (splits, B, S)
    out = _merge_splits(parts, used)
    return out.to(q.dtype).transpose(1, 2).reshape(b, s, h * hd)


def _merge_splits(parts, used):
    """Merge per-split (o, m, l), each (B, H, S, hd / 1), over the splits
    `used` (splits, B, S) marks: M = max m_s, o = sum e^(m_s - M) o_s /
    max(sum e^(m_s - M) l_s, 1e-30); a row with no split used is 0."""
    use = used[:, :, None, :, None]                                    # (splits, B, 1, S, 1)
    m = torch.stack([p[1] for p in parts])                             # (splits, B, H, S, 1)
    m = torch.where(use, m, torch.full_like(m, NEG_INF))
    top = m.amax(dim=0)
    w = torch.where(use, torch.exp(m - top), torch.zeros_like(m))
    num = (w * torch.stack([p[0] for p in parts])).sum(dim=0)
    den = (w * torch.stack([p[2] for p in parts])).sum(dim=0)
    return num / den.clamp(min=1e-30)


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
    major, minor = _device_info(q.device.index)[0]
    if (major, minor) != (9, 0):
        raise RuntimeError(f"kernel built for sm_90a, device is sm_{major}{minor}")


@functools.lru_cache(maxsize=None)
def _device_info(index) -> Tuple[Tuple[int, int], int]:
    """((major, minor) capability, SM count) of CUDA device `index`."""
    props = torch.cuda.get_device_properties(index)
    return (props.major, props.minor), props.multi_processor_count


def _ragged_attention_cuda(q, k_pool, v_pool, tables, valid_len, plan=None):
    """The kernel on CUDA tensors. `plan` (a `_split_plan`) defaults to
    the plan of these shapes on this device."""
    from dstack_tpu_torch.workloads import _build

    _check_cuda_args(q, k_pool, v_pool, tables, valid_len)
    b, s, h, hd = q.shape
    nb, bs, kv, _ = k_pool.shape
    out = torch.empty((b, s, h * hd), dtype=q.dtype, device=q.device)
    if b == 0 or s == 0:
        return out
    if plan is None:
        plan = _split_plan(b, s, h, kv, tables.shape[1], bs, hd, q.dtype,
                           _device_info(q.device.index)[1])
    ws = (torch.empty(plan.workspace, dtype=torch.float32, device=q.device)
          if plan.workspace else None)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.dstack_ragged_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), valid_len.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None,
        b, s, h, kv, hd, nb, bs, tables.shape[1],
        plan.rows_per_cta, plan.splits, plan.keys_per_split,
        ctypes.c_float(hd ** -0.5), _DTYPE_CODE[q.dtype], stream,
    )
    if rc != 0:
        raise RuntimeError(
            "ragged paged-attention kernel launch failed: "
            + lib.dstack_cuda_error_string(rc).decode()
        )
    LAUNCHES["ragged_paged_attention"] += 1
    return out
