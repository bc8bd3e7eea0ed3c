"""Flash attention for training (port of
`dstack_tpu.workloads.flash_attention`): the single-device kernels and
the ring step.

Four hand-written Hopper kernels in `csrc/flash_attention.cu` (built at
first use by `_build.py`) replace the TPU kernels of the reference:

| Kernel here              | Replaces (dstack_tpu/workloads/flash_attention.py) |
|--------------------------|----------------------------------------------------|
| `dstack_flash_fwd`       | `_fwd_kernel` :219 (body `_streaming_attend` :170) |
| `dstack_flash_block_fwd` | `_block_fwd_kernel` :455 (the ring step)           |
| `dstack_flash_bwd_dq`    | `_bwd_dq_kernel` :256                              |
| `dstack_flash_bwd_dkv`   | `_bwd_dkv_kernel` :294                             |

At the smol-1b training shape (B*H 128, S 2048, hd 128, causal, bf16) all
three are bound by operations on this card, not bytes: ~137.5, ~206 and
~275 GFLOP against ~0.27-0.40 GB, bounds of ~0.139, ~0.209 and ~0.278 ms
at the bf16 tensor-core peak. The kernels keep the (S, S) scores out of
HBM and run their products on the tensor cores (see the .cu's notes).

Each kernel sits beside its plain PyTorch version (`_flash_fwd_plain`,
`_flash_bwd_dq_plain`, `_flash_bwd_dkv_plain`): dense, on (B*H, S, hd),
with the same formulas and the same NEG_INF handling. The wrappers take
the plain version only for CPU tensors; a CUDA tensor launches the kernel
or raises. No switch routes CUDA tensors elsewhere (the reference's
DSTACK_TPU_FLASH_ATTENTION has no counterpart here).

Rounding: for bf16 the kernels round P (forward) and dS (backward) to
bf16 before their products, as the tensor cores need; the TPU kernels and
the plain versions keep them in f32. The logsumexp is kept as (B*H, S);
the reference's (B*H, 1, S) was a TPU tiling rule, and so are the ring
step's m and l.

The ring step (`_RingBlock`, `flash_block_attend`) returns one step's
unnormalised partials (o in f32 relative to the row max m, m, l) for the
ring's merge (attention.py). Its backward has no kernel in the reference
either: it recomputes through the plain version `_block_ref_bh` under
autograd, so plain torch ops there are the design, not a fallback.
"""

import ctypes
from typing import Dict, Tuple

import torch

from dstack_tpu_torch.workloads.attention import NEG_INF, _repeat_kv

__all__ = ["flash_attention", "flash_block_attend", "use_flash", "LAUNCHES",
           "CUDA_HEAD_DIMS"]

# Launches of each kernel, counted where it is launched and nowhere else
# (chip_smoke.py zeroes and reads them around the training runs).
LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                            "flash_block_fwd": 0}

CUDA_HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def use_flash(seq_len: int, head_dim: int, device) -> bool:
    """Whether the single-device attention runs the flash kernels: on a
    CUDA device always (any seq_len; the kernels mask a ragged last tile),
    on the CPU never (the plain attention runs, as the JAX package does
    off the TPU). A head_dim the kernels do not take raises on CUDA
    rather than running a plain version there."""
    if torch.device(device).type == "cuda":
        if head_dim not in CUDA_HEAD_DIMS:
            raise NotImplementedError(
                f"the CUDA flash-attention kernels take head_dim in"
                f" {CUDA_HEAD_DIMS}, got {head_dim}"
            )
        return True
    return False


# ----------------------------------------------------------- plain versions


def _scores(q, k, causal):
    """f32 logits (BH, Sq, Sk) scaled and masked with NEG_INF; causal is
    the tril shifted by Sk - Sq (the plain diagonal when Sq == Sk)."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril(sk - sq)
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    return logits


def _flash_fwd_plain(q, k, v, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse): o in q.dtype, lse (BH, S) f32, with the floors
    m >= NEG_INF/2 and l >= 1e-30 of `_fwd_kernel`."""
    logits = _scores(q, k, causal)
    m = torch.clamp(logits.amax(dim=-1), min=NEG_INF / 2)
    p = torch.exp(logits - m[..., None])
    l = torch.clamp(p.sum(dim=-1), min=1e-30)
    o = torch.einsum("bqk,bkd->bqd", p, v.to(torch.float32)) / l[..., None]
    return o.to(q.dtype), m + torch.log(l)


def _block_ref_bh(q, k, v, causal: bool):
    """The ring step's plain version (`_block_ref_bh` :462): (o, m, l) on
    (BH, S, hd), o f32 relative to m = max(row max, NEG_INF/2), l the
    unfloored row sum of P, P kept in f32. The backward of `_RingBlock`
    differentiates this."""
    logits = _scores(q, k, causal)
    m = torch.clamp(logits.amax(dim=-1), min=NEG_INF / 2)
    p = torch.exp(logits - m[..., None])
    o = torch.einsum("bqk,bkd->bqd", p, v.to(torch.float32))
    return o, m, p.sum(dim=-1)


def _probs(q, k, lse, causal):
    return torch.exp(_scores(q, k, causal) - lse[..., None])


def _flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool) -> torch.Tensor:
    """dQ = dS K with dS = P (dO V^T - delta) scale, as `_bwd_dq_kernel`."""
    scale = q.shape[-1] ** -0.5
    p = _probs(q, k, lse, causal)
    dp = torch.einsum("bqd,bkd->bqk", do.to(torch.float32), v.to(torch.float32))
    ds = p * (dp - delta[..., None]) * scale
    return torch.einsum("bqk,bkd->bqd", ds, k.to(torch.float32)).to(q.dtype)


def _flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool):
    """(dK, dV) = (dS^T Q, P^T dO), as `_bwd_dkv_kernel`."""
    scale = q.shape[-1] ** -0.5
    p = _probs(q, k, lse, causal)
    dof = do.to(torch.float32)
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    dp = torch.einsum("bqd,bkd->bqk", dof, v.to(torch.float32))
    ds = p * (dp - delta[..., None]) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, q.to(torch.float32))
    return dk.to(k.dtype), dv.to(v.dtype)


def _flash_bwd_plain(q, k, v, o, lse, do, delta, causal: bool):
    """(dq, dk, dv) of the plain versions; `o` rides along for the
    reference's signature (delta already carries it)."""
    del o
    dq = _flash_bwd_dq_plain(q, k, v, do, lse, delta, causal)
    dk, dv = _flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal)
    return dq, dk, dv


# ------------------------------------------------------------- CUDA kernels


def _check_cuda(*ts: torch.Tensor) -> None:
    q = ts[0]
    if q.dim() != 3:
        raise ValueError(f"expected (B*H, S, hd) tensors, got {tuple(q.shape)}")
    bh, s, hd = q.shape
    if hd not in CUDA_HEAD_DIMS:
        raise NotImplementedError(f"head_dim {hd} not in {CUDA_HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"dtype {q.dtype}: float32 or bfloat16")
    if bh > 65535:
        raise ValueError(f"B*H {bh} > 65535 (the kernels' grid y)")
    for t in ts:
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"tensors must match q {tuple(q.shape)} {q.dtype},"
                             f" got {tuple(t.shape)} {t.dtype}")
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"tensors must be on {q.device}, got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("tensors must be contiguous and 16-byte aligned")
    major, minor = torch.cuda.get_device_capability(q.device)
    if (major, minor) != (9, 0):
        raise RuntimeError(f"kernels built for sm_90a, device is sm_{major}{minor}")


def _check_stats(q, *stats: torch.Tensor) -> None:
    for t in stats:
        if (t.shape != q.shape[:2] or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"lse/delta must be contiguous f32 {tuple(q.shape[:2])}"
                             f" on {q.device}")


def _launch(name: str, tensors, causal: bool) -> None:
    """Launch `dstack_<name>` on the current stream over `tensors` (q
    first, outputs last) and count it; raises if the launch was refused."""
    from dstack_tpu_torch.workloads import _build

    lib = _build.load_library()
    q = tensors[0]
    bh, s, hd = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = getattr(lib, f"dstack_{name}")(
        *[t.data_ptr() for t in tensors], bh, s, hd, ctypes.c_float(hd ** -0.5),
        int(causal), _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.dstack_cuda_error_string(rc).decode())
    LAUNCHES[name] += 1


def _flash_fwd_cuda(q, k, v, causal: bool):
    _check_cuda(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    if q.numel():
        _launch("flash_fwd", (q, k, v, o, lse), causal)
    return o, lse


def _ring_block_cuda(q, k, v, causal: bool):
    """The ring step's kernel: q and k/v shards of equal S (the ring's)."""
    _check_cuda(q, k, v)
    o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    m = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    if q.numel():
        _launch("flash_block_fwd", (q, k, v, o, m, l), causal)
    return o, m, l


def _flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal: bool):
    _check_cuda(q, k, v, do)
    _check_stats(q, lse, delta)
    dq = torch.empty_like(q)
    if q.numel():
        _launch("flash_bwd_dq", (q, k, v, do, lse, delta, dq), causal)
    return dq


def _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal: bool):
    _check_cuda(q, k, v, do)
    _check_stats(q, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel():
        _launch("flash_bwd_dkv", (q, k, v, do, lse, delta, dk, dv), causal)
    return dk, dv


# ------------------------------------------------------------ autograd seam


class _Flash(torch.autograd.Function):
    """The reference's `_flash` custom VJP (:390-408) on (B*H, S, hd):
    forward saves q, k, v, o and lse; backward computes delta =
    rowsum(dO * O) in f32 with plain torch (as `_flash_bwd` :403), then
    dQ, then dK/dV. CPU tensors run the plain versions, CUDA tensors the
    kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        fwd = _flash_fwd_cuda if q.is_cuda else _flash_fwd_plain
        o, lse = fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.to(torch.float32) * o.to(torch.float32)).sum(dim=-1)
        if q.is_cuda:
            dq = _flash_bwd_dq_cuda(q, k, v, do, lse, delta, ctx.causal)
            dk, dv = _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, ctx.causal)
        else:
            dq, dk, dv = _flash_bwd_plain(q, k, v, o, lse, do, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Drop-in for `plain_attention`: q (B, S, H, hd), k/v (B, S, KV, hd)
    -> (B, S, H, hd). GQA is expanded outside the autograd Function, so
    autograd sums dK/dV over each query-head group."""
    b, s, h, hd = q.shape
    n_rep = h // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)

    def to_bh(x):  # (B, S, H, hd) -> (B*H, S, hd), contiguous
        return x.transpose(1, 2).reshape(b * h, s, hd).contiguous()

    o = _Flash.apply(to_bh(q), to_bh(k), to_bh(v), causal)
    return o.reshape(b, h, s, hd).transpose(1, 2)


class _RingBlock(torch.autograd.Function):
    """The reference's `_ring_block` custom VJP (:480-522) on (B*H, S, hd):
    forward returns the step's (o, m, l), from the kernel for CUDA tensors
    and from `_block_ref_bh` for CPU ones, and saves q, k, v. Backward
    recomputes `_block_ref_bh` under autograd and pulls the cotangents of
    all three outputs through it (:514-519); the reference has no backward
    kernel for this step, so this is its design, not a fallback. The
    recompute holds the step's (Sq, Sk) f32 logits, the reference's own
    known limit (:447-452)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        fwd = _ring_block_cuda if q.is_cuda else _block_ref_bh
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return fwd(q, k, v, causal)

    @staticmethod
    def backward(ctx, do, dm, dl):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [x.detach().requires_grad_() for x in (q, k, v)]
            outs = _block_ref_bh(*qkv, ctx.causal)
            dq, dk, dv = torch.autograd.grad(outs, qkv, (do, dm, dl))
        return dq, dk, dv, None


def flash_block_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool):
    """One ring step's partials: q (B, Sq, H, hd), k/v (B, Sk, H, hd)
    already GQA-expanded -> o (B, Sq, H, hd) f32 unnormalised, m and l
    (B, H, Sq). The kernel takes Sq == Sk only (the ring's equal shards,
    the only case the reference launches its kernel for); the plain
    version on the CPU takes any Sk when not causal."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    # The kernel's causal mask is the absolute row >= col diagonal, which
    # equals the ring's shifted tril only for equal shards.
    assert not causal or sq == sk, (sq, sk)

    def to_bh(x, s):
        return x.transpose(1, 2).reshape(b * h, s, hd).contiguous()

    o, m, l = _RingBlock.apply(to_bh(q, sq), to_bh(k, sk), to_bh(v, sk), causal)
    o = o.reshape(b, h, sq, hd).transpose(1, 2)
    return o, m.reshape(b, h, sq), l.reshape(b, h, sq)
