"""Attention (port of `dstack_tpu.workloads.attention`): the GQA head
repeat, the per-row-masked decode attention of the dense reference
engine, the plain full-sequence attention, the ring over a sequence-
sharded mesh, and `make_attention_fn`, which picks the path for a mesh.

The ring comes in two forms. On the one-device seq mesh its n sequence
shards take turns on one device: the same per-step math and the same
merge, in the same order, as the reference's `shard_map` over n devices,
where the "hop" of K/V to the next device is here the read of the next
shard's slice. On a training mesh over ranks with a seq axis of n
(`_RankRing`) each rank holds one shard and the K/V hops travel between
the ranks of its seq line (`sharding.ppermute`), forward and, for the
reverse ring of the backward, with the dK/dV accumulators. Each step runs
the ring-step kernel on a CUDA device and the plain `_block_attend` on
the CPU (as the reference does off the TPU).

On a training mesh over ranks with seq 1 attention is the one-device path
on the rank's own rows and heads: the flash kernels at B/(data*fsdp) rows
and H/model q with KV/model KV heads. The reference's Pallas kernel has
no SPMD partitioning rule (`dstack_tpu/workloads/flash_attention.py:94-103`);
the port launches its kernels on each rank's own heads (ROADMAP Queue 3).
The ring over ranks composes with model (a rank attends with its heads)
and with data and fsdp (its rows).

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


def _block_attend(q, k, v, mask):
    """One ring step's plain partials (`_block_attend` :94): q (B, Sq, H,
    hd), k/v (B, Sk, H, hd) GQA-expanded, mask (Sq, Sk) bool or None ->
    unnormalised o (B, Sq, H, hd) f32, m and l (B, H, Sq). P is rounded to
    v.dtype before PV, as the reference rounds it."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    # Floor fully masked rows, as the reference guards its first ring steps.
    m = torch.clamp(logits.amax(dim=-1), min=NEG_INF / 2)
    p = torch.exp(logits - m[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).to(torch.float32),
                     v.to(torch.float32))
    return o, m, p.sum(dim=-1)


def _ring_attention_local(q, k, v, *, n_shards: int, causal: bool):
    """The ring (`_ring_attention_local` :138-230) over `n_shards` equal
    sequence shards of q (B, S, H, hd), k/v (B, S, KV, hd), on q's device.

    Query shard i at ring step t reads K/V shard j = (i - t) mod n: a later
    shard is empty, shard i is its causal diagonal, an earlier one is read
    in full. The empty steps, which all come after the diagonal (t = 0), are
    skipped: merging the reference's empty partials (o = 0, m = NEG_INF/2,
    l = 0) into a merged diagonal is an exact no-op, forward and backward.
    Each step's partials merge into (o, m, l) in the reference's t order,
    so f32 results follow it operation for operation."""
    from dstack_tpu_torch.workloads.flash_attention import flash_block_attend, use_flash

    b, s, h, hd = q.shape
    if s % n_shards:
        raise ValueError(f"sequence length {s} does not split into {n_shards} shards")
    ss = s // n_shards
    # One expansion for the whole sequence (the reference expands each
    # hop's shard); autograd sums dK/dV over each group.
    n_rep = h // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    kernel = use_flash(ss, hd, q.device)
    tril = (torch.ones((ss, ss), dtype=torch.bool, device=q.device).tril()
            if causal and not kernel else None)
    outs = []
    for i in range(n_shards):
        qi = q[:, i * ss:(i + 1) * ss]
        o = torch.zeros((b, ss, h, hd), dtype=torch.float32, device=q.device)
        m = torch.full((b, h, ss), NEG_INF / 2, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, ss), dtype=torch.float32, device=q.device)
        for t in range(n_shards):
            j = (i - t) % n_shards
            if causal and j > i:
                continue
            kj, vj = k[:, j * ss:(j + 1) * ss], v[:, j * ss:(j + 1) * ss]
            diag = causal and j == i
            if kernel:
                blk_o, blk_m, blk_l = flash_block_attend(qi, kj, vj, causal=diag)
            else:
                blk_o, blk_m, blk_l = _block_attend(qi, kj, vj, tril if diag else None)
            o, m, l = _merge(o, m, l, blk_o, blk_m, blk_l)
        o = o / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
        outs.append(o.to(q.dtype))
    return torch.cat(outs, dim=1)


def _merge(o, m, l, blk_o, blk_m, blk_l):
    """The streaming-softmax merge of a step's partials into (o, m, l)."""
    m_new = torch.maximum(m, blk_m)
    alpha = torch.exp(m - m_new)
    beta = torch.exp(blk_m - m_new)
    l = l * alpha + blk_l * beta
    o = o * alpha.transpose(1, 2)[..., None] + blk_o * beta.transpose(1, 2)[..., None]
    return o, m_new, l


class _RankRing(torch.autograd.Function):
    """The ring over the ranks of a training mesh's seq axis (the
    reference's `_ring_attention_local` under `shard_map`, :138-230): q
    (B, S, H, hd) and k/v (B, S, KV, hd) are this rank's shard i of n.

    Forward: at step t the rank holds K/V shard j = (i - t) mod n and
    attends it with the ring-step kernel on a CUDA tensor (causal on the
    diagonal, full on an earlier shard) or the plain `_block_attend` on
    the CPU, merging the partials in the reference's t order. K/V travel
    unexpanded (1/n_rep of the bytes) and are GQA-expanded for the local
    step only. A later shard is empty on a causal ring: its step skips the
    compute, never the hop, so every rank makes the same n - 1 hops (the
    reference makes n; its last brings the shard home unused). Saves q,
    the own K/V, the output and the merged lse = m + log l.

    Backward: the reverse ring, the same on every rank. K/V travel the
    ring again with f32 dK/dV accumulators; at step t the rank adds its
    contribution to the accumulator of shard (i - t) mod n, and the n-th
    hop (accumulators only) brings each accumulator home. A step's
    contribution is the plain math of its block from the saved final lse
    and delta = rowsum(dO * O): P = exp(S * scale - lse), dS = P (dO V^T -
    delta), dQ += dS K scale, dK += dS^T Q scale, dV += P^T dO. The
    reference recomputes each step's partials and pulls the cotangents of
    (o, m, l) through `_block_ref_bh`'s vjp (flash_attention.py:462-516);
    this is the same gradient in another order (for bf16 inputs it also
    keeps P in f32 where the forward kernel rounds it, as the flash
    backward does). Kernels #3/#4 do not run here (ROADMAP P3).

    Every hop of both directions lives inside this Function, so a rank
    whose later shards reach no loss (rank 0 of a causal ring) still makes
    every hop its neighbours wait for: nothing is left to the autograd
    engine to reach or skip."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, causal: bool):
        from dstack_tpu_torch.workloads.flash_attention import flash_block_attend, use_flash
        from dstack_tpu_torch.workloads.sharding import ppermute

        b, s, h, hd = q.shape
        n, i = mesh.shape["seq"], mesh.coords["seq"]
        n_rep = h // k.shape[2]
        kernel = use_flash(s, hd, q.device)
        tril = (torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
                if causal and not kernel else None)
        o = torch.zeros((b, s, h, hd), dtype=torch.float32, device=q.device)
        m = torch.full((b, h, s), NEG_INF / 2, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
        kv = [k, v]
        for t in range(n):
            j = (i - t) % n
            if not (causal and j > i):
                diag = causal and j == i
                ke, ve = (_repeat_kv(x, n_rep) for x in kv)
                if kernel:
                    blk = flash_block_attend(q, ke, ve, causal=diag)
                else:
                    blk = _block_attend(q, ke, ve, tril if diag else None)
                o, m, l = _merge(o, m, l, *blk)
            if t < n - 1:
                kv = ppermute(kv, mesh, "seq")
        l = torch.clamp(l, min=1e-30)
        out = (o / l.transpose(1, 2)[..., None]).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.mesh, ctx.causal = mesh, causal
        return out

    @staticmethod
    def backward(ctx, do):
        from dstack_tpu_torch.workloads.sharding import ppermute

        q, k, v, out, lse = ctx.saved_tensors
        mesh, causal = ctx.mesh, ctx.causal
        b, s, h, hd = q.shape
        n_kv = k.shape[2]
        n_rep = h // n_kv
        n, i = mesh.shape["seq"], mesh.coords["seq"]
        scale = hd ** -0.5
        qf, dof = q.to(torch.float32), do.to(torch.float32)
        delta = (dof * out.to(torch.float32)).sum(dim=-1).transpose(1, 2)  # (B, H, S)
        tril = (torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
                if causal else None)
        dq = torch.zeros((b, s, h, hd), dtype=torch.float32, device=q.device)
        kv = [k, v]
        acc = [torch.zeros((b, s, n_kv, hd), dtype=torch.float32, device=q.device)
               for _ in range(2)]
        for t in range(n):
            j = (i - t) % n
            if not (causal and j > i):
                ke, ve = (_repeat_kv(x, n_rep).to(torch.float32) for x in kv)
                logits = torch.einsum("bqhd,bkhd->bhqk", qf, ke) * scale
                if causal and j == i:
                    logits = torch.where(tril, logits, torch.full_like(logits, NEG_INF))
                p = torch.exp(logits - lse[..., None])
                dp = torch.einsum("bqhd,bkhd->bhqk", dof, ve)
                ds = p * (dp - delta[..., None])
                dq += torch.einsum("bhqk,bkhd->bqhd", ds, ke) * scale
                dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
                dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
                acc[0] += dk.reshape(b, s, n_kv, n_rep, hd).sum(dim=3)
                acc[1] += dv.reshape(b, s, n_kv, n_rep, hd).sum(dim=3)
            if t < n - 1:
                moved = ppermute(kv + acc, mesh, "seq")
                kv, acc = moved[:2], moved[2:]
            else:
                acc = _RankRing.home(acc, mesh)
        return dq.to(q.dtype), acc[0].to(k.dtype), acc[1].to(v.dtype), None, None

    @staticmethod
    def home(acc, mesh):
        """The backward's n-th hop: the dK/dV accumulators, each one hop
        from its shard's rank, travel that hop home."""
        from dstack_tpu_torch.workloads.sharding import ppermute

        return ppermute(acc, mesh, "seq")


def make_attention_fn(mesh: Optional[Any] = None, *, seq_axis: str = "seq",
                      causal: bool = True):
    """The attention for a mesh. No mesh, or a `seq` axis of size 1 (a
    training mesh over ranks too, on the rank's rows and heads): the
    single-device path, which runs the flash kernels on a CUDA device and
    `plain_attention` on the CPU (as the JAX package does off the TPU). A
    `seq` axis of n > 1 in `mesh.shape` (axis -> size): on a training mesh
    over ranks the ring across them (`_RankRing`), else the ring over n
    sequence shards on the one device (`_ring_attention_local`)."""
    n_shards = dict(mesh.shape).get(seq_axis, 1) if mesh is not None else 1
    if n_shards > 1 and getattr(mesh, "training", False):
        return _make_ring(n_shards, causal, mesh)
    if n_shards > 1:
        return _make_ring(n_shards, causal)

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


def _make_ring(n_shards: int, causal: bool, mesh=None):
    def ring(q, k, v):
        if mesh is not None:  # this rank's shard; the others are its neighbours'
            return _RankRing.apply(q, k, v, mesh, causal)
        return _ring_attention_local(q, k, v, n_shards=n_shards, causal=causal)

    def _ring_quadratic(seq_len: int, head_dim: int, dtype_bytes: int = 2,
                        device=None) -> bool:
        # The reference's gate on the local block (`_ring_quadratic`
        # :292-306), from the whole sequence's length: the ring-step kernel
        # keeps a step's scores out of memory; the plain steps on the CPU
        # save f32 (Sq, Sk) residuals for each step.
        from dstack_tpu_torch.workloads.flash_attention import use_flash

        return not use_flash(max(seq_len // n_shards, 1), head_dim, device or "cpu")

    ring.memory_is_quadratic = _ring_quadratic
    return ring
