"""Sparse mixture-of-experts MLP in PyTorch (port of
`dstack_tpu.workloads.moe`, one device).

The reference's functions one for one. Routing builds the GShard/Switch
dispatch: a top-k over the router's softmax, slots handed out by one
cumsum over the choice-major token axis (every first choice is placed
before any second choice), and `slot >= C` for a token its expert has no
room for. A dropped token falls out of the dispatch and keeps its
residual value. Two interchangeable dispatches (`config.moe_impl`):

- "einsum": dense dispatch/combine tensors (B, S, E, C) and products;
- "gather": the same slot permutation applied with gathers and one small
  integer scatter; the gate multiply stays f32.

Numerics are the reference's. The router product runs in f32, never TF32:
routing is discontinuous, and a TF32 router flips top-k near-ties, so a
CUDA router refuses to run while `torch.backends.cuda.matmul.allow_tf32`
is set. The einsum path casts dispatch and combine to the activation
dtype, so its combine rounds the gate to bf16, where the gather path
keeps it f32: in bf16 the two are slightly different functions.

Tensor-parallel serving: on a `model` mesh the expert banks carry their
output columns per rank (`we_*` take "model" on their last dim) and the
router is replicated, so the expert FFN gathers where the dense MLP does.
On a serving mesh with an expert axis each rank's banks also hold only its
block of E/expert experts (`we_*` take "expert" on their expert dim): every
rank holds every token and routes it alike, dispatches only to its own
experts, runs them (gathering over model inside the bank, as above), and
gathers the experts' outputs over the expert line
(`sharding.gather_experts`, with no autograd there) before the combine, which
runs in the unsharded order on every rank. Gathers move bits, so each
expert's products are the unsharded ones and the combine is the same sum
in the same order: an f32 engine on the CPU gives the unsharded engine's
streams token for token. The reference's GSPMD program is free to place
the combine's sum elsewhere (a partial sum per expert shard, then a
psum); its expert-mesh engine gave the one-device streams on the CPU too
(tests/test_torch_serving_expert.py).

Training across ranks (a training mesh, sharding.py): the reference's
layout, where the batch rides (data, fsdp) only and the expert inputs and
outputs are constrained to P("expert", ("data", "fsdp"), None, None)
(`moe.py:150-154`). Every rank of an expert line holds the same tokens and
routes them alike from the replicated router; it dispatches only to its
own block of E/expert experts (`sharding.expert_block`), runs its banks
(Megatron's pair on a model axis: `enter_model` before the gate and up
products, `reduce_model` after we_down; the fsdp dims come whole through
`gather_layer`), and gathers every expert's output (`gather_experts`)
before the combine, which runs whole on every rank. The tokens that enter
the experts go through `enter_expert`, whose backward sums their grad over
the line; the router's input does not (its grad is already whole on every
rank). The forward's gathers move bits, so a rank's output equals the
unsharded one. The router aux on a training mesh is a rank's share of the
reference's global Switch loss (`switch_aux`): the shares summed over the
batch axes give the global value and its grad.

A seq axis over ranks: a seq rank holds one stretch of each batch row,
while the reference routes a row over its whole sequence (GSPMD runs the
cumsum and the capacity across the shards). So a rank takes C from the
whole length (`row_capacity`), and a token's slot is where the row's one
choice-major cumsum would put it: the local running count of its choice
of that expert, plus the picks of that expert as that choice on the seq
ranks before this one, plus its picks as every earlier choice over the
whole row (`slot_offsets`: one all-gather over the seq line of the
rank's (B, k, E) integer counts a layer, no grad). The expert FFN works
row by row, so a rank runs only its own tokens, at their global slots,
and no token crosses ranks; each rank still runs all E*C slot rows, most
of them empty (ROADMAP: compact a seq rank's slots).
There is no kernel here: the reference computes these products in XLA.
"""

import math
from typing import Any, Dict, Tuple

import torch

from dstack_tpu_torch.workloads.config import ModelConfig
from dstack_tpu_torch.workloads.quant import QTensor, dequantize_tensor
from dstack_tpu_torch.workloads.sharding import (
    all_gather,
    batch_sum,
    enter_expert,
    enter_model,
    expert_block,
    gather_axes,
    gather_experts,
    reduce_model,
    seq_ranks,
)

Params = Dict[str, Any]


def expert_capacity(c: ModelConfig, seq_len: int) -> int:
    """Per-expert slot count for one batch row's sequence (static)."""
    return max(1, int(math.ceil(
        c.experts_per_token * seq_len * c.capacity_factor / c.n_experts)))


def row_capacity(c: ModelConfig, s_local: int, mesh=None) -> int:
    """expert_capacity of a batch row whose `s_local` positions are this
    rank's stretch of seq_ranks(mesh) equal stretches (the whole row off a
    seq axis of ranks)."""
    return expert_capacity(c, s_local * seq_ranks(mesh))


def slot_offsets(counts: torch.Tensor, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(earlier_ranks, earlier_choices), each (B, k, E), from this rank's
    picks `counts` (B, k, E) of each expert as each choice: the picks of
    expert e as choice j on the seq ranks before this one, and the picks
    of e as any choice before j over the whole row. One all-gather over
    the seq line of a training mesh (integers, no grad); without a seq
    axis of ranks the first is 0 and the second comes from `counts`."""
    n = seq_ranks(mesh)
    every = gather_axes(counts[None], 0, mesh, ("seq",)) if n > 1 else counts[None]
    earlier_ranks = every[:mesh.coords["seq"]].sum(dim=0) if n > 1 else torch.zeros_like(counts)
    total = every.sum(dim=0)
    return earlier_ranks, torch.cumsum(total, dim=1) - total


def _router_logits(h: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """(B, S, D) x (D, E) -> f32 logits, the product in full f32."""
    if h.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "MoE routing needs full-f32 products: a TF32 router flips top-k"
            " near-ties; set torch.backends.cuda.matmul.allow_tf32 = False")
    return torch.matmul(h.to(torch.float32), router.to(torch.float32))


def route_assignments(c: ModelConfig, h: torch.Tensor, router: torch.Tensor,
                      mesh=None) -> Tuple[torch.Tensor, ...]:
    """Top-k routing -> (gate_vals (B,S,k) f32, gate_idx (B,S,k) int64,
    slot (B,S,k) int64, sel (B,S,k,E) f32 one-hot, aux 0-d f32).
    slot >= C marks a dropped token.

    The top-k is a stable descending sort, so of two equal probabilities
    the lower expert index comes first, as `lax.top_k` orders them.
    Gradients flow through gate_vals and the aux loss's mean
    probabilities. On a training `mesh` the aux is this rank's share
    (`switch_aux`)."""
    probs = torch.softmax(_router_logits(h, router), dim=-1)      # (B,S,E) f32
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    return assign_slots(c, probs, order[..., :c.experts_per_token], mesh)


def switch_aux(probs: torch.Tensor, sel: torch.Tensor, mesh=None) -> torch.Tensor:
    """The Switch load-balance loss E * sum_e mean_prob_e * top1_share_e,
    its means over the (B, S) tokens of `probs` (B,S,E) and the first
    choices `sel[:, :, 0]`. On a training mesh over ranks the means are
    the global batch's and a rank returns its share: the top-1 counts
    summed over the batch axes (no grad; their total is the global token
    count N, every token having one first choice), and the share
    E * sum_e (sum of this rank's probs_e / N) * top1_share_e. The shares
    summed over data x fsdp x seq are the global loss, and so are their
    grads."""
    E = probs.shape[-1]
    top1 = sel[:, :, 0, :]
    if mesh is None or not mesh.training:
        return float(E) * torch.sum(probs.mean(dim=(0, 1)) * top1.mean(dim=(0, 1)))
    counts = batch_sum(top1.sum(dim=(0, 1)), mesh)
    n = counts.sum()
    return float(E) * torch.sum(probs.sum(dim=(0, 1)) / n * (counts / n))


def assign_slots(c: ModelConfig, probs: torch.Tensor, gate_idx: torch.Tensor,
                 mesh=None) -> Tuple[torch.Tensor, ...]:
    """route_assignments' outputs for router probabilities `probs`
    (B,S,E) f32 and a choice of experts `gate_idx` (B,S,k): the gate
    renormalised with max(sum, 1e-9), the slots of the reference's one
    integer cumsum over the row's choice-major token axis (every first
    choice is placed before any second choice; exact at any length) as a
    running count per choice along the sequence plus `slot_offsets` (the
    whole row's on a seq rank), and the Switch aux loss (`switch_aux`, a
    rank's share on a training `mesh`)."""
    B, S, E = probs.shape
    k = gate_idx.shape[-1]
    gate_vals = torch.gather(probs, -1, gate_idx)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    # One-hot by comparison: F.one_hot checks its input on the host.
    sel_i = (gate_idx[..., None] == torch.arange(E, device=probs.device)).long()
    # Choice-major: every pick of an expert as choice j comes after all its
    # picks as earlier choices, and in sequence order within choice j.
    running = torch.cumsum(sel_i, dim=1)                           # (B,S,k,E)
    earlier_ranks, earlier_choices = slot_offsets(running[:, -1], mesh)
    pos = running - 1 + (earlier_ranks + earlier_choices)[:, None]
    slot = (pos * sel_i).sum(dim=-1)                               # (B,S,k)
    sel = sel_i.to(torch.float32)
    return gate_vals, gate_idx, slot, sel, switch_aux(probs, sel, mesh)


def _slot_one_hot(slot: torch.Tensor, C: int) -> torch.Tensor:
    """one_hot(slot, C) in f32, the zero row where slot >= C (a drop)."""
    return (slot[..., None] == torch.arange(C, device=slot.device)).to(torch.float32)


def route(c: ModelConfig, h: torch.Tensor, router: torch.Tensor, mesh=None
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing -> (dispatch (B,S,E,C), combine (B,S,E,C), aux); C
    is the whole row's (`row_capacity`)."""
    C = row_capacity(c, h.shape[1], mesh)
    gate_vals, _, slot, sel, aux = route_assignments(c, h, router, mesh)
    slot_oh = _slot_one_hot(slot, C)                               # (B,S,k,C)
    dispatch = torch.einsum("bske,bskc->bsec", sel, slot_oh)
    combine = torch.einsum("bsk,bske,bskc->bsec", gate_vals, sel, slot_oh)
    return dispatch, combine, aux


class _BmmF32(torch.autograd.Function):
    """bf16 x bf16 -> f32 batched product on the card, without an f32
    copy of the bank (`torch.bmm(..., out_dtype=)` has no autograd
    formula). Backward takes the f32 cotangent to the operands' dtype and
    returns grads in it, with f32 accumulation inside the product."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.bmm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gx = torch.bmm(g, w.transpose(1, 2)) if ctx.needs_input_grad[0] else None
        gw = torch.bmm(x.transpose(1, 2), g) if ctx.needs_input_grad[1] else None
        return gx, gw


def _bmm_f32_result(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E, N, D) x (E, D, F) -> (E, N, F) f32: the reference's
    `preferred_element_type=f32` product. The device decides how: on the
    card a bf16 product with an f32 result (_BmmF32); on the CPU, which
    has no such overload, the operands upcast (exact) and multiply in f32.
    An f32 model multiplies in f32 on either."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return torch.bmm(x, w)
    if x.is_cuda and x.dtype == w.dtype:
        return _BmmF32.apply(x, w)
    return torch.bmm(x.to(torch.float32), w.to(torch.float32))


def _bank(w, dtype: torch.dtype) -> torch.Tensor:
    """An expert bank in the activation dtype: an int8 QTensor bank is
    dequantized to `dtype` first, as the reference does (not the f32
    product that `transformer.linear` uses for a QTensor)."""
    return dequantize_tensor(w, dtype) if isinstance(w, QTensor) else w


def _expert_ffn(h_dtype: torch.dtype, expert_in: torch.Tensor, p: Params,
                mesh=None) -> torch.Tensor:
    """SwiGLU over the expert bank: (E,B,C,D) -> (E,B,C,D). The gate
    product has an f32 result and silu runs in f32, cast back; the up and
    down products are in the activation dtype. On a serving model `mesh`
    each bank holds a rank's output columns: the activation is gathered
    before we_down and we_down's output after it, as the dense MLP's. On
    a training mesh the banks follow PARAM_SPECS (gate/up column-parallel
    and down row-parallel on model): Megatron's pair, as the dense MLP's."""
    training = mesh is not None and mesh.training
    E, B, C, D = expert_in.shape
    x = (enter_model(expert_in, mesh) if training else expert_in).reshape(E, B * C, D)
    gate = _bmm_f32_result(x, _bank(p["we_gate"], h_dtype))
    up = torch.bmm(x, _bank(p["we_up"], h_dtype))
    act = torch.nn.functional.silu(gate).to(h_dtype) * up
    if training:
        out = reduce_model(torch.bmm(act, _bank(p["we_down"], h_dtype)), mesh)
    else:
        act = all_gather(act, -1, mesh)
        out = all_gather(torch.bmm(act, _bank(p["we_down"], h_dtype)), -1, mesh)
    return out.reshape(E, B, C, -1)


def moe_mlp(c: ModelConfig, h: torch.Tensor, p: Params, mesh=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed SwiGLU experts on a normed input h -> (out, aux_loss).

    p carries router (D,E) f32, we_gate/we_up (E,D,F), we_down (E,F,D).
    `config.moe_impl` picks the dispatch: "einsum" (dense dispatch and
    combine products, 2*E*C*D FLOPs a token each way) or "gather" (the
    same permutation by gathers, no dispatch FLOPs). The router is
    replicated, so every rank of a `mesh` routes alike; on a serving mesh
    the banks are column slices (`_expert_ffn`); on a training mesh, and
    on a serving mesh with an expert axis, a rank dispatches to its block
    of experts and gathers their outputs (module docstring)."""
    if c.moe_impl == "gather":
        return _moe_mlp_gather(c, h, p, mesh)
    if c.moe_impl != "einsum":
        raise ValueError(f'moe_impl={c.moe_impl!r}: expected "einsum" or "gather"')
    dispatch, combine, aux = route(c, h, p["router"], mesh)
    e0, e1 = expert_block(c.n_experts, mesh)
    expert_in = torch.einsum("bsec,bsd->ebcd", dispatch[:, :, e0:e1].to(h.dtype),
                             enter_expert(h, mesh))
    expert_out = gather_experts(_expert_ffn(h.dtype, expert_in, p, mesh), 0, mesh)
    out = torch.einsum("bsec,ebcd->bsd", combine.to(h.dtype), expert_out)
    return out, aux


def _moe_mlp_gather(c: ModelConfig, h: torch.Tensor, p: Params, mesh=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather dispatch: the einsum path's permutation without its FLOPs.

    The inverse slot permutation (source token of each expert slot) comes
    from one integer scatter; rows move by gathers. Dropped tokens aim at
    a dummy column E*C (sliced off) going in and a zero pad row coming
    back, so they contribute 0 as in the einsum path; empty slots read
    the zero pad row S. The gate multiply stays f32. On a training mesh a
    rank gathers the source rows of its own experts' slots only; on a seq
    rank the slots its tokens do not hold read the pad row."""
    B, S, D = h.shape
    E, k = c.n_experts, c.experts_per_token
    C = row_capacity(c, S, mesh)
    gate_vals, gate_idx, slot, _, aux = route_assignments(c, h, p["router"], mesh)
    e0, e1 = expert_block(E, mesh)

    # Flat slot id; an overflowing choice writes the trailing dummy column.
    sid = torch.where(slot < C, gate_idx * C + slot, torch.full_like(slot, E * C))
    s_ix = torch.arange(S, device=h.device)[None, :, None].expand(B, S, k)
    # src[b, e*C+c] = s. A slot goes to at most one token (the cumsum), so
    # only the dummy column sees several writes.
    src = torch.full((B, E * C + 1), S, dtype=torch.int64, device=h.device)
    src = src.scatter(1, sid.reshape(B, S * k), s_ix.reshape(B, S * k))[:, e0 * C:e1 * C]

    h_in = enter_expert(h, mesh)
    h_pad = torch.cat([h_in, h_in.new_zeros(B, 1, D)], dim=1)
    expert_in = torch.gather(h_pad, 1, src[:, :, None].expand(B, (e1 - e0) * C, D))
    expert_in = expert_in.reshape(B, e1 - e0, C, D).transpose(0, 1)
    expert_out = gather_experts(_expert_ffn(h.dtype, expert_in, p, mesh), 0, mesh)

    flat = expert_out.transpose(0, 1).reshape(B, E * C, D)
    flat = torch.cat([flat, flat.new_zeros(B, 1, D)], dim=1)
    gathered = torch.gather(flat, 1, sid.reshape(B, S * k, 1).expand(B, S * k, D))
    gathered = gathered.reshape(B, S, k, D)   # overflow ids read the zero row
    out = torch.sum(gate_vals[..., None] * gathered.to(torch.float32), dim=2)
    return out.to(h.dtype), aux


def moe_block(c: ModelConfig, x: torch.Tensor, p: Params, mesh=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm MoE block with residual: x -> (x + moe(norm(x)), aux)."""
    from dstack_tpu_torch.workloads.transformer import rms_norm

    h = rms_norm(x, p["mlp_norm"], c.norm_eps)
    out, aux = moe_mlp(c, h, p, mesh)
    return x + out, aux
