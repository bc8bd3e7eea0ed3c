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
The expert-parallel layout (the "expert" mesh axis, all-to-all dispatch)
is not ported: `sharding.Mesh` refuses it (ROADMAP Queue 1 item 3).
There is no kernel here: the reference computes these products in XLA.
"""

import math
from typing import Any, Dict, Tuple

import torch

from dstack_tpu_torch.workloads.config import ModelConfig
from dstack_tpu_torch.workloads.quant import QTensor, dequantize_tensor
from dstack_tpu_torch.workloads.sharding import all_gather

Params = Dict[str, Any]


def expert_capacity(c: ModelConfig, seq_len: int) -> int:
    """Per-expert slot count for one batch row's sequence (static)."""
    return max(1, int(math.ceil(
        c.experts_per_token * seq_len * c.capacity_factor / c.n_experts)))


def _router_logits(h: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """(B, S, D) x (D, E) -> f32 logits, the product in full f32."""
    if h.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "MoE routing needs full-f32 products: a TF32 router flips top-k"
            " near-ties; set torch.backends.cuda.matmul.allow_tf32 = False")
    return torch.matmul(h.to(torch.float32), router.to(torch.float32))


def route_assignments(c: ModelConfig, h: torch.Tensor, router: torch.Tensor
                      ) -> Tuple[torch.Tensor, ...]:
    """Top-k routing -> (gate_vals (B,S,k) f32, gate_idx (B,S,k) int64,
    slot (B,S,k) int64, sel (B,S,k,E) f32 one-hot, aux 0-d f32).
    slot >= C marks a dropped token.

    The top-k is a stable descending sort, so of two equal probabilities
    the lower expert index comes first, as `lax.top_k` orders them.
    Gradients flow through gate_vals and the aux loss's mean
    probabilities."""
    probs = torch.softmax(_router_logits(h, router), dim=-1)      # (B,S,E) f32
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    return assign_slots(c, probs, order[..., :c.experts_per_token])


def assign_slots(c: ModelConfig, probs: torch.Tensor, gate_idx: torch.Tensor
                 ) -> Tuple[torch.Tensor, ...]:
    """route_assignments' outputs for router probabilities `probs`
    (B,S,E) f32 and a choice of experts `gate_idx` (B,S,k): the gate
    renormalised with max(sum, 1e-9), the slots from one integer cumsum
    over the choice-major token axis (every first choice is placed before
    any second choice; exact at any length), and the Switch aux loss."""
    B, S, E = probs.shape
    k = gate_idx.shape[-1]
    gate_vals = torch.gather(probs, -1, gate_idx)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    # One-hot by comparison: F.one_hot checks its input on the host.
    sel_i = (gate_idx[..., None] == torch.arange(E, device=probs.device)).long()
    # Choice-major flatten so the cumsum hands out slots first-choices-first.
    sel_flat = sel_i.transpose(1, 2).reshape(B, k * S, E)
    pos_flat = torch.cumsum(sel_flat, dim=1) * sel_flat - 1
    pos = pos_flat.reshape(B, k, S, E).transpose(1, 2)             # (B,S,k,E)
    slot = (pos * sel_i).sum(dim=-1)                               # (B,S,k)
    sel = sel_i.to(torch.float32)

    # Switch-style load-balance loss: E * sum_e mean_prob_e * top1_share_e.
    mean_prob = probs.mean(dim=(0, 1))
    top1_share = sel[:, :, 0, :].mean(dim=(0, 1))
    aux = float(E) * torch.sum(mean_prob * top1_share)
    return gate_vals, gate_idx, slot, sel, aux


def _slot_one_hot(slot: torch.Tensor, C: int) -> torch.Tensor:
    """one_hot(slot, C) in f32, the zero row where slot >= C (a drop)."""
    return (slot[..., None] == torch.arange(C, device=slot.device)).to(torch.float32)


def route(c: ModelConfig, h: torch.Tensor, router: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing -> (dispatch (B,S,E,C), combine (B,S,E,C), aux)."""
    C = expert_capacity(c, h.shape[1])
    gate_vals, _, slot, sel, aux = route_assignments(c, h, router)
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
    down products are in the activation dtype. On a model `mesh` each
    bank holds a rank's output columns: the activation is gathered before
    we_down and we_down's output after it, as the dense MLP's."""
    E, B, C, D = expert_in.shape
    x = expert_in.reshape(E, B * C, D)
    gate = _bmm_f32_result(x, _bank(p["we_gate"], h_dtype))
    up = torch.bmm(x, _bank(p["we_up"], h_dtype))
    act = all_gather(torch.nn.functional.silu(gate).to(h_dtype) * up, -1, mesh)
    out = all_gather(torch.bmm(act, _bank(p["we_down"], h_dtype)), -1, mesh)
    return out.reshape(E, B, C, -1)


def moe_mlp(c: ModelConfig, h: torch.Tensor, p: Params, mesh=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed SwiGLU experts on a normed input h -> (out, aux_loss).

    p carries router (D,E) f32, we_gate/we_up (E,D,F), we_down (E,F,D).
    `config.moe_impl` picks the dispatch: "einsum" (dense dispatch and
    combine products, 2*E*C*D FLOPs a token each way) or "gather" (the
    same permutation by gathers, no dispatch FLOPs). The router is
    replicated, so every rank of a model `mesh` routes alike; the banks
    are column slices (`_expert_ffn`)."""
    if c.moe_impl == "gather":
        return _moe_mlp_gather(c, h, p, mesh)
    if c.moe_impl != "einsum":
        raise ValueError(f'moe_impl={c.moe_impl!r}: expected "einsum" or "gather"')
    dispatch, combine, aux = route(c, h, p["router"])
    expert_in = torch.einsum("bsec,bsd->ebcd", dispatch.to(h.dtype), h)
    expert_out = _expert_ffn(h.dtype, expert_in, p, mesh)
    out = torch.einsum("bsec,ebcd->bsd", combine.to(h.dtype), expert_out)
    return out, aux


def _moe_mlp_gather(c: ModelConfig, h: torch.Tensor, p: Params, mesh=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather dispatch: the einsum path's permutation without its FLOPs.

    The inverse slot permutation (source token of each expert slot) comes
    from one integer scatter; rows move by gathers. Dropped tokens aim at
    a dummy column E*C (sliced off) going in and a zero pad row coming
    back, so they contribute 0 as in the einsum path; empty slots read
    the zero pad row S. The gate multiply stays f32."""
    B, S, D = h.shape
    E, k = c.n_experts, c.experts_per_token
    C = expert_capacity(c, S)
    gate_vals, gate_idx, slot, _, aux = route_assignments(c, h, p["router"])

    # Flat slot id; an overflowing choice writes the trailing dummy column.
    sid = torch.where(slot < C, gate_idx * C + slot, torch.full_like(slot, E * C))
    s_ix = torch.arange(S, device=h.device)[None, :, None].expand(B, S, k)
    # src[b, e*C+c] = s. A slot goes to at most one token (the cumsum), so
    # only the dummy column sees several writes.
    src = torch.full((B, E * C + 1), S, dtype=torch.int64, device=h.device)
    src = src.scatter(1, sid.reshape(B, S * k), s_ix.reshape(B, S * k))[:, :E * C]

    h_pad = torch.cat([h, h.new_zeros(B, 1, D)], dim=1)
    expert_in = torch.gather(h_pad, 1, src[:, :, None].expand(B, E * C, D))
    expert_in = expert_in.reshape(B, E, C, D).transpose(0, 1)
    expert_out = _expert_ffn(h.dtype, expert_in, p, mesh)

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
