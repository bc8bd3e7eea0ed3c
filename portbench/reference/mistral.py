"""Mistral-7B / Mixtral-8x7B forward in plain PyTorch, float32, TF32 off.

The published decoder (Mistral AI's `MistralForCausalLM` and
`MixtralForCausalLM`): token embedding; per layer RMSNorm pre-norm, q/k/v
projections without bias, rotary embedding on q and k in the
rotate-half form (theta from the config), causal grouped-query
attention, output projection, residual; RMSNorm, then a SwiGLU MLP
(silu(x W_gate) * (x W_up)) W_down, or for Mixtral a router (softmax over
the experts, the top-k taken, their weights renormalised to sum to 1)
and the sum of the chosen experts' SwiGLU outputs times their weights;
residual; a final RMSNorm and an untied lm-head. The sliding window is
null in both configs, so attention is full causal.

It runs one sequence at a time, layer by layer, each layer's weights
upcast to f32 only while that layer runs, attention over blocks of query
heads, so it fits on the card beside nothing but the weights. Of two
equal router probabilities the lower expert index is taken first. `s`
is the family's shapes (`families/mistral.py` `Shapes`).

`quant="bf16"` is a witness, not a control: every linear layer takes its
input rounded to bf16 and multiplies in bf16 (f32 accumulation), the
precision the program serves in, everything else as above.

`quant="fp8"` is the control: every linear layer (q, k, v, o, the MLP or
each expert's three, the lm-head) takes its weight quantized to
float8 e4m3 per output column and its input per row, the W8A8 product a
serving stack on this card would be tempted to run; the router stays in
f32.
"""

from typing import Any, Dict, Optional, Sequence

import torch

FP8_MAX = 448.0


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along `dim`
    (the amax over `dim` maps to the format's largest value), back in f32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _linear(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    if quant == "bf16":
        return (x.to(torch.bfloat16) @ w.to(torch.bfloat16)).to(torch.float32)
    w = w.to(torch.float32)
    if quant == "fp8":
        return _fp8(x, -1) @ _fp8(w, 0)
    return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.to(torch.float32)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, H, hd) at positions 0..T-1, rotate-half form."""
    T, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, head_block: int) -> torch.Tensor:
    """Causal GQA attention: q (T, H, hd), k and v (T, KV, hd) -> (T, H*hd)."""
    T, H, hd = q.shape
    group = H // k.shape[1]
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    out = torch.empty(T, H, hd, dtype=torch.float32, device=q.device)
    for h0 in range(0, H, head_block):
        hs = range(h0, min(h0 + head_block, H))
        qb = q[:, hs.start:hs.stop].transpose(0, 1)                  # (h, T, hd)
        kb = k[:, [h // group for h in hs]].transpose(0, 1)
        vb = v[:, [h // group for h in hs]].transpose(0, 1)
        s = (qb @ kb.transpose(1, 2)) * hd ** -0.5
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        out[:, hs.start:hs.stop] = (p @ vb).transpose(0, 1)
    return out.reshape(T, H * hd)


def swiglu(h, w_gate, w_up, w_down, quant):
    g = _linear(h, w_gate, quant)
    return _linear(torch.nn.functional.silu(g) * _linear(h, w_up, quant), w_down, quant)


def moe(s, h: torch.Tensor, lw: Dict[str, torch.Tensor], quant) -> torch.Tensor:
    probs = torch.softmax(h @ lw["router"].to(torch.float32), dim=-1)     # (T, E)
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    idx = order[:, : s.experts_per_token]
    gate = torch.gather(probs, -1, idx)
    gate = gate / gate.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(s.experts):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            y = swiglu(h[tok], lw["we_gate"][e], lw["we_up"][e], lw["we_down"][e], quant)
            out.index_add_(0, tok, gate[tok, slot, None] * y)
    return out


@torch.no_grad()
def logits(s, w: Dict[str, Any], tokens: Sequence[int], rows: Sequence[int],
           quant: Optional[str] = None, head_block: int = 8) -> torch.Tensor:
    """f32 logits (len(rows), V) at positions `rows` of the causal forward
    over `tokens` (a list of ids), on the weights' device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = w["embed"].device
    ids = torch.as_tensor(list(tokens), dtype=torch.long, device=dev)
    T, H, KV, hd = ids.numel(), s.heads, s.kv_heads, s.head_dim
    x = w["embed"][ids].to(torch.float32)
    L = w["layers"]
    for layer in range(s.layers):
        lw = {k: v[layer] for k, v in L.items()}
        h = rms_norm(x, lw["attn_norm"], s.norm_eps)
        q = rope(_linear(h, lw["wq"], quant).reshape(T, H, hd), s.rope_theta)
        k = rope(_linear(h, lw["wk"], quant).reshape(T, KV, hd), s.rope_theta)
        v = _linear(h, lw["wv"], quant).reshape(T, KV, hd)
        x = x + _linear(attention(q, k, v, head_block), lw["wo"], quant)
        h = rms_norm(x, lw["mlp_norm"], s.norm_eps)
        if s.experts:
            x = x + moe(s, h, lw, quant)
        else:
            x = x + swiglu(h, lw["w_gate"], lw["w_up"], lw["w_down"], quant)
    sel = torch.as_tensor(list(rows), dtype=torch.long, device=dev)
    h = rms_norm(x[sel], w["final_norm"], s.norm_eps)
    return _linear(h, w["lm_head"], quant)
