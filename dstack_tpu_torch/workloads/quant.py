"""Weight-only int8 quantization for the serving path.

Port of `dstack_tpu.workloads.quant`: symmetric per-output-channel int8,
scale_c = max|W[:, c]| / 127, q = round(W / scale). `transformer.linear`
and `logits_linear` dispatch on the QTensor leaf type, so serving runs
unchanged on quantized or full-precision params. Embedding and norms
stay in their own dtypes.
"""

from typing import Any, Dict, NamedTuple

import torch

Params = Dict[str, Any]


class QTensor(NamedTuple):
    """int8 weights + f32 per-output-channel scales.

    q: (..., in, out) int8; scale: (..., 1, out) f32 — leading dims carry
    the layer (and expert) stacks so stacked weights quantize as one leaf."""

    q: torch.Tensor
    scale: torch.Tensor


def quantize_tensor(w: torch.Tensor) -> QTensor:
    """Symmetric per-channel int8 over the last (output) axis."""
    wf = w.to(torch.float32)
    amax = wf.abs().amax(dim=-2, keepdim=True)  # (..., 1, out)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    # torch.round is round-half-to-even, as jnp.round.
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale)


def dequantize_tensor(t: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (t.q.to(torch.float32) * t.scale).to(dtype)


_QUANT_KEYS = frozenset(
    {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
     "we_gate", "we_up", "we_down", "lm_head"}
)


def quantize_params(params: Params) -> Params:
    """Return a copy of the params tree with the matmul weights as QTensors."""

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            return {
                k: quantize_tensor(v)
                if k in _QUANT_KEYS and not isinstance(v, QTensor)
                else walk(v)
                for k, v in node.items()
            }
        return node

    return walk(params)
