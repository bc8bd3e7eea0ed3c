"""Weights from the seed, made by the benchmark and handed to both sides.

The tree has the layout the program's serving engine takes (one stacked
tensor per weight kind with a leading layer dim; norms and the router in
f32, everything else in the configuration's dtype). Each leaf is one
`torch.randn` call on the device in the served dtype, scaled by
fan_in^-0.5 in place, so making 14.5 GB takes a fraction of a second and
no f32 copy. The same seed on the same device gives the same tensors,
which is how the reference gets them again once the program is gone.
"""

from typing import Any, Dict

import torch

from portbench.model_config import Shapes

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_weights(s: Shapes, seed: int, device) -> Dict[str, Any]:
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed % (1 << 63))
    dt = _DTYPES[s.dtype]
    L, D, F, V, hd = s.layers, s.d_model, s.d_ff, s.vocab, s.head_dim

    def dense(shape, fan_in, dtype=dt):
        w = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
        return w.mul_(fan_in ** -0.5)

    def norm(shape):
        return torch.ones(shape, device=dev, dtype=torch.float32)

    layers = {
        "wq": dense((L, D, s.heads * hd), D),
        "wk": dense((L, D, s.kv_heads * hd), D),
        "wv": dense((L, D, s.kv_heads * hd), D),
        "wo": dense((L, s.heads * hd, D), s.heads * hd),
        "attn_norm": norm((L, D)),
        "mlp_norm": norm((L, D)),
    }
    if s.experts:
        E = s.experts
        layers["router"] = dense((L, D, E), D, torch.float32)
        layers["we_gate"] = dense((L, E, D, F), D)
        layers["we_up"] = dense((L, E, D, F), D)
        layers["we_down"] = dense((L, E, F, D), F)
    else:
        layers["w_gate"] = dense((L, D, F), D)
        layers["w_up"] = dense((L, D, F), D)
        layers["w_down"] = dense((L, F, D), F)
    return {
        "embed": dense((V, D), D),
        "layers": layers,
        "final_norm": norm((D,)),
        "lm_head": dense((D, V), D),
    }


def weight_bytes(tree: Dict[str, Any]) -> int:
    total = 0
    for v in tree.values():
        if isinstance(v, dict):
            total += weight_bytes(v)
        else:
            total += v.numel() * v.element_size()
    return total
