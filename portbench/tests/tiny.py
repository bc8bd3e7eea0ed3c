"""Tiny cells for the CPU tests: the cells' own mixes and loops at a size
a test run holds, on Mistral- and Mixtral-shaped configurations."""

import copy

from portbench import spec


def config(moe: bool = False) -> dict:
    c = {
        "hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2, "vocab_size": 256,
        "max_position_embeddings": 1024, "rope_theta": 1e6, "rms_norm_eps": 1e-5,
        "dtype": "float32",
    }
    if moe:
        c.update(num_local_experts=8, num_experts_per_tok=2, capacity_factor=4.0,
                 moe_impl="einsum")
    return c


def traffic(kind: str) -> dict:
    """The mix `kind` (docs, chat) at a tiny size; "open" is the chat mix
    as an open loop at a fixed rate (kind open_rate), which no cell runs
    yet."""
    name = "chat" if kind == "open" else kind
    t = copy.deepcopy(spec.load_json(spec.PKG / "traffic" / f"{name}.json"))
    t["prompt"] = {"median": 40, "sigma": 0.45, "min": 16, "max": 96}
    t["output"] = {"median": 8, "sigma": 0.6, "min": 4, "max": 16}
    t["engine"].update(slots=4, max_len=224, prefill_chunk_tokens=32)
    t["warm_seconds"] = 0.5
    t["check"] = {"served_tokens": 24, "max_requests": 3}
    t["backlog"], t["requests"] = 8, 200
    if kind != "docs":
        t["system_prompts"] = {"count": 4, "min": 16, "max": 48, "zipf": 1.1}
    if kind == "open":
        t.update(kind="open_rate", rate=4.0, drain_seconds=20)
    return t


def cell(kind: str = "docs", moe: bool = False, limit: float = 1e-3) -> dict:
    return {"name": f"tiny.{kind}", "chips": 1, "config": config(moe),
            "traffic": traffic(kind),
            "check": {"name": "logit_gap", "statistic": "max", "limit": limit},
            "end_to_end": [], "per_layer": []}
