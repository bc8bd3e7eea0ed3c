"""Tiny cells for the CPU tests: the cells' own mixes and loops at a size
a test run holds, on Mistral- and Mixtral-shaped configurations
(`tiny_mistral.json`, `tiny_mixtral.json` beside this file)."""

import copy

from portbench import spec


def config(moe: bool = False) -> dict:
    """Mixtral's experts (8, top-2, at capacity factor E/k) with `moe`."""
    name = "mixtral" if moe else "mistral"
    return spec.load_json(spec.PKG / "tests" / f"tiny_{name}.json")


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
    conf = config(moe)
    return {"name": f"tiny.{kind}", "chips": 1, "config": conf, "family": spec.family(conf),
            "traffic": traffic(kind),
            "check": {"name": "logit_gap", "statistic": "max", "limit": limit},
            "end_to_end": [], "per_layer": []}
