"""The benchmark's data: BENCHMARK.json and the files it names.

A cell is found by its name in BENCHMARK.json; its configuration file,
traffic file and check file are found by the names the cell gives, and
its model family by the configuration's published `model_type`.
This module imports neither torch nor the program; the family module
that `cell` loads imports torch.
"""

import importlib.util
import json
from pathlib import Path
from typing import Any, Dict, List

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, bench: Dict[str, Any] = None) -> Dict[str, Any]:
    """The cell `name` with its configuration, traffic and check read in:
    {"name", "chips", "config": {...file...}, "family": the config's family
    module, "traffic": {...file...}, "check": {...}, "end_to_end": [metric
    entries], "per_layer": [...]}."""
    bench = bench or benchmark()
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(ROOT / conf["file"])
    return {
        "name": name,
        "chips": w["chips"],
        "config_name": w["config"],
        "config": config,
        "family": family(config),
        "traffic_name": w["traffic"],
        "traffic": load_json(PKG / "traffic" / f"{w['traffic']}.json"),
        "check": load_json(PKG / "checks" / f"{name}.json"),
        "end_to_end": metrics_of(bench["end_to_end"], name),
        "per_layer": metrics_of(bench["per_layer"], name),
    }


def metrics_of(entries: List[Dict[str, Any]], cell_name: str) -> List[Dict[str, Any]]:
    """The metric entries a cell reports: those that list it, and those
    that list no cells (every cell reports them)."""
    return [m for m in entries if cell_name in m.get("workloads", [cell_name])]


def family(conf: Dict[str, Any]):
    """The configuration's model family: families/<model_type>.py."""
    return load_module("families", conf["model_type"])


def load_module(kind: str, name: str):
    """portbench/<kind>/<name>.py as a module (a metric's name may hold
    dots, so it is loaded by path, not by import name)."""
    path = PKG / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {name!r} under {kind}/: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
