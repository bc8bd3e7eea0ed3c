"""The PyTorch port stands alone: it imports no JAX and nothing of the
JAX package, and its entry points run on the CUDA device unless the
caller asks for the CPU."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "dstack_tpu_torch"

MODULES = (
    "dstack_tpu_torch",
    "dstack_tpu_torch.fine_tune",
    "dstack_tpu_torch.native_server",
    "dstack_tpu_torch.run_rl",
    "dstack_tpu_torch.train_pipeline",
    "dstack_tpu_torch.utils",
    "dstack_tpu_torch.utils.accum",
    "dstack_tpu_torch.utils.flight_recorder",
    "dstack_tpu_torch.utils.histogram",
    "dstack_tpu_torch.utils.qos",
    "dstack_tpu_torch.utils.stagemarkers",
    "dstack_tpu_torch.utils.tracecontext",
    "dstack_tpu_torch.workloads",
    "dstack_tpu_torch.workloads._build",
    "dstack_tpu_torch.workloads.attention",
    "dstack_tpu_torch.workloads.checkpoint",
    "dstack_tpu_torch.workloads.compile_cache",
    "dstack_tpu_torch.workloads.config",
    "dstack_tpu_torch.workloads.data",
    "dstack_tpu_torch.workloads.device",
    "dstack_tpu_torch.workloads.flash_attention",
    "dstack_tpu_torch.workloads.generate",
    "dstack_tpu_torch.workloads.kv_blocks",
    "dstack_tpu_torch.workloads.kv_host_tier",
    "dstack_tpu_torch.workloads.kv_transfer",
    "dstack_tpu_torch.workloads.lora",
    "dstack_tpu_torch.workloads.lora_serving",
    "dstack_tpu_torch.workloads.moe",
    "dstack_tpu_torch.workloads.paged_attention",
    "dstack_tpu_torch.workloads.pipeline",
    "dstack_tpu_torch.workloads.quant",
    "dstack_tpu_torch.workloads.rl",
    "dstack_tpu_torch.workloads.rl_drill",
    "dstack_tpu_torch.workloads.serving",
    "dstack_tpu_torch.workloads.serving_disagg",
    "dstack_tpu_torch.workloads.sharding",
    "dstack_tpu_torch.workloads.stages",
    "dstack_tpu_torch.workloads.train",
    "dstack_tpu_torch.workloads.transformer",
    "dstack_tpu_torch.workloads.weights",
)
FORBIDDEN = ("jax", "jaxlib", "optax", "ml_dtypes", "dstack_tpu")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_every_module_is_listed():
    found = {
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py")
    }
    assert found == set(MODULES)


def test_importing_the_port_loads_no_jax():
    """A fresh interpreter imports every module of the port; none of JAX,
    ml_dtypes or the JAX package may be loaded afterwards."""
    src = (
        "import json, sys\n"
        f"for m in {list(MODULES)!r}:\n"
        "    __import__(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", src], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, bad


@pytest.mark.parametrize(
    "path", sorted(p.relative_to(ROOT).as_posix() for p in PKG.rglob("*.py")))
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    assert not [n for n in names if _forbidden(n)], names


def test_chip_smoke_imports_nothing_of_jax():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert not [n for n in names if _forbidden(n)], names


def _entry_points():
    from dstack_tpu_torch import fine_tune, run_rl
    from dstack_tpu_torch.native_server import Engine
    from dstack_tpu_torch.workloads.config import PRESETS
    from dstack_tpu_torch.workloads.data import BatchLoader
    from dstack_tpu_torch.workloads.train import init_train_state, synthetic_batch
    from dstack_tpu_torch.workloads.device import resolve_device
    from dstack_tpu_torch.workloads.rl import Learner, run_anakin, tiny_rl_config
    from dstack_tpu_torch.workloads.rl_drill import run_drill as rl_drill
    from dstack_tpu_torch.workloads.serving import ServingEngine
    from dstack_tpu_torch.workloads.serving_disagg import run_drill
    from dstack_tpu_torch.workloads.sharding import make_mesh
    from dstack_tpu_torch.workloads.transformer import init_params
    from dstack_tpu_torch.workloads.weights import load_packed, params_from_numpy

    cfg = PRESETS["tiny"]
    cpu_params = init_params(cfg, 0, device="cpu")
    return {
        "resolve_device": lambda: resolve_device(None),
        "init_params": lambda: init_params(cfg, 0),
        "params_from_numpy": lambda: params_from_numpy({}),
        "load_packed": lambda: load_packed("/nonexistent"),
        "ServingEngine": lambda: ServingEngine(cfg, cpu_params, slots=1, max_len=32),
        "native_server.Engine": lambda: Engine("tiny", 8),
        "ServingEngine role=decode": lambda: ServingEngine(cfg, cpu_params, slots=1,
                                                           max_len=32, role="decode"),
        "native_server.Engine role=decode": lambda: Engine("tiny", 8, role="decode",
                                                           kv_transfer_port=0),
        "serving_disagg.run_drill": lambda: run_drill(verbose=False),
        "rl.Learner": lambda: Learner(tiny_rl_config()),
        "rl.run_anakin": lambda: run_anakin(updates=1),
        "rl_drill.run_drill": lambda: rl_drill(updates_per_phase=1),
        "init_train_state": lambda: init_train_state(cfg, 0),
        "synthetic_batch": lambda: synthetic_batch(cfg, 2, 8),
        "BatchLoader": lambda: BatchLoader(_OneRow(), 1),
        "make_mesh": lambda: make_mesh(seq=4),
        "fine_tune": lambda: fine_tune.main(["--preset", "tiny", "--steps", "1"]),
        "fine_tune --lora-rank": lambda: fine_tune.main(["--preset", "tiny", "--steps", "1",
                                                         "--lora-rank", "4"]),
        "run_rl": lambda: run_rl.main(["--updates", "1"]),
    }


class _OneRow:
    """A one-row dataset stand-in: the loader resolves its device before
    it reads anything."""

    n_rows, seq_len, row = 1, 4, 5


@pytest.mark.parametrize("name", ["resolve_device", "init_params",
                                  "params_from_numpy", "load_packed",
                                  "ServingEngine", "native_server.Engine",
                                  "ServingEngine role=decode",
                                  "native_server.Engine role=decode",
                                  "serving_disagg.run_drill",
                                  "rl.Learner", "rl.run_anakin", "rl_drill.run_drill",
                                  "init_train_state", "synthetic_batch",
                                  "BatchLoader", "make_mesh", "fine_tune",
                                  "fine_tune --lora-rank", "run_rl"])
def test_entry_points_default_to_cuda_and_raise_without_it(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        _entry_points()[name]()
