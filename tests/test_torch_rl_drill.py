"""The port's Sebulba drill (`python -m dstack_tpu_torch.workloads.rl_drill`)
as a subprocess on the CPU, held to tests/test_rl.py's drill asserts: the
learner and three actor processes (two, one SIGKILLed, a replacement),
zero learner restarts, two gang resizes, one preemption, and every
surviving actor stamped with the learner's final epoch. One intra-op
thread per process, so the drill keeps well inside its limit beside other
test workers."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _drill(*extra, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "dstack_tpu_torch.workloads.rl_drill", "--device", "cpu",
         "--updates-per-phase", "1", "--timeout", "100", *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )


def test_drill_preempts_shrinks_reexpands_and_leaves_no_actor_stale():
    out = _drill()
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    summary = json.loads(out.stdout[out.stdout.index("{"):])
    assert summary["ok"] is True and summary["failures"] == []
    assert summary["learner_restarts"] == 0
    assert summary["gang_resizes"] == 2
    assert summary["preemptions"] == 1
    assert summary["learner_updates"] == 3 and summary["final_weight_epoch"] == 3
    survivors = {k: v for k, v in summary["actor_final_epochs"].items()
                 if v == summary["final_weight_epoch"]}
    assert set(survivors) >= {"0", "2"}
    assert summary["device"] == "cpu" and summary["preset"] == "tiny-rl"
    # The learner's stage markers ride its stdout under DSTACK_RUN_NAME.
    assert out.stdout.count("::dstack-tpu-stage::learn_step") == 3


def test_drill_config_is_the_tiny_rl_policy_or_a_preset():
    from dstack_tpu_torch.workloads import rl_drill
    from dstack_tpu_torch.workloads.config import PRESETS
    from dstack_tpu_torch.workloads.rl import tiny_rl_config

    assert rl_drill.drill_config() == tiny_rl_config()
    assert rl_drill.drill_config("tiny") == PRESETS["tiny"]


def test_drill_defaults_to_cuda(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from dstack_tpu_torch.workloads import rl_drill

    monkeypatch.delenv("DSTACK_RUN_NAME", raising=False)  # restored after

    with pytest.raises(RuntimeError, match="CUDA"):
        rl_drill.main(["--updates-per-phase", "1"])
