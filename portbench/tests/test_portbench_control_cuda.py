"""The control on the card, at each serving cell's own size: on three
seeds the fp8 reference put in the program's place reads a gap above the
cell's limit, while the program reads one below it.

    python3 -m pytest -m cuda portbench/tests/test_portbench_control_cuda.py

runs it on a machine with an H100 (the readings PERF.md gives came from
`python3 -m portbench.series ... --quant fp8`, the same code)."""

import time

import pytest

from portbench import run, spec

SEEDS = (101, 2_147_483_659, 4_000_000_007)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card (H100)")
    run.set_environment()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in spec.benchmark()["workloads"]])
def test_control_fails_where_the_program_passes(card, name):
    cell = spec.cell(name)
    name, limit = cell["check"]["name"], cell["check"]["limit"]
    for seed in SEEDS:
        _, checks = run.measure(cell, seed, 10.0, False, "cuda", time.monotonic(), quant="fp8")
        assert checks[name]["value"] <= limit
        assert checks["control"] > limit
