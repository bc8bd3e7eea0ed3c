"""A whole run of each serving loop on the CPU (the harness's look for a
card skipped, a tiny Mistral- or Mixtral-shaped cell; the open loop, which
no cell runs yet, too), sound and with the timed path broken underneath:
`correct` has to come out true for the sound run and false for each fault
a serving cell can have. A decode step that leaves its state unchanged (no
K/V row written) and a token altered where the sampler produces it. The other faults of the list (half of a
training batch left out, the exchange between chips) have no place in a
one-card serving cell."""

import time

import pytest

from portbench import run
from portbench.tests import tiny

SEED = 2_147_483_711
KINDS = [("docs", False), ("chat", True), ("open", True)]


def measure(kind, moe):
    rec, checks = run.measure(tiny.cell(kind, moe), SEED, 2.0, False, "cpu", time.monotonic())
    return rec, checks


@pytest.mark.parametrize("kind,moe", KINDS)
def test_sound_run_is_correct(kind, moe):
    rec, checks = measure(kind, moe)
    assert checks["correct"], checks
    assert checks["checked_tokens"] >= 8 and rec.attempted and not rec.failed


@pytest.mark.parametrize("kind,moe", KINDS)
def test_state_left_unchanged_fails(monkeypatch, kind, moe):
    from dstack_tpu_torch.workloads import kv_blocks

    monkeypatch.setattr(kv_blocks, "_write_rows", lambda *a, **k: None)
    _, checks = measure(kind, moe)
    assert not checks["correct"] and checks["logit_gap"]["value"] > 1e-3


@pytest.mark.parametrize("kind,moe", KINDS)
def test_altered_token_fails(monkeypatch, kind, moe):
    from dstack_tpu_torch.workloads import serving

    real = serving._select_next_token

    def altered(state, logits, *a, **k):
        return (real(state, logits, *a, **k) + 1) % logits.shape[-1]

    monkeypatch.setattr(serving, "_select_next_token", altered)
    _, checks = measure(kind, moe)
    assert not checks["correct"] and checks["logit_gap"]["value"] > 1e-3


def test_fp8_control_is_not_correct_where_the_program_is():
    rec, checks = run.measure(tiny.cell("docs", False), SEED, 2.0, False, "cpu",
                              time.monotonic(), quant="fp8")
    assert checks["correct"]
    assert checks["control"] > checks["logit_gap"]["limit"]


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    assert run.main(["--workload", "mistral7b.docs", "--seed", "1", "--seconds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "needs 1 CUDA card" in out.err
