"""The plain reference against the program at tiny Mistral- and
Mixtral-shaped configurations (Mixtral's at capacity factor E/k, where
the program drops no token), in f32 on the CPU."""

import pytest
import torch

from portbench import spec
from portbench.reference import mistral as ref
from portbench.tests import tiny


def family(moe):
    conf = tiny.config(moe)
    fam = spec.family(conf)
    return fam, fam.shapes(conf)


@pytest.mark.parametrize("moe", [False, True], ids=["mistral", "mixtral"])
def test_reference_matches_the_program(moe):
    from dstack_tpu_torch.workloads.transformer import serving_forward

    fam, s = family(moe)
    w = fam.make_weights(s, 7, "cpu")
    tokens = torch.randint(0, s.vocab, (1, 48), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = serving_forward(fam.port_config(s), w, tokens)[0]
    want = fam.logits(s, w, tokens[0].tolist(), range(48))
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("moe", [False, True], ids=["mistral", "mixtral"])
def test_fp8_control_moves_the_logits(moe):
    fam, s = family(moe)
    w = fam.make_weights(s, 7, "cpu")
    toks = list(range(40))
    full = fam.logits(s, w, toks, range(40))
    low = fam.logits(s, w, toks, range(40), quant="fp8")
    rel = float((low - full).norm() / full.norm())
    assert 1e-3 < rel < 0.5


def test_router_takes_the_lower_expert_on_a_tie():
    fam, s = family(True)
    h = torch.zeros(3, s.d_model)
    # layer 0's weights, every one zero: all router probabilities tie
    lw = {k: torch.zeros_like(v[0]) for k, v in fam.make_weights(s, 7, "cpu")["layers"].items()}
    probs = torch.softmax(torch.zeros(3, s.experts), dim=-1)  # h @ a zero router
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    assert order[:, :2].tolist() == [[0, 1]] * 3
    assert torch.equal(ref.moe(s, h, lw, None), torch.zeros_like(h))
