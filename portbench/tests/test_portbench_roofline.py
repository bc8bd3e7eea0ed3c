"""Operation and byte counts against hand values for both configurations,
reached through their family (families/mistral.py, which Mixtral's is)."""

import pytest

from portbench import roofline, spec
from portbench.families import mistral


def conf(name):
    return mistral.shapes(spec.load_json(spec.PKG / "configs" / f"{name}.json"))


def test_param_counts():
    assert conf("mistral-7b-v0.3").param_count() == 7_248_023_552
    assert conf("mixtral-8x7b-v0.1-s8").param_count() == 11_872_309_248


def test_mistral_matmul_flops_per_token_and_layer():
    s = conf("mistral-7b-v0.3")
    # q 4096x4096, k and v 4096x1024, o 4096x4096, MLP 3 x 4096x14336; 2 FLOPs a MAC
    proj = 2 * (4096 * 4096 * 2 + 4096 * 1024 * 2)
    mlp = 2 * 3 * 4096 * 14336
    assert mistral.layer_matmul_flops(s) == proj + mlp == 436_207_616


def test_mixtral_counts_two_experts_and_the_router():
    s = conf("mixtral-8x7b-v0.1-s8")
    proj = 2 * (4096 * 4096 * 2 + 4096 * 1024 * 2)
    assert mistral.layer_matmul_flops(s) == proj + 2 * 2 * 3 * 4096 * 14336 + 2 * 4096 * 8


def test_decode_token_flops_and_paged_bytes():
    s = conf("mistral-7b-v0.3")
    ctx = 2048
    attn = 4 * 32 * 128 * ctx
    assert mistral.decode_flops(s, ctx) == 32 * (436_207_616 + attn) + 2 * 4096 * 32768
    nbytes, ops = mistral.paged_decode_work(s, ctx)
    # K and V of 2048 positions, 8 heads of 128 in bf16, 32 layers: 128 KiB a position
    assert nbytes == 32 * (ctx * 2 * 8 * 128 * 2 + 2 * 32 * 128 * 2)
    assert ctx * 131072 < nbytes
    assert ops == 32 * attn


def test_prefill_attention_counts_the_causal_pairs_only():
    s = conf("mixtral-8x7b-v0.1-s8")
    assert roofline.attention_pairs(0, 4) == 1 + 2 + 3 + 4
    assert roofline.attention_pairs(2, 4) == 3 + 4
    full = mistral.prefill_flops(s, 1024)
    cached = mistral.prefill_flops(s, 1024, reused=512)
    lm = 2 * 4096 * 32000
    per = mistral.layer_matmul_flops(s)
    assert full - lm == pytest.approx(8 * (1024 * per + 4 * 32 * 128 * 1024 * 1025 / 2))
    assert cached < full


def test_least_time_takes_the_larger_bound():
    t, by = roofline.least_seconds(3.35e12, 1.0)
    assert by == "bytes" and t == pytest.approx(1.0)
    t, by = roofline.least_seconds(1.0, 989e12)
    assert by == "operations" and t == pytest.approx(1.0)


def test_window_work_counts_what_arrived_in_it():
    from portbench import work
    from portbench.traffic import Request

    s = conf("mixtral-8x7b-v0.1-s8")
    a = Request(0, [1] * 300, 3, system=0, system_len=100)
    a.t_submit, a.times = 0.0, [1.0, 2.0, 3.0]
    b = Request(1, [1] * 400, 3, system=0, system_len=100)  # its system prompt is cached
    b.t_submit, b.times = 0.5, [4.0, 5.0, 11.0]
    nbytes, ops = work.window_paged_work(mistral, s, [a, b], 2.0, 10.0, 16)
    parts = [mistral.paged_decode_work(s, 300 + 1), mistral.paged_decode_work(s, 300 + 2),
             mistral.paged_prefill_work(s, 400, 96), mistral.paged_decode_work(s, 400 + 1)]
    assert nbytes == pytest.approx(sum(p[0] for p in parts))
    assert ops == pytest.approx(sum(p[1] for p in parts))
    flops = work.window_flops(mistral, s, [a, b], 2.0, 10.0, 16)
    assert flops == pytest.approx(mistral.decode_flops(s, 301) + mistral.decode_flops(s, 302)
                                  + mistral.prefill_flops(s, 400, 96)
                                  + mistral.decode_flops(s, 401))
