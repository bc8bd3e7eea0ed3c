"""The traffic generator: reproducible from the seed, inside the mix's
ranges, and the same work for every seed in another order."""

from collections import Counter

import pytest

from portbench import spec
from portbench.traffic import (lognormal_quantiles, make_requests,
                               system_prompt_lengths, zipf_counts)

SEED = 3_000_000_019  # more than 32 signed bits hold


def mix(name):
    return spec.load_json(spec.PKG / "traffic" / f"{name}.json")


@pytest.mark.parametrize("name", ["docs", "chat"])
def test_same_seed_same_requests(name):
    a = make_requests(mix(name), SEED, 32000, 70)
    b = make_requests(mix(name), SEED, 32000, 70)
    assert [(r.prompt, r.max_new, r.due) for r in a] == [(r.prompt, r.max_new, r.due) for r in b]
    c = make_requests(mix(name), SEED + 1, 32000, 70)
    assert [r.prompt for r in a] != [r.prompt for r in c]


@pytest.mark.parametrize("name", ["docs", "chat"])
def test_lengths_inside_ranges_and_ids_inside_vocab(name):
    m = mix(name)
    for r in make_requests(m, SEED, 32000, 200):
        body = len(r.prompt) - r.system_len
        assert m["prompt"]["min"] <= body <= m["prompt"]["max"]
        assert m["output"]["min"] <= r.max_new <= m["output"]["max"]
        assert len(r.prompt) + r.max_new <= m["engine"]["max_len"]
        assert 0 <= min(r.prompt) and max(r.prompt) < 32000


@pytest.mark.parametrize("name", ["docs", "chat"])
def test_every_seed_serves_the_same_sizes_per_block(name):
    m = mix(name)
    n = 3 * m["block"]
    sizes = [Counter((len(r.prompt), r.max_new, r.system) for r in make_requests(m, s, 32000, n))
             for s in (1, 2)]
    bodies = [sorted(len(r.prompt) - r.system_len for r in make_requests(m, s, 32000, n))
              for s in (1, 2)]
    assert bodies[0] == bodies[1]
    assert sizes[0] != sizes[1] or name == "docs"  # pairings differ, the multisets do not


def test_lognormal_quantiles_median_and_clip():
    q = lognormal_quantiles({"median": 2560, "sigma": 0.45, "min": 1024, "max": 6144}, 33)
    assert q[16] == 2560 and min(q) >= 1024 and max(q) <= 6144 and q == sorted(q)


def test_zipf_counts_fill_the_block_in_rank_order():
    c = zipf_counts(16, 1.1, 64)
    assert sum(c) == 64 and c == sorted(c, reverse=True) and c[-1] >= 1


def test_open_rate_blocks_span_block_over_rate():
    m = dict(mix("chat"), kind="open_rate", rate=2.5)
    reqs = make_requests(m, SEED, 32000, 3 * m["block"] + 1)
    dues = [r.due for r in reqs]
    assert dues == sorted(dues)
    for k in (1, 2, 3):
        assert dues[k * m["block"]] == pytest.approx(k * m["block"] / 2.5)


def test_system_prompts_shared_and_lengths_fixed():
    m = mix("chat")
    lens = system_prompt_lengths(m["system_prompts"])
    assert sorted(lens)[0] == 512 and sorted(lens)[-1] == 2048 and len(lens) == 16
    a = make_requests(m, SEED, 32000, 64)
    same = [r for r in a if r.system == a[0].system]
    assert len(same) > 1
    assert all(r.prompt[:r.system_len] == same[0].prompt[:same[0].system_len] for r in same)
