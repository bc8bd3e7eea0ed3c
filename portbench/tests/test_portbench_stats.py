"""Rate, tail and time-per-token arithmetic on synthetic timestamps."""

import pytest

from portbench import stats
from portbench.traffic import Request


def req(i, prompt, times, due=None, n=None, error=None):
    r = Request(i, [0] * prompt, n or len(times), t_due=due)
    r.times = list(times)
    r.tokens = [1] * len(times)
    r.t_done = times[-1] if times else 0.0
    r.error = error
    return r


def test_percentile_is_nearest_rank():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile(xs, 50) == 50
    assert stats.percentile([3.0], 95) == 3.0


def test_window_tokens_counts_prompts_at_first_token_and_tokens_by_arrival():
    a = req(0, 100, [1.0, 2.0, 3.0])       # first token before the window
    b = req(1, 50, [4.0, 5.0, 11.0])       # first token inside, one token after
    assert stats.window_tokens([a, b], 2.0, 10.0) == 2 + 50 + 2


def test_ttft_from_due_time_and_missing_takes_the_limit():
    r = req(0, 10, [5.5, 6.0], due=5.0)
    assert stats.ttft(r, 60.0) == pytest.approx(0.5)
    miss = req(1, 10, [], due=5.0, n=4)
    assert stats.ttft(miss, 60.0) == 60.0
    err = req(2, 10, [5.2], due=5.0, n=4, error="RuntimeError()")
    assert stats.ttft(err, 60.0) == 60.0


def test_tpot_over_the_request():
    r = req(0, 10, [1.0, 1.0, 1.0, 1.0, 2.0, 2.0, 2.0, 2.0, 3.0])
    assert stats.tpot(r, 60.0) == pytest.approx(2.0 / 8)


def test_a_stall_inside_the_window_moves_the_tail():
    def run(stall):
        reqs = []
        for i in range(100):
            due = i * 0.1
            first = due + 0.2 + (2.0 if stall and 5.0 <= due < 6.0 else 0.0)
            reqs.append(req(i, 10, [first + 0.05 * k for k in range(5)], due=due))
        return reqs

    calm = [stats.ttft(r, 60.0) for r in run(False)]
    stalled = [stats.ttft(r, 60.0) for r in run(True)]
    assert stats.percentile(calm, 95) == pytest.approx(0.2)
    assert stats.percentile(stalled, 95) == pytest.approx(2.2)
    assert stats.percentile(stalled, 50) == pytest.approx(0.2)


def test_live_kv_counts_live_contexts_and_a_shared_prompt_once():
    from types import SimpleNamespace

    from portbench import spec

    def live(i, times, done):
        r = req(i, 100, times)
        r.system, r.system_len, r.t_done = 0, 40, done
        return r

    reqs = [live(0, [4.0, 4.5, 5.0, 6.0], 6.0),   # 3 tokens by t = 5
            live(1, [3.0, 4.0, 5.0, 7.0], 7.0),   # 3 tokens by t = 5
            live(2, [1.0, 2.0], 2.0),             # done before t
            live(3, [6.0, 7.0], 7.0)]             # no first token by t
    rec = SimpleNamespace(load=[{"t": 5.0, "kv_blocks_total": 100}],
                          traffic={"engine": {"kv_block_size": 16}},
                          submitted=lambda: reqs)
    share = spec.load_module("metrics", "kv_live_share.serve").read(rec)
    # ceil(103 / 16) = 7 blocks a request, of which 40 // 16 = 2 are the shared prompt's
    assert share == pytest.approx(5 + 5 + 2)
