"""decode_tok_s.serve: tokens that decode steps generated in the window
(every token after a request's first, which its prefill produces) over
the seconds the engine spent in decode chunks in it (the change of its
`decode_seconds_total` counter): the decode loop's own rate, apart from
the prefill work that shares the window."""

from portbench.stats import decoded_in


def read(rec):
    dt = rec.stats1["decode_seconds_total"] - rec.stats0["decode_seconds_total"]
    if dt <= 0:
        return None
    return decoded_in(rec.submitted(), rec.t0, rec.t1) / dt
