"""tpot_p90_ms.chat: the 90th percentile, over every request that
completed in the window (its last token reached the client in it), of
(last token - first token) / (n - 1) at the client, in ms: the pace of
each conversation's answer while the batch is full."""

from portbench.stats import percentile, tpot


def read(rec):
    done = [r for r in rec.submitted() if r.done and rec.t0 <= r.t_done < rec.t1]
    if not done:
        return None
    return 1e3 * percentile([tpot(r, None) for r in done], 90)
