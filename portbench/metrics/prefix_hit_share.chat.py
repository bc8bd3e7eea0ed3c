"""prefix_hit_share.chat: prompt tokens the prefix cache served in the
window (the change of `prefix_tokens_reused_total`) over the prompt
tokens of the requests submitted in it, in %."""


def read(rec):
    sent = sum(len(r.prompt) for r in rec.requests
               if r.t_submit is not None and rec.t0 <= r.t_submit < rec.t1)
    if not sent:
        return None
    got = rec.stats1["prefix_tokens_reused_total"] - rec.stats0["prefix_tokens_reused_total"]
    return 100.0 * got / sent
