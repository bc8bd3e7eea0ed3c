"""kv_live_share.serve: the share of the paged KV pool's blocks that the
live requests' contexts fill, at the times the load gauges were read
(the mean over them), in %. A request is live at t when its first token
had reached the client and its last had not; its context is its prompt
and the tokens it had received, in whole blocks, with a shared system
prompt's full blocks counted once. Requests still in prefill are left
out, so this is a lower bound. Beside kv_pool_used.serve, which also
counts the blocks the prefix cache keeps after a request ends, it shows
how much of the reserved pool holds live KV."""

import bisect

from portbench.work import blocks_of


def read(rec):
    if not rec.load:
        return None
    bs = rec.traffic["engine"]["kv_block_size"]
    shares = []
    for x in rec.load:
        t, used, systems = x["t"], 0, {}
        for r in rec.submitted():
            if not r.times or r.times[0] > t or (r.t_done is not None and r.t_done <= t):
                continue
            n = bisect.bisect_right(r.times, t)
            shared = r.system_len // bs if r.system >= 0 else 0
            systems[r.system] = shared
            used += blocks_of(len(r.prompt) + n, bs) - shared
        shares.append((used + sum(systems.values())) / x["kv_blocks_total"])
    return 100.0 * sum(shares) / len(shares)
