"""kv_pool_used.serve: the share of the paged KV pool's blocks that are
not free (the allocator's `kv_blocks_in_use` over `kv_blocks_total`:
live requests' blocks and those the prefix cache keeps after a request
ends), the mean of the readings taken evenly over the window, in %: how
much of the reserved pool the traffic has written."""


def read(rec):
    if not rec.load:
        return None
    return 100.0 * sum(x["kv_blocks_in_use"] / x["kv_blocks_total"]
                       for x in rec.load) / len(rec.load)
