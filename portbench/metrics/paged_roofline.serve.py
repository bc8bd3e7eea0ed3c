"""paged_roofline.serve: the least time of the paged-attention work the
window's traffic needed (work.py at the configuration's family's counts:
the causal FLOPs of each prompt whose first token arrived in the window,
the K/V bytes of each decode token that did), scaled to the profiled
slice's share of the window, over the device time of the
`ragged_paged_attention*` kernels (main and combine) in the slice, in %.
The least time is the larger of all that work's bytes over HBM bandwidth
and its operations over the bf16 peak, taken together. The work comes
from what the client received, so how the engine schedules and delivers
it does not enter; the slice stands for the window, whose load is steady
(a standing queue)."""

from portbench import roofline, work


def read(rec):
    if not rec.slice or not rec.slice["paged_s"]:
        return None
    block = rec.traffic["engine"]["kv_block_size"]
    nbytes, ops = work.window_paged_work(rec.family, rec.shapes, rec.submitted(),
                                         rec.t0, rec.t1, block)
    if not ops:
        return None
    least, _ = roofline.least_seconds(nbytes, ops)
    share = rec.slice["window_s"] / (rec.t1 - rec.t0)
    return 100.0 * least * share / rec.slice["paged_s"]
