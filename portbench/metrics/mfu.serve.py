"""mfu.serve: the forward FLOPs the window's traffic needed (work.py:
a prompt when its first token arrived in the window, a decode token when
it did, each at the configuration's family's count: an MoE token through
its k experts) over the window's seconds and the H100's bf16 peak, in %."""

from portbench import roofline, work


def read(rec):
    block = rec.traffic["engine"]["kv_block_size"]
    flops = work.window_flops(rec.family, rec.shapes, rec.submitted(), rec.t0, rec.t1, block)
    return 100.0 * flops / (rec.t1 - rec.t0) / roofline.PEAK_FLOPS_BF16
