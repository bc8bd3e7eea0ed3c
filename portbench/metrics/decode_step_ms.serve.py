"""decode_step_ms.serve: ms of stream time per decode step in the window
(the changes of the engine's `decode_stream_seconds_total` and
`decode_steps_total` counters): each decode op bracketed on the stream
from its first launch to its last kernel's end, without the prefill
chunks queued ahead of it. The bracket holds the stretches in which the
device waited for the host to launch the next kernel, so this is the
engine's pace of a step, not the kernels' busy time: faster launching
(CUDA graphs) moves it as much as faster kernels. None where the program
has no stream counter."""


def read(rec):
    key = "decode_stream_seconds_total"
    if key not in rec.stats1:
        return None
    steps = rec.stats1["decode_steps_total"] - rec.stats0["decode_steps_total"]
    if steps <= 0:
        return None
    return 1e3 * (rec.stats1[key] - rec.stats0[key]) / steps
