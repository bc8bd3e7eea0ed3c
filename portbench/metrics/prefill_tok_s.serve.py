"""prefill_tok_s.serve: prompt tokens the engine's prefill chunks computed
in the window over the stream time of those chunks (the changes of its
`prefill_tokens_computed_total` and `prefill_stream_seconds_total`
counters). An iteration's chunks are bracketed on the stream from the
first one's launch to the last one's end, so the stretches in which the
device waited for the host to launch the next kernel count: this is the
engine's prefill pace, not the kernels' busy time, and faster launching
(CUDA graphs) moves it as much as faster kernels. None where the program
has no stream counter."""


def read(rec):
    key = "prefill_stream_seconds_total"
    if key not in rec.stats1:
        return None
    dt = rec.stats1[key] - rec.stats0[key]
    if dt <= 0:
        return None
    n = rec.stats1["prefill_tokens_computed_total"] - rec.stats0["prefill_tokens_computed_total"]
    return n / dt
