"""serve_tok_s: prompt tokens prefilled plus tokens generated in the window,
over the window's seconds. A prompt counts when its first token reached
the client inside the window; a generated token when it did."""

from portbench.stats import window_tokens


def read(rec):
    return window_tokens(rec.submitted(), rec.t0, rec.t1) / (rec.t1 - rec.t0)
