"""The work the window's traffic needed, counted from what the client
received.

A request of P prompt tokens and n generated tokens needs: the prefill of
its uncached positions [R, P), which yields token 0, then one decode step
for each token j >= 1 at position P + j - 1, attending P + j keys. R is
the most the prefix cache could have saved: a shared system prompt seen
in an earlier request, floored to whole cache blocks. Taking the most
keeps every count of work a lower bound. A prompt counts when its first
token arrived in the window, a decode token when it did; how the engine
scheduled or delivered the work does not enter. What each prefill and
decode token costs is the configuration's family's count
(`families/<model_type>.py`).
"""

from typing import Dict, List

from portbench.traffic import Request


def blocks_of(tokens: int, block: int) -> int:
    return -(-tokens // block)


def reused(reqs: List[Request], block: int) -> Dict[int, int]:
    """index -> the most prompt tokens the prefix cache could have served."""
    seen, out = set(), {}
    for r in sorted(reqs, key=lambda r: (r.t_submit or 0.0, r.index)):
        R = 0
        if r.system >= 0 and r.system in seen:
            R = min(r.system_len, len(r.prompt) - 1) // block * block
        out[r.index] = R
        if r.system >= 0:
            seen.add(r.system)
    return out


def window_flops(fam, s, reqs: List[Request], t0: float, t1: float, block: int) -> float:
    """Forward FLOPs of the work that arrived in [t0, t1), by the family
    `fam`'s counts at its shapes `s`."""
    R = reused(reqs, block)
    total = 0.0
    for r in reqs:
        P = len(r.prompt)
        for j, t in enumerate(r.times):
            if not (t0 <= t < t1):
                continue
            total += (fam.prefill_flops(s, P, R[r.index]) if j == 0
                      else fam.decode_flops(s, P + j))
    return total


def window_paged_work(fam, s, reqs: List[Request], t0: float, t1: float, block: int):
    """(bytes, ops) of the paged kernel for the work that arrived in
    [t0, t1), by the family `fam`'s counts at its shapes `s`."""
    R = reused(reqs, block)
    nbytes = ops = 0.0
    for r in reqs:
        P = len(r.prompt)
        for j, t in enumerate(r.times):
            if not (t0 <= t < t1):
                continue
            b, o = (fam.paged_prefill_work(s, P, R[r.index]) if j == 0
                    else fam.paged_decode_work(s, P + j))
            nbytes, ops = nbytes + b, ops + o
    return nbytes, ops
