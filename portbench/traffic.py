"""The one traffic generator: a mix's data file in, requests out.

Sizes are stratified so that every seed serves the same work in another
order. A distribution is represented by its `block` quantiles (the clipped
lognormal's at (i + 1/2) / block), and the request stream is a sequence of
blocks, each a permutation of those quantiles drawn from the seed. Prompt
and output lengths are permuted apart, so they are independent. Arrivals
(kind "open_rate") take the same form: each block of inter-arrival gaps is
a permutation of the exponential's quantiles, scaled so a block spans
exactly block / rate seconds. A shared system prompt is chosen by a Zipf
law over the mix's pool of prompts, stratified the same way (each block
holds each prompt as often as the law says, to the nearest whole count).

The seed draws the order and every token id; the sizes come from the
file alone. Nothing here imports torch or the program.
"""

import math
from dataclasses import dataclass, field
from statistics import NormalDist
from typing import Any, Dict, List, Optional

import numpy as np


@dataclass
class Request:
    index: int
    prompt: List[int]
    max_new: int
    due: Optional[float] = None      # seconds after the arrival process starts
    system: int = -1                 # which shared system prompt, -1 for none
    system_len: int = 0
    # Filled in by the client.
    t_due: Optional[float] = None    # monotonic time the request was due
    t_submit: Optional[float] = None
    times: List[float] = field(default_factory=list)
    tokens: List[int] = field(default_factory=list)
    t_done: Optional[float] = None
    error: Optional[str] = None

    @property
    def done(self) -> bool:
        return self.t_done is not None and self.error is None and len(self.tokens) == self.max_new


def lognormal_quantiles(d: Dict[str, Any], n: int) -> List[int]:
    """The n quantiles of a lognormal (median, sigma) clipped to [min, max]."""
    nd = NormalDist()
    out = []
    for i in range(n):
        v = d["median"] * math.exp(d["sigma"] * nd.inv_cdf((i + 0.5) / n))
        out.append(int(round(min(max(v, d["min"]), d["max"]))))
    return out


def exponential_quantiles(n: int) -> List[float]:
    return [-math.log(1.0 - (i + 0.5) / n) for i in range(n)]


def zipf_counts(n_items: int, alpha: float, block: int) -> List[int]:
    """How often each of n_items ranks appears in a block under Zipf(alpha):
    the largest-remainder rounding of block * p_k."""
    w = [(k + 1) ** -alpha for k in range(n_items)]
    total = sum(w)
    exact = [block * x / total for x in w]
    counts = [int(math.floor(x)) for x in exact]
    order = sorted(range(n_items), key=lambda k: counts[k] - exact[k])
    for k in order[:block - sum(counts)]:
        counts[k] += 1
    return counts


def stratified(base: List, n: int, rng: np.random.Generator) -> List:
    out: List = []
    while len(out) < n:
        out.extend(base[i] for i in rng.permutation(len(base)))
    return out[:n]


def system_prompt_lengths(d: Dict[str, Any]) -> List[int]:
    """Fixed lengths of the shared prompts: log-spaced over [min, max],
    assigned to the Zipf ranks in a fixed order (the file's, not the seed's)."""
    n = d["count"]
    lens = [int(round(d["min"] * (d["max"] / d["min"]) ** (i / (n - 1)))) for i in range(n)]
    order = np.random.default_rng(0).permutation(n)
    return [lens[i] for i in order]


def make_requests(mix: Dict[str, Any], seed: int, vocab: int, n: int) -> List[Request]:
    """The first n requests of the mix for `seed`."""
    rng = np.random.default_rng(seed)
    block = mix["block"]
    prompt_lens = stratified(lognormal_quantiles(mix["prompt"], block), n, rng)
    out_lens = stratified(lognormal_quantiles(mix["output"], block), n, rng)
    dues: List[Optional[float]] = [None] * n
    if mix["kind"] == "open_rate":
        gaps = exponential_quantiles(block)
        scale = block / mix["rate"] / sum(gaps)
        t, dues = 0.0, []
        for g in stratified(gaps, n, rng):
            dues.append(t)
            t += g * scale
    systems: List[List[int]] = []
    choice = [-1] * n
    sp = mix.get("system_prompts")
    if sp:
        systems = [rng.integers(0, vocab, size=m).tolist()
                   for m in system_prompt_lengths(sp)]
        counts = zipf_counts(sp["count"], sp["zipf"], block)
        base = [k for k, c in enumerate(counts) for _ in range(c)]
        choice = stratified(base, n, rng)
    reqs = []
    for i in range(n):
        sys_toks = systems[choice[i]] if choice[i] >= 0 else []
        body = rng.integers(0, vocab, size=prompt_lens[i]).tolist()
        reqs.append(Request(i, sys_toks + body, out_lens[i], dues[i], choice[i], len(sys_toks)))
    return reqs
