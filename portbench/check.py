"""What decides `correct` in a serving cell.

Once the window has closed and the program is gone, a sample of the
requests it finished, drawn from the seed and holding the longest, is run
through the plain reference once each (prompt + served tokens), on
weights made again from the seed. Every served token was greedy, so the
reference's logit of that token should be its best at that position up
to rounding: the number compared is the widest gap, over every served
token of the sample, by which the served token's reference logit lies
below the reference's best. The control reads the same gap for the token
that the fp8 reference puts first at each of those positions.
"""

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from portbench.traffic import Request


def sample(finished: Sequence[Request], seed: int, served: int, most: int) -> List[Request]:
    """The longest finished request (prompt + output), then others in an
    order drawn from the seed until `served` tokens or `most` requests."""
    if not finished:
        return []
    longest = max(finished, key=lambda r: (len(r.prompt) + len(r.tokens), -r.index))
    rest = [r for r in finished if r is not longest]
    order = np.random.default_rng(seed % (1 << 63) ^ 0x5EED).permutation(len(rest))
    out, n = [longest], len(longest.tokens)
    for i in order:
        if n >= served or len(out) >= most:
            break
        out.append(rest[i])
        n += len(rest[i].tokens)
    return out


def statistic(gaps: Sequence[float], spec: Dict) -> float:
    """The number a cell compares (its checks file): "max", the widest gap,
    or "share_above", the share of tokens whose gap exceeds `threshold`."""
    if not gaps:
        return float("inf")
    if spec["statistic"] == "max":
        return max(gaps)
    if spec["statistic"] == "share_above":
        return sum(g > spec["threshold"] for g in gaps) / len(gaps)
    raise ValueError(f"unknown statistic {spec['statistic']!r}")


def gaps(logits: Callable, s, w, r: Request,
         quant: Optional[str] = None) -> Dict[str, List[float]]:
    """{"served": the gap of each served token} and, with `quant`,
    {"control": the gap of the token the quantized reference ranks first}
    at each of the positions that produced r's served tokens. `logits` is
    the family's reference, `s` its shapes."""
    p, toks = len(r.prompt), list(r.tokens)
    seq = list(r.prompt) + toks[:-1]
    rows = range(p - 1, p - 1 + len(toks))
    full = logits(s, w, seq, rows)
    best = full.max(dim=-1).values
    served = torch.as_tensor(toks, device=full.device)
    at = torch.arange(len(toks), device=full.device)
    out = {"served": (best - full[at, served]).tolist()}
    if quant is not None:
        low = logits(s, w, seq, rows, quant=quant)
        out["control"] = (best - full[at, low.argmax(dim=-1)]).tolist()
    return out
