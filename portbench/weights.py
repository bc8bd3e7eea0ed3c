"""The size of a weight tree. The tree itself is made from the seed by the
configuration's family (`families/<model_type>.py` `make_weights`) and
handed to both sides: the same seed on the same device gives the same
tensors, which is how the reference gets them again once the program is
gone."""

from typing import Any, Dict


def weight_bytes(tree: Dict[str, Any]) -> int:
    total = 0
    for v in tree.values():
        if isinstance(v, dict):
            total += weight_bytes(v)
        else:
            total += v.numel() * v.element_size()
    return total
