"""Weight bridge: JAX-layout params (as numpy) and packed exports -> torch.

torch cannot reproduce `jax.random`, so a model trained or initialised by
the JAX package reaches the port through numpy, never through a second
init. Two entry points:

- `params_from_numpy(tree, device)`: a params pytree whose leaves are
  numpy arrays (e.g. `jax.tree.map(np.asarray, params)`), with stacked
  `(L, in, out)` layer leaves and QTensor-like leaves (any object with
  `q` and `scale`), becomes the port's dict of tensors in the same layout.
- `load_packed(directory, device)`: reads the `save_packed` export
  (`<dir>/packed/manifest.json` + `weights.bin`) that the JAX package
  writes for cold starts, without JAX.

bf16: numpy has no bfloat16 of its own. A JAX bf16 array converts to an
`ml_dtypes` dtype that `torch.from_numpy` refuses, and the packed manifest
names the dtype "bfloat16". Both are recognised by name and their bits
reinterpreted as uint16 -> torch.bfloat16, which needs no `ml_dtypes`.
"""

import json
import mmap
from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from dstack_tpu_torch.workloads.device import DeviceLike, resolve_device
from dstack_tpu_torch.workloads.quant import QTensor

Params = Dict[str, Any]

_PACKED_DIR = "packed"
_PACKED_MANIFEST = "manifest.json"
_PACKED_WEIGHTS = "weights.bin"
_Q_SUFFIX, _SCALE_SUFFIX = ".q", ".scale"

_NP_DTYPES = {
    "float32": np.float32, "float16": np.float16, "int8": np.int8,
    "int32": np.int32, "int64": np.int64, "uint8": np.uint8,
    "bool": np.bool_, "bfloat16": np.uint16,
}


def tensor_from_numpy(a, device: torch.device) -> torch.Tensor:
    """One leaf: numpy (including an ml_dtypes bf16 array) -> torch."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Params:
    """JAX-layout params pytree with numpy leaves -> port params."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if hasattr(node, "q") and hasattr(node, "scale"):
            return QTensor(tensor_from_numpy(node.q, dev),
                           tensor_from_numpy(node.scale, dev))
        return tensor_from_numpy(node, dev)

    return walk(tree)


def _insert(tree: Params, path: str, leaf: Any) -> None:
    node = tree
    parts = path.split("/")
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = leaf


def load_packed(directory: Union[str, Path],
                device: DeviceLike = None) -> Optional[Params]:
    """Restore a JAX `checkpoint.save_packed` export, or None when absent.

    The manifest lists every leaf as {name, shape, dtype, offset, nbytes};
    names are "/"-joined dict paths and a QTensor contributes `path.q` +
    `path.scale`. `weights.bin` is mmapped once and each leaf copied
    straight from the mapped pages to `device`."""
    dev = resolve_device(device)
    path = Path(directory) / _PACKED_DIR
    man_path = path / _PACKED_MANIFEST
    bin_path = path / _PACKED_WEIGHTS
    if not man_path.exists() or not bin_path.exists():
        return None
    manifest = json.loads(man_path.read_text())
    tree: Params = {}
    pairs: Dict[str, Dict[str, torch.Tensor]] = {}
    with open(bin_path, "rb") as f, \
            mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        for spec in manifest:
            dtype = spec["dtype"]
            if dtype not in _NP_DTYPES:
                raise ValueError(f"packed checkpoint: unsupported dtype {dtype!r}")
            shape = tuple(int(d) for d in spec["shape"])
            count = int(np.prod(shape, dtype=np.int64))
            view = np.frombuffer(mm, dtype=_NP_DTYPES[dtype], count=count,
                                 offset=spec["offset"]).reshape(shape)
            t = torch.from_numpy(view.copy())
            if dtype == "bfloat16":
                t = t.view(torch.bfloat16)
            t = t.to(dev)
            del view
            name = spec["name"]
            if name.endswith(_Q_SUFFIX):
                pairs.setdefault(name[: -len(_Q_SUFFIX)], {})["q"] = t
            elif name.endswith(_SCALE_SUFFIX):
                pairs.setdefault(name[: -len(_SCALE_SUFFIX)], {})["scale"] = t
            else:
                _insert(tree, name, t)
    for base, qs in pairs.items():
        if set(qs) != {"q", "scale"}:
            raise ValueError(f"packed checkpoint: incomplete QTensor `{base}`")
        _insert(tree, base, QTensor(q=qs["q"], scale=qs["scale"]))
    return tree
