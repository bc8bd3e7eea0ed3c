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
  writes for cold starts, without JAX;
- `save_packed(directory, params)`: writes that export from port params,
  byte for byte what the JAX `checkpoint.save_packed` writes for the same
  values, so either package loads what the other saved.

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
_PACKED_ALIGN = 64  # leaf offsets, as the reference aligns them

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


def unflatten_params(pairs) -> Params:
    """[(path, leaf)] -> the nested dict (no QTensor regrouping)."""
    tree: Params = {}
    for path, leaf in pairs:
        _insert(tree, path, leaf)
    return tree


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


def flatten_params(node: Any, prefix: str = ""):
    """Params -> [(path, tensor)] in sorted-key order (the order of
    `jax.tree.leaves` over the same dict tree); a QTensor gives `path.q`
    and `path.scale` (the reference's `_flatten_params`)."""
    if isinstance(node, QTensor):
        return [(prefix + _Q_SUFFIX, node.q), (prefix + _SCALE_SUFFIX, node.scale)]
    if isinstance(node, dict):
        out = []
        for k in sorted(node):
            out.extend(flatten_params(node[k], f"{prefix}/{k}" if prefix else str(k)))
        return out
    return [(prefix, node)]


def _to_numpy(t: torch.Tensor):
    """(array, manifest dtype name); bf16 leaves go out as their raw bits."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy(), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def save_packed(directory: Union[str, Path], params: Params) -> Path:
    """Write `<dir>/packed/{manifest.json,weights.bin}`: every leaf
    contiguous at a 64-byte-aligned offset, manifest entries {name, shape,
    dtype, offset, nbytes} in sorted path order. Both files are written
    under temporary names and renamed, so a killed writer never leaves a
    half export behind a valid-looking path."""
    path = Path(directory) / _PACKED_DIR
    path.mkdir(parents=True, exist_ok=True)
    manifest = []
    tmp_bin = path / (_PACKED_WEIGHTS + ".tmp")
    with open(tmp_bin, "wb") as f:
        for name, leaf in flatten_params(params):
            a, dtype = _to_numpy(leaf)
            pad = (-f.tell()) % _PACKED_ALIGN
            if pad:
                f.write(b"\0" * pad)
            manifest.append({"name": name, "shape": list(a.shape), "dtype": dtype,
                             "offset": f.tell(), "nbytes": int(a.nbytes)})
            f.write(a.tobytes())
    tmp_man = path / (_PACKED_MANIFEST + ".tmp")
    tmp_man.write_text(json.dumps(manifest, separators=(",", ":")))
    tmp_bin.replace(path / _PACKED_WEIGHTS)
    tmp_man.replace(path / _PACKED_MANIFEST)
    return path
