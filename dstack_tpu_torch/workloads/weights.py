"""Weight bridge: JAX-layout params and train states (as numpy) and packed
exports -> torch.

torch cannot reproduce `jax.random`, so a model trained or initialised by
the JAX package reaches the port through numpy, never through a second
init. Entry points:

- `params_from_numpy(tree, device)`: a params pytree whose leaves are
  numpy arrays (e.g. `jax.tree.map(np.asarray, params)`), with stacked
  `(L, in, out)` layer leaves and QTensor-like leaves (any object with
  `q` and `scale`), becomes the port's dict of tensors in the same layout;
- `train_state_from_numpy(state, device)`: the JAX package's whole
  `TrainState` (step, params, and optax's AdamW state: count, mu, nu)
  with numpy leaves becomes the port's, so a state trained or
  checkpointed in JAX continues in the port;
- `lora_from_numpy(tree, device)` / `lora_state_from_numpy(state,
  device)`: the JAX package's adapter tree, or its whole `LoraState`
  (step, adapters, AdamW count/mu/nu), becomes the port's, so both
  packages train adapters from one JAX init;
- `load_packed(directory, device)`: reads the `save_packed` export
  (`<dir>/packed/manifest.json` + `weights.bin`) that the JAX package
  writes for cold starts, without JAX;
- `save_packed(directory, params)`: writes that export from port params,
  byte for byte what the JAX `checkpoint.save_packed` writes for the same
  values, so either package loads what the other saved.

The packed reader and writer (`read_manifest` and `read_leaves`,
`write_leaves`) also carry the port's train-state checkpoints
(workloads/checkpoint.py).

bf16: numpy has no bfloat16 of its own. A JAX bf16 array converts to an
`ml_dtypes` dtype that `torch.from_numpy` refuses, and the packed manifest
names the dtype "bfloat16". Both are recognised by name and their bits
reinterpreted as uint16 -> torch.bfloat16, which needs no `ml_dtypes`.
"""

import json
import os
from pathlib import Path
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Tuple, Union)

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

_DTYPES = {
    "float32": torch.float32, "float16": torch.float16, "int8": torch.int8,
    "int32": torch.int32, "int64": torch.int64, "uint8": torch.uint8,
    "bool": torch.bool, "bfloat16": torch.bfloat16,
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


def read_manifest(path: Path) -> Optional[List[Dict[str, Any]]]:
    """The manifest under `path` ({name, shape, dtype, offset, nbytes} per
    leaf), or None when it or weights.bin is absent."""
    man_path = path / _PACKED_MANIFEST
    if not man_path.exists() or not (path / _PACKED_WEIGHTS).exists():
        return None
    return json.loads(man_path.read_text())


def read_leaves(path: Path, manifest: List[Dict[str, Any]],
                keep: Optional[Callable[[str], bool]] = None
                ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, host tensor) for each leaf of `manifest` whose name `keep`
    accepts, in manifest order, each read from `path`/weights.bin straight
    into a fresh tensor (one leaf is read at a time)."""
    bin_path = path / _PACKED_WEIGHTS
    with open(bin_path, "rb") as f:
        for spec in manifest:
            name = spec["name"]
            if keep is not None and not keep(name):
                continue
            dtype = _DTYPES.get(spec["dtype"])
            if dtype is None:
                raise ValueError(f"packed checkpoint: unsupported dtype {spec['dtype']!r}")
            buf = torch.empty(int(spec["nbytes"]), dtype=torch.uint8)
            f.seek(spec["offset"])
            if f.readinto(buf.numpy()) != buf.numel():
                raise ValueError(f"packed checkpoint: {bin_path} ends inside `{name}`")
            yield name, buf.view(dtype).reshape(tuple(int(d) for d in spec["shape"]))


def dtype_name(dtype: torch.dtype) -> str:
    """The manifest's name of a torch dtype ("bfloat16", "float32", ...)."""
    return str(dtype).removeprefix("torch.")


def unflatten_params(pairs: Iterable[Tuple[str, torch.Tensor]]) -> Params:
    """[(path, tensor)] -> the nested dict, `path.q` + `path.scale` pairs
    regrouped into QTensor leaves: the inverse of `flatten_params` (the
    reference's `_unflatten_params`)."""
    tree: Params = {}
    qpairs: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, t in pairs:
        if name.endswith(_Q_SUFFIX):
            qpairs.setdefault(name[: -len(_Q_SUFFIX)], {})["q"] = t
        elif name.endswith(_SCALE_SUFFIX):
            qpairs.setdefault(name[: -len(_SCALE_SUFFIX)], {})["scale"] = t
        else:
            _insert(tree, name, t)
    for base, qs in qpairs.items():
        if set(qs) != {"q", "scale"}:
            raise ValueError(f"packed checkpoint: incomplete QTensor `{base}`")
        _insert(tree, base, QTensor(q=qs["q"], scale=qs["scale"]))
    return tree


def load_packed(directory: Union[str, Path],
                device: DeviceLike = None) -> Optional[Params]:
    """Restore a JAX `checkpoint.save_packed` export, or None when absent.

    The manifest lists every leaf as {name, shape, dtype, offset, nbytes};
    names are "/"-joined dict paths and a QTensor contributes `path.q` +
    `path.scale`."""
    dev = resolve_device(device)
    path = Path(directory) / _PACKED_DIR
    manifest = read_manifest(path)
    if manifest is None:
        return None
    return unflatten_params((name, t.to(dev)) for name, t in read_leaves(path, manifest))


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


def write_leaves(path: Path, pairs: Iterable[Tuple[str, torch.Tensor]], *,
                 sync: bool = False) -> None:
    """Write `path/{manifest.json,weights.bin}` (`path` created): every
    leaf contiguous at a 64-byte-aligned offset, manifest entries {name,
    shape, dtype, offset, nbytes} in the order given. Both files are
    written under temporary names and renamed, so a killed writer never
    leaves a half export behind a valid-looking path; with `sync` both
    reach the disk (fsync) before the renames."""
    path.mkdir(parents=True, exist_ok=True)
    manifest = []
    tmp_bin = path / (_PACKED_WEIGHTS + ".tmp")
    with open(tmp_bin, "wb") as f:
        for name, leaf in pairs:
            a, dtype = _to_numpy(leaf)
            pad = (-f.tell()) % _PACKED_ALIGN
            if pad:
                f.write(b"\0" * pad)
            manifest.append({"name": name, "shape": list(a.shape), "dtype": dtype,
                             "offset": f.tell(), "nbytes": int(a.nbytes)})
            f.write(a.reshape(-1).view(np.uint8))
        if sync:
            f.flush()
            os.fsync(f.fileno())
    tmp_man = path / (_PACKED_MANIFEST + ".tmp")
    with open(tmp_man, "w") as f:
        f.write(json.dumps(manifest, separators=(",", ":")))
        if sync:
            f.flush()
            os.fsync(f.fileno())
    tmp_bin.replace(path / _PACKED_WEIGHTS)
    tmp_man.replace(path / _PACKED_MANIFEST)


def save_packed(directory: Union[str, Path], params: Params) -> Path:
    """Write `<dir>/packed/{manifest.json,weights.bin}` (`write_leaves`),
    leaves in sorted path order, as the JAX `checkpoint.save_packed`."""
    path = Path(directory) / _PACKED_DIR
    write_leaves(path, flatten_params(params))
    return path


def _adam_from_numpy(opt_state: Any, dev: torch.device):
    """The AdamW (count, mu, nu) of an optax state with numpy leaves: the
    chain element that holds them (`ScaleByAdamState`)."""
    from dstack_tpu_torch.workloads.train import AdamState

    adam = [s for s in opt_state if all(hasattr(s, k) for k in ("count", "mu", "nu"))]
    if len(adam) != 1:
        raise ValueError("opt_state holds no single AdamW (count, mu, nu) state")
    return AdamState(int(adam[0].count), params_from_numpy(adam[0].mu, dev),
                     params_from_numpy(adam[0].nu, dev))


def train_state_from_numpy(state: Any, device: DeviceLike = None):
    """The JAX package's `TrainState(step, params, opt_state)` with numpy
    leaves (`jax.tree.map(np.asarray, state)`) -> the port's TrainState:
    the step, params marked for grad, and the AdamW moments and count from
    the optax state's `ScaleByAdamState` (the chain element that holds
    count, mu and nu; mu f32, nu in the param dtype, as both keep them)."""
    from dstack_tpu_torch.workloads.train import TrainState

    dev = resolve_device(device)
    params = params_from_numpy(state.params, dev)
    for _, p in flatten_params(params):
        p.requires_grad_(True)
    return TrainState(int(state.step), params, _adam_from_numpy(state.opt_state, dev))


def lora_from_numpy(tree: Any, device: DeviceLike = None) -> Params:
    """A JAX adapter tree `{"layers": {f"{t}_a", f"{t}_b"}}` with numpy
    leaves -> the port's, in the same layout and dtypes (a serving
    registry's load or `merge_lora` takes it as is)."""
    layers = tree.get("layers") if isinstance(tree, dict) else None
    if not layers:
        raise ValueError("an adapter tree is {'layers': {...}}")
    return params_from_numpy({"layers": layers}, device)


def lora_state_from_numpy(state: Any, device: DeviceLike = None):
    """The JAX package's `LoraState(step, lora, opt_state)` with numpy
    leaves -> the port's lora.LoraState: the step, the adapters marked for
    grad, and the AdamW moments and count of the adapter tree."""
    from dstack_tpu_torch.workloads.lora import LoraState

    dev = resolve_device(device)
    lora = lora_from_numpy(state.lora, dev)
    for _, t in flatten_params(lora):
        t.requires_grad_(True)
    return LoraState(int(state.step), lora, _adam_from_numpy(state.opt_state, dev))
