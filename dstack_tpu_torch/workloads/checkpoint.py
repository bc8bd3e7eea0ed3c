"""Train-state checkpoints on a mounted volume, and the packed serving
export (the counterpart of `dstack_tpu.workloads.checkpoint`).

The orchestrator re-provisions a retried gang with the same volume mounts;
a trainer that calls `save` / `restore_latest` against the volume resumes
at its last saved step instead of step 0, and a drained one
(`train.DrainHandler`) at the step it was drained at.

Format: the reference writes Orbax, which the port cannot import (the
card's machine has no JAX), so the port's train-state format is its own.
One directory per step, the packed layout of `weights.save_packed`:

    <dir>/<step>/manifest.json   {name, shape, dtype, offset, nbytes} per leaf
    <dir>/<step>/weights.bin     params/<path>, mu/<path>, nu/<path> leaves
    <dir>/<step>/state.json      {"format": 1, "step": N, "count": C}

A LoRA run (lora.LoraState) saves its adapters and their moments in the
same layout, as `lora/<path>`, `mu/<path>` and `nu/<path>` leaves: a few
MB where a full state is three times the params. The leaf names keep the
two apart: a full checkpoint does not restore into a LoRA template, nor a
LoRA one into a full template (`_load_into` raises on the names).

Neither package reads the other's train-state checkpoints. Params travel
between them through the packed export (`export_params`, which both
packages' servers load), and a JAX TrainState reaches the port through
`weights.train_state_from_numpy`.

A step is written into a temporary directory beside the others, each file
reaches the disk (fsync), and the directory is then published by rename;
`restore_latest` takes the newest step directory that holds its
state.json, so a killed writer never leaves a half checkpoint that looks
valid. Only the newest MAX_TO_KEEP steps are kept.

`save` is asynchronous by default. The port's train step updates params
and moments in place, so `save` copies every leaf to the host before it
returns (on the CPU too, where `.cpu()` would alias the live storage);
only the file write runs on the directory's background writer, and saves
to one directory are written in order.

A sharded state (a training mesh over ranks, sharding.py) saves and
restores layout-free: `save(mesh=)`, a collective every rank calls, gathers
each leaf whole from every rank's slices (sharding.unshard) and rank 0
writes the one-device format above; `restore_latest(mesh=)` reads the
whole leaves on every rank and keeps the rank's slices. So a checkpoint
saved on one mesh restores on another mesh or on one device bit for bit
(the reference's elastic width change), and `export_params(mesh=)` writes
the whole params `native_server` serves.
"""

import json
import os
import shutil
import tempfile
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from dstack_tpu_torch.workloads.device import DeviceLike, resolve_device
from dstack_tpu_torch.workloads.sharding import global_shape, param_specs, shard, unshard
from dstack_tpu_torch.workloads.weights import (  # noqa: F401  (load_packed re-exported)
    dtype_name,
    flatten_params,
    load_packed,
    read_leaves,
    read_manifest,
    save_packed,
    unflatten_params,
    write_leaves,
)

MAX_TO_KEEP = 3
FORMAT = 1
_STATE = "state.json"
_GROUPS = ("params", "mu", "nu")
_LORA_GROUPS = ("lora", "mu", "nu")

Params = Dict[str, Any]


class _Writer:
    """One background thread per directory (as the reference keeps one
    Orbax manager per directory): saves are written in submission order,
    and a failed write raises on the next save, wait or close."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="checkpoint-writer")
        self._pending: List[Future] = []

    def submit(self, fn) -> None:
        done = [f for f in self._pending if f.done()]
        self._pending = [f for f in self._pending if not f.done()]
        for f in done:
            f.result()
        self._pending.append(self._pool.submit(fn))

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown()


_writers: Dict[str, _Writer] = {}
_lock = threading.Lock()


def _writer(directory: Union[str, Path], create: bool = True) -> Optional[_Writer]:
    key = str(Path(directory).absolute())
    with _lock:
        w = _writers.get(key)
        if w is None and create:
            w = _writers[key] = _Writer()
        return w


def _is_lora(state) -> bool:
    return hasattr(state, "lora")


def _leaves(state) -> List[Tuple[str, torch.Tensor]]:
    """The state's tensors as (group/path, tensor): params (a LoraState's
    adapters: lora), mu, nu."""
    opt = state.opt_state
    groups, first = ((_LORA_GROUPS, state.lora) if _is_lora(state)
                     else (_GROUPS, state.params))
    return [(f"{group}/{path}", t)
            for group, tree in zip(groups, (first, opt.mu, opt.nu))
            for path, t in flatten_params(tree)]


def _leaf_specs(state) -> Dict[str, Tuple]:
    """Each leaf's PARAM_SPECS / LORA_SPECS entry, by its `_leaves` name
    (the moments mirror their params)."""
    opt = state.opt_state
    groups, first = ((_LORA_GROUPS, state.lora) if _is_lora(state)
                     else (_GROUPS, state.params))
    return {f"{group}/{path}": spec
            for group, tree in zip(groups, (first, opt.mu, opt.nu))
            for path, spec in flatten_params(param_specs(tree))}


def _ranked(mesh) -> bool:
    return mesh is not None and mesh.ranked


def _fsync_dir(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _steps(root: Path) -> List[int]:
    """Published steps under `root` (directories named by the step that
    hold their state.json), ascending."""
    if not root.is_dir():
        return []
    return sorted(int(p.name) for p in root.iterdir()
                  if p.name.isdigit() and (p / _STATE).is_file())


def _write(root: Path, step: int, leaves, meta: Dict[str, int]) -> None:
    root.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=f".{step}.", suffix=".tmp", dir=root))
    try:
        os.chmod(tmp, 0o755)  # mkdtemp's 0700 would hide it from other readers
        write_leaves(tmp, leaves, sync=True)
        with open(tmp / _STATE, "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        final = root / str(step)
        if final.exists():  # a second save of one step replaces the first
            old = Path(tempfile.mkdtemp(prefix=f".{step}.", suffix=".old", dir=root))
            final.rename(old / "step")
            tmp.rename(final)
            shutil.rmtree(old, ignore_errors=True)
        else:
            tmp.rename(final)
        _fsync_dir(root)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    for old_step in _steps(root)[:-MAX_TO_KEEP]:
        shutil.rmtree(root / str(old_step), ignore_errors=True)


def save(directory: Union[str, Path], state, *, wait: bool = False, mesh=None) -> int:
    """Write a checkpoint of `state` for `state.step`; returns the step.

    Every leaf is copied to the host before this returns, so the caller
    may step (in place) at once; the write drains in the background unless
    `wait` (or `close_all()` at job end) blocks until it is on disk. On a
    training mesh over ranks every rank calls this: each leaf is gathered
    whole, leaf by leaf, and rank 0 writes."""
    step = int(state.step)
    if _ranked(mesh):
        specs = _leaf_specs(state)
        snapshot = []
        for name, t in _leaves(state):
            whole = unshard(t.detach(), specs[name], mesh)
            if mesh.rank == 0:
                snapshot.append((name, whole.to("cpu", copy=True)))
            del whole
        if mesh.rank:
            return step
    else:
        snapshot = [(name, t.detach().to("cpu", copy=True)) for name, t in _leaves(state)]
    meta = {"format": FORMAT, "step": step, "count": int(state.opt_state.count)}
    w = _writer(directory)
    w.submit(lambda: _write(Path(directory), step, snapshot, meta))
    if wait:
        w.wait()
    return step


def _load_into(path: Path, manifest, targets: List[Tuple[str, torch.Tensor]],
               mesh=None, leaf_specs: Optional[Dict[str, Tuple]] = None) -> None:
    """Copy the leaves of `path` into `targets` [(name, tensor)] in place,
    after checking that names, shapes and dtypes all match (so a mismatch
    leaves the targets untouched). On a mesh over ranks the targets are
    the rank's slices (`leaf_specs`): the whole leaves are checked against
    their whole shapes and each target takes its slice."""
    cut = _ranked(mesh)
    specs = {s["name"]: s for s in manifest}
    want = dict(targets)
    if set(specs) != set(want):
        missing, extra = sorted(set(want) - set(specs)), sorted(set(specs) - set(want))
        raise ValueError(f"checkpoint {path} does not match the template:"
                         f" missing {missing[:5]}, unexpected {extra[:5]}")
    for name, t in want.items():
        s = specs[name]
        shape = global_shape(t, leaf_specs[name], mesh) if cut else tuple(t.shape)
        if list(s["shape"]) != list(shape) or s["dtype"] != dtype_name(t.dtype):
            raise ValueError(f"checkpoint {path}: `{name}` is {s['dtype']} {s['shape']},"
                             f" the template's {dtype_name(t.dtype)} {list(shape)}")
    with torch.no_grad():
        for name, host in read_leaves(path, manifest, keep=want.__contains__):
            want[name].copy_(shard(host, leaf_specs[name], mesh) if cut else host)


def restore_latest(directory: Union[str, Path], template, mesh=None):
    """Restore the newest checkpoint into `template` (a TrainState of the
    same config, e.g. from `init_train_state`, or a lora.LoraState from
    `init_lora_state`), or None when the volume holds no checkpoint yet
    (first run).

    The leaves are read into the template's tensors in place (its device,
    dtypes and shapes; no second state on the device), and the returned
    state carries them with the saved step and optimizer count. On a
    training mesh over ranks (`mesh`, every rank calls this) the template
    holds the rank's slices and each takes its slice of the whole leaf,
    whatever mesh the checkpoint was saved on."""
    from dstack_tpu_torch.workloads.lora import LoraState
    from dstack_tpu_torch.workloads.train import AdamState, TrainState

    root = Path(directory)
    w = _writer(root, create=False)
    if w is not None:
        w.wait()  # this process's own saves first
    if _ranked(mesh):
        torch.distributed.barrier(group=mesh.group)  # and rank 0's, on a mesh
    steps = _steps(root)
    if not steps:
        return None
    path = root / str(steps[-1])
    meta = json.loads((path / _STATE).read_text())
    if meta.get("format") != FORMAT:
        raise ValueError(f"checkpoint {path}: format {meta.get('format')!r},"
                         f" this reader knows {FORMAT}")
    _load_into(path, read_manifest(path), _leaves(template), mesh,
               _leaf_specs(template) if _ranked(mesh) else None)
    opt = template.opt_state
    adam = AdamState(int(meta["count"]), opt.mu, opt.nu)
    if _is_lora(template):
        return LoraState(int(meta["step"]), template.lora, adam)
    return TrainState(int(meta["step"]), template.params, adam)


def restore_latest_params(directory: Union[str, Path],
                          device: DeviceLike = None) -> Optional[Params]:
    """The params of the newest train-state checkpoint on `device` (the
    moments are not read), or None without one: a serving host's fallback
    when the volume holds no packed export. A LoRA checkpoint holds no
    params (only adapters) and reads as None too."""
    dev = resolve_device(device)
    root = Path(directory)
    steps = _steps(root)
    if not steps:
        return None
    path = root / str(steps[-1])
    n = len("params/")
    pairs = [(name[n:], t.to(dev)) for name, t in
             read_leaves(path, read_manifest(path),
                         keep=lambda name: name.startswith("params/"))]
    return unflatten_params(pairs) if pairs else None


def export_params(directory: Union[str, Path], state, mesh=None) -> Path:
    """Write the params-only serving export (`<dir>/packed`, the layout
    both packages' servers load): a serving host need not read the Adam
    moments (~3x the bf16 parameter bytes). A LoRA run exports the merged
    params (`lora.merge_lora`) through a TrainState that carries them. On
    a training mesh over ranks every rank calls this: the params are
    gathered whole and rank 0 writes them."""
    if not _ranked(mesh):
        return save_packed(directory, state.params)
    specs = dict(flatten_params(param_specs(state.params)))
    whole = [(name, unshard(t.detach(), specs[name], mesh).to("cpu"))
             for name, t in flatten_params(state.params)]
    if mesh.rank:
        return Path(directory) / "packed"
    return save_packed(directory, unflatten_params(whole))


def restore_exported_params(directory: Union[str, Path], params_template: Params
                            ) -> Optional[Params]:
    """Restore the params-only export into `params_template`'s tensors in
    place (shapes and dtypes must match), or None when there is none."""
    path = Path(directory) / "packed"
    manifest = read_manifest(path)
    if manifest is None:
        return None
    _load_into(path, manifest, flatten_params(params_template))
    return params_template


def close_all() -> None:
    """Drain and release every directory's writer (job end, drain, tests);
    raises the first failed write after all are closed."""
    with _lock:
        writers = list(_writers.values())
        _writers.clear()
    error = None
    for w in writers:
        try:
            w.close()
        except Exception as e:  # close every writer, then report
            error = error or e
    if error is not None:
        raise error
