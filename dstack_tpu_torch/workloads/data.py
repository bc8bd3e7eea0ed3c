"""Training data pipeline (port of `dstack_tpu.workloads.data`, lines
37-215).

- `TokenDataset`: a flat int32 token .npy, memmapped, cut into rows of
  `seq_len + 1` tokens; each epoch's row order is a permutation from a
  seeded numpy `default_rng`, the same order the JAX loader draws.
- `BatchLoader`: pre-shifted inputs/targets (B, S) int32 on the device,
  prefetched on a background thread; CUDA copies go through pinned
  memory. A prefetch failure is raised on the consumer, never a hang.
- `encode_bytes` / `write_token_file`: build the .npy from raw text
  (byte-level, the example tokenizer).

On a training mesh over ranks (`BatchLoader(mesh=)`) every rank derives
the same global batch order and reads only the rows BATCH_SPEC gives its
(data, fsdp) coordinate, as the reference's shard callback
(`data.py:128-140`) reads only its devices' windows, and keeps the
stretch of the sequence its seq coordinate gives it (inputs and targets
alike); the global batch is unchanged. The ranks of a model or expert line
share a (data, fsdp) coordinate, so they read the same rows.
"""

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from dstack_tpu_torch.workloads.device import DeviceLike, resolve_device
from dstack_tpu_torch.workloads.sharding import (
    BATCH_SPEC,
    batch_shards,
    seq_ranks,
    shard,
    training_mesh,
)


def encode_bytes(text: str, vocab_size: int) -> np.ndarray:
    """Byte-level token ids (the example tokenizer), clipped to the vocab."""
    b = np.frombuffer(text.encode(), dtype=np.uint8).astype(np.int32)
    return np.minimum(b, vocab_size - 1)


def write_token_file(path: str, tokens: np.ndarray) -> None:
    """Flat int32 .npy the loader memmaps."""
    np.save(path, np.asarray(tokens, dtype=np.int32))


class TokenDataset:
    """Fixed-length rows of `seq_len + 1` tokens over a flat memmapped
    token array; a trailing partial row is dropped."""

    def __init__(self, path: str, seq_len: int):
        self.tokens = np.load(path, mmap_mode="r")
        if self.tokens.ndim != 1:
            raise ValueError(f"{path}: expected a flat token array")
        self.seq_len = seq_len
        self.row = seq_len + 1
        self.n_rows = len(self.tokens) // self.row
        if self.n_rows == 0:
            raise ValueError(f"{path}: {len(self.tokens)} tokens < one row of {self.row}")

    def epoch_order(self, epoch: int, seed: int = 0) -> np.ndarray:
        """The epoch's row permutation (the reference's, seed for seed)."""
        rng = np.random.default_rng(seed * 1_000_003 + epoch)
        return rng.permutation(self.n_rows)

    def rows(self, idx: np.ndarray) -> np.ndarray:
        """Gather rows (len(idx), seq_len + 1) from the memmap."""
        out = np.empty((len(idx), self.row), dtype=np.int32)
        for i, r in enumerate(idx):
            start = int(r) * self.row
            out[i] = self.tokens[start:start + self.row]
        return out


def _global_batches(ds: TokenDataset, batch_size: int, seed: int,
                    start_step: int) -> Iterator[np.ndarray]:
    """Endless stream of batch row indices, deterministic in the step, so
    a resume at `start_step` re-derives its position with no state file."""
    per_epoch = ds.n_rows // batch_size
    step = start_step
    cached = (-1, None)  # one permutation per epoch, not per batch
    while True:
        epoch, within = divmod(step, per_epoch)
        if cached[0] != epoch:
            cached = (epoch, ds.epoch_order(epoch, seed))
        yield cached[1][within * batch_size:(within + 1) * batch_size]
        step += 1


class BatchLoader:
    """Background-prefetched batches on `device` (default: the card).
    `batch_size` is the global batch; on a training `mesh` over ranks
    each batch holds this rank's rows of it, on the mesh's device."""

    def __init__(self, dataset: TokenDataset, batch_size: int, *,
                 device: DeviceLike = None, seed: int = 0, start_step: int = 0,
                 prefetch: int = 2, vocab_size: Optional[int] = None, mesh=None):
        self.dataset = dataset
        # Fail fast: the generator body would only run on the prefetch thread.
        if dataset.n_rows < batch_size:
            raise ValueError(f"dataset has {dataset.n_rows} rows < batch_size {batch_size}")
        self.mesh = training_mesh(mesh) if mesh is not None and mesh.ranked else None
        if batch_size % batch_shards(self.mesh):
            raise ValueError(f"batch_size {batch_size} does not split over the"
                             f" {batch_shards(self.mesh)} data x fsdp ranks")
        if dataset.seq_len % seq_ranks(self.mesh):
            raise ValueError(f"seq_len {dataset.seq_len} does not split over the"
                             f" {seq_ranks(self.mesh)} seq ranks")
        self.batch_size = batch_size
        self.device = resolve_device(device) if self.mesh is None else self.mesh.device
        self._source = _global_batches(dataset, batch_size, seed, start_step)
        self._vocab_size = vocab_size
        self._q: "queue.Queue[object]" = queue.Queue(maxsize=prefetch)
        self._stop = False
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _check_vocab(self, arr: np.ndarray) -> None:
        if self._vocab_size is not None and arr.max(initial=0) >= self._vocab_size:
            raise ValueError(
                f"corpus token id {int(arr.max())} >= vocab_size {self._vocab_size}"
                " — wrong tokenizer for this model (an out-of-range id would"
                " index past the embedding; failing loud instead)")

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _place(self, idx: np.ndarray) -> Dict[str, torch.Tensor]:
        # This rank's rows of the global batch and its stretch of their
        # sequence (all of both off a mesh).
        idx = shard(torch.from_numpy(idx), BATCH_SPEC[:1], self.mesh).numpy()
        rows = self.dataset.rows(idx)
        self._check_vocab(rows)

        def cut(a):
            return shard(torch.from_numpy(a), (None, BATCH_SPEC[1]), self.mesh).numpy()

        return {"inputs": self._to_device(cut(rows[:, :-1])),
                "targets": self._to_device(cut(rows[:, 1:]))}

    def _fill(self) -> None:
        try:
            for idx in self._source:
                if self._stop:
                    return
                placed = self._place(idx)
                while not self._stop:
                    try:
                        self._q.put(placed, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if self._stop:
                    return
        except Exception as e:  # surface on the consumer, never hang it
            self._q.put(e)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        item = self._q.get()
        if isinstance(item, BaseException):
            raise RuntimeError(f"data loader failed: {item}") from item
        return item

    def close(self) -> None:
        self._stop = True
        try:  # unblock a producer waiting on a full queue
            self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
