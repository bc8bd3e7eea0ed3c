"""Meshes for the port (a subset of `dstack_tpu.workloads.sharding`,
`AXES` and `make_mesh`, lines 27-53).

The axes are the reference's: data, fsdp, seq, model, expert. This slice
runs one mesh shape: one device with a `seq` axis of n, whose n sequence
shards take turns on that device through the ring
(`attention._ring_attention_local`). Any other axis above 1, or more than
one device, belongs to the sharding slice (torch.distributed, one rank per
card) and raises.
"""

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch

from dstack_tpu_torch.workloads.device import DeviceLike, resolve_device

AXES = ("data", "fsdp", "seq", "model", "expert")


_UNPORTED = ("the port runs one device with a seq axis (the ring's shards take"
             " turns on it); other axes and more devices belong to the sharding"
             " slice (torch.distributed; ROADMAP Queue 1 item 3), not ported yet")


@dataclass(frozen=True)
class Mesh:
    """One device and the size of each axis (`shape`, axis -> size, the
    field `make_attention_fn` and the remat estimate read); only `seq` may
    be above 1."""

    device: torch.device
    shape: Dict[str, int]

    def __post_init__(self):
        if set(self.shape) != set(AXES) or any(n < 1 for n in self.shape.values()):
            raise ValueError(f"mesh axes {AXES} must each be >= 1, got {self.shape}")
        if any(n > 1 for a, n in self.shape.items() if a != "seq"):
            raise NotImplementedError(f"mesh {self.shape}: {_UNPORTED}")


def make_mesh(devices: Optional[Sequence[DeviceLike]] = None, *, data: int = 1,
              fsdp: Optional[int] = None, seq: int = 1, model: int = 1,
              expert: int = 1) -> Mesh:
    """A mesh over `devices` (default: the CUDA device). `fsdp=None`
    takes the factor left after the other axes, which on one device is 1."""
    devices = [resolve_device(None)] if devices is None else [
        resolve_device(d) for d in devices]
    if len(devices) != 1:
        raise NotImplementedError(f"a mesh over {len(devices)} devices: {_UNPORTED}")
    fsdp = 1 if fsdp is None else fsdp
    return Mesh(devices[0], dict(zip(AXES, (data, fsdp, seq, model, expert))))


def device_shards(mesh: Optional[Mesh]) -> Optional[Dict[str, int]]:
    """The device's real share of the activations, as `resolve_remat`'s
    `shards`. The reference divides the activations by the seq axis, since
    each of its devices holds 1/n of the sequence; here the n seq shards
    take turns on one device, which holds them all: a seq factor of 1."""
    if mesh is None:
        return None
    if not isinstance(mesh, Mesh):
        raise NotImplementedError(f"{type(mesh).__name__} is not a mesh of the port"
                                  f" (sharding.make_mesh): {_UNPORTED}")
    return {**mesh.shape, "seq": 1}
