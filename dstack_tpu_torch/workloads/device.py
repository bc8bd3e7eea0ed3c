"""Device resolution for every entry point of the port.

`device=None` means the card. Without a CUDA device that raises: the port
never slides onto the CPU on its own, because a CPU run would report
host-kernel speeds under the name of the serving path. Tests pass
`device="cpu"` explicitly.
"""

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' explicitly to run the"
                " port's plain PyTorch path on the host"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type == "cuda" and dev.index is None:
        # "cuda" names the current card; tensors report it with its index.
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def host_to_device(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """Small host data (token ids, a table row) onto `device` without
    waiting for the device: a plain copy from pageable memory would
    synchronise the stream, so CUDA copies go through pinned memory with
    non_blocking (the caching host allocator keeps the staging buffer
    alive until the copy has run)."""
    t = torch.as_tensor(values, dtype=dtype)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
