"""Device selection shared by the port's entry points."""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"


def resolve(device=DEFAULT_DEVICE) -> torch.device:
    """The torch.device an entry point runs on. The default is the
    CUDA card; with no CUDA device this raises rather than carrying on
    on the CPU — CPU runs must ask for ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run "
            "on the CPU")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """ModelConfig.dtype string ("bfloat16", "float32") -> torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def to_device(array, device: torch.device) -> torch.Tensor:
    """A host array as a new tensor on ``device``, queued without
    waiting: on a card the copy goes through pinned memory with
    ``non_blocking=True``, so the host does not wait for the work in
    flight (a copy from pageable memory synchronises the stream). The
    pinned buffer is held until the copy has run."""
    host = torch.tensor(np.asarray(array))
    if device.type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)
