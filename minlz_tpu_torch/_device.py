"""Explicit device resolution: asking for CUDA without a GPU raises."""

from __future__ import annotations

import torch


def stream_device(device):
    """A stream Reader's or Writer's ``device`` as the JAX package's also
    takes it, a bool: True is the card ("cuda"), False the host (None).
    Anything else is returned as it is."""
    if device is True:
        return "cuda"
    if device is False:
        return None
    return device


def resolve_device(device) -> torch.device:
    """``device``: a torch.device or a string such as "cuda", "cuda:0" or
    "cpu".  Raises RuntimeError for a CUDA device when no GPU is visible;
    nothing drops to the CPU on its own.  A bool raises TypeError (torch
    would read True as the second GPU)."""
    if isinstance(device, bool):
        raise TypeError(f"device must be a torch device or a string, not "
                        f"{device!r}")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch sees no CUDA GPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev
