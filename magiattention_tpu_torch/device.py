"""Where the port's entry points run: the card, unless the caller asks for
the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``device`` as given, or the current CUDA device when it is None.

    Raises when no device was named and no GPU is visible: the entry points
    never fall back to the CPU on their own (pass ``device="cpu"`` to run
    the plain versions there)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())
