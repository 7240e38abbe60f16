"""Device choice: explicit, with no fallback."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``"cuda"``, ``"cuda:N"`` or ``"cpu"`` as a ``torch.device``.

    Raises when CUDA is asked for and ``torch.cuda.is_available()`` is
    false: a run that asked for the card never carries on on the CPU.
    A bare ``"cuda"`` resolves to the current CUDA device index.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (use cuda or cpu)")
    return dev
