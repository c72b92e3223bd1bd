"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Set, Union

import torch

from .utils.observability import span

DeviceLike = Optional[Union[str, torch.device]]

#: the cards whose CUDA context this process has made
_READY: Set[int] = set()


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card (``cuda``). Raises when the card is asked for
    and there is none: the port never drops to the CPU on its own; pass
    ``device="cpu"`` to run the plain PyTorch versions. The first call for
    a card makes its CUDA context (the span ``setup.device_init``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rtlamr_tpu_torch: no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"rtlamr_tpu_torch: unsupported device {dev}")
    if dev.type == "cuda":
        index = torch.cuda.current_device() if dev.index is None else dev.index
        if index not in _READY:
            # The card's context, made here once rather than at the first
            # allocation.
            with span("setup.device_init"):
                torch.cuda.synchronize(index)
            _READY.add(index)
    return dev
