"""The device an entry point runs on: the card unless the caller asks for
the CPU, and never the CPU in place of a missing card."""
from __future__ import annotations

import torch


def require_device(cli: str, device: str) -> None:
    """Exit with one line when ``device`` is the card and there is none."""
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{cli}: no CUDA device is available; pass --device cpu to run "
                         "on the CPU")


def resolve_device(device, who: str) -> torch.device:
    """``device``: None (the card), a name or a ``torch.device``; checked by
    ``require_device`` under the name ``who``."""
    dev = torch.device(device or "cuda")
    require_device(who, dev.type)
    return dev
