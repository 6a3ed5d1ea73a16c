"""Device selection: every entry point takes an explicit ``device`` that
defaults to ``cuda``; the CPU runs only when the caller asks for it."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when a card is asked for
    and none is present (the port never carries on on the CPU instead)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available "
            "(pass device='cpu' to run the plain PyTorch versions)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
