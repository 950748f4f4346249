"""Device resolution: the card by default, the CPU only when asked.

Every entry point that touches tensors (``Sloth``, ``record``,
``failrank``, ``failrank_dense``) resolves its ``device`` argument here.
There is no silent fallback: without a card, ``device=None`` raises, and
only an explicit ``"cpu"`` selects the plain torch versions of the
kernels.
"""

from __future__ import annotations

import torch


def cuda_available() -> bool:
    return torch.cuda.is_available()


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda:0``; a CUDA device without a card raises; any
    other spelling is passed to ``torch.device``."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda" and not cuda_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is present; "
            "pass device='cpu' to run the plain torch path")
    return dev
