"""Explicit device selection.

The port never picks a device on its own: solvers take ``device=``
(default ``"cuda"``) and a CUDA request without a card is an error, not a
silent move to the CPU.  The CPU runs only when the caller asks for it.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """Turn a ``device=`` argument into a ``torch.device``, or raise."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")
    return dev
