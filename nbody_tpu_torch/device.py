"""Device selection: the port runs on one CUDA card, or on the CPU for tests.

Asking for `cuda` where no card is visible raises: no code path of the
port falls back to the CPU on its own.
"""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """'cuda' -> the current CUDA device (raises without one); 'cpu'."""
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda", torch.cuda.current_device())
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unknown device {name!r}: expected 'cuda' or 'cpu'")
