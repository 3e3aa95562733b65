"""Device selection: the port runs on the card unless the caller asks for
the CPU, and never falls back to the CPU by itself."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d
