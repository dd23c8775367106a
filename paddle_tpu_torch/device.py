"""Where the port runs: the CUDA card unless the caller asks otherwise."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device, ``cuda`` when None.  Raises when CUDA
    is asked for (or defaulted to) and no CUDA device exists: the port
    never falls back to the CPU on its own; pass ``device="cpu"`` to run
    the plain PyTorch path."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on CUDA unless told otherwise, and no "
            "CUDA device is available; pass device='cpu' for the plain "
            "PyTorch path")
    return dev
