"""Device policy: entry points run on CUDA unless the caller asks for the
CPU. With no GPU and no explicit request they raise; they never carry on
quietly on the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
