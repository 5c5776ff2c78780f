"""Periodic windows (torch.hann_window conventions) and the symmetric Hann
window of the autocorrelation pitch tracker, computed in float64 on
the host and cast, as `ddsp_svc_tpu/ops/windows.py` does, so both packages
hold bit-identical window constants."""
from __future__ import annotations

import numpy as np
import torch


def _periodic_hann(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / max(n, 1))


def hann_window(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann window of length n."""
    return torch.as_tensor(_periodic_hann(n), dtype=dtype, device=device)


def bartlett_window(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Bartlett (triangular) window of length n (the analysis
    window of the LTV-FIR filter's frames)."""
    w = 1.0 - np.abs(2.0 * np.arange(n) / max(n, 1) - 1.0)
    return torch.as_tensor(w, dtype=dtype, device=device)


def sqrt_hann_window(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """sqrt of the periodic Hann window: the 50%-overlap analysis/synthesis
    window of the CombSubFast synthesizer."""
    return torch.as_tensor(np.sqrt(_periodic_hann(n)), dtype=dtype,
                           device=device)


def hann_window_symmetric(n: int, dtype=torch.float32, device=None
                          ) -> torch.Tensor:
    """Symmetric Hann window of length n (numpy/scipy convention)."""
    if n == 1:
        return torch.ones((1,), dtype=dtype, device=device)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))
    return torch.as_tensor(w, dtype=dtype, device=device)
