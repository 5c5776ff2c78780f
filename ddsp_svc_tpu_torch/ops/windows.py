"""Periodic windows (torch.hann_window conventions) and the symmetric Hann
window of the autocorrelation pitch tracker, computed in float64 on
the host and cast, as `ddsp_svc_tpu/ops/windows.py` does, so both packages
hold bit-identical window constants.

Each window is made once per (length, dtype, device) and then shared: a
window built on the host and copied to the card on every call would be a
host-to-device copy inside a captured CUDA graph, which a capture forbids.
Callers treat the returned tensor as read-only. Under torch.export or
torch.compile a window is made afresh and not kept: a traced tensor is a
fake one, which an eager caller must never get back."""
from __future__ import annotations

import functools

import numpy as np
import torch

_CACHE: dict = {}


def _cached(make):
    """make(n) -> float64 numpy window, served as a tensor made once per
    (n, dtype, device)."""
    @functools.wraps(make)
    def window(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
        if torch.compiler.is_compiling():
            return torch.as_tensor(make(n), dtype=dtype, device=device)
        key = (make.__name__, n, dtype, torch.device(device or "cpu"))
        w = _CACHE.get(key)
        if w is None:
            w = _CACHE[key] = torch.as_tensor(make(n), dtype=dtype,
                                              device=device)
        return w
    return window


def _periodic_hann(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / max(n, 1))


@_cached
def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window of length n."""
    return _periodic_hann(n)


@_cached
def bartlett_window(n: int) -> np.ndarray:
    """Periodic Bartlett (triangular) window of length n (the analysis
    window of the LTV-FIR filter's frames)."""
    return 1.0 - np.abs(2.0 * np.arange(n) / max(n, 1) - 1.0)


@_cached
def sqrt_hann_window(n: int) -> np.ndarray:
    """sqrt of the periodic Hann window: the 50%-overlap analysis/synthesis
    window of the CombSubFast synthesizer."""
    return np.sqrt(_periodic_hann(n))


@_cached
def hann_window_symmetric(n: int) -> np.ndarray:
    """Symmetric Hann window of length n (numpy/scipy convention)."""
    if n == 1:
        return np.ones((1,))
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))
