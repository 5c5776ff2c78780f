"""Windowed-sinc polyphase resampling as one strided convolution.

Counterpart of `ddsp_svc_tpu/ops/resample.py` (torchaudio
`functional.resample` parity: 'sinc_interp_hann', lowpass_filter_width
128, rolloff 0.99). After reducing the rate pair by its gcd, each of the
`new` output phases gets a Hann-windowed sinc sampled at the input
positions; the filter bank is built on the host in float64, cached per rate
pair (and as a tensor per rate pair, dtype and device, so that a captured
CUDA graph holds no copy of it), and applied as one F.conv1d of stride
`orig` (a plain large product, which the JAX package also leaves to XLA).
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=32)
def _sinc_kernel(orig_freq: int, new_freq: int,
                 lowpass_filter_width: int = 128, rolloff: float = 0.99):
    """The polyphase filter bank: (kernel (new, 2 width + orig) float32,
    width, orig, new), the rates reduced by their gcd. Cached: read-only."""
    g = math.gcd(int(orig_freq), int(new_freq))
    orig, new = int(orig_freq) // g, int(new_freq) // g
    base_freq = min(orig, new) * rolloff
    width = math.ceil(lowpass_filter_width * orig / base_freq)
    idx = np.arange(-width, width + orig, dtype=np.float64)[None, :] / orig
    t = (-np.arange(new, dtype=np.float64)[:, None] / new + idx) * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t = t * np.pi
    kernel = np.where(t == 0.0, 1.0, np.sin(t) / np.where(t == 0.0, 1.0, t))
    kernel = kernel * window * (base_freq / orig)
    return kernel.astype(np.float32), width, orig, new


_KERNELS: dict = {}


def _kernel_tensor(orig_freq: int, new_freq: int, width: int, dtype, device):
    """_sinc_kernel's bank as a (new, 1, taps) tensor on `device`, made once
    per (rates, width, dtype, device) (afresh under torch.compile).
    Read-only."""
    def make():
        return torch.as_tensor(_sinc_kernel(orig_freq, new_freq, width)[0],
                               dtype=dtype, device=device)[:, None, :]

    if torch.compiler.is_compiling():
        return make()
    key = (orig_freq, new_freq, width, dtype, torch.device(device))
    if key not in _KERNELS:
        _KERNELS[key] = make()
    return _KERNELS[key]


def resampled_length(length: int, orig_freq: int, new_freq: int) -> int:
    """The output length of resample: ceil(length * new / orig), the rates
    reduced by their gcd."""
    if orig_freq == new_freq:
        return int(length)
    g = math.gcd(int(orig_freq), int(new_freq))
    return int(math.ceil(int(new_freq) // g * int(length) / (int(orig_freq)
                                                              // g)))


def resample(x: torch.Tensor, orig_freq: int, new_freq: int,
             lowpass_filter_width: int = 128) -> torch.Tensor:
    """Resample a batch of waveforms on x's device: (B, T) ->
    (B, ceil(T * new_freq / orig_freq))."""
    if orig_freq == new_freq:
        return x
    _, width, orig, new = _sinc_kernel(orig_freq, new_freq,
                                       lowpass_filter_width)
    kernel = _kernel_tensor(orig_freq, new_freq, lowpass_filter_width,
                            x.dtype, x.device)
    b, length = x.shape
    target_len = int(math.ceil(new * length / orig))
    xp = F.pad(x, (width, width + orig))
    out = F.conv1d(xp[:, None, :], kernel, stride=orig)
    # interleave the phases: (B, new, steps) -> (B, steps * new)
    return out.transpose(1, 2).reshape(b, -1)[:, :target_len]
