"""Multi-scale spectral losses of training.

Counterpart of `ddsp_svc_tpu/models/losses.py`:
  - sss_loss: spectral convergence + L1(log magnitude) on a power-1,
    window-normalised, center=False spectrogram with hop n_fft;
  - RSSLoss: per step, n_scale FFT sizes drawn uniformly from 16 linearly
    spaced buckets in [fft_min, fft_max), averaged; `mss` is the
    deterministic all-bucket average used for validation;
  - mel_l1: the log-mel L1 distance.
The spectrogram's magnitude goes through the dft_magnitude kernel on the
card (ops/spectral.py). The per-step draw comes from a host torch.Generator,
or the caller passes the bucket indices (tests pin them).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.spectral import log_mel_spectrogram, spectrogram

N_BUCKETS = 16


def sss_loss(x_true: torch.Tensor, x_pred: torch.Tensor, n_fft: int,
             eps: float = 1e-7) -> torch.Tensor:
    """Single-scale spectral loss of (B, T) signals."""
    s_true = spectrogram(x_true, n_fft) + eps
    s_pred = spectrogram(x_pred, n_fft) + eps
    converge = torch.mean(
        torch.sqrt(torch.sum((s_true - s_pred) ** 2, dim=(1, 2)))
        / torch.sqrt(torch.sum((s_true + s_pred) ** 2, dim=(1, 2))))
    log_term = torch.mean(torch.abs(torch.log(s_true) - torch.log(s_pred)))
    return converge + log_term


def default_buckets(fft_min: int, fft_max: int) -> tuple:
    """N_BUCKETS linearly spaced static FFT sizes spanning [fft_min,
    fft_max) (the JAX package's default set; 256..2048 gives 256, 375, ...,
    2047)."""
    sizes = np.unique(
        np.round(np.linspace(fft_min, fft_max - 1, N_BUCKETS)).astype(int))
    return tuple(int(s) for s in sizes)


class RSSLoss:
    """Random-scale spectral loss over the default bucket set:
    loss = rss(x_pred, x_true, generator) or rss(x_pred, x_true, idx=...)."""

    def __init__(self, fft_min: int = 256, fft_max: int = 2048,
                 n_scale: int = 4, eps: float = 1e-7):
        self.n_scale = n_scale
        self.eps = eps
        self.buckets = default_buckets(fft_min, fft_max)

    def draw(self, generator: Optional[torch.Generator] = None) -> list:
        """n_scale bucket indices, uniform, from a host generator."""
        idx = torch.randint(0, len(self.buckets), (self.n_scale,),
                            generator=generator)
        return [int(i) for i in idx]

    def __call__(self, x_pred: torch.Tensor, x_true: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 idx: Optional[Sequence[int]] = None) -> torch.Tensor:
        idx = self.draw(generator) if idx is None else idx
        total = sum(sss_loss(x_true, x_pred, self.buckets[i], self.eps)
                    for i in idx)
        return total / len(idx)

    def mss(self, x_pred: torch.Tensor, x_true: torch.Tensor) -> torch.Tensor:
        """Deterministic all-bucket average (the validation metric)."""
        total = sum(sss_loss(x_true, x_pred, n, self.eps)
                    for n in self.buckets)
        return total / len(self.buckets)


def mel_l1(x_pred: torch.Tensor, x_true: torch.Tensor, sr: int = 44100,
           n_fft: int = 2048, hop: int = 512, n_mels: int = 128
           ) -> torch.Tensor:
    """Log-mel L1 distance (the JAX package's parity metric)."""
    m_p = log_mel_spectrogram(x_pred, sr, n_fft, hop, n_fft, n_mels, 0.0,
                              sr / 2)
    m_t = log_mel_spectrogram(x_true, sr, n_fft, hop, n_fft, n_mels, 0.0,
                              sr / 2)
    return torch.mean(torch.abs(m_p - m_t))
