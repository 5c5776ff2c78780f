"""Frame-wise RMS volume.

Counterpart of `ddsp_svc_tpu/ops/volume.py`: reflect-pad (hop//2,
(hop+1)//2), then per non-overlapping hop window sqrt(mean(x^2));
n_frames = len(audio)//hop + 1. The host form takes a fractional hop
(frame n spans [int(n hop), int((n+1) hop))), used when the input's sample
rate differs from the model's.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def extract_volume(audio: torch.Tensor, hop_size: int) -> torch.Tensor:
    """(..., T) -> (..., T//hop + 1) frame RMS."""
    t = audio.shape[-1]
    n_frames = t // hop_size + 1
    lead = audio.shape[:-1]
    x = F.pad(audio.reshape(-1, 1, t), (hop_size // 2, (hop_size + 1) // 2),
              mode="reflect").reshape(*lead, -1)
    x2 = (x[..., :n_frames * hop_size] ** 2).reshape(*lead, n_frames, hop_size)
    return torch.sqrt(x2.mean(dim=-1))


def extract_volume_np(audio: np.ndarray, hop_size: float) -> np.ndarray:
    """Host form for a fractional hop: (T,) -> (int(T // hop) + 1,)."""
    t = audio.shape[-1]
    n_frames = int(t // hop_size) + 1
    x = np.pad(audio, (int(hop_size // 2), int((hop_size + 1) // 2)),
               mode="reflect")
    cs = np.concatenate([[0.0], np.cumsum(x.astype(np.float64) ** 2)])
    starts = (np.arange(n_frames) * hop_size).astype(np.int64)
    ends = np.minimum(((np.arange(n_frames) + 1) * hop_size).astype(np.int64),
                      len(x))
    counts = np.maximum(ends - starts, 1)
    return np.sqrt((cs[ends] - cs[starts]) / counts).astype(np.float32)
