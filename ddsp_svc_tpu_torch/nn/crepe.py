"""CREPE "full" pitch estimator.

Counterpart of `ddsp_svc_tpu/nn/crepe.py`: 1024-sample windows of 16 kHz
audio at a 5 ms hop, each normalised to zero mean and unit std; six strided
convs (1 -> 1024 -> 128 -> 128 -> 128 -> 256 -> 512 channels; the first k512
s4 padded (254, 254), the rest k64 padded (31, 32)), each ReLU -> BatchNorm
(folded into a per-channel scale and bias) -> maxpool 2; a time-major
flatten (B, 4, 512) -> 2048, the 360-bin sigmoid classifier. The network
runs on the device in chunks of frames; the band-limited Viterbi decode and
the weighted local-average cents stay host numpy, as in JAX. No TPU kernel
computes any of it: it runs on stock PyTorch ops (cuDNN convs, cuBLAS).

`load_torchcrepe_state_dict` reads torchcrepe's `full.pth` (Conv2d weights
(out, in, k, 1), BatchNorm running statistics), folding BatchNorm as the JAX
package's `convert_crepe_state_dict` does.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.device import resolve_device
from .layers import lecun_init_

CENTS_PER_BIN = 20.0
CENTS_OFFSET = 1997.3794084376191
N_BINS = 360
WINDOW_SIZE = 1024
HOP_16K = 80  # 5 ms at 16 kHz
# (out channels, kernel, stride, (pad left, pad right)) of the six convs
SPECS = ((1024, 512, 4, (254, 254)), (128, 64, 1, (31, 32)),
         (128, 64, 1, (31, 32)), (128, 64, 1, (31, 32)),
         (256, 64, 1, (31, 32)), (512, 64, 1, (31, 32)))


class CrepeFull(nn.Module):
    """(B, 1024) normalised frames -> (B, 360) bin probabilities."""

    def __init__(self):
        super().__init__()
        c_in = 1
        for i, (ch, k, _, _) in enumerate(SPECS, start=1):
            setattr(self, f"conv{i}", nn.Conv1d(c_in, ch, k))
            self.register_parameter(f"bn{i}_scale",
                                    nn.Parameter(torch.ones(ch)))
            self.register_parameter(f"bn{i}_bias", nn.Parameter(torch.zeros(ch)))
            c_in = ch
        self.classifier = nn.Linear(4 * 512, N_BINS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x[:, None, :]
        for i, (_, _, s, pad) in enumerate(SPECS, start=1):
            conv = getattr(self, f"conv{i}")
            x = F.relu(F.conv1d(F.pad(x, pad), conv.weight, conv.bias,
                                stride=s))
            x = (x * getattr(self, f"bn{i}_scale")[:, None]
                 + getattr(self, f"bn{i}_bias")[:, None])
            x = F.max_pool1d(x, 2)
        # (B, 512, 4) -> time-major (B, 4 * 512), as flax's (B, T, C) reshape
        x = x.transpose(1, 2).reshape(x.shape[0], -1)
        return torch.sigmoid(self.classifier(x))


def load_torchcrepe_state_dict(model: CrepeFull, sd: Mapping) -> CrepeFull:
    """torchcrepe `full.pth` -> `model`, BatchNorm folded into scale =
    gamma / sqrt(var + 1e-5), bias = beta - mean scale."""
    own = {}
    for i in range(1, 7):
        own[f"conv{i}.weight"] = sd[f"conv{i}.weight"][..., 0]
        own[f"conv{i}.bias"] = sd[f"conv{i}.bias"]
        bn = f"conv{i}_BN."
        scale = sd[bn + "weight"] / torch.sqrt(sd[bn + "running_var"] + 1e-5)
        own[f"bn{i}_scale"] = scale
        own[f"bn{i}_bias"] = sd[bn + "bias"] - sd[bn + "running_mean"] * scale
    own["classifier.weight"] = sd["classifier.weight"]
    own["classifier.bias"] = sd["classifier.bias"]
    model.load_state_dict(own)
    return model


def _viterbi(logits: np.ndarray) -> np.ndarray:
    """Band-limited Viterbi decode (torchcrepe transition prior:
    max(12 - |i-j|, 0), row-normalized). logits :: (T, 360) probabilities."""
    t, n = logits.shape
    idx = np.arange(n)
    transition = np.maximum(12 - np.abs(idx[:, None] - idx[None, :]), 0).astype(np.float64)
    transition = transition / transition.sum(axis=1, keepdims=True)
    log_trans = np.log(transition + 1e-16)
    probs = logits.astype(np.float64)
    probs = probs / (probs.sum(axis=1, keepdims=True) + 1e-16)
    log_probs = np.log(probs + 1e-16)

    value = log_probs[0] + np.log(1.0 / n)
    ptr = np.zeros((t, n), dtype=np.int32)
    for i in range(1, t):
        scores = value[:, None] + log_trans
        ptr[i] = np.argmax(scores, axis=0)
        value = scores[ptr[i], idx] + log_probs[i]
    bins = np.zeros(t, dtype=np.int32)
    bins[-1] = int(np.argmax(value))
    for i in range(t - 2, -1, -1):
        bins[i] = ptr[i + 1][bins[i + 1]]
    return bins


def _local_average_cents(probs: np.ndarray, bins: np.ndarray) -> np.ndarray:
    """Weighted average of cents in a +-4-bin window around the decoded bin."""
    t = probs.shape[0]
    cents_map = CENTS_PER_BIN * np.arange(N_BINS) + CENTS_OFFSET
    out = np.zeros(t)
    for i in range(t):
        lo = max(0, bins[i] - 4)
        hi = min(N_BINS, bins[i] + 5)
        w = probs[i, lo:hi]
        out[i] = (w * cents_map[lo:hi]).sum() / (w.sum() + 1e-12)
    return out


def decode(probs: np.ndarray, fmin: float, fmax: float
           ) -> Tuple[np.ndarray, np.ndarray]:
    """(T, 360) probabilities -> (f0 [Hz], periodicity) on the host: bins
    outside [fmin, fmax] zeroed, Viterbi, local-average cents."""
    cents_map = CENTS_PER_BIN * np.arange(N_BINS) + CENTS_OFFSET
    freq_map = 10.0 * 2.0 ** (cents_map / 1200.0)
    probs_masked = np.where((freq_map >= fmin) & (freq_map <= fmax), probs,
                            0.0)
    bins = _viterbi(probs_masked)
    cents = _local_average_cents(probs_masked, bins)
    f0 = 10.0 * 2.0 ** (cents / 1200.0)
    periodicity = probs[np.arange(len(bins)), bins]
    return f0.astype(np.float32), periodicity.astype(np.float32)


class CrepeExtractor:
    """predict(wav16k) -> (f0 [Hz], periodicity) on the 5 ms grid. Weights
    from `seed` (the JAX extractor's are random too) unless a torchcrepe
    checkpoint is loaded."""

    def __init__(self, fmin: float = 50.0, fmax: float = 2006.0, device=None,
                 seed: int = 0, model: Optional[CrepeFull] = None):
        self.fmin, self.fmax = fmin, fmax
        self.device = resolve_device(device)
        if model is None:
            model = lecun_init_(CrepeFull(), torch.Generator().manual_seed(seed))
        self.model = model.to(self.device).eval()

    def load_torch_checkpoint(self, path: str) -> None:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        load_torchcrepe_state_dict(self.model, sd)

    def frames(self, wav16k) -> torch.Tensor:
        """Centred 1024-sample windows at a 5 ms hop (zero padded), each
        normalised to zero mean and unit std, on the device: (T, 1024).
        wav16k: a numpy array or a tensor."""
        x = torch.as_tensor(wav16k, dtype=torch.float32, device=self.device)
        n_frames = 1 + x.shape[0] // HOP_16K
        pad = WINDOW_SIZE // 2
        x = F.pad(x, (pad, pad + WINDOW_SIZE))
        frames = x.unfold(0, WINDOW_SIZE, HOP_16K)[:n_frames]
        frames = frames - frames.mean(dim=1, keepdim=True)
        return frames / frames.std(dim=1, keepdim=True,
                                   unbiased=False).clamp(min=1e-10)

    @torch.no_grad()
    def probabilities(self, wav16k, batch_size: int = 512
                      ) -> np.ndarray:
        """(T, 360) bin probabilities, the network run in chunks of
        batch_size frames."""
        frames = self.frames(wav16k)
        probs = [self.model(frames[i:i + batch_size])
                 for i in range(0, frames.shape[0], batch_size)]
        return torch.cat(probs).cpu().numpy()

    def predict(self, wav16k, batch_size: int = 512
                ) -> Tuple[np.ndarray, np.ndarray]:
        return decode(self.probabilities(wav16k, batch_size), self.fmin,
                      self.fmax)
