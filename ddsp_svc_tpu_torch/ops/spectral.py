"""Framing, overlap-add, STFT, the inverse real FFT of any size, the loss
spectrogram and the NSF-HiFiGAN log-mel frontend.

Transforms go through torch.fft (cuFFT on the card), except two
magnitudes, which go through the dft_magnitude kernel on the card as the
JAX package routes them through dft_magnitude_pallas on the TPU: the loss
spectrogram's (it takes any n_fft) and the staged-bf16 enhancer's mel
(`mxu_bf16`: the bf16-input form). The keyshift/speed mel takes
torch.fft.rfft of its non-power-of-two size (JAX's `rfft_any`, a DFT
product XLA runs, not a Pallas kernel). The mel filterbank is a numpy copy
of `ddsp_svc_tpu/ops/spectral.py::mel_filterbank` (librosa slaney parity),
so both packages share one basis bit for bit; on a device it is made once
per (geometry, device), so that a captured CUDA graph holds no copy of it.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from .kernels import dft_magnitude, dft_magnitude_bf16
from .windows import hann_window


def next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def irfft_any(spec: torch.Tensor, n: int) -> torch.Tensor:
    """irfft of a half spectrum (..., n//2+1) to n real samples, for any n,
    with irfft's semantics: the imaginary parts of the DC bin and, for even
    n, the Nyquist bin are dropped. torch.fft.irfft drops them on the CPU,
    but cuFFT's C2R reads them (measured on an H100 from 2048 rows of n
    1024 up), so they are zeroed first. Counterpart of
    `ddsp_svc_tpu/ops/spectral.py::irfft_any`, whose DFT path drops them.
    The mask is made by comparisons on the device (no host scalar is
    copied in), so a CUDA graph can capture it."""
    bins = torch.arange(spec.shape[-1], device=spec.device)
    keep = bins != 0
    if n % 2 == 0:
        keep = keep & (bins != n // 2)
    return torch.fft.irfft(
        torch.complex(spec.real, spec.imag * keep.to(spec.real.dtype)), n)


def frame_signal(x: torch.Tensor, frame_size: int, hop: int) -> torch.Tensor:
    """(B, T) -> (B, n_frames, frame_size), n = (T - frame)//hop + 1
    (torch unfold semantics)."""
    return x.unfold(-1, frame_size, hop)


def overlap_add_half(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """50%-overlap OLA as two shifted adds. (B, n, 2*hop) -> (B, (n+1)*hop)."""
    b, n, frame = frames.shape
    if frame != 2 * hop:
        raise ValueError(f"frame {frame} != 2 * hop {hop}")
    first = frames[:, :, :hop].reshape(b, n * hop)
    second = frames[:, :, hop:].reshape(b, n * hop)
    pad = frames.new_zeros((b, hop))
    return torch.cat([first, pad], 1) + torch.cat([pad, second], 1)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """General overlap-add (nn.Fold): (B, n, frame) -> (B, (n-1)*hop +
    frame). Built from shifted adds of hop-wide slabs, in a fixed order, so
    that the sum is the same on every run (an index_add_ on CUDA would sum
    in the order its atomics land)."""
    b, n, frame = frames.shape
    k = -(-frame // hop)
    if k * hop != frame:
        frames = F.pad(frames, (0, k * hop - frame))
    out = None
    for j in range(k):
        slab = F.pad(frames[:, :, j * hop:(j + 1) * hop].reshape(b, n * hop),
                     (j * hop, (k - 1 - j) * hop))
        out = slab if out is None else out + slab
    return out[:, :(n - 1) * hop + frame]


def windowed_frames(x: torch.Tensor, n_fft: int, hop: int,
                    window: torch.Tensor) -> torch.Tensor:
    """(B, T) -> (B, n_frames, n_fft) frames times the window; a window
    shorter than n_fft is zero-padded on both sides (torch.stft)."""
    win_length = window.shape[0]
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = F.pad(window, (lpad, n_fft - win_length - lpad))
    return frame_signal(x, n_fft, hop) * window


def stft(x: torch.Tensor, n_fft: int, hop: int, window: torch.Tensor
         ) -> torch.Tensor:
    """center=False STFT. (B, T) -> (B, n_frames, n_fft//2+1) complex."""
    return torch.fft.rfft(windowed_frames(x, n_fft, hop, window), n_fft)


def spectrogram(x: torch.Tensor, n_fft: int) -> torch.Tensor:
    """The loss's magnitude spectrogram, with the semantics of
    torchaudio.transforms.Spectrogram(n_fft, hop_length=n_fft, power=1,
    normalized=True, center=False): periodic Hann window, 'window'
    normalisation. (B, T) -> (B, n_fft//2+1, n_frames). The magnitude
    carries the 1e-12 floor of dft_magnitude inside its square root."""
    win = hann_window(n_fft, dtype=x.dtype, device=x.device)
    frames = frame_signal(x, n_fft, n_fft) * win  # (B, F, n_fft)
    b, f, _ = frames.shape
    mag = dft_magnitude(frames.reshape(b * f, n_fft), n_fft)
    mag = mag.reshape(b, f, n_fft // 2 + 1) / torch.sqrt(torch.sum(win * win))
    return mag.transpose(-1, -2)


def _hz_to_mel(f):
    """Slaney mel scale (librosa default, htk=False)."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        f >= min_log_hz,
        min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
        f / f_sp,
    )


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


@lru_cache(maxsize=16)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: float | None = None) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, (n_mels, n_fft//2+1)
    float32 (librosa.filters.mel parity). Cached: treat as read-only."""
    fmax = sr / 2 if fmax is None else fmax
    fft_freqs = np.linspace(0.0, sr / 2, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


def mel_reflect_pad(x: torch.Tensor, win_length: int, hop: int
                    ) -> torch.Tensor:
    """The mel frontend's reflect padding ((win-hop)//2, max((win-hop+1)//2,
    hop)) of (B, T) audio."""
    pad_l = (win_length - hop) // 2
    pad_r = max((win_length - hop + 1) // 2, hop)
    return F.pad(x[:, None, :], (pad_l, pad_r), mode="reflect")[:, 0, :]


_BASIS: dict = {}


def mel_basis(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float,
              device) -> torch.Tensor:
    """mel_filterbank as a tensor on `device`, made once per (geometry,
    device). Read-only."""
    key = (sr, n_fft, n_mels, fmin, fmax, torch.device(device))
    if torch.compiler.is_compiling():
        return torch.as_tensor(mel_filterbank(sr, n_fft, n_mels, fmin, fmax),
                               device=device)
    if key not in _BASIS:
        _BASIS[key] = torch.as_tensor(
            mel_filterbank(sr, n_fft, n_mels, fmin, fmax), device=device)
    return _BASIS[key]


def bf16_frames_magnitude(x: torch.Tensor, n_fft: int, hop: int,
                          win: torch.Tensor) -> torch.Tensor:
    """JAX's bf16 DFT route of the mel (dft_magnitude_pallas(mxu_bf16=True)):
    the Hann-windowed frames rounded to bf16, then |rfft| with the 1e-12
    floor inside the root, fp32. (B, T) padded audio -> (B, F, n_fft//2+1);
    on the card the dft_magnitude kernel's bf16-input form, on the CPU its
    plain version."""
    frames = windowed_frames(x, n_fft, hop, win).to(torch.bfloat16)
    b, f, _ = frames.shape
    return dft_magnitude_bf16(frames.reshape(b * f, n_fft), n_fft).reshape(
        b, f, n_fft // 2 + 1)


def _log_mel(mag: torch.Tensor, sr: int, n_fft: int, n_mels: int,
             fmin: float, fmax: float, clip_val: float) -> torch.Tensor:
    """(B, F, n_fft//2+1) magnitudes -> (B, n_mels, F) log mel (the basis
    in mag's dtype)."""
    basis = mel_basis(sr, n_fft, n_mels, fmin, fmax, mag.device).to(mag.dtype)
    mel = torch.einsum("mf,btf->bmt", basis, mag)
    return torch.log(torch.clamp(mel, min=clip_val))


def log_mel_spectrogram(x: torch.Tensor, sr: int, n_fft: int, hop: int,
                        win_length: int, n_mels: int, fmin: float, fmax: float,
                        clip_val: float = 1e-5, mxu_bf16: bool = False,
                        keyshift: float = 0.0, speed: float = 1.0,
                        pre_padded: bool = False) -> torch.Tensor:
    """NSF-HiFiGAN mel frontend (nvSTFT.get_mel parity, fp32 FFT branch):
    reflect pad ((win-hop)//2, max((win-hop+1)//2, hop)), center=False
    STFT, magnitude sqrt(re^2 + im^2 + 1e-9), slaney mel, log(clamp).
    (B, T) -> (B, n_mels, n_frames). pre_padded=True: the caller already
    applied that padding (each item of a mixed-length batch its own
    reflection, `Enhancer.enhance_batch`). mxu_bf16 asks for JAX's bf16
    DFT route, which JAX takes on its accelerator (the TPU's "mxu"
    magnitude backend) and not on the CPU. Here likewise: on the card the
    frames are rounded to bf16 and the magnitude is the dft_magnitude
    kernel's bf16-input form (`bf16_frames_magnitude`), on the CPU the fp32
    FFT route's. keyshift / speed: `_log_mel_keyshift`."""
    if keyshift != 0 or speed != 1:
        return _log_mel_keyshift(x, sr, n_fft, hop, win_length, n_mels, fmin,
                                 fmax, clip_val, keyshift, speed)
    if not pre_padded:
        x = mel_reflect_pad(x, win_length, hop)
    win = hann_window(win_length, dtype=x.dtype, device=x.device)
    if mxu_bf16 and x.is_cuda:
        mag = bf16_frames_magnitude(x, n_fft, hop, win)
    else:
        spec = stft(x, n_fft, hop, win)
        mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
    return _log_mel(mag, sr, n_fft, n_mels, fmin, fmax, clip_val)


def _log_mel_keyshift(x: torch.Tensor, sr: int, n_fft: int, hop: int,
                      win_length: int, n_mels: int, fmin: float, fmax: float,
                      clip_val: float, keyshift: float, speed: float
                      ) -> torch.Tensor:
    """The keyshift/speed mel (nvSTFT.get_mel with keyshift != 0; the JAX
    package's `_log_mel_keyshift`): n_fft and the window scale by
    2^(keyshift/12), rounded, the hop by `speed`; reflect padding, constant
    where the right pad reaches the whole input; the windowed rFFT of the
    new size with sqrt(re^2 + im^2 + 1e-9); the spectrum padded with zeros
    or truncated back to n_fft//2+1 bins and rescaled by win / win_new
    (keyshift != 0 only); the unscaled basis of n_fft."""
    factor = 2.0 ** (keyshift / 12.0)
    n_fft_new = int(np.round(n_fft * factor))
    win_new = int(np.round(win_length * factor))
    hop_new = int(np.round(hop * speed))
    t = x.shape[-1]
    pad_l = (win_new - hop_new) // 2
    pad_r = max((win_new - hop_new + 1) // 2, win_new - t - pad_l)
    mode = "reflect" if pad_r < t else "constant"
    x = F.pad(x[:, None, :], (pad_l, pad_r), mode=mode)[:, 0, :]
    win = hann_window(win_new, dtype=x.dtype, device=x.device)
    spec = stft(x, n_fft_new, hop_new, win)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
    if keyshift != 0:
        size = n_fft // 2 + 1
        bins = mag.shape[-1]
        if bins < size:
            mag = F.pad(mag, (0, size - bins))
        mag = mag[..., :size] * (win_length / win_new)
    return _log_mel(mag, sr, n_fft, n_mels, fmin, fmax, clip_val)
