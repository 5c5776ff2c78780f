"""Linear-phase time-varying FIR filtering in the frequency domain.

Counterpart of `ddsp_svc_tpu/ops/fft_filter.py`: frame-wise frequency
responses become windowed causal impulse responses (static Hann or the
f0-dependent dynamic half-width), the audio is cut into 50%-overlapped
Bartlett-windowed frames, each frame is convolved with its response,
and the frames are overlap-added and cropped by the linear-phase group
delay (ir_size // 2). The FFT size is next_pow2(frame + ir - 1), as in the
JAX package.

The framed convolution is `ops/kernels.py::ltv_fir_convolve`: the
hand-written kernel on CUDA tensors, its plain torch.fft version on CPU
tensors. The JAX package's backend switch (`_CONV_BACKEND` and its
spectral-mode gate) has no counterpart.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .kernels import ltv_fir_convolve
from .spectral import frame_signal, irfft_any, next_pow2, overlap_add
from .windows import bartlett_window, hann_window


def _apply_window_to_impulse_response(ir: torch.Tensor) -> torch.Tensor:
    """Static full-size Hann windowing of a zero-phase IR; returns the
    causal IR."""
    ir_size = ir.shape[-1]
    win = torch.roll(hann_window(ir_size, dtype=ir.dtype, device=ir.device),
                     ir_size // 2)
    return torch.roll(ir * win, ir_size // 2, dims=-1)


def _apply_dynamic_window_to_impulse_response(
        ir: torch.Tensor, half_width_frames: torch.Tensor) -> torch.Tensor:
    """f0-dependent raised-cosine windowing; half_width_frames (B, Frame, 1)
    in samples. As in the reference, only the side past +1 is zeroed."""
    ir_size = ir.shape[-1]
    t = torch.arange(-(ir_size // 2), (ir_size + 1) // 2, dtype=ir.dtype,
                     device=ir.device)
    win = t / half_width_frames
    win = torch.where(win > 1.0, torch.zeros_like(win), win)
    win = (1.0 + torch.cos(np.pi * win)) / 2.0
    return torch.roll(ir, ir_size // 2, dims=-1) * win


def _frequency_impulse_response(
        magnitudes: torch.Tensor, hann_windowed: bool = True,
        half_width_frames: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Half-spectrum frequency response (B, Frame, n_mags), complex or real
    -> (windowed) causal impulse response (B, Frame, 2 * (n_mags - 1))."""
    n_ir = 2 * (magnitudes.shape[-1] - 1)
    if not magnitudes.is_complex():
        magnitudes = torch.complex(magnitudes, torch.zeros_like(magnitudes))
    ir = irfft_any(magnitudes, n_ir)
    if hann_windowed:
        if half_width_frames is None:
            return _apply_window_to_impulse_response(ir)
        return _apply_dynamic_window_to_impulse_response(ir, half_width_frames)
    return torch.roll(ir, ir.shape[-1] // 2, dims=-1)


def fft_convolve(audio: torch.Tensor,
                 impulse_response: torch.Tensor) -> torch.Tensor:
    """Frame-wise convolution with 50%-overlap Bartlett OLA. audio (B, T);
    impulse_response (B, ir) or (B, Frame, ir) -> (B, T), group delay
    compensated."""
    if impulse_response.ndim == 2:
        impulse_response = impulse_response[:, None, :]
    b, n_ir_frames, ir_size = impulse_response.shape
    audio_size = audio.shape[-1]
    hop = audio_size // n_ir_frames
    frame_size = 2 * hop
    frames = frame_signal(F.pad(audio, (hop, hop)), frame_size, hop)
    frames = frames * bartlett_window(frame_size, dtype=audio.dtype,
                                      device=audio.device)  # (B, n+1, 2h)
    n1 = frames.shape[1]
    fft_size = next_pow2(frame_size + ir_size - 1)
    ir_frames = torch.cat([impulse_response, impulse_response[:, -1:]], 1)
    conv = ltv_fir_convolve(frames.reshape(b * n1, frame_size),
                            ir_frames.reshape(b * n1, ir_size).contiguous(),
                            fft_size).reshape(b, n1, fft_size)
    start = hop + ir_size // 2
    return overlap_add(conv, hop)[:, start:start + audio_size]


def frequency_filter(audio: torch.Tensor, magnitudes: torch.Tensor,
                     hann_windowed: bool = True,
                     half_width_frames: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Apply a frame-wise LTV-FIR filter given its frequency response:
    audio (B, T), magnitudes (B, Frame, n_mags) real or complex."""
    ir = _frequency_impulse_response(magnitudes, hann_windowed,
                                     half_width_frames)
    return fft_convolve(audio, ir)
