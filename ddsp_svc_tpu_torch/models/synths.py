"""The three synthesizers, inference and training: Sins, CombSubFast and
CombSub. Counterparts of `ddsp_svc_tpu/models/synths.py`, with the same
call contract:

    signal, phase_out, (component_a, component_b) = model(
        units, f0_frames, volume_frames, spk_id, spk_mix_dict=...,
        initial_phase=..., infer=..., noise=..., valid_frames=...,
        generator=...)

CombSubFast: a sinc-comb
excitation and uniform noise, filtered per 50%-overlap sqrt-Hann frame by
exp(mag + j*pi*phase) (harmonic) and exp(mag)/128 (noise) from the
Unit2Control outputs, then overlap-added. The filter chain is the
hand-written combsub_spectral kernel (differentiable, its backward the
adjoint kernel) exactly where the JAX package's gate uses its Pallas kernel:
at inference, or in training under bf16, with block_size % 64 == 0. fp32
training and other block sizes take the plain torch.fft chain. Under
model.bf16 the chain is the kernels' bf16-operand form (the frames, and in
the backward g * window, rounded to bf16), as JAX passes self.bf16 as
mxu_bf16.

Sins: an additive oscillator bank (the oscillator_bank kernel on the card)
through an all-pass LTV-FIR filter, plus filtered noise. CombSub (the "old"
model): the comb through an all-pass and then a dynamically windowed
magnitude filter, plus filtered noise. Their LTV-FIR filters
(`ops/fft_filter.py`) convolve through the ltv_fir_convolve kernel on the
card.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.unit2control import Unit2Control
from ..ops.exciters import combtooth, remove_above_fmax
from ..ops.fft_filter import frequency_filter
from ..ops.interp import upsample_frames
from ..ops.kernels import (combsub_spectral, combsub_spectral_plain,
                           oscillator_bank)
from ..ops.masking import frame_mask
from ..ops.phase import f0_to_rot_upsampled
from ..ops.spectral import frame_signal, overlap_add_half
from ..ops.windows import sqrt_hann_window


def _compute_dtype(bf16: bool):
    return torch.bfloat16 if bf16 else None


def _uniform_noise(like: torch.Tensor, generator) -> torch.Tensor:
    """The uniform(-1, 1) noise excitation, drawn from `generator`."""
    return torch.rand(like.shape, generator=generator, dtype=like.dtype,
                      device=like.device) * 2 - 1


def _sample_mask(n_samples: int, valid_frames, block: int, like):
    """Sample-rate mask of the valid frames, or None without valid_frames."""
    if valid_frames is None:
        return None
    if not isinstance(valid_frames, (int, np.integer)):
        valid_frames = torch.as_tensor(valid_frames)
    return frame_mask(n_samples, valid_frames * block, like.dtype,
                      like.device)


def _filter_radius(n_mags: int, block: int) -> int:
    """Frames on either side of a block that `frequency_filter`'s output
    there depends on: the centred impulse response (2 (n_mags - 1) taps)
    reaches ir // 2 samples each way, and each sample is summed from the
    frames of its block and the next, each with its own control frame."""
    ir = 2 * (n_mags - 1)
    return -(-(ir // 2) // block) + 1


def _allpass(group_delay: torch.Tensor) -> torch.Tensor:
    """exp(j * cumsum(group_delay)) over the frequency axis."""
    angle = torch.cumsum(group_delay, dim=-1)
    return torch.polar(torch.ones_like(angle), angle)


class Sins(nn.Module):
    """Additive harmonic-oscillator-bank synthesizer."""

    def __init__(self, sampling_rate: int, block_size: int, n_harmonics: int,
                 n_mag_allpass: int, n_mag_noise: int, n_unit: int = 256,
                 n_spk: int = 1, causal: bool = False, bf16: bool = False):
        super().__init__()
        self.sampling_rate = sampling_rate
        self.block_size = block_size
        self.bf16 = bf16
        # the output order decides how dense_out's columns split
        self.unit2ctrl = Unit2Control(
            n_unit, n_spk,
            {"amplitudes": n_harmonics, "group_delay": n_mag_allpass,
             "noise_magnitude": n_mag_noise},
            causal, compute_dtype=_compute_dtype(bf16),
        )

    def forward(self, units_frames: torch.Tensor, f0_frames: torch.Tensor,
                volume_frames: torch.Tensor,
                spk_id: Optional[torch.Tensor] = None,
                spk_mix_dict: Optional[Dict[int, float]] = None,
                initial_phase: Optional[torch.Tensor] = None,
                infer: bool = True, max_upsample_dim: int = 32,
                noise: Optional[torch.Tensor] = None, valid_frames=None,
                generator: Optional[torch.Generator] = None, shard=None):
        """As CombSubFast.forward; max_upsample_dim is the plain oscillator
        bank's harmonic chunk. Returns (signal, phase (B, T, 1) [rad],
        (harmonic, noise))."""
        bs = self.block_size
        phase = 2.0 * np.pi * f0_to_rot_upsampled(
            f0_frames[..., 0], bs, self.sampling_rate, initial_phase,
            carry=None if shard is None else shard.phase_carry)
        phase_frames = phase[:, ::bs]
        ctrls = self.unit2ctrl(units_frames, f0_frames, phase_frames,
                               volume_frames, spk_id, spk_mix_dict=spk_mix_dict,
                               infer=infer, valid_frames=valid_frames,
                               shard=shard)
        amplitudes_frames = torch.exp(ctrls["amplitudes"]) / 128.0
        group_delay = np.pi * torch.tanh(ctrls["group_delay"])
        noise_param = torch.exp(ctrls["noise_magnitude"]) / 128.0
        amplitudes_frames = remove_above_fmax(
            amplitudes_frames, f0_frames, self.sampling_rate / 2.0,
            level_start=1)
        sinusoids = oscillator_bank(phase, amplitudes_frames, bs,
                                    harmonic_chunk=max_upsample_dim)
        smask = _sample_mask(sinusoids.shape[-1], valid_frames, bs, sinusoids)
        if smask is not None:
            sinusoids = sinusoids * smask
        harmonic = frequency_filter(sinusoids, _allpass(group_delay),
                                    hann_windowed=False)
        if noise is None:
            noise = _uniform_noise(harmonic, generator)
        if smask is not None:
            noise = noise * smask
        noise = frequency_filter(noise, noise_param, hann_windowed=True)
        return harmonic + noise, phase[..., None], (harmonic, noise)

    def receptive_radius(self) -> int:
        """Frames on either side of a block that its output depends on: the
        controls' radius, then the bank (the next frame's f0 and
        amplitudes, lerped) through the all-pass filter, or the noise
        filter."""
        n = self.unit2ctrl.output_splits
        bs = self.block_size
        return self.unit2ctrl.receptive_radius() + max(
            1 + _filter_radius(n["group_delay"], bs),
            _filter_radius(n["noise_magnitude"], bs))


class CombSubFast(nn.Module):
    def __init__(self, sampling_rate: int, block_size: int, n_unit: int = 256,
                 n_spk: int = 1, causal: bool = False, frame_norm: bool = False,
                 bf16: bool = False):
        super().__init__()
        self.sampling_rate = sampling_rate
        self.block_size = block_size
        self.bf16 = bf16
        n = block_size + 1
        self.unit2ctrl = Unit2Control(
            n_unit, n_spk,
            {"harmonic_magnitude": n, "harmonic_phase": n,
             "noise_magnitude": n},
            causal, frame_norm=frame_norm,
            compute_dtype=_compute_dtype(bf16),
        )

    def forward(self, units_frames: torch.Tensor, f0_frames: torch.Tensor,
                volume_frames: torch.Tensor,
                spk_id: Optional[torch.Tensor] = None,
                spk_mix_dict: Optional[Dict[int, float]] = None,
                initial_phase: Optional[torch.Tensor] = None,
                infer: bool = True, noise: Optional[torch.Tensor] = None,
                valid_frames=None,
                generator: Optional[torch.Generator] = None, shard=None):
        """units (B, F, n_unit), f0 (B, F, 1) [Hz], volume (B, F), spk_id
        (B,) or (B, 1). noise: the uniform(-1, 1) excitation (B, F*block),
        drawn from `generator` when None. valid_frames: the true length of
        bucket-padded inputs. shard: the inputs are a time shard's window
        (`parallel.timeparallel`, which slices them, starts the phase and
        keeps the owned samples). Returns (signal (B, F*block),
        phase_frames (B, F, 1), (signal, signal))."""
        bs = self.block_size
        f0 = upsample_frames(f0_frames, bs)[..., 0]
        rot = f0_to_rot_upsampled(f0_frames[..., 0], bs, self.sampling_rate,
                                  initial_phase, carry=None if shard is None
                                  else shard.phase_carry)
        phase_frames = 2.0 * np.pi * rot[:, ::bs]
        ctrls = self.unit2ctrl(units_frames, f0_frames, phase_frames,
                               volume_frames, spk_id, spk_mix_dict=spk_mix_dict,
                               infer=infer, valid_frames=valid_frames,
                               shard=shard)
        tooth = combtooth(rot, f0, self.sampling_rate)
        if noise is None:
            noise = _uniform_noise(tooth, generator)
        smask = _sample_mask(tooth.shape[-1], valid_frames, bs, tooth)
        if smask is not None:
            # zero the excitations past the true length: the first padded
            # frame then windows [tail audio, zeros] with the repeated last
            # filter, exactly the reference's own tail frame
            tooth = tooth * smask
            noise = noise * smask

        window = sqrt_hann_window(2 * bs, dtype=tooth.dtype,
                                  device=tooth.device)
        tooth_frames = frame_signal(F.pad(tooth, (bs, bs)), 2 * bs, bs) * window
        noise_frames = frame_signal(F.pad(noise, (bs, bs)), 2 * bs, bs) * window
        b, n1, fs = tooth_frames.shape  # n1 = n_frames + 1

        def rows(c):  # last filter frame repeated -> n_frames + 1 rows
            return torch.cat([c, c[:, -1:]], 1).reshape(b * n1, bs + 1)

        # model.bf16 takes the chain's bf16-operand form, as JAX passes
        # self.bf16 as mxu_bf16 (its backward the adjoint's form)
        chain = (combsub_spectral if (infer or self.bf16) and bs % 64 == 0
                 else combsub_spectral_plain)
        signal_frames = chain(
            tooth_frames.reshape(b * n1, fs), noise_frames.reshape(b * n1, fs),
            rows(ctrls["harmonic_magnitude"]), rows(ctrls["harmonic_phase"]),
            rows(ctrls["noise_magnitude"]), 2 * bs, mxu_bf16=self.bf16,
        ).reshape(b, n1, fs)
        signal = overlap_add_half(signal_frames, bs)[:, bs:-bs]
        return signal, phase_frames[..., None], (signal, signal)

    def receptive_radius(self) -> int:
        """Frames on either side of a block that its output depends on: the
        controls' radius, plus one for the 50 %-overlap frames (a block
        sums its own frame and the next, each with its own control frame)
        and one for the excitation (the next frame's f0, lerped)."""
        return self.unit2ctrl.receptive_radius() + 2


class CombSub(nn.Module):
    """Combtooth subtractive synthesizer with an LTV-FIR cascade (the "old"
    model): all-pass (predicted group delay), then the dynamically windowed
    magnitude filter, plus filtered noise."""

    def __init__(self, sampling_rate: int, block_size: int,
                 n_mag_allpass: int, n_mag_harmonic: int, n_mag_noise: int,
                 n_unit: int = 256, n_spk: int = 1, causal: bool = False,
                 bf16: bool = False):
        super().__init__()
        self.sampling_rate = sampling_rate
        self.block_size = block_size
        self.bf16 = bf16
        self.unit2ctrl = Unit2Control(
            n_unit, n_spk,
            {"group_delay": n_mag_allpass,
             "harmonic_magnitude": n_mag_harmonic,
             "noise_magnitude": n_mag_noise},
            causal, compute_dtype=_compute_dtype(bf16),
        )

    def forward(self, units_frames: torch.Tensor, f0_frames: torch.Tensor,
                volume_frames: torch.Tensor,
                spk_id: Optional[torch.Tensor] = None,
                spk_mix_dict: Optional[Dict[int, float]] = None,
                initial_phase: Optional[torch.Tensor] = None,
                infer: bool = True, noise: Optional[torch.Tensor] = None,
                valid_frames=None,
                generator: Optional[torch.Generator] = None, shard=None):
        """As CombSubFast.forward. Returns (signal, phase_frames (B, F, 1),
        (harmonic, noise))."""
        bs = self.block_size
        f0 = upsample_frames(f0_frames, bs)[..., 0]
        rot = f0_to_rot_upsampled(f0_frames[..., 0], bs, self.sampling_rate,
                                  initial_phase, carry=None if shard is None
                                  else shard.phase_carry)
        phase_frames = 2.0 * np.pi * rot[:, ::bs]
        ctrls = self.unit2ctrl(units_frames, f0_frames, phase_frames,
                               volume_frames, spk_id, spk_mix_dict=spk_mix_dict,
                               infer=infer, valid_frames=valid_frames,
                               shard=shard)
        group_delay = np.pi * torch.tanh(ctrls["group_delay"])
        src_param = torch.exp(ctrls["harmonic_magnitude"])
        noise_param = torch.exp(ctrls["noise_magnitude"]) / 128.0

        tooth = combtooth(rot, f0, self.sampling_rate, zero_unvoiced=False)
        smask = _sample_mask(tooth.shape[-1], valid_frames, bs, tooth)
        if smask is not None:
            tooth = tooth * smask
        harmonic = frequency_filter(tooth, _allpass(group_delay),
                                    hann_windowed=False)
        if smask is not None:
            # the all-pass spills ir_size // 2 samples past the true length;
            # an exact-length run crops them, so zero them before the
            # cascaded magnitude filter
            harmonic = harmonic * smask
        harmonic = frequency_filter(
            harmonic, src_param, hann_windowed=True,
            half_width_frames=1.5 * self.sampling_rate / (f0_frames + 1e-3))
        if noise is None:
            noise = _uniform_noise(harmonic, generator)
        if smask is not None:
            noise = noise * smask
        noise = frequency_filter(noise, noise_param, hann_windowed=True)
        return harmonic + noise, phase_frames[..., None], (harmonic, noise)

    def receptive_radius(self) -> int:
        """Frames on either side of a block that its output depends on: the
        controls' radius, then the comb (the next frame's f0, lerped)
        through the all-pass and the magnitude filter in cascade, or the
        noise filter."""
        n = self.unit2ctrl.output_splits
        bs = self.block_size
        return self.unit2ctrl.receptive_radius() + max(
            1 + _filter_radius(n["group_delay"], bs)
            + _filter_radius(n["harmonic_magnitude"], bs),
            _filter_radius(n["noise_magnitude"], bs))
