"""The CombSubFast synthesizer, inference and training.

Counterpart of `ddsp_svc_tpu/models/synths.py::CombSubFast`: a sinc-comb
excitation and uniform noise, filtered per 50%-overlap sqrt-Hann frame by
exp(mag + j*pi*phase) (harmonic) and exp(mag)/128 (noise) from the
Unit2Control outputs, then overlap-added. The filter chain is the
hand-written combsub_spectral kernel (differentiable, its backward the
adjoint kernel) exactly where the JAX package's gate uses its Pallas kernel:
at inference, or in training under bf16, with block_size % 64 == 0. fp32
training and other block sizes take the plain torch.fft chain.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.unit2control import Unit2Control
from ..ops.exciters import combtooth
from ..ops.interp import upsample_frames
from ..ops.kernels import combsub_spectral, combsub_spectral_plain
from ..ops.masking import frame_mask
from ..ops.phase import f0_to_rot_upsampled
from ..ops.spectral import frame_signal, overlap_add_half
from ..ops.windows import sqrt_hann_window


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
            compute_dtype=torch.bfloat16 if bf16 else None,
        )

    def forward(self, units_frames: torch.Tensor, f0_frames: torch.Tensor,
                volume_frames: torch.Tensor,
                spk_id: Optional[torch.Tensor] = None,
                spk_mix_dict: Optional[Dict[int, float]] = None,
                initial_phase: Optional[torch.Tensor] = None,
                infer: bool = True, noise: Optional[torch.Tensor] = None,
                valid_frames=None,
                generator: Optional[torch.Generator] = None):
        """units (B, F, n_unit), f0 (B, F, 1) [Hz], volume (B, F), spk_id
        (B,) or (B, 1). noise: the uniform(-1, 1) excitation (B, F*block),
        drawn from `generator` when None. valid_frames: the true length of
        bucket-padded inputs. Returns (signal (B, F*block), phase_frames
        (B, F, 1), (signal, signal))."""
        bs = self.block_size
        f0 = upsample_frames(f0_frames, bs)[..., 0]
        rot = f0_to_rot_upsampled(f0_frames[..., 0], bs, self.sampling_rate,
                                  initial_phase)
        phase_frames = 2.0 * np.pi * rot[:, ::bs]
        ctrls = self.unit2ctrl(units_frames, f0_frames, phase_frames,
                               volume_frames, spk_id, spk_mix_dict=spk_mix_dict,
                               infer=infer, valid_frames=valid_frames)
        tooth = combtooth(rot, f0, self.sampling_rate)
        if noise is None:
            noise = torch.rand(tooth.shape, generator=generator,
                               dtype=tooth.dtype, device=tooth.device) * 2 - 1
        if valid_frames is not None:
            # zero the excitations past the true length: the first padded
            # frame then windows [tail audio, zeros] with the repeated last
            # filter, exactly the reference's own tail frame
            smask = frame_mask(tooth.shape[-1],
                               torch.as_tensor(valid_frames) * bs,
                               tooth.dtype, tooth.device)
            tooth = tooth * smask
            noise = noise * smask

        window = sqrt_hann_window(2 * bs, dtype=tooth.dtype,
                                  device=tooth.device)
        tooth_frames = frame_signal(F.pad(tooth, (bs, bs)), 2 * bs, bs) * window
        noise_frames = frame_signal(F.pad(noise, (bs, bs)), 2 * bs, bs) * window
        b, n1, fs = tooth_frames.shape  # n1 = n_frames + 1

        def rows(c):  # last filter frame repeated -> n_frames + 1 rows
            return torch.cat([c, c[:, -1:]], 1).reshape(b * n1, bs + 1)

        chain = (combsub_spectral if (infer or self.bf16) and bs % 64 == 0
                 else combsub_spectral_plain)
        signal_frames = chain(
            tooth_frames.reshape(b * n1, fs), noise_frames.reshape(b * n1, fs),
            rows(ctrls["harmonic_magnitude"]), rows(ctrls["harmonic_phase"]),
            rows(ctrls["noise_magnitude"]), 2 * bs,
        ).reshape(b, n1, fs)
        signal = overlap_add_half(signal_frames, bs)[:, bs:-bs]
        return signal, phase_frames[..., None], (signal, signal)
