"""NSF-HiFiGAN generator (the enhancer), fp32.

Counterpart of `ddsp_svc_tpu/nn/nsf_hifigan.py`: the SineGen harmonic
source (9 sine channels, amplitude 0.1) merged by Linear(9 -> 1) + tanh,
then conv_pre k7 -> per stage [leaky(0.1) -> ConvTranspose upsample ->
+ f0-source injection conv -> mean of 3 ResBlock1] -> leaky(0.01) ->
conv_post k7 -> tanh. Module names follow the reference state dict
(`ups.{i}`, `noise_convs.{i}`, `resblocks.{n}.convs1.{m}`,
`m_source.l_linear`), with weight norm folded into plain weights.

Activations are channel-first inside; the public forward keeps the JAX
package's (B, F, num_mels) mel layout. The narrow stages (C <= 64) go
through the hand-written kernels, in the JAX Generator's forms:
`fused_inject=True` (default) runs the injection conv and the resblock
trio in one kernel (`ops.kernels.fused_resblocks_inject`), False runs the
injection on F.conv1d and the trio alone (`fused_resblocks`);
`fused_stage=True` runs each stage that `_stage_fusable` admits, the
transposed conv included, in one kernel (`fused_stage`);
`fused_resblocks=False` keeps every stage on F.conv1d. The wide stages (C
= 256, 128) stay on F.conv1d, as the JAX package left them to XLA.
`valid_frames` masks a bucket-padded batch per item, as in JAX.

Staged bf16 (`bf16_min_channels`, JAX's +29 % configuration at 128): a
stage of C >= bf16_min_channels casts x to bf16 on entry and runs its
transposed conv, injection conv (the source cast to bf16 inside it) and
ResBlocks in bf16 on cuDNN, parameters fp32 and cast per call; the last
bf16 stage hands fp32 to the first fp32 stage, whose kernels run as
before; the output is fp32. `dtype=torch.bfloat16` runs every conv in
bf16, the source too. A bf16 stage of C <= 64 (staged at a threshold of
64 or less, or full bf16) runs its transposed conv in bf16 and its trio,
the injection folded in, in the bf16-input form of the trio kernel, as
JAX's does: x (and a bf16 source) upcast at the kernel's input, the fp32
weights, fp32 sums, the output rounded once to bf16; on the CPU the plain
version of that form. The fused stage (#11) takes fp32 stages only, as
JAX's gate does.

`fused_mxu_bf16=True` (JAX's field of that name, default False) runs the
kernels of the narrow stages (#4, #5, #11; fp32 or bf16 stages) in their
bf16-operand forms: each conv of the resblock chains on bf16-rounded
inputs and weights, fp32 sums, h and residual carries; the injection conv,
the transposed conv and the biases stay fp32.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels import (STAGE_RATES, TRIO_CHANNELS, TRIO_KERNEL_SIZES,
                           fused_resblocks, fused_resblocks_inject,
                           fused_stage, harmonic_source, noise_conv_cf,
                           resblock1_cf)
from ..ops.masking import frame_mask
from ..ops.phase import _cumsum_mod1_compensated, _wrap

LRELU_SLOPE = 0.1


def _source_phase(f0_frames: torch.Tensor, upp: int, sr: int,
                  rand_ini: torch.Tensor, harmonic_num: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frame-start rotations and per-sample rotation (SineGen phase
    bookkeeping). rand_ini is added to frame 0's per-sample rad before the
    cumulative sum, as the reference does, so every later frame inherits a
    wrapped offset of upp * rand_ini. Returns (start, rad), each (B, F, H)."""
    k = torch.arange(1, harmonic_num + 2, dtype=f0_frames.dtype,
                     device=f0_frames.device)
    rad = _wrap(f0_frames[..., None] * k / sr)
    rad = torch.cat([rad[:, :1] + rand_ini[:, None, :], rad[:, 1:]], dim=1)
    d = _wrap(rad * upp)
    end = _cumsum_mod1_compensated(d, dim=1)
    return _wrap(end - d), rad


def harmonic_source_fused(f0_frames: torch.Tensor, upp: int, sr: int,
                          rand_ini: torch.Tensor, w: torch.Tensor,
                          b: torch.Tensor, harmonic_num: int = 8,
                          sine_amp: float = 0.1, phase=None) -> torch.Tensor:
    """Sine source + SourceModuleHnNSF merge, (B, F) f0 -> (B, F*upp, 1).
    The frame-rate phase scan stays plain torch; the per-sample part is
    the harmonic_source kernel on the card. phase: `_source_phase`'s
    (start, rad) taken already (a time shard's frames of the whole f0's),
    in place of the scan of f0_frames."""
    start, rad = phase if phase is not None else _source_phase(
        f0_frames, upp, sr, rand_ini, harmonic_num)
    return harmonic_source(start.contiguous(), rad.contiguous(), w, b, upp,
                           sine_amp)[..., None]


class ResBlock1(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilation = tuple(dilation)
        k = kernel_size
        self.convs1 = nn.ModuleList(
            nn.Conv1d(channels, channels, k, dilation=d,
                      padding=(k * d - d) // 2) for d in self.dilation)
        self.convs2 = nn.ModuleList(
            nn.Conv1d(channels, channels, k, padding=(k - 1) // 2)
            for _ in self.dilation)

    def stacked(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Weights (n_dil, 2, C, C, k) and biases (n_dil, 2, C)."""
        w = torch.stack([torch.stack([c1.weight, c2.weight])
                         for c1, c2 in zip(self.convs1, self.convs2)])
        b = torch.stack([torch.stack([c1.bias, c2.bias])
                         for c1, c2 in zip(self.convs1, self.convs2)])
        return w, b

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        """x (B, C, T) channel-first, fp32 or bf16; mask (B?, 1, T) of x's
        dtype zeroes each conv's input past the valid length."""
        pairs = list(zip(self.convs1, self.convs2))
        dt = x.dtype  # a bf16 stage casts the fp32 parameters per call
        return resblock1_cf(
            x, [(c1.weight.to(dt), c2.weight.to(dt)) for c1, c2 in pairs],
            [(c1.bias.to(dt), c2.bias.to(dt)) for c1, c2 in pairs],
            self.kernel_size, self.dilation, mask)


class SourceModule(nn.Module):
    """Holds the Linear(9 -> 1) merge of SourceModuleHnNSF."""

    def __init__(self, harmonic_num: int = 8):
        super().__init__()
        self.l_linear = nn.Linear(harmonic_num + 1, 1)


class Generator(nn.Module):
    def __init__(self, sampling_rate: int, num_mels: int,
                 upsample_rates: Sequence[int],
                 upsample_kernel_sizes: Sequence[int],
                 upsample_initial_channel: int,
                 resblock_kernel_sizes: Sequence[int],
                 resblock_dilation_sizes: Sequence[Sequence[int]],
                 fused_resblocks: bool = True, fused_inject: bool = True,
                 fused_stage: bool = False, dtype=None,
                 bf16_min_channels: int = 0, fused_mxu_bf16: bool = False):
        super().__init__()
        self.dtype = dtype
        self.bf16_min_channels = int(bf16_min_channels)
        self.upsample_initial_channel = upsample_initial_channel
        self.sampling_rate = sampling_rate
        self.upsample_rates = tuple(upsample_rates)
        self.upsample_kernel_sizes = tuple(upsample_kernel_sizes)
        self.resblock_kernel_sizes = tuple(resblock_kernel_sizes)
        self.resblock_dilation_sizes = tuple(
            tuple(d) for d in resblock_dilation_sizes)
        self.fused_resblocks = fused_resblocks
        self.fused_inject = fused_inject
        self.fused_stage = fused_stage
        self.fused_mxu_bf16 = bool(fused_mxu_bf16)
        self.m_source = SourceModule()
        self.conv_pre = nn.Conv1d(num_mels, upsample_initial_channel, 7,
                                  padding=3)
        self.ups = nn.ModuleList()
        self.noise_convs = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        n_up = len(self.upsample_rates)
        for i, (u, k) in enumerate(zip(self.upsample_rates,
                                       upsample_kernel_sizes)):
            c_in = upsample_initial_channel // (2 ** i)
            ch = c_in // 2
            self.ups.append(nn.ConvTranspose1d(c_in, ch, k, u,
                                               padding=(k - u) // 2))
            if i + 1 < n_up:
                s = math.prod(self.upsample_rates[i + 1:])
                self.noise_convs.append(nn.Conv1d(1, ch, 2 * s, stride=s,
                                                  padding=s // 2))
            else:
                self.noise_convs.append(nn.Conv1d(1, ch, 1))
            for rk, rd in zip(self.resblock_kernel_sizes,
                              self.resblock_dilation_sizes):
                self.resblocks.append(ResBlock1(ch, rk, rd))
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)

    def _use_fused(self, ch: int) -> bool:
        """The JAX package's gate for its trio kernel (C <= 64 on an fp32 or
        a bf16 stage, three resblocks sharing one dilation schedule),
        narrowed to the widths and kernel sizes the kernel instantiates."""
        return (bool(self.fused_resblocks) and ch in TRIO_CHANNELS
                and self.resblock_kernel_sizes == TRIO_KERNEL_SIZES
                and len(set(self.resblock_dilation_sizes)) == 1)

    def _stage_fusable(self, c_in: int, u: int, k: int, stage_dtype) -> bool:
        """The JAX package's gate for its fused stage (an fp32 stage, k =
        2u, C_in a multiple of 8, u dividing the 64-sample tile halo),
        narrowed to the rates the kernel takes."""
        return (bool(self.fused_stage) and stage_dtype is None
                and k == 2 * u and c_in % 8 == 0 and u in STAGE_RATES)

    def _stage_dtype(self, ch: int):
        """The compute dtype of a stage of ch channels (None: fp32)."""
        if self.bf16_min_channels:
            return torch.bfloat16 if ch >= self.bf16_min_channels else None
        return self.dtype

    def _finish_stage(self, x: torch.Tensor, i: int, stage_dtype
                      ) -> torch.Tensor:
        """Cast back to fp32 after the last bf16 stage of a staged run."""
        if self.bf16_min_channels and stage_dtype is not None:
            next_ch = self.upsample_initial_channel // (2 ** (i + 2))
            if (i + 1 >= len(self.upsample_rates)
                    or next_ch < self.bf16_min_channels):
                x = x.float()
        return x

    def receptive_radius(self) -> int:
        """Mel frames on either side of a frame that its output samples
        depend on through the convolutions (zero-padded at a window's edge):
        conv_pre, then per stage the transposed conv, the source's
        injection conv and the widest ResBlock1, then conv_post, each in
        samples at its own rate, summed in frames and rounded up. The sine
        source is exact on any window of the whole f0's phase."""
        def reach(conv) -> int:  # input samples a conv's output reaches
            k, pad = conv.kernel_size[0], conv.padding[0]
            return -(-max(pad, k - 1 - pad) // conv.stride[0])

        frames, rate = float(reach(self.conv_pre)), 1
        n_k = len(self.resblock_kernel_sizes)
        for i, u in enumerate(self.upsample_rates):
            frames += reach(self.ups[i]) / rate
            rate *= u
            trio = max(sum((rb.kernel_size - 1) // 2 * (d + 1)
                           for d in rb.dilation)
                       for rb in self.resblocks[i * n_k:(i + 1) * n_k])
            frames += (reach(self.noise_convs[i]) + trio) / rate
        return math.ceil(frames + reach(self.conv_post) / rate)

    def forward(self, mel: torch.Tensor, f0_frames: torch.Tensor,
                rand_ini: torch.Tensor, valid_frames=None,
                source_phase=None) -> torch.Tensor:
        """mel (B, F, num_mels); f0_frames (B, F); rand_ini (B, 9).
        Returns (B, F * prod(upsample_rates)), fp32 (float64 for a float64 one).

        valid_frames (int, 0-d or (B,)): the true frame counts of a
        bucket-padded batch. The mel, the source and every stage boundary
        are zeroed past each item's length, each conv sees the zero padding
        an exact-length forward sees, and the output past it is exactly 0;
        the trio kernels take the per-row sample counts, the fused stage is
        not used (as in JAX). source_phase: the sine source's (start, rad)
        of these frames, taken from the whole f0 (a time shard's window,
        `parallel/timeparallel.py`); None takes them from f0_frames."""
        upp = math.prod(self.upsample_rates)
        masks = {}

        def mask(scale: int) -> torch.Tensor:  # (B?, 1, F * scale) fp32
            if scale not in masks:
                masks[scale] = frame_mask(mel.shape[1] * scale, vf * scale,
                                          torch.float32, mel.device
                                          )[:, None, :]
            return masks[scale]

        if valid_frames is not None:
            vf = torch.as_tensor(valid_frames, device=mel.device)
            mel = mel * mask(1).transpose(1, 2)
        lin = self.m_source.l_linear
        # the sine source stays fp32: phase accuracy matters
        har = harmonic_source_fused(f0_frames, upp, self.sampling_rate,
                                    rand_ini, lin.weight[0], lin.bias,
                                    phase=source_phase)
        if valid_frames is not None:
            har = har * mask(upp).transpose(1, 2)
        if self.dtype is not None:
            har, mel = har.to(self.dtype), mel.to(self.dtype)
        x = _conv(mel.transpose(1, 2), self.conv_pre, padding=3)
        if valid_frames is not None:
            x = x * mask(1).to(x.dtype)
        for i in range(len(self.upsample_rates)):
            stage_dtype = self._stage_dtype(x.shape[1] // 2)
            if self.bf16_min_channels and stage_dtype is not None:
                x = x.to(stage_dtype)
            x = self._stage(i, x, har, stage_dtype, mask,
                            None if valid_frames is None else vf)
            x = self._finish_stage(x, i, stage_dtype)
        x = _conv(F.leaky_relu(x, 0.01), self.conv_post, padding=3)
        # fp32 out of a bf16 forward (float64 stays float64)
        out = torch.tanh(x.to(torch.promote_types(x.dtype, torch.float32))
                         )[:, 0, :]
        if valid_frames is not None:
            # conv_post's bias makes the pad region a nonzero constant
            out = out * mask(upp)[:, 0, :]
        return out

    def _stage(self, i: int, x: torch.Tensor, har: torch.Tensor,
               stage_dtype, mask, vf) -> torch.Tensor:
        """Upsample stage i: leaky -> transposed conv -> + source injection
        -> mean of the ResBlock trio, on the kernels or on cuDNN."""
        u, k = self.upsample_rates[i], self.upsample_kernel_sizes[i]
        n_up, n_k = len(self.upsample_rates), len(self.resblock_kernel_sizes)
        cum = math.prod(self.upsample_rates[:i + 1])
        s = math.prod(self.upsample_rates[i + 1:]) if i + 1 < n_up else 1
        dils = self.resblock_dilation_sizes[0]
        up, nc = self.ups[i], self.noise_convs[i]
        rbs = self.resblocks[i * n_k:(i + 1) * n_k]
        ch = x.shape[1] // 2
        fused = self._use_fused(ch)
        if fused:
            # fp32 weights on an fp32 or a bf16 stage (the bf16-input form)
            stacks = [rb.stacked() for rb in rbs]
            ws, bs = [w for w, _ in stacks], [b for _, b in stacks]
            if vf is None and self._stage_fusable(x.shape[1], u, k,
                                                  stage_dtype):
                return fused_stage(x.transpose(1, 2), har, up.weight,
                                   up.bias, nc.weight, nc.bias, ws, bs, u, s,
                                   dils, mxu_bf16=self.fused_mxu_bf16
                                   ).transpose(1, 2)
        x = _conv(F.leaky_relu(x, LRELU_SLOPE), up, stride=u,
                  padding=(k - u) // 2, transposed=True)
        stage_mask = vsamp = None
        if vf is not None:
            stage_mask, vsamp = mask(cum).to(x.dtype), vf * cum
            x = x * stage_mask
        if fused and self.fused_inject:
            # the trio kernels zero their output past vsamp themselves
            return fused_resblocks_inject(x.transpose(1, 2), har, nc.weight,
                                          nc.bias, ws, bs, s, dils,
                                          valid=vsamp,
                                          mxu_bf16=self.fused_mxu_bf16
                                          ).transpose(1, 2)
        dt = x.dtype
        x = x + noise_conv_cf(har.transpose(1, 2).to(dt), nc.weight.to(dt),
                              nc.bias.to(dt), s, x.shape[-1])
        if stage_mask is not None:
            x = x * stage_mask
        if fused:
            return fused_resblocks(x.transpose(1, 2), ws, bs, dils,
                                   valid=vsamp, mxu_bf16=self.fused_mxu_bf16
                                   ).transpose(1, 2)
        x = sum(rb(x, stage_mask) for rb in rbs) / n_k
        if stage_mask is not None:
            x = x * stage_mask
        return x


def _conv(x: torch.Tensor, conv: nn.Module, transposed: bool = False,
          **kw) -> torch.Tensor:
    """conv's forward in x's dtype: fp32 parameters cast per call."""
    f = F.conv_transpose1d if transposed else F.conv1d
    return f(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), **kw)


def generator_from_h(h: dict, **forms) -> Generator:
    """The Generator of config `h`; forms: fused_resblocks, fused_inject,
    fused_stage, fused_mxu_bf16 (the JAX package's `generator_overrides`),
    dtype, bf16_min_channels."""
    return Generator(
        sampling_rate=h["sampling_rate"],
        num_mels=h["num_mels"],
        upsample_rates=h["upsample_rates"],
        upsample_kernel_sizes=h["upsample_kernel_sizes"],
        upsample_initial_channel=h["upsample_initial_channel"],
        resblock_kernel_sizes=h["resblock_kernel_sizes"],
        resblock_dilation_sizes=h["resblock_dilation_sizes"],
        **forms,
    )

