"""Time-parallel inference: one utterance's synthesizer and enhancer
sharded over the frames of a mesh axis.

Counterpart of `ddsp_svc_tpu/parallel/timeparallel.py`, where XLA's SPMD
partitioner inserts halo exchanges, a psum of the linear-attention moments
and a prefix exchange for the phase. PyTorch has no partitioner, so this
module does that work itself, by overlap-and-discard:

  - every rank holds the whole input; rank i owns the contiguous frames
    [own_lo, own_hi) (`time_span`) and runs the unmodified model on them
    widened by R frames on each side, clipped to the sequence: the window
    [lo, hi). R is the model's `receptive_radius()`, computed from its
    convolutions, so the owned frames come out exact;
  - each window frame's phase carry is the whole sequence's (each rank
    scans the whole f0: `ops.phase.frame_carry`, handed to the synth on the
    `TimeShard`; the enhancer's `_source_phase`), so the owned frames'
    phases are the unsharded ones bit for bit; noise and SineGen draws are
    the whole sequence's, sliced;
  - three things cross ranks, each an all-reduce over the axis's group:
    GroupNorm's statistics (sums and counts, then squared deviations) and
    the FAVOR+ key moments of each PCmer layer (context and key sums), each
    over the owned and valid frames only (`TimeShard`), and the output, the
    owned samples added into a zero buffer. A causal layer needs the
    moments of the frames before its own instead: each rank's go into its
    own row of a (ranks, ...) buffer, and the lower ranks' rows summed are
    the carry at its first owned frame (`TimeShard.carry`,
    `nn/pcmer.py::window_carry`), so a streamable (causal, frame_norm)
    model runs sharded too.
Only all-reduce crosses ranks, so the same code runs on NCCL (one rank a
card) and on Gloo (CPU tensors, or CUDA tensors of ranks sharing a card).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..nn.nsf_hifigan import _source_phase
from ..ops.kernels import key_range_mask
from ..ops.phase import frame_carry
from ..ops.spectral import mel_reflect_pad


def time_span(n: int, parts: int, index: int, radius: int
              ) -> Tuple[int, int, int, int]:
    """(lo, hi, own_lo, own_hi): part `index` of n frames cut into `parts`
    contiguous spans as even as can be, [own_lo, own_hi), and its window,
    widened by `radius` frames on each side and clipped to [0, n)."""
    own_lo, own_hi = n * index // parts, n * (index + 1) // parts
    return max(0, own_lo - radius), min(n, own_hi + radius), own_lo, own_hi


class TimeShard:
    """One rank's window [lo, hi) of a sequence sharded over time, owning
    [own_lo, own_hi) (global frame indices), the `index` of `parts` ranks
    on its axis, with the process group its sums cross (None: the default
    group). The model's layers see only the window; valid_frames reach
    them counted from the window's first frame. phase_carry: (B, hi - lo)
    [turns], the whole sequence's `frame_carry` of the window's frames."""

    def __init__(self, group: Optional[dist.ProcessGroup], lo: int, hi: int,
                 own_lo: int, own_hi: int, parts: int = 1, index: int = 0,
                 phase_carry: Optional[torch.Tensor] = None):
        self.group = group
        self.lo, self.hi, self.own_lo, self.own_hi = lo, hi, own_lo, own_hi
        self.parts, self.index = parts, index
        self.phase_carry = phase_carry

    def key_range(self, valid_frames=None):
        """The owned frames that are valid, [key_lo, key_hi) in window
        frames: ints, or key_hi a (B,) tensor for per-item lengths."""
        lo, hi = self.own_lo - self.lo, self.own_hi - self.lo
        if valid_frames is None:
            return lo, hi
        if torch.is_tensor(valid_frames) and valid_frames.ndim:
            return lo, torch.clamp(valid_frames, max=hi)
        return lo, min(hi, int(valid_frames))

    def owned_mask(self, t: int, valid_frames=None, dtype=None, device=None):
        """0/1 mask of the window's owned, valid frames: (1, t) or (B, t)."""
        return key_range_mask(t, *self.key_range(valid_frames), dtype, device)

    def all_reduce(self, *tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The sums of `tensors` over the group, in one all-reduce of one
        packed buffer (fp32 on the tensors' device)."""
        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        dist.all_reduce(flat, group=self.group)
        out, at = [], 0
        for t in tensors:
            out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
            at += t.numel()
        return tuple(out)

    def carry(self, *tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The sums of `tensors` over the ranks before this one (its
        `index` of `parts`; zeros on the first), fp32: one all-reduce of a
        (parts, n) buffer in which each rank fills its own row, then the
        lower rows summed in rank order."""
        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        buf = flat.new_zeros((self.parts, flat.numel()))
        buf[self.index] = flat
        dist.all_reduce(buf, group=self.group)
        pre = buf[:self.index].sum(dim=0)
        out, at = [], 0
        for t in tensors:
            out.append(pre[at:at + t.numel()].reshape(t.shape))
            at += t.numel()
        return tuple(out)


def _axis(mesh, axis: str):
    return mesh.group(axis), mesh.size(axis), mesh.index(axis)


def make_time_parallel_forward(model, mesh, axis: str = "data",
                               spk_mix_dict=None):
    """The synthesizer's inference forward with the frames sharded over
    `axis` of `mesh`. Returns fn(units (B, F, C), f0 (B, F, 1), volume
    (B, F), spk_id (B, 1), noise (B, F*block), valid_frames=None) ->
    signal (B, F*block), the whole signal on every rank. Every rank calls
    it with the same inputs (tensors on the mesh's device); valid_frames
    (int or (B,)) is the true length of a bucket-padded input, as in the
    unsharded forward."""
    group, parts, index = _axis(mesh, axis)
    radius = model.receptive_radius()
    block, sr = int(model.block_size), int(model.sampling_rate)

    @torch.no_grad()
    def forward(units, f0, volume, spk_id, noise, valid_frames=None):
        b, n = units.shape[:2]
        lo, hi, own_lo, own_hi = time_span(n, parts, index, radius)
        shard = TimeShard(group, lo, hi, own_lo, own_hi, parts, index,
                          frame_carry(f0[..., 0], block, sr)[:, lo:hi])
        valid = None if valid_frames is None else valid_frames - lo
        signal, _, _ = model(
            units[:, lo:hi], f0[:, lo:hi], volume[:, lo:hi], spk_id,
            spk_mix_dict=spk_mix_dict, infer=True,
            noise=noise[:, lo * block:hi * block], valid_frames=valid,
            shard=shard)
        out = signal.new_zeros((b, n * block))
        out[:, own_lo * block:own_hi * block] = signal[
            :, (own_lo - lo) * block:(own_hi - lo) * block]
        return shard.all_reduce(out)[0]

    return forward


def make_time_parallel_enhancer(nsf, mesh, axis: str = "data"):
    """The NSF-HiFiGAN forward (log-mel frontend + generator, as
    `NsfHifiGAN.__call__` runs it) with the mel frames sharded over `axis`
    of `mesh`. Returns fn(audio (B, T), f0_frames (B, F), rand_ini (B, 9))
    -> (B, n_mel * upp), the whole output on every rank. The mel's reflect
    padding is the whole signal's; each window's mel is cut from it."""
    group, parts, index = _axis(mesh, axis)
    gen, h = nsf.model, nsf.h
    radius = gen.receptive_radius()
    n_fft, hop, win = int(h["n_fft"]), int(h["hop_size"]), int(h["win_size"])
    upp = math.prod(gen.upsample_rates)
    n_harmonics = gen.m_source.l_linear.in_features - 1

    @torch.no_grad()
    def forward(audio, f0_frames, rand_ini):
        padded = mel_reflect_pad(audio, win, hop)
        b, n = audio.shape[0], (padded.shape[-1] - n_fft) // hop + 1
        lo, hi, own_lo, own_hi = time_span(n, parts, index, radius)
        start, rad = _source_phase(f0_frames[:, :n], upp, gen.sampling_rate,
                                   rand_ini, n_harmonics)
        mel = nsf._mel(padded[:, lo * hop:(hi - 1) * hop + n_fft],
                       pre_padded=True)
        y = gen(mel, f0_frames[:, lo:hi], rand_ini,
                source_phase=(start[:, lo:hi].contiguous(),
                              rad[:, lo:hi].contiguous()))
        out = y.new_zeros((b, n * upp))
        out[:, own_lo * upp:own_hi * upp] = y[
            :, (own_lo - lo) * upp:(own_hi - lo) * upp]
        return TimeShard(group, lo, hi, own_lo, own_hi).all_reduce(out)[0]

    return forward
