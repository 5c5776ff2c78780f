"""Unit2Control: units + f0/phase/volume/speaker -> DSP control parameters.

Counterpart of `ddsp_svc_tpu/nn/unit2control.py`:
  PreNet (Conv k3 -> GroupNorm(4), or FrameGroupNorm(4) with frame_norm,
  -> LeakyReLU -> Conv k3; causal convs with `causal`)
  + Linear(1, 256) embeddings of log-scaled f0, phase/pi and volume
  + the speaker embedding, ids counted from 1 (or a {spk: weight} mix)
  -> PCmer(3 layers, 8 heads, 256) -> LayerNorm -> weight-norm Linear
  -> the named control dict.
compute_dtype (torch.bfloat16 under model.bf16) reaches the PCmer only; the
prenet, embeddings and output head stay fp32, as in the JAX package.
Submodules carry the reference model's state-dict names (`unit_prenet.1`,
`dec_post.0.net.{i}`, `dec_post.2.weight_g`, ...).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from ..ops.masking import frame_mask, valid_col
from .layers import (Conv1d, FrameGroupNorm, GroupNorm, WeightNormDense,
                     leaky_relu)
from .pcmer import PCmer


def split_to_dict(tensor: torch.Tensor,
                  tensor_splits: Dict[str, int]) -> Dict[str, torch.Tensor]:
    out, start = {}, 0
    for k, size in tensor_splits.items():
        out[k] = tensor[..., start:start + size]
        start += size
    return out


class Unit2Control(nn.Module):
    def __init__(self, input_channel: int, n_spk: int,
                 output_splits: Dict[str, int], causal: bool = False,
                 ndim_feat: int = 256, num_layers: int = 3,
                 num_heads: int = 8, frame_norm: bool = False,
                 compute_dtype=None):
        super().__init__()
        d = ndim_feat
        self.output_splits = dict(output_splits)
        self.unit_prenet = nn.ModuleDict({
            "1": Conv1d(input_channel, d, 3, causal=causal),
            "2": (FrameGroupNorm if frame_norm else GroupNorm)(4, d),
            "4": Conv1d(d, d, 3, causal=causal),
        })
        self.f0_embed = nn.Linear(1, d)
        self.phase_embed = nn.Linear(1, d)
        self.volume_embed = nn.Linear(1, d)
        self.spk_embed = nn.Embedding(n_spk, d)
        self.dec_post = nn.ModuleDict({
            "0": PCmer(num_layers, num_heads, d, causal=causal,
                       compute_dtype=compute_dtype),
            "1": nn.LayerNorm(d, eps=1e-5),
            "2": WeightNormDense(d, sum(self.output_splits.values())),
        })

    def forward(self, units: torch.Tensor, f0: torch.Tensor,
                phase: torch.Tensor, volume: torch.Tensor,
                spk_id: Optional[torch.Tensor] = None,
                spk_mix_dict: Optional[Dict[int, float]] = None,
                infer: bool = False, valid_frames=None, shard=None
                ) -> Dict[str, torch.Tensor]:
        """units (B, F, C), f0 (B, F, 1) [Hz], phase (B, F) [rad],
        volume (B, F), spk_id (B,) or (B, 1), 1-based. valid_frames: the true
        length of bucket-padded inputs; statistics, attention and convs are
        masked to it, and the control tail past it repeats the last valid
        frame. shard (a `parallel.timeparallel.TimeShard`): the inputs are
        its window, valid_frames counted from the window's first frame; the
        GroupNorm statistics and the attention's key moments are summed
        over the frames every shard owns. Returns {name: (B, F, size)}."""
        prenet = self.unit_prenet
        fmask = None
        if valid_frames is not None:
            fmask = frame_mask(units.shape[1], valid_frames, units.dtype,
                               units.device)[:, :, None]
            units = units * fmask
        x = prenet["1"](units)
        x = leaky_relu(prenet["2"](x, valid_frames=valid_frames, shard=shard))
        if fmask is not None:
            x = x * fmask
        x = prenet["4"](x)
        x = (x + self.f0_embed(torch.log1p(f0 / 700.0))
             + self.phase_embed(phase[..., None] / np.pi)
             + self.volume_embed(volume[..., None]))
        if spk_mix_dict is not None:
            for k, w in spk_mix_dict.items():
                x = x + w * self.spk_embed.weight[int(k) - 1]
        else:
            if spk_id.ndim == 1:
                spk_id = spk_id[:, None]
            x = x + self.spk_embed(spk_id - 1)
        x = self.dec_post["0"](x, infer=infer, valid_frames=valid_frames,
                               shard=shard)
        e = self.dec_post["2"](self.dec_post["1"](x))
        if valid_frames is not None:
            idx = torch.minimum(
                torch.arange(e.shape[1], device=e.device)[None, :],
                valid_col(valid_frames, torch.int64, e.device) - 1,
            ).clamp(min=0)  # a shard's window may lie wholly past the end
            e = torch.take_along_dim(e, idx[:, :, None], dim=1)
        return split_to_dict(e, self.output_splits)

    def receptive_radius(self) -> int:
        """Frames on either side of a frame that its controls depend on
        through the convolutions (the prenet's two and each PCmer layer's
        depthwise conv, in sequence). GroupNorm's statistics and the
        attention reach every frame and cross shards as sums instead."""
        return sum(max(m.time_pad) for m in self.modules()
                   if isinstance(m, Conv1d))
