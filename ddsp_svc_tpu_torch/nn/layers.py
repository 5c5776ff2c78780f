"""Basic layers on channel-last (B, T, C) activations.

Counterparts of `ddsp_svc_tpu/nn/layers.py`. Parameters carry the torch
names of the reference model's modules (`weight`, `bias`, `weight_g`,
`weight_v`), so a reference state dict loads into them directly.

A `compute_dtype` (torch.bfloat16, or None for fp32) casts a layer's input,
weight and bias at call time, as flax's `dtype=` does: the parameters stay
fp32 and receive fp32 gradients through the cast.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.masking import frame_mask, valid_col


def _cast(t, dtype):
    return t if dtype is None or t is None else t.to(dtype)


def linear(x: torch.Tensor, weight: torch.Tensor, bias=None,
           compute_dtype=None) -> torch.Tensor:
    """F.linear in `compute_dtype` (None: the input's own)."""
    return F.linear(_cast(x, compute_dtype), _cast(weight, compute_dtype),
                    _cast(bias, compute_dtype))


class Conv1d(nn.Conv1d):
    """1D convolution over (B, T, C) with 'same' or causal (left) padding:
    causal pads (k-1, 0), otherwise ((k-1)//2, k//2) (extorch.Conv1dEx)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 causal: bool = False, groups: int = 1, bias: bool = True,
                 stride: int = 1, compute_dtype=None):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, groups=groups, bias=bias)
        k = kernel_size
        self.time_pad = (k - 1, 0) if causal else ((k - 1) // 2, k // 2)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = F.conv1d(F.pad(_cast(x, dt).transpose(1, 2), self.time_pad),
                     _cast(self.weight, dt), _cast(self.bias, dt),
                     self.stride, 0, 1, self.groups)
        return y.transpose(1, 2)


class GroupNorm(nn.Module):
    """torch.nn.GroupNorm on (B, T, C): statistics per channel group over
    (T, C//G), eps 1e-5. `valid_frames` restricts the statistics to each
    item's first N frames, so a bucket-padded forward normalises exactly as
    the same input does at its true length. On a time shard (`shard`, a
    `parallel.timeparallel.TimeShard`, x its window) the statistics are
    taken over the frames every shard owns (and valid ones), in two passes
    as here: the sums and counts all-reduced, then the squared deviations
    from the global mean all-reduced."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor, valid_frames=None,
                shard=None) -> torch.Tensor:
        b, t, c = x.shape
        g = self.num_groups
        xg = x.reshape(b, t, g, c // g)
        if shard is not None:
            m = shard.owned_mask(t, valid_frames, x.dtype,
                                 x.device)[:, :, None, None]
            count = m.sum(dim=(1, 3), keepdim=True).expand(b, 1, 1, 1)
            total, count = shard.all_reduce(
                (xg * m).sum(dim=(1, 3), keepdim=True), count * (c // g))
            mean = total / count
            var, = shard.all_reduce(
                (((xg - mean) * m) ** 2).sum(dim=(1, 3), keepdim=True))
            var = var / count
        elif valid_frames is None:
            mean = xg.mean(dim=(1, 3), keepdim=True)
            var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
        else:
            m = frame_mask(t, valid_frames, x.dtype, x.device)[:, :, None, None]
            denom = valid_col(valid_frames, x.dtype,
                              x.device)[:, :, None, None] * (c // g)
            mean = (xg * m).sum(dim=(1, 3), keepdim=True) / denom
            var = (((xg - mean) * m) ** 2).sum(dim=(1, 3), keepdim=True) / denom
        xg = (xg - mean) * torch.rsqrt(var + self.eps)
        return xg.reshape(b, t, c) * self.weight + self.bias


class FrameGroupNorm(GroupNorm):
    """GroupNorm with frame-local statistics: each frame's channel groups
    are normalised on their own, with no reduction over time, so a causal
    model built with it depends on no future frame (the exact incremental
    engine, models/incremental.py, needs that). Padding cannot leak into
    the statistics, so `valid_frames` is a no-op. The parameters carry
    GroupNorm's names. Nothing crosses a time shard either."""

    def forward(self, x: torch.Tensor, valid_frames=None,
                shard=None) -> torch.Tensor:
        b, t, c = x.shape
        xg = x.reshape(b, t, self.num_groups, c // self.num_groups)
        mean = xg.mean(dim=3, keepdim=True)
        var = ((xg - mean) ** 2).mean(dim=3, keepdim=True)
        xg = (xg - mean) * torch.rsqrt(var + self.eps)
        return xg.reshape(b, t, c) * self.weight + self.bias


class WeightNormDense(nn.Module):
    """Linear layer under torch weight_norm (dim=0): W = g * V / ||V||, the
    norm per output unit over the input axis (the Unit2Control head)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight_g = nn.Parameter(torch.ones(out_features, 1))
        self.weight_v = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        nn.init.normal_(self.weight_v, std=in_features ** -0.5)
        # a `parallel.sharding.ModelShard` once the output columns are cut
        # over the mesh's model axis (each column's norm stays local)
        self.tp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.linalg.vector_norm(self.weight_v, dim=1, keepdim=True)
        w = self.weight_v * (self.weight_g / (norm + 1e-12))
        if self.tp is None:
            return F.linear(x, w, self.bias)
        return self.tp.gather(F.linear(self.tp.enter(x), w, self.bias))


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return torch.where(x >= 0, x, negative_slope * x)


def glu(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    a, b = x.chunk(2, dim=dim)
    return a * torch.sigmoid(b)


@torch.no_grad()
def lecun_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw every weight of `module` from `generator`, as the JAX package's
    flax initialisers do: weights N(0, 1/fan_in) (fan_in = input channels x
    kernel taps), biases 0, norms 1/0, embeddings N(0, 1/features), weight
    norm g = ||v||. Buffers (the PCmer projections) stay as they are."""

    def normal_(p: torch.Tensor, std: float) -> None:
        p.copy_(torch.randn(p.shape, generator=generator, device=p.device,
                            dtype=p.dtype) * std)

    for m in module.modules():
        if isinstance(m, WeightNormDense):
            normal_(m.weight_v, m.weight_v.shape[1] ** -0.5)
            m.weight_g.copy_(torch.linalg.vector_norm(m.weight_v, dim=1,
                                                      keepdim=True))
            m.bias.zero_()
        elif isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d,
                            nn.ConvTranspose1d)):
            w = m.weight
            if isinstance(m, nn.ConvTranspose1d):  # (in, out, k)
                fan_in = w.shape[0] * w.shape[2]
            else:  # (out, in[/groups], k...)
                fan_in = math.prod(w.shape[1:])
            normal_(w, fan_in ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            normal_(m.weight, m.weight.shape[1] ** -0.5)
        elif isinstance(m, (nn.LayerNorm, GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return module
