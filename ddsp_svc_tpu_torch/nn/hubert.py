"""HuBERT-family unit encoder (HuBERT-soft and the base / ContentVec
variants).

Counterpart of `ddsp_svc_tpu/nn/hubert.py::HubertSoft`: a conv feature
extractor (k10 s5, then k3 s2 x4 and k2 s2 x2 to 512 channels, a 320x
downsample; the first conv followed by GroupNorm(512, 512), a per-channel
norm over time), LayerNorm + Linear 512 -> 768, the positional conv
embedding (k128, 16 groups, pad 64, last frame dropped), LayerNorm, post-norm
transformer layers (12 heads, 3072 FF, exact GELU; softmax attention by
`scaled_dot_product_attention`), and the projection 768 -> 256. No TPU
kernel computes any of it: it runs on stock PyTorch ops.

Module names are those of the bshall HuBERT-soft checkpoint, with the
positional conv's weight norm folded: `load_hubert_state_dict` reads that
layout and the fairseq one (HuBERT-base, ContentVec).

Also here: `compute_mask`, the SpecAugment span mask of HuBERT's training
(the JAX package's `compute_mask`), and `HubertDiscrete`, layer-7 features
quantised to the nearest k-means centre (its `HubertDiscrete`). No
conversion path uses either.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Union

import numpy as np

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import lecun_init_

# the encoder variants of the reference's matrix: (output_layer, proj_dim,
# pad_input) for HubertSoft
VARIANTS = {
    "hubertsoft": (None, 256, True),
    "hubertbase": (9, 256, False),
    "contentvec": (9, 256, False),
    "hubertbase768": (9, None, False),
    "contentvec768": (9, None, False),
}


class FeatureExtractor(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv0 = nn.Conv1d(1, 512, 10, 5, bias=False)
        self.norm0 = nn.GroupNorm(512, 512, eps=1e-5)
        for i, k in enumerate([3] * 4 + [2] * 2, start=1):
            setattr(self, f"conv{i}", nn.Conv1d(512, 512, k, 2, bias=False))

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, T) -> (B, 512, Frame)."""
        x = F.gelu(self.norm0(self.conv0(wav[:, None, :])))
        for i in range(1, 7):
            x = F.gelu(getattr(self, f"conv{i}")(x))
        return x


class FeatureProjection(nn.Module):
    def __init__(self):
        super().__init__()
        self.norm = nn.LayerNorm(512, eps=1e-5)
        self.projection = nn.Linear(512, 768)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(self.norm(x))


class PositionalConvEmbedding(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv1d(768, 768, 128, padding=64, groups=16)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, Frame, 768) -> (B, Frame, 768)."""
        y = self.conv(x.transpose(1, 2))[:, :, :-1]
        return F.gelu(y).transpose(1, 2)


class SelfAttention(nn.Module):
    """nn.MultiheadAttention's parameters (packed in_proj), softmax
    attention."""

    def __init__(self, dim: int = 768, heads: int = 12):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = (t.reshape(b, n, self.heads, d // self.heads).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        out = F.scaled_dot_product_attention(q, k, v)
        return self.out_proj(out.transpose(1, 2).reshape(b, n, d))


class TransformerLayer(nn.Module):
    """nn.TransformerEncoderLayer parity: post-norm, exact GELU."""

    def __init__(self, dim: int = 768, heads: int = 12, ff: int = 3072):
        super().__init__()
        self.self_attn = SelfAttention(dim, heads)
        self.linear1 = nn.Linear(dim, ff)
        self.linear2 = nn.Linear(ff, dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.self_attn(x))
        return self.norm2(x + self.linear2(F.gelu(self.linear1(x))))


class Encoder(nn.Module):
    def __init__(self, n_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(TransformerLayer() for _ in range(n_layers))


class HubertSoft(nn.Module):
    """forward == the reference HubertSoft.units: (B, T) 16 kHz audio ->
    (B, Frame, proj_dim or 768). output_layer: stop after this many layers
    (1-based); proj_dim None: the raw transformer features; pad_input: the
    (400 - 320) / 2 = 40-sample pad on both sides (HuBERT-soft only)."""

    def __init__(self, num_layers: int = 12, output_layer: Optional[int] = None,
                 proj_dim: Optional[int] = 256, pad_input: bool = True):
        super().__init__()
        self.pad_input = pad_input
        self.feature_extractor = FeatureExtractor()
        self.feature_projection = FeatureProjection()
        self.positional_embedding = PositionalConvEmbedding()
        self.norm = nn.LayerNorm(768, eps=1e-5)
        self.encoder = Encoder(output_layer or num_layers)
        self.proj = None if proj_dim is None else nn.Linear(768, proj_dim)

    @classmethod
    def variant(cls, encoder: str) -> "HubertSoft":
        if encoder not in VARIANTS:
            raise ValueError(f" [x] Unknown units encoder: {encoder}")
        output_layer, proj_dim, pad = VARIANTS[encoder]
        return cls(output_layer=output_layer, proj_dim=proj_dim, pad_input=pad)

    def frames(self, n_samples: int) -> int:
        """Frames of forward's output for n_samples of input: the feature
        extractor's convs (k10 s5, k3 s2 x4, k2 s2 x2) on the padded input."""
        n = int(n_samples) + (80 if self.pad_input else 0)
        for k, s in ((10, 5),) + ((3, 2),) * 4 + ((2, 2),) * 2:
            n = (n - k) // s + 1
        return n

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        if self.pad_input:
            wav = F.pad(wav, (40, 40))
        x = self.feature_extractor(wav).transpose(1, 2)
        x = self.feature_projection(x)
        x = self.norm(x + self.positional_embedding(x))
        for layer in self.encoder.layers:
            x = layer(x)
        return x if self.proj is None else self.proj(x)


def span_mask(starts: torch.Tensor, t: int, mask_length: int) -> torch.Tensor:
    """The bool (B, T) mask of spans [s, s + mask_length) from the (B, N)
    span starts (spans may overlap), as the JAX package's compute_mask
    scatters them."""
    idx = starts[..., None] + torch.arange(mask_length, device=starts.device)
    mask = torch.zeros((starts.shape[0], t), dtype=torch.bool,
                       device=starts.device)
    return mask.scatter_(1, idx.reshape(starts.shape[0], -1), True)


def compute_mask(shape: Sequence[int], mask_prob: float = 0.8,
                 mask_length: int = 10, min_masks: int = 2,
                 generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
    """SpecAugment span mask of HuBERT's training (the reference model's
    _compute_mask): round(mask_prob T / mask_length) spans a row, at most
    T // mask_length and at least min_masks, each starting uniformly in
    [0, T - mask_length]. The starts come from `generator` (the JAX package
    draws them from a jax.random key: the same distribution, other
    numbers). Returns bool (B, T) on `device`."""
    b, t = (int(n) for n in shape)
    if mask_length > t:
        raise ValueError("mask_length must be <= sequence_length")
    num_spans = int(mask_prob * t / mask_length + 0.5)
    num_spans = max(min(num_spans, t // mask_length), min_masks)
    starts = torch.randint(0, t - mask_length + 1, (b, num_spans),
                           generator=generator, device=device)
    return span_mask(starts, t, mask_length)


class HubertDiscrete:
    """Discrete units: HuBERT's layer-7 features (768 wide, no projection)
    quantised to the nearest k-means centre, the reference's
    HubertDiscrete. model_or_state: a HubertSoft or a HuBERT state dict
    (`load_hubert_state_dict`'s layouts; layers past 7 and the projection
    are not used); cluster_centers: (K, 768), or the reference's codebook
    dict ({'n_features_in_', 'cluster_centers_'}). CUDA unless the caller
    asks for the CPU."""

    # the (frames, K, 768) fp32 differences of one distance chunk
    CHUNK_BYTES = 256 * 2 ** 20

    def __init__(self, model_or_state: Union[nn.Module, Mapping],
                 cluster_centers, device=None):
        from ..utils.device import resolve_device

        self.device = resolve_device(device)
        sd = (model_or_state.state_dict()
              if isinstance(model_or_state, nn.Module) else model_or_state)
        model = HubertSoft(output_layer=7, proj_dim=None)
        self.model = load_hubert_state_dict(model, sd).to(self.device).eval()
        if isinstance(cluster_centers, Mapping):
            cluster_centers = cluster_centers["cluster_centers_"]
        self.centers = torch.as_tensor(np.asarray(cluster_centers, np.float32),
                                       device=self.device)
        k, d = self.centers.shape
        self.chunk = max(1, self.CHUNK_BYTES // (4 * k * d))

    @torch.no_grad()
    def units(self, wav) -> torch.Tensor:
        """(B, T) 16 kHz audio -> (B, Frame) int64 ids of the nearest
        centre, by sum((f - c)^2) over the features as the JAX package
        computes it (not |f|^2 - 2 f.c + |c|^2, which cancels), in chunks
        of frames."""
        x = self.model(torch.as_tensor(np.asarray(wav, np.float32)
                                       if not torch.is_tensor(wav) else wav,
                                       device=self.device))
        feats = x.reshape(-1, x.shape[-1])
        ids = [((f[:, None, :] - self.centers[None]) ** 2).sum(-1).argmin(1)
               for f in feats.split(self.chunk)]
        return torch.cat(ids).reshape(x.shape[0], x.shape[1])


@torch.no_grad()
def init_hubert_(model: HubertSoft, generator: torch.Generator) -> HubertSoft:
    """Seeded weights as the JAX package's flax initialisers draw them
    (`lecun_init_`, and the packed in_proj at N(0, 1/768))."""
    lecun_init_(model, generator)
    for layer in model.encoder.layers:
        w = layer.self_attn.in_proj_weight
        w.copy_(torch.randn(w.shape, generator=generator) * w.shape[1] ** -0.5)
        layer.self_attn.in_proj_bias.zero_()
    return model


def _fold_positional(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """torch weight_norm(dim=2) of the positional conv: w = g v / ||v||,
    the norm over the output and input axes per tap (1e-12 as the JAX
    converter)."""
    norm = torch.sqrt((v ** 2).sum(dim=(0, 1), keepdim=True))
    return v * (g / (norm + 1e-12))


def _fairseq_to_bshall(sd: Mapping) -> Dict[str, torch.Tensor]:
    """Key map of a fairseq HuBERT / ContentVec state dict onto the bshall
    layout (separate q/k/v packed into in_proj)."""
    out: Dict[str, torch.Tensor] = {}
    for i in range(7):
        out[f"feature_extractor.conv{i}.weight"] = sd[
            f"feature_extractor.conv_layers.{i}.0.weight"]
    for p in ("weight", "bias"):
        out[f"feature_extractor.norm0.{p}"] = sd[
            f"feature_extractor.conv_layers.0.2.{p}"]
        out[f"feature_projection.norm.{p}"] = sd[f"layer_norm.{p}"]
        out[f"feature_projection.projection.{p}"] = sd[f"post_extract_proj.{p}"]
        out[f"norm.{p}"] = sd[f"encoder.layer_norm.{p}"]
        if f"final_proj.{p}" in sd:
            out[f"proj.{p}"] = sd[f"final_proj.{p}"]
    for p in ("weight_g", "weight_v", "bias"):
        out[f"positional_embedding.conv.{p}"] = sd[f"encoder.pos_conv.0.{p}"]
    i = 0
    while f"encoder.layers.{i}.self_attn.q_proj.weight" in sd:
        src, dst = f"encoder.layers.{i}.", f"encoder.layers.{i}."
        for p in ("weight", "bias"):
            out[f"{dst}self_attn.in_proj_{p}"] = torch.cat(
                [sd[f"{src}self_attn.{n}_proj.{p}"] for n in "qkv"])
            out[f"{dst}self_attn.out_proj.{p}"] = sd[f"{src}self_attn.out_proj.{p}"]
            out[f"{dst}linear1.{p}"] = sd[f"{src}fc1.{p}"]
            out[f"{dst}linear2.{p}"] = sd[f"{src}fc2.{p}"]
            out[f"{dst}norm1.{p}"] = sd[f"{src}self_attn_layer_norm.{p}"]
            out[f"{dst}norm2.{p}"] = sd[f"{src}final_layer_norm.{p}"]
        i += 1
    return out


def load_hubert_state_dict(model: HubertSoft, sd: Mapping) -> HubertSoft:
    """Load a torch HuBERT checkpoint's state dict into `model`: the bshall
    HuBERT-soft layout (what `convert_hubert_state_dict` reads) or the
    fairseq layout (`convert_fairseq_hubert_state_dict`), wrapped under
    'state_dict' or 'model' or bare, 'module.' prefixes stripped, the
    positional conv's weight norm folded. Layers past the model's depth and
    entries it has no use for (label embeddings, masks) are ignored."""
    for key in ("state_dict", "model"):
        if isinstance(sd.get(key), Mapping):
            sd = sd[key]
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    if "encoder.layers.0.self_attn.k_proj.weight" in sd:
        sd = _fairseq_to_bshall(sd)
    sd = dict(sd)
    pos = "positional_embedding.conv."
    if pos + "weight" not in sd:
        sd[pos + "weight"] = _fold_positional(sd[pos + "weight_g"],
                                              sd[pos + "weight_v"])
    own = model.state_dict()
    missing = [k for k in own if k not in sd]
    if missing:
        raise KeyError(f"HuBERT checkpoint lacks {missing[:4]}"
                       f"{' ...' if len(missing) > 4 else ''}")
    model.load_state_dict({k: sd[k] for k in own})
    return model
