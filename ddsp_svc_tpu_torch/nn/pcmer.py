"""PCmer: the conformer-performer backbone of Unit2Control.

Counterpart of `ddsp_svc_tpu/nn/pcmer.py`. Each layer is
    x = x + SelfAttention(LayerNorm(x));  x = x + ConformerConvModule(x)
with Performer FAVOR+ attention (dim_head 64, m = int(64 ln 64) = 266
random features). Module and buffer names follow the reference model's
state dict (`net.{i}.attn.to_q`, `attn.fast_attention.projection_matrix`,
`local_mixer.net.{0,2,4,6}`).

At inference the non-causal attention runs through the hand-written kernel
(`ops.kernels.performer_attention`); training and the CPU take the plain
softmax_kernel + linear_attention below. A causal layer (`causal=True`, the
streamable models) takes `causal_linear_attention`, a chunked prefix scan
of plain products, in training and at inference alike: the JAX package
never routes a causal layer to its Pallas attention either.

compute_dtype=torch.bfloat16 (model.bf16) runs the QKV/out projections, the
random-feature projection, the attention contractions and the conv module's
matmuls in bf16, as the JAX package does; LayerNorms, the FAVOR+
exponentials, the attention denominators, the residual stream and the
parameters stay fp32. At inference (and on a time shard) the bf16 q, k and
v go to the attention kernel's bf16-operand form, as JAX's PCmer passes
`mxu_bf16=compute_dtype == bfloat16` to its Pallas kernel; in training the
plain route below rounds the projection to bf16 as JAX's XLA route does.
The kernel takes any T; JAX's takes T % 128 == 0 and T <= 512 and leaves
the rest to its XLA route.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels import (performer_attention, performer_attention_apply,
                           performer_attention_moments,
                           performer_attention_plain)
from ..ops.masking import frame_mask
from .layers import Conv1d, glu, linear


def gaussian_orthogonal_random_matrix(nb_rows: int, nb_columns: int,
                                      seed: int) -> np.ndarray:
    """Orthogonal random feature projection (Performer, scaling=0 mode):
    QR-orthogonalised Gaussian blocks with chi-distributed row norms. The
    same numpy draw as the JAX package, so both hold the same matrix for a
    seed."""
    rng = np.random.default_rng(seed)
    blocks = []
    n_full = nb_rows // nb_columns
    for _ in range(n_full):
        q, _ = np.linalg.qr(rng.standard_normal((nb_columns, nb_columns)))
        blocks.append(q.T)
    rem = nb_rows - n_full * nb_columns
    if rem > 0:
        q, _ = np.linalg.qr(rng.standard_normal((nb_columns, nb_columns)))
        blocks.append(q.T[:rem])
    final = np.concatenate(blocks, axis=0)
    multiplier = np.linalg.norm(
        rng.standard_normal((nb_rows, nb_columns)), axis=1
    )
    return (np.diag(multiplier) @ final).astype(np.float32)


def softmax_kernel(data: torch.Tensor, projection: torch.Tensor,
                   is_query: bool, eps: float = 1e-4) -> torch.Tensor:
    """FAVOR+ positive softmax features. data (B, H, T, d), projection
    (m, d) -> (B, H, T, m). The query subtracts its max over the m features
    of each position; the key keeps the reference's eps inside the exp.
    The projection runs in data's dtype, the exponentials in fp32; the
    features come back in data's dtype."""
    d = data.shape[-1]
    normalizer = d ** -0.25
    ratio = projection.shape[0] ** -0.5
    data_dash = torch.einsum("bhid,jd->bhij", normalizer * data,
                             projection.to(data.dtype)).float()
    data32 = data.float()
    diag = (data32 * data32).sum(-1, keepdim=True) * 0.5 * normalizer ** 2
    if is_query:
        out = ratio * (torch.exp(
            data_dash - diag - data_dash.amax(dim=-1, keepdim=True)) + eps)
    else:
        out = ratio * torch.exp(data_dash - diag + eps)
    return out.to(data.dtype)


def attention_moments(k: torch.Tensor, v: torch.Tensor):
    """The key moments of non-causal linear attention: k (B, H, T, m)
    features, v (B, H, T, d) -> (context (B, H, m, d), k_sum (B, H, m)),
    the key sums fp32 whatever the inputs' dtype."""
    return torch.einsum("...nd,...ne->...de", k, v), k.float().sum(dim=-2)


def attention_apply(q: torch.Tensor, context: torch.Tensor,
                    k_sum: torch.Tensor) -> torch.Tensor:
    """Query features q (B, H, T, m) against the key moments -> (B, H, T,
    d); the denominators fp32 whatever the inputs' dtype."""
    d_inv = 1.0 / (torch.einsum("...nd,...d->...n", q.float(), k_sum) + 1e-8)
    return torch.einsum("...de,...nd,...n->...ne", context, q,
                        d_inv.to(q.dtype))


def linear_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Non-causal linear attention. q, k (B, H, T, m); v (B, H, T, d)."""
    return attention_apply(q, *attention_moments(k, v))


def causal_linear_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, chunk: int = 128,
                            eps: float = 1e-6, carry=None,
                            start: int = 0) -> torch.Tensor:
    """Causal linear attention as a chunked prefix scan. q, k (B, H, T, m)
    features; v (B, H, T, d) -> (B, H, T, d):

        out[t] = (q[t] S_t) / (q[t] . (K_t + eps)),
        S_t = sum_{s<=t} k[s] v[s]^T,  K_t = sum_{s<=t} k[s].

    Within a chunk of `chunk` frames the causal interaction is a masked
    (C x C) product; across chunks an (m x d) state and an (m,) key sum
    are carried in fp32 whatever the inputs' dtype (they grow with T, and
    bf16 would drop late contributions). T is zero-padded to a multiple of
    the chunk; padded positions have q = k = 0, so their denominator is 0,
    and they divide by 1 instead, which keeps the backward free of NaNs
    (real positions always have a positive denominator: FAVOR+ features
    are positive). carry: (S_0 (B, H, m, d), K_0 (B, H, m)), the sums of the
    frames before the first (a time shard's window), else zeros; start: the
    first frame's index in the whole sequence, whose chunk grid the window
    then keeps (zero frames in front), so its sums group as the whole
    sequence's do."""
    b, h, t, m = q.shape
    front = start % chunk
    pad = (-(t + front)) % chunk
    if pad or front:
        q, k, v = (F.pad(x, (0, 0, front, pad)) for x in (q, k, v))
    mask = torch.tril(torch.ones((chunk, chunk), dtype=q.dtype,
                                 device=q.device))
    if carry is None:
        s = torch.zeros((b, h, m, v.shape[-1]), dtype=torch.float32,
                        device=q.device)
        ksum = torch.zeros((b, h, m), dtype=torch.float32, device=q.device)
    else:
        s, ksum = (c.float() for c in carry)
    outs = []
    for lo in range(0, front + t + pad, chunk):
        qi, ki, vi = (x[:, :, lo:lo + chunk] for x in (q, k, v))
        attn = torch.einsum("bhim,bhjm->bhij", qi, ki) * mask
        num = (torch.einsum("bhij,bhjd->bhid", attn, vi)
               + torch.einsum("bhim,bhmd->bhid", qi, s.to(qi.dtype)))
        k_cum = torch.cumsum(ki.float(), dim=-2) + ksum[:, :, None, :]
        denom = torch.einsum("bhim,bhim->bhi", qi.float(), k_cum + eps)
        safe = torch.where(denom > 0, denom, torch.ones_like(denom))
        outs.append((num.float() / safe[..., None]).to(qi.dtype))
        s = s + torch.einsum("bhjm,bhjd->bhmd", ki, vi).float()
        ksum = ksum + ki.float().sum(dim=-2)
    return torch.cat(outs, dim=2)[:, :, front:front + t]


class FastAttention(nn.Module):
    """Holds the fixed random projection, as the reference module does."""

    def __init__(self, dim_head: int, nb_features: int, seed: int):
        super().__init__()
        self.register_buffer("projection_matrix", torch.from_numpy(
            gaussian_orthogonal_random_matrix(nb_features, dim_head, seed)))


class SelfAttention(nn.Module):
    """Multi-head Performer self-attention, (B, T, dim) -> (B, T, dim)."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 causal: bool = False, proj_seed: int = 0, compute_dtype=None):
        super().__init__()
        self.causal = causal
        self.heads = heads
        self.dim_head = dim_head
        self.compute_dtype = compute_dtype
        inner = heads * dim_head
        self.fast_attention = FastAttention(
            dim_head, int(dim_head * math.log(dim_head)), proj_seed)
        self.to_q = nn.Linear(dim, inner)
        self.to_k = nn.Linear(dim, inner)
        self.to_v = nn.Linear(dim, inner)
        self.to_out = nn.Linear(inner, dim)
        # a `parallel.sharding.ModelShard` once the heads are cut over the
        # mesh's model axis (shard_train_state): self.heads is then local
        self.tp = None

    def forward(self, x: torch.Tensor, infer: bool = False,
                valid_frames=None, shard=None) -> torch.Tensor:
        """valid_frames: zero the key features past each item's true length,
        so padded frames feed neither the context nor the denominator.
        shard (a `parallel.timeparallel.TimeShard`, x its window): the key
        moments of the frames the shard owns, all-reduced over its group,
        then the queries of the whole window against them; the moments and
        apply kernels on the card, their plain versions on the CPU; a
        causal layer carries in the moments of the frames before its
        window (`window_carry`). Sharded over the model axis (self.tp),
        this rank's heads, the output projection's partial sums
        all-reduced before its bias."""
        b, n, _ = x.shape
        dt = self.compute_dtype
        if self.tp is not None:
            x = self.tp.enter(x)

        def split_heads(layer):  # a (B, H, T, d) view, read in place
            t = linear(x, layer.weight, layer.bias, dt)
            return t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)

        q, k, v = (split_heads(f) for f in (self.to_q, self.to_k, self.to_v))
        proj = self.fast_attention.projection_matrix
        # the attention kernels: bf16 q, k, v (model.bf16) take their
        # bf16-operand form, the fp32 form takes fp32
        mxu = q.dtype == torch.bfloat16
        kq, kk, kv = (q, k, v) if mxu else (q.float(), k.float(), v.float())
        if self.causal:
            qf = softmax_kernel(q, proj, is_query=True)
            kf = softmax_kernel(k, proj, is_query=False)
            if valid_frames is not None:
                kf = kf * frame_mask(n, valid_frames, kf.dtype,
                                     kf.device)[:, None, :, None]
            out = (causal_linear_attention(qf, kf, v) if shard is None
                   else causal_linear_attention(
                       qf, kf, v, carry=window_carry(kf, v, shard),
                       start=shard.lo))
        elif shard is not None:
            # the split on its bf16-operand form under bf16: the moments
            # summed fp32 over the shards, rounded in the apply
            context, k_sum = performer_attention_moments(
                kk, kv, proj, *shard.key_range(valid_frames), mxu_bf16=mxu)
            context, k_sum = shard.all_reduce(context, k_sum)
            out = performer_attention_apply(kq, proj, context, k_sum,
                                            mxu_bf16=mxu).to(q.dtype)
        elif infer:
            out = performer_attention(kq, kk, kv, proj, valid_frames,
                                      mxu_bf16=mxu).to(q.dtype)
        else:
            out = performer_attention_plain(q, k, v, proj, valid_frames)
        out = out.transpose(1, 2).reshape(b, n, self.heads * self.dim_head)
        if self.tp is None:
            return linear(out, self.to_out.weight, self.to_out.bias,
                          dt).to(x.dtype)
        y = self.tp.reduce(linear(out, self.to_out.weight, None, dt).float())
        return (y + self.to_out.bias).to(x.dtype)


def window_carry(kf: torch.Tensor, v: torch.Tensor, shard):
    """The causal prefix sums (S_0, K_0) at the first frame of a time
    shard's window (kf, v (B, H, T, .) the window's key features and
    values): each rank's moments over its owned frames go into its own row
    of one all-reduce (`TimeShard.carry`), the lower ranks' sum is the
    carry at its first owned frame, and the window's frames before that
    (the halo) take it less their own moments, so the prefix sums at every
    owned frame are the whole sequence's."""
    a, c = shard.own_lo - shard.lo, shard.own_hi - shard.lo
    own = attention_moments(kf[:, :, a:c], v[:, :, a:c])
    halo = attention_moments(kf[:, :, :a], v[:, :, :a])
    s0, k0 = shard.carry(own[0].float(), own[1])
    return s0 - halo[0].float(), k0 - halo[1]


class ConformerConvModule(nn.Module):
    """LN -> pointwise x2 -> GLU -> depthwise k31 -> SiLU -> pointwise."""

    def __init__(self, dim: int, causal: bool = False,
                 expansion_factor: int = 2, kernel_size: int = 31,
                 compute_dtype=None):
        super().__init__()
        inner = dim * expansion_factor
        self.compute_dtype = compute_dtype
        self.net = nn.ModuleDict({
            "0": nn.LayerNorm(dim, eps=1e-5),
            "2": nn.Conv1d(dim, inner * 2, 1),
            "4": Conv1d(inner, inner, kernel_size, causal=causal,
                        groups=inner, compute_dtype=compute_dtype),
            "6": nn.Conv1d(inner, dim, 1),
        })
        # a `parallel.sharding.ModelShard` once the channels are cut over
        # the mesh's model axis (shard_train_state)
        self.tp = None

    def forward(self, x: torch.Tensor, valid_frames=None) -> torch.Tensor:
        net = self.net
        dt = self.compute_dtype
        in_dtype = x.dtype
        x = net["0"](x)
        if self.tp is not None:
            x = self.tp.enter(x)
        x = glu(linear(x, net["2"].weight[:, :, 0], net["2"].bias, dt))
        if valid_frames is not None:
            # zero pad frames: the depthwise conv then sees exactly the zeros
            # its own boundary padding gives at the true length
            x = x * frame_mask(x.shape[1], valid_frames, x.dtype,
                               x.device)[:, :, None]
        x = F.silu(net["4"](x))
        if self.tp is None:
            return linear(x, net["6"].weight[:, :, 0], net["6"].bias,
                          dt).to(in_dtype)
        y = self.tp.reduce(linear(x, net["6"].weight[:, :, 0], None,
                                  dt).float())
        return (y + net["6"].bias).to(in_dtype)


class PCmerLayer(nn.Module):
    def __init__(self, dim: int, heads: int, causal: bool = False,
                 proj_seed: int = 0, compute_dtype=None):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.attn = SelfAttention(dim, heads, causal=causal,
                                  proj_seed=proj_seed,
                                  compute_dtype=compute_dtype)
        self.local_mixer = ConformerConvModule(dim, causal=causal,
                                               compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor, infer: bool = False,
                valid_frames=None, shard=None) -> torch.Tensor:
        x = x + self.attn(self.norm(x), infer=infer, valid_frames=valid_frames,
                          shard=shard)
        return x + self.local_mixer(x, valid_frames=valid_frames)


class PCmer(nn.Module):
    """Stack of PCmer layers; layer i draws its projection from seed i."""

    def __init__(self, num_layers: int, num_heads: int, dim_model: int,
                 causal: bool = False, compute_dtype=None):
        super().__init__()
        self.net = nn.ModuleList(
            PCmerLayer(dim_model, num_heads, causal=causal, proj_seed=i,
                       compute_dtype=compute_dtype)
            for i in range(num_layers)
        )

    def forward(self, x: torch.Tensor, infer: bool = False,
                valid_frames=None, shard=None) -> torch.Tensor:
        for layer in self.net:
            x = layer(x, infer=infer, valid_frames=valid_frames, shard=shard)
        return x
