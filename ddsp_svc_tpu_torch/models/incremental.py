"""Exact incremental (state-carrying) streaming inference for CombSubFast.

Counterpart of `ddsp_svc_tpu/models/incremental.py`. For a model built with
`causal=True, frame_norm=True` each incoming feature frame advances a
carried state and emits one block of audio, equal to the batch forward
(within fp32 reassociation) at a fixed 2-frame algorithmic delay, with
O(block) work per frame: no window is recomputed and nothing is spliced.

Carried state:
  - the prenet: the last 2 inputs of each causal k3 conv;
  - per PCmer layer: the linear-attention moments (S = sum k v^T, sum k)
    and the last kernel-1 inputs of the causal depthwise conv;
  - the DSP: the double-single (hi, lo) phase-rotation carry, the previous
    f0 frame, the previous combtooth and noise blocks, the second half of
    the previous synthesis frame (the overlap-add tail) and the previous
    frame's control vector.

Plain PyTorch on the model's device: the JAX engine runs no Pallas kernel
(its frame step is one `lax.scan`); here `process` is a Python loop over a
chunk's frames, each frame a few hundred small launches on the card.

Unlike the JAX engine, which takes each interval's rotation as an fp32
cumsum of the f0 steps (its stream drifts from the batch forward as the
carry's rounding accumulates, 1.4e-3 of max |out| after 48 frames), the
rotation here is the batch forward's own: the interval's closed form on a
carry advanced by the exact double-single interval totals, so the stream
stays within fp32 reassociation of the batch forward however long it runs.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..nn.layers import FrameGroupNorm, leaky_relu
from ..nn.pcmer import softmax_kernel
from ..ops.exciters import combtooth
from ..ops.phase import _combine, _wrap, frame_inner, frame_totals
from ..ops.spectral import irfft_any
from ..ops.windows import sqrt_hann_window


class LayerState(NamedTuple):
    attn_s: torch.Tensor  # (B, H, m, d)
    attn_ksum: torch.Tensor  # (B, H, m)
    conv_tail: torch.Tensor  # (B, kernel - 1, inner)


class StreamState(NamedTuple):
    prenet0_tail: torch.Tensor  # (B, 2, n_unit)
    prenet1_tail: torch.Tensor  # (B, 2, d)
    layers: Tuple[LayerState, ...]
    rot_hi: torch.Tensor  # (B,)
    rot_lo: torch.Tensor  # (B,)
    prev_f0: torch.Tensor  # (B,) the last f0 frame seen
    prev_tooth: torch.Tensor  # (B, bs) combtooth of the previous interval
    prev_noise: torch.Tensor  # (B, bs)
    prev_filtered_half: torch.Tensor  # (B, bs) the overlap-add tail
    prev_ctrl: torch.Tensor  # (B, 3 (bs + 1)) the previous control vector
    frame_idx: int
    spk_embed: torch.Tensor  # (B, d)


def _causal_conv_frame(weight, bias, tail, x):
    """One output frame of a causal k-tap conv. weight (out, in, k); tail
    (B, k-1, in) the previous inputs; x (B, in). Returns (y, new tail)."""
    window = torch.cat([tail, x[:, None, :]], dim=1)  # (B, k, in)
    y = torch.einsum("bki,oik->bo", window, weight) + bias
    return y, window[:, 1:]


def _depthwise_conv_frame(weight, bias, tail, x):
    """One output frame of a causal depthwise conv. weight (C, 1, k)."""
    window = torch.cat([tail, x[:, None, :]], dim=1)  # (B, k, C)
    y = torch.einsum("bkc,ck->bc", window, weight[:, 0, :]) + bias
    return y, window[:, 1:]


class IncrementalCombSubFast:
    """Streaming engine over a CombSubFast(causal=True, frame_norm=True).

    The widths (layers, heads, dim_head, features, d, n_unit, the depthwise
    kernel) are read from the model. The JAX engine fixes 3 layers, 8
    heads, dim_head 64 and d 256, the values every shipped config has, so
    the two agree on those configs."""

    def __init__(self, model):
        u2c = model.unit2ctrl
        prenet = u2c.unit_prenet
        if not (prenet["1"].time_pad == (2, 0)
                and isinstance(prenet["2"], FrameGroupNorm)):
            raise ValueError(
                "incremental mode needs a model built with causal=True and "
                "frame_norm=True (GroupNorm statistics reach future frames)")
        self.model = model
        self.u2c = u2c
        self.bs = int(model.block_size)
        self.sr = int(model.sampling_rate)
        self.device = next(model.parameters()).device
        self.layers = list(u2c.dec_post["0"].net)
        attn = self.layers[0].attn
        self.heads, self.dim_head = attn.heads, attn.dim_head
        self.m = attn.fast_attention.projection_matrix.shape[0]
        self.d = u2c.f0_embed.out_features
        self.n_unit = prenet["1"].in_channels
        mixer = self.layers[0].local_mixer.net["4"]
        self.inner, self.conv_taps = mixer.in_channels, mixer.kernel_size[0]
        self.window = sqrt_hann_window(2 * self.bs, device=self.device)
        # the lerp weights of a frame's samples, as ops/interp.py's upsampler
        self.frac = (torch.arange(self.bs, dtype=torch.float64,
                                  device=self.device) / self.bs).float()

    # ------------------------------ state ----------------------------------

    def init_state(self, spk_id, batch: int = 1) -> StreamState:
        """The state before frame 0 for speakers spk_id (1-based, (B,) or
        (B, 1))."""
        dev, b = self.device, batch

        def zeros(*shape):
            return torch.zeros(shape, device=dev)

        layers = tuple(
            LayerState(attn_s=zeros(b, self.heads, self.m, self.dim_head),
                       attn_ksum=zeros(b, self.heads, self.m),
                       conv_tail=zeros(b, self.conv_taps - 1, self.inner))
            for _ in self.layers)
        ids = torch.as_tensor(np.asarray(spk_id).reshape(-1) - 1,
                              dtype=torch.int64, device=dev)
        with torch.no_grad():
            spk = self.u2c.spk_embed.weight[ids].expand(b, -1).clone()
        return StreamState(
            prenet0_tail=zeros(b, 2, self.n_unit),
            prenet1_tail=zeros(b, 2, self.d),
            layers=layers, rot_hi=zeros(b), rot_lo=zeros(b),
            prev_f0=zeros(b), prev_tooth=zeros(b, self.bs),
            prev_noise=zeros(b, self.bs),
            prev_filtered_half=zeros(b, self.bs),
            prev_ctrl=zeros(b, 3 * (self.bs + 1)), frame_idx=0,
            spk_embed=spk)

    # --------------------------- control network ---------------------------

    def _control_frame(self, state: StreamState, unit, f0, phase, volume):
        """One frame through Unit2Control. unit (B, n_unit); f0, phase
        [rad], volume (B,). Returns (control vector, prenet tails, layer
        states)."""
        u2c = self.u2c
        prenet = u2c.unit_prenet
        x, pre0 = _causal_conv_frame(prenet["1"].weight, prenet["1"].bias,
                                     state.prenet0_tail, unit)
        x = leaky_relu(prenet["2"](x[:, None])[:, 0])  # frame-local stats
        x, pre1 = _causal_conv_frame(prenet["4"].weight, prenet["4"].bias,
                                     state.prenet1_tail, x)
        x = (x + u2c.f0_embed(torch.log1p(f0 / 700.0)[:, None])
             + u2c.phase_embed((phase / np.pi)[:, None])
             + u2c.volume_embed(volume[:, None]) + state.spk_embed)

        new_layers = []
        b, h, dh = x.shape[0], self.heads, self.dim_head
        for layer, ls in zip(self.layers, state.layers):
            attn = layer.attn
            y = layer.norm(x)
            q, k, v = (f(y).reshape(b, h, dh)
                       for f in (attn.to_q, attn.to_k, attn.to_v))
            proj = attn.fast_attention.projection_matrix
            qf = softmax_kernel(q[:, :, None], proj, is_query=True)[:, :, 0]
            kf = softmax_kernel(k[:, :, None], proj, is_query=False)[:, :, 0]
            s_new = ls.attn_s + kf[..., None] * v[:, :, None, :]
            ksum_new = ls.attn_ksum + kf
            num = torch.einsum("bhm,bhmd->bhd", qf, s_new)
            den = torch.einsum("bhm,bhm->bh", qf, ksum_new + 1e-6)
            x = x + attn.to_out((num / den[..., None]).reshape(b, -1))
            net = layer.local_mixer.net
            y = net["0"](x)
            y = F.linear(y, net["2"].weight[:, :, 0], net["2"].bias)
            a, g = y.chunk(2, dim=-1)
            y, tail = _depthwise_conv_frame(net["4"].weight, net["4"].bias,
                                            ls.conv_tail, a * torch.sigmoid(g))
            y = F.silu(y)
            x = x + F.linear(y, net["6"].weight[:, :, 0], net["6"].bias)
            new_layers.append(LayerState(s_new, ksum_new, tail))
        ctrl = u2c.dec_post["2"](u2c.dec_post["1"](x))
        return ctrl, pre0, pre1, tuple(new_layers)

    # ------------------------------ dsp step -------------------------------

    def _filter_frame(self, tooth_pair, noise_pair, ctrl):
        """One analysis frame: the windowed (previous, current) tooth and
        noise blocks filtered by the control vector ctrl; (B, 2 bs)."""
        bs, n_bins = self.bs, self.bs + 1
        seg = tooth_pair * self.window
        nseg = noise_pair * self.window
        src = torch.exp(torch.complex(ctrl[:, :n_bins],
                                      np.pi * ctrl[:, n_bins:2 * n_bins]))
        noise_filter = torch.exp(ctrl[:, 2 * n_bins:]) / 128.0
        spec = (torch.fft.rfft(seg, 2 * bs) * src
                + torch.fft.rfft(nseg, 2 * bs) * noise_filter)
        return irfft_any(spec, 2 * bs) * self.window

    def _frame_step(self, state: StreamState, unit, f0, volume, noise_blk):
        """Advance by one incoming frame; returns (audio block, state). The
        block is frame_idx - 2's (zeros while the 2-frame pipeline fills)."""
        bs, sr = self.bs, self.sr
        first = state.frame_idx == 0  # no interval precedes frame 0

        # interval j-1: f0 lerped from the previous frame to this one, its
        # rotation in the batch forward's closed form on the carry, and its
        # total added to the carry in double-single (ops/phase.py)
        a, slope = state.prev_f0, f0 - state.prev_f0
        f0_seg = a[:, None] + slope[:, None] * self.frac
        carry = _wrap(state.rot_hi + state.rot_lo)
        rot = _wrap(_wrap(frame_inner(a, slope, bs, sr)) + carry[:, None])
        tooth = combtooth(rot, f0_seg, sr)
        if first:
            tooth = torch.zeros_like(tooth)
            new_rot_hi, new_rot_lo = state.rot_hi, state.rot_lo
            noise_blk = torch.zeros_like(noise_blk)
        else:
            new_rot_hi, new_rot_lo = _combine(state.rot_hi, state.rot_lo,
                                              *frame_totals(a, f0, bs, sr))

        # control frame j (phase at sample j bs = the carry + f0[j] / sr)
        phase_j = 2.0 * np.pi * _wrap(_wrap(f0 / sr)
                                      + _wrap(new_rot_hi + new_rot_lo))
        ctrl, pre0, pre1, layers = self._control_frame(state, unit, f0,
                                                       phase_j, volume)

        # analysis frame j-1: tooth blocks (j-2, j-1), filtered by ctrl[j-1]
        frame_out = self._filter_frame(
            torch.cat([state.prev_tooth, tooth], dim=-1),
            torch.cat([state.prev_noise, noise_blk], dim=-1),
            state.prev_ctrl)
        # emit block j-2: the previous frame's second half + this one's first
        audio = state.prev_filtered_half + frame_out[:, :bs]
        return audio, StreamState(
            prenet0_tail=pre0, prenet1_tail=pre1, layers=layers,
            rot_hi=new_rot_hi, rot_lo=new_rot_lo, prev_f0=f0,
            prev_tooth=tooth, prev_noise=noise_blk,
            prev_filtered_half=frame_out[:, bs:], prev_ctrl=ctrl,
            frame_idx=state.frame_idx + 1, spk_embed=state.spk_embed)

    def _tensor(self, a):
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def process(self, state: StreamState, units, f0, volume, noise
                ) -> Tuple[torch.Tensor, StreamState]:
        """Feed a chunk of Fc frames: units (B, Fc, n_unit), f0 (B, Fc)
        [Hz], volume (B, Fc), noise (B, Fc bs) uniform(-1, 1), numpy or
        tensors. Returns (audio (B, Fc bs) on the model's device, state);
        the output blocks lag the input frames by 2."""
        units, f0, volume, noise = (self._tensor(a)
                                    for a in (units, f0, volume, noise))
        b, fc = f0.shape
        blocks = noise.reshape(b, fc, self.bs)
        out = []
        for j in range(fc):
            blk, state = self._frame_step(state, units[:, j], f0[:, j],
                                          volume[:, j], blocks[:, j])
            out.append(blk)
        return torch.cat(out, dim=-1), state

    @torch.no_grad()
    def flush(self, state: StreamState, noise_last: Optional = None
              ) -> Tuple[torch.Tensor, StreamState]:
        """Drain the 2-frame pipeline as the batch forward ends: the last
        interval holds f0 (edge repeat), the last analysis frame repeats the
        last control frame, and the excitation is zero-padded behind.
        noise_last: the noise of the final interval (B, bs); zeros if
        omitted. Returns ((B, 2 bs) audio, state)."""
        b, bs = state.prev_f0.shape[0], self.bs
        noise_last = (torch.zeros((b, bs), device=self.device)
                      if noise_last is None else self._tensor(noise_last))
        last_ctrl = state.prev_ctrl
        # a virtual incoming frame: the interval F-1 uses (f0[F-1], f0[F-1]);
        # the control frame it computes is discarded
        blk1, st = self._frame_step(
            state, torch.zeros_like(state.prenet0_tail[:, -1]), state.prev_f0,
            torch.zeros_like(state.prev_f0), noise_last)
        zeros = torch.zeros((b, bs), device=self.device)
        frame_out = self._filter_frame(
            torch.cat([st.prev_tooth, zeros], dim=-1),
            torch.cat([st.prev_noise, zeros], dim=-1), last_ctrl)
        blk2 = st.prev_filtered_half + frame_out[:, :bs]
        return torch.cat([blk1, blk2], dim=-1), st
