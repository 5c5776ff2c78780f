"""The hand-written Hopper kernels, each beside its plain PyTorch version.

Counterpart of `ddsp_svc_tpu/ops/pallas_kernels.py`:

    performer_attention      <- performer_attention_pallas (masked form)
    combsub_spectral         <- combsub_spectral_pallas (forward)
    combsub_spectral_bwd     <- combsub_spectral_pallas (backward,
                                _combsub_spectral_bwd_impl)
    harmonic_source          <- harmonic_source_pallas
    fused_resblocks_inject   <- fused_resblocks_inject_pallas
    fused_resblocks          <- fused_resblocks_pallas (the same kernel
                                without the injection)
    dft_magnitude            <- dft_magnitude_pallas
    oscillator_bank          <- oscillator_bank_pallas
    ltv_fir_convolve         <- ltv_fir_convolve_pallas

combsub_spectral, dft_magnitude, oscillator_bank and ltv_fir_convolve are
differentiable: on CUDA tensors they run inside a torch.autograd.Function
whose backward is the combsub_spectral_bwd kernel for the first and plain
PyTorch for the others (the JAX package's VJPs of #6 and #9 are plain XLA;
oscillator_bank_pallas has none).

Each wrapper takes its plain version only for CPU tensors. For any other
(CUDA) tensor it checks device, dtype, shape and contiguity, allocates the
outputs, and launches its kernel (csrc/<name>.cu, built by ops/build.py) on
the current stream, or raises; it never falls back. `wrapper.launches` counts the
launches. Layouts at these functions are the JAX package's: (B, T, C)
activations, (B, H, T, d) attention.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .build import library
from .exciters import oscillator_bank as oscillator_bank_plain
from .masking import frame_mask
from .windows import sqrt_hann_window

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

_SIGNATURES = {
    "performer_attention_launch": [_P] * 8 + [_I] * 3 + [_F, _F, _P],
    "combsub_spectral_launch": [_P] * 7 + [_I, _I, _P],
    "combsub_spectral_bwd_launch": [_P] * 12 + [_I, _I, _P],
    "dft_magnitude_launch": [_P] * 2 + [_I, _I, _P],
    "harmonic_source_launch": [_P] * 5 + [_I, _I, _I, _F, _P],
    "resblocks_launch": [_P] * 12 + [_I] * 9 + [_P],
    "oscillator_bank_launch": [_P] * 3 + [_I] * 4 + [_P],
    "ltv_fir_convolve_launch": [_P] * 3 + [_I] * 4 + [_P],
}


def _c_function(lib_name: str, symbol: str):
    fn = getattr(library(lib_name), symbol)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[symbol]
        fn.restype = ctypes.c_int
    return fn


def _launch(lib_name: str, symbol: str, *args) -> None:
    err = _c_function(lib_name, symbol)(*args)
    if err != 0:
        raise RuntimeError(f"{symbol} failed: CUDA error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(t: torch.Tensor, name: str, shape, device,
           dtype=torch.float32) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _lengths(valid, b: int, default: int, device) -> torch.Tensor:
    """valid lengths (None, int, 0-d or (B,)) as a (B,) int32 tensor."""
    v = default if valid is None else valid
    v = torch.as_tensor(v, device=device).to(torch.int32).reshape(-1)
    return v.expand(b).contiguous()


def launch_counts() -> dict:
    return {f.__name__: f.launches for f in KERNELS}


def reset_launch_counts() -> None:
    for f in KERNELS:
        f.launches = 0


# --------------------------- performer attention ---------------------------


def performer_attention_plain(q, k, v, projection, valid_frames=None):
    """softmax_kernel features of q and k, key features zeroed past
    valid_frames, then non-causal linear attention. (B, H, T, d) fp32."""
    # nn.pcmer imports this module, so its feature maps are imported here
    from ..nn.pcmer import linear_attention, softmax_kernel

    qf = softmax_kernel(q, projection, is_query=True)
    kf = softmax_kernel(k, projection, is_query=False)
    if valid_frames is not None:
        kf = kf * frame_mask(k.shape[2], valid_frames, kf.dtype,
                             kf.device)[:, None, :, None]
    return linear_attention(qf, kf, v)


def performer_attention(q, k, v, projection, valid_frames=None):
    """Fused non-causal FAVOR+ attention: q, k, v (B, H, T, 64) fp32,
    projection (266, 64) -> (B, H, T, 64). valid_frames (int, 0-d or (B,))
    masks the key features of padded frames; output rows past it are
    meaningless, as in the plain version."""
    if q.device.type == "cpu":
        return performer_attention_plain(q, k, v, projection, valid_frames)
    b, h, t, d = q.shape
    m = projection.shape[0]
    if (m, d) != (266, 64):
        raise ValueError(f"performer_attention takes dim_head 64 and 266 "
                         f"features, got {d} and {m}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check(x, name, (b, h, t, d), q.device)
    _check(projection, "projection", (m, d), q.device)
    valid = _lengths(valid_frames, b, t, q.device)
    ctx_size = m * (d + 1)  # the (m, d) context and the m key sums
    part = torch.empty((b * h * -(-t // 32) * ctx_size,), device=q.device)
    ctx = torch.empty((b * h * ctx_size,), device=q.device)
    out = torch.empty_like(q)
    _launch("performer_attention", "performer_attention_launch",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), projection.data_ptr(),
            valid.data_ptr(), part.data_ptr(), ctx.data_ptr(), out.data_ptr(),
            b, h, t, d ** -0.25, m ** -0.5, _stream(q))
    performer_attention.launches += 1
    return out


# ------------------------------ combsub spectral ----------------------------


def combsub_spectral_plain(tooth_frames, noise_frames, hm, hp, nm,
                           n_fft: int):
    """irfft(rfft(tooth) * exp(hm + j*pi*hp) + rfft(noise) * exp(nm)/128)
    * sqrt_hann, per row. (R, n_fft) frames, (R, n_fft//2+1) controls."""
    tf = torch.fft.rfft(tooth_frames, n_fft)
    nf = torch.fft.rfft(noise_frames, n_fft)
    flt = torch.polar(torch.exp(hm), np.pi * hp)
    # ops.spectral imports this module, so its irfft is imported here; it
    # drops the imaginary parts of DC and Nyquist, which cuFFT's C2R would
    # read (at n_fft 1024 from 2048 rows up every row is ~2e-2 off otherwise)
    from .spectral import irfft_any

    spec = tf * flt + nf * (torch.exp(nm) / 128.0)
    sig = irfft_any(spec, n_fft)
    return sig * sqrt_hann_window(n_fft, dtype=sig.dtype, device=sig.device)


def _check_combsub(n_fft: int, rows: int, dev, named) -> None:
    if n_fft & (n_fft - 1) or not 64 <= n_fft <= 4096:
        raise ValueError(f"combsub_spectral takes a power-of-two n_fft in "
                         f"[64, 4096], got {n_fft}")
    for name, x in named:
        width = n_fft if name in ("g", "tooth_frames", "noise_frames") \
            else n_fft // 2 + 1
        _check(x, name, (rows, width), dev)


def _combsub_spectral_launch(tooth_frames, noise_frames, hm, hp, nm,
                             n_fft: int):
    rows = tooth_frames.shape[0]
    dev = tooth_frames.device
    _check_combsub(n_fft, rows, dev, (
        ("tooth_frames", tooth_frames), ("noise_frames", noise_frames),
        ("hm", hm), ("hp", hp), ("nm", nm)))
    window = sqrt_hann_window(n_fft, device=dev)
    out = torch.empty_like(tooth_frames)
    _launch("combsub_spectral", "combsub_spectral_launch",
            tooth_frames.data_ptr(), noise_frames.data_ptr(), hm.data_ptr(),
            hp.data_ptr(), nm.data_ptr(), window.data_ptr(), out.data_ptr(),
            rows, n_fft, _stream(out))
    combsub_spectral.launches += 1
    return out


class _CombsubSpectralFn(torch.autograd.Function):
    """The forward kernel, with the adjoint kernel as its backward."""

    @staticmethod
    def forward(ctx, tooth_frames, noise_frames, hm, hp, nm, n_fft):
        ctx.n_fft = n_fft
        ctx.save_for_backward(tooth_frames, noise_frames, hm, hp, nm)
        return _combsub_spectral_launch(tooth_frames, noise_frames, hm, hp,
                                        nm, n_fft)

    @staticmethod
    def backward(ctx, g):
        grads = combsub_spectral_bwd(g.contiguous(), *ctx.saved_tensors,
                                     ctx.n_fft)
        return (*grads, None)


def combsub_spectral(tooth_frames, noise_frames, hm, hp, nm, n_fft: int):
    """The CombSubFast STFT-domain filter chain of one frame row per block:
    windowed excitation frames (R, n_fft) and raw controls (R, n_fft//2+1)
    -> windowed output frames (R, n_fft). n_fft a power of two, 64..4096.
    Differentiable in all five inputs."""
    if tooth_frames.device.type == "cpu":
        return combsub_spectral_plain(tooth_frames, noise_frames, hm, hp, nm,
                                      n_fft)
    return _CombsubSpectralFn.apply(tooth_frames, noise_frames, hm, hp, nm,
                                    n_fft)


def combsub_spectral_bwd_plain(g, tooth_frames, noise_frames, hm, hp, nm,
                               n_fft: int):
    """The analytic adjoint of combsub_spectral_plain written out (the
    arithmetic of `_combsub_spectral_bwd_kernel`): returns the gradients of
    sum(g * out) with respect to (tooth, noise, hm, hp, nm)."""
    bins = n_fft // 2 + 1
    dev = g.device
    win = sqrt_hann_window(n_fft, dtype=g.dtype, device=dev)
    w = torch.full((bins,), 2.0 / n_fft, dtype=g.dtype, device=dev)
    w[0] = w[-1] = 1.0 / n_fft
    ds = torch.fft.rfft(g * win, n_fft) * w
    spec_a = torch.fft.rfft(tooth_frames, n_fft)
    spec_n = torch.fft.rfft(noise_frames, n_fft)
    h = torch.polar(torch.exp(hm), np.pi * hp)
    q = torch.exp(nm) / 128.0
    dh = ds * spec_a.conj() * h.conj()
    d_hm, d_hp = dh.real, np.pi * dh.imag
    d_nm = (ds * spec_n.conj()).real * q

    def half_sum(x):  # Re sum_k x[k] e^{+2 pi j k t / n}, k = 0 .. n/2
        return torch.fft.ifft(x, n_fft).real * n_fft

    return (half_sum(ds * h.conj()), half_sum(ds * q), d_hm, d_hp, d_nm)


def combsub_spectral_bwd(g, tooth_frames, noise_frames, hm, hp, nm,
                         n_fft: int):
    """The adjoint of combsub_spectral in one kernel (a block per frame row):
    the upstream gradient g (R, n_fft) and the forward's inputs -> (d_tooth,
    d_noise, d_hm, d_hp, d_nm)."""
    if g.device.type == "cpu":
        return combsub_spectral_bwd_plain(g, tooth_frames, noise_frames, hm,
                                          hp, nm, n_fft)
    rows = g.shape[0]
    dev = g.device
    _check_combsub(n_fft, rows, dev, (
        ("g", g), ("tooth_frames", tooth_frames),
        ("noise_frames", noise_frames), ("hm", hm), ("hp", hp), ("nm", nm)))
    window = sqrt_hann_window(n_fft, device=dev)
    d_tooth, d_noise = torch.empty_like(g), torch.empty_like(g)
    d_hm, d_hp, d_nm = (torch.empty_like(hm) for _ in range(3))
    _launch("combsub_spectral", "combsub_spectral_bwd_launch",
            g.data_ptr(), tooth_frames.data_ptr(), noise_frames.data_ptr(),
            hm.data_ptr(), hp.data_ptr(), nm.data_ptr(), window.data_ptr(),
            d_tooth.data_ptr(), d_noise.data_ptr(), d_hm.data_ptr(),
            d_hp.data_ptr(), d_nm.data_ptr(), rows, n_fft, _stream(g))
    combsub_spectral_bwd.launches += 1
    return d_tooth, d_noise, d_hm, d_hp, d_nm


# ------------------------------- DFT magnitude ------------------------------

DFT_MAX_N = 8192


def dft_magnitude_plain(frames, n_fft: int):
    """sqrt(re^2 + im^2 + 1e-12) of rfft(frames, n_fft): (R, n_fft) ->
    (R, n_fft//2+1), for any n_fft."""
    spec = torch.fft.rfft(frames, n_fft)
    return torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-12)


def _dft_magnitude_launch(frames, n_fft: int):
    rows = frames.shape[0]
    if not 2 <= n_fft <= DFT_MAX_N:
        raise ValueError(f"dft_magnitude takes n_fft in [2, {DFT_MAX_N}], "
                         f"got {n_fft}")
    _check(frames, "frames", (rows, n_fft), frames.device)
    out = torch.empty((rows, n_fft // 2 + 1), dtype=torch.float32,
                      device=frames.device)
    _launch("dft_magnitude", "dft_magnitude_launch", frames.data_ptr(),
            out.data_ptr(), rows, n_fft, _stream(out))
    dft_magnitude.launches += 1
    return out


class _DftMagnitudeFn(torch.autograd.Function):
    """The magnitude kernel forward; the backward is plain PyTorch, as the
    JAX package's custom VJP is plain XLA: with X = rfft(frames) and
    inv = g / max(|X|, 1e-12), d frames = Re sum_k inv X[k] e^{+2 pi j k t/n}
    (= (inv re) C^T - (inv im) S^T in the JAX package's DFT-matrix form)."""

    @staticmethod
    def forward(ctx, frames, n_fft):
        mag = _dft_magnitude_launch(frames, n_fft)
        ctx.n_fft = n_fft
        ctx.save_for_backward(frames, mag)
        return mag

    @staticmethod
    def backward(ctx, g):
        frames, mag = ctx.saved_tensors
        n = ctx.n_fft
        spec = torch.fft.rfft(frames, n) * (g / mag.clamp_min(1e-12))
        return torch.fft.ifft(spec, n).real * n, None


def dft_magnitude(frames, n_fft: int):
    """|rfft(frames, n_fft)| with the 1e-12 floor inside the root, for any
    n_fft up to 8192: frames (R, n_fft) fp32 -> (R, n_fft//2+1). One block
    per tile of 16 rows and up to 128 bins; differentiable."""
    if frames.device.type == "cpu":
        return dft_magnitude_plain(frames, n_fft)
    return _DftMagnitudeFn.apply(frames, n_fft)


# ------------------------------ harmonic source -----------------------------


def harmonic_source_plain(start, rad, w, b, upp: int, sine_amp: float = 0.1):
    """tanh(sine_amp * sum_k w_k sin(2 pi wrap(start_k + rad_k s)) + b) for
    s = 1..upp. start, rad (B, F, H); w (H,); b (1,) -> (B, F*upp)."""
    s = torch.arange(1, upp + 1, dtype=start.dtype, device=start.device)
    ph = start[:, :, None, :] + rad[:, :, None, :] * s[None, None, :, None]
    ph = ph - torch.round(ph)
    acc = (torch.sin(2.0 * np.pi * ph) * w).sum(-1)
    bsz, f, _ = start.shape
    return torch.tanh(sine_amp * acc + b).reshape(bsz, f * upp)


def harmonic_source(start, rad, w, b, upp: int, sine_amp: float = 0.1):
    """The NSF harmonic source merge: only the merged audio is written, the
    (B, F, upp, H) sine bank never exists. Same arguments as the plain
    version; b is a (1,) tensor so that no host read is needed."""
    if start.device.type == "cpu":
        return harmonic_source_plain(start, rad, w, b, upp, sine_amp)
    bsz, f, n_h = start.shape
    dev = start.device
    _check(start, "start", (bsz, f, n_h), dev)
    _check(rad, "rad", (bsz, f, n_h), dev)
    _check(w, "w", (n_h,), dev)
    _check(b, "b", (1,), dev)
    out = torch.empty((bsz, f * upp), dtype=torch.float32, device=dev)
    _launch("harmonic_source", "harmonic_source_launch",
            start.data_ptr(), rad.data_ptr(), w.data_ptr(), b.data_ptr(),
            out.data_ptr(), bsz * f, n_h, upp, sine_amp, _stream(out))
    harmonic_source.launches += 1
    return out


# ------------------------- resblock trio (+ injection) ----------------------

TRIO_KERNEL_SIZES = (3, 7, 11)
TRIO_CHANNELS = (8, 16, 32, 64)


def resblock1_cf(x, weights, biases, kernel_size: int,
                 dilations: Sequence[int], mask=None):
    """One ResBlock1 chain on channel-first x (B, C, T): per dilation
    leaky(0.1) -> dilated conv -> leaky(0.1) -> conv, residual add.
    weights (n_dil, 2, C, C, k), biases (n_dil, 2, C); mask (B?, 1, T)
    zeroes each conv's input past the valid length."""
    k = kernel_size
    for i, d in enumerate(dilations):
        t = F.leaky_relu(x, 0.1)
        if mask is not None:
            t = t * mask
        t = F.conv1d(t, weights[i][0], biases[i][0],
                     padding=(k * d - d) // 2, dilation=d)
        t = F.leaky_relu(t, 0.1)
        if mask is not None:
            t = t * mask
        t = F.conv1d(t, weights[i][1], biases[i][1], padding=(k - 1) // 2)
        x = x + t
    return x


def noise_conv_cf(har, weight, bias, stride: int, t_out: int):
    """The Generator's f0-source injection conv: har (B, 1, T_final) ->
    (B, C, t_out); kernel 2*stride with padding stride//2, or kernel 1."""
    return F.conv1d(har, weight, bias, stride=stride,
                    padding=stride // 2)[..., :t_out]


def resblocks_inject_plain(x_up, har, nc_weight, nc_bias, weights, biases,
                           s_src: int, dilations=(1, 3, 5), valid=None):
    """x = x_up + noise_conv(har), then the mean of the ResBlock1 chains.
    x_up (B, T, C); har (B, T_final, 1) or None (no injection); nc_weight
    (C, 1, ksrc); weights[r] (n_dil, 2, C, C, k_r); biases[r] (n_dil, 2, C);
    valid (optional sample counts) masks every conv input and zeroes the
    output past it. Returns (B, T, C)."""
    x = x_up.transpose(1, 2)
    t = x.shape[-1]
    if har is not None:
        x = x + noise_conv_cf(har.transpose(1, 2), nc_weight, nc_bias, s_src,
                              t)
    mask = None
    if valid is not None:
        mask = frame_mask(t, valid, x.dtype, x.device)[:, None, :]
        x = x * mask
    acc = None
    for w, b in zip(weights, biases):
        h = resblock1_cf(x, w, b, w.shape[-1], dilations, mask)
        acc = h if acc is None else acc + h
    out = acc / len(weights)
    if mask is not None:
        out = out * mask
    return out.transpose(1, 2)


def fused_resblocks_inject(x_up, har, nc_weight, nc_bias, weights, biases,
                           s_src: int, dilations=(1, 3, 5), valid=None):
    """The narrow-stage trio in one kernel: injection conv, three ResBlock1
    chains (k = 3/7/11) and their mean, on time tiles held in shared
    memory. Same arguments and result as resblocks_inject_plain; har=None
    runs the trio alone (the fused_resblocks_pallas form)."""
    if x_up.device.type == "cpu":
        return resblocks_inject_plain(x_up, har, nc_weight, nc_bias, weights,
                                      biases, s_src, dilations, valid)
    bsz, t, c = x_up.shape
    dev = x_up.device
    ks = tuple(int(w.shape[-1]) for w in weights)
    if ks != TRIO_KERNEL_SIZES or c not in TRIO_CHANNELS:
        raise ValueError(f"fused_resblocks_inject takes kernel sizes "
                         f"{TRIO_KERNEL_SIZES} and C in {TRIO_CHANNELS}, got "
                         f"{ks} and C={c}")
    dils = tuple(int(d) for d in dilations)
    # the receptive margin of the widest chain must fit the kernel's 64-sample
    # tile halo, and each tap offset its 32-column row padding
    if len(dils) != 3 or 5 * sum(dils) + 15 > 64 or 5 * max(dils) > 32:
        raise ValueError(f"unsupported dilations {dils}")
    x_cf = x_up.transpose(1, 2).contiguous()
    _check(x_cf, "x_up", (bsz, c, t), dev)
    w_k, b_k = [], []
    for w, bias, k in zip(weights, biases, ks):
        _check(w, "weight", (3, 2, c, c, k), dev)
        _check(bias, "bias", (3, 2, c), dev)
        # kernel layout (dilation, conv, C_in, tap, C_out)
        w_k.append(w.permute(0, 1, 3, 4, 2).contiguous())
        b_k.append(bias)
    har2 = wnc = bnc = None
    t_final = ksrc = 0
    if har is not None:
        t_final = har.shape[1]
        ksrc = nc_weight.shape[-1]
        har2 = har.reshape(bsz, t_final)
        _check(har2, "har", (bsz, t_final), dev)
        _check(nc_weight, "nc_weight", (c, 1, ksrc), dev)
        _check(nc_bias, "nc_bias", (c,), dev)
        wnc = nc_weight.reshape(c, ksrc)
        bnc = nc_bias
    vl = None if valid is None else _lengths(valid, bsz, t, dev)
    out = torch.empty_like(x_cf)
    _launch("resblocks", "resblocks_launch",
            x_cf.data_ptr(), _ptr(har2), _ptr(wnc), _ptr(bnc),
            *(w.data_ptr() for w in w_k), *(b.data_ptr() for b in b_k),
            _ptr(vl), out.data_ptr(), bsz, c, t, t_final, s_src, ksrc,
            *dils, _stream(out))
    # the no-injection form is the fused_resblocks_pallas kernel: counted apart
    (fused_resblocks if har is None else fused_resblocks_inject).launches += 1
    return out.transpose(1, 2)


def fused_resblocks(x, weights, biases, dilations=(1, 3, 5), valid=None):
    """The trio alone (fused_resblocks_pallas): fused_resblocks_inject with
    har=None, whose launches are counted here."""
    return fused_resblocks_inject(x, None, None, None, weights, biases, 1,
                                  dilations, valid)


# ------------------------------ oscillator bank -----------------------------

def _oscillator_bank_launch(phase, amplitudes_frames, block_size: int):
    bsz, t = phase.shape
    _, f, n_h = amplitudes_frames.shape
    dev = phase.device
    if t != f * block_size:
        raise ValueError(f"oscillator_bank takes T = F * block_size, got T={t}"
                         f", F={f}, block_size={block_size}")
    _check(phase, "phase", (bsz, t), dev)
    _check(amplitudes_frames, "amplitudes_frames", (bsz, f, n_h), dev)
    out = torch.empty_like(phase)
    _launch("oscillator_bank", "oscillator_bank_launch", phase.data_ptr(),
            amplitudes_frames.data_ptr(), out.data_ptr(), bsz * f, f, n_h,
            block_size, _stream(out))
    oscillator_bank.launches += 1
    return out


def oscillator_bank_bwd_plain(g, phase, amplitudes_frames, block_size: int,
                              harmonic_chunk: int = 32, needs=(False, True)):
    """The adjoint of the oscillator bank (the JAX package's
    oscillator_bank_pallas has no VJP): autograd through the plain version,
    re-run here. needs: which of (d phase, d amplitudes_frames) to compute;
    the other is None."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(n)
              for x, n in zip((phase, amplitudes_frames), needs)]
        out = oscillator_bank_plain(*xs, block_size, harmonic_chunk)
        grads = iter(torch.autograd.grad(
            out, [x for x in xs if x.requires_grad], g))
    return tuple(next(grads) if n else None for n in needs)


class _OscillatorBankFn(torch.autograd.Function):
    """The kernel forward, oscillator_bank_bwd_plain as the backward; each
    gradient only when asked for (the phase comes from f0 and needs none)."""

    @staticmethod
    def forward(ctx, phase, amplitudes_frames, block_size, harmonic_chunk):
        ctx.block_size, ctx.harmonic_chunk = block_size, harmonic_chunk
        ctx.save_for_backward(phase, amplitudes_frames)
        return _oscillator_bank_launch(phase, amplitudes_frames, block_size)

    @staticmethod
    def backward(ctx, g):
        phase, amps = ctx.saved_tensors
        return oscillator_bank_bwd_plain(
            g, phase, amps, ctx.block_size, ctx.harmonic_chunk,
            ctx.needs_input_grad[:2]) + (None, None)


def oscillator_bank(phase, amplitudes_frames, block_size: int,
                    harmonic_chunk: int = 32):
    """Additive synthesis in one kernel: phase (B, T) [rad] and
    amplitudes_frames (B, F, n_harm), T = F * block_size, fp32 ->
    sum_k lerp(amp_k) sin(wrap((k+1) phase)), (B, T). One thread per output
    sample; the (B, T, n_harm) bank never exists in the forward.
    harmonic_chunk bounds the plain forward's memory; the backward, autograd
    of the plain version, keeps the sines of every chunk. Differentiable."""
    if phase.device.type == "cpu":
        return oscillator_bank_plain(phase, amplitudes_frames, block_size,
                                     harmonic_chunk)
    return _OscillatorBankFn.apply(phase, amplitudes_frames, block_size,
                                   harmonic_chunk)


# ------------------------------ LTV-FIR convolve ----------------------------

LTV_MAX_N = 4096


def ltv_fir_convolve_plain(a_frames, ir_frames, n_fft: int):
    """Per row irfft(rfft(a, n) * rfft(h, n), n): with n >= frame + ir - 1
    the linear convolution of each frame with its impulse response. a (R,
    frame), h (R, ir) -> (R, n_fft)."""
    from .spectral import irfft_any

    spec = torch.fft.rfft(a_frames, n_fft) * torch.fft.rfft(ir_frames, n_fft)
    return irfft_any(spec, n_fft)


def _ltv_fir_convolve_launch(a_frames, ir_frames, n_fft: int):
    rows, frame = a_frames.shape
    ir = ir_frames.shape[-1]
    dev = a_frames.device
    if n_fft & (n_fft - 1) or not 64 <= n_fft <= LTV_MAX_N:
        raise ValueError(f"ltv_fir_convolve takes a power-of-two n_fft in "
                         f"[64, {LTV_MAX_N}], got {n_fft}")
    if frame + ir - 1 > n_fft:
        raise ValueError(f"frame {frame} + ir {ir} - 1 exceeds n_fft {n_fft}")
    _check(a_frames, "a_frames", (rows, frame), dev)
    _check(ir_frames, "ir_frames", (rows, ir), dev)
    out = torch.empty((rows, n_fft), dtype=torch.float32, device=dev)
    _launch("ltv_fir_convolve", "ltv_fir_convolve_launch", a_frames.data_ptr(),
            ir_frames.data_ptr(), out.data_ptr(), rows, frame, ir, n_fft,
            _stream(out))
    ltv_fir_convolve.launches += 1
    return out


def ltv_fir_convolve_bwd_plain(g, a_frames, ir_frames, n_fft: int,
                               needs=(True, True)):
    """The adjoint of ltv_fir_convolve_plain, plain PyTorch as the JAX
    package's VJP is plain XLA (`pallas_kernels.py::_ltv_conv_vjp_bwd`):
    a linear convolution's adjoint is a correlation,
        d a = irfft(rfft(g) conj(rfft(h)))[:frame],
        d h = irfft(rfft(g) conj(rfft(a)))[:ir].
    needs: which of (d a, d h) to compute; the other is None."""
    from .spectral import irfft_any

    spec_g = torch.fft.rfft(g, n_fft)
    d_a = d_h = None
    if needs[0]:
        d_a = irfft_any(spec_g * torch.fft.rfft(ir_frames, n_fft).conj(),
                        n_fft)[:, :a_frames.shape[-1]]
    if needs[1]:
        d_h = irfft_any(spec_g * torch.fft.rfft(a_frames, n_fft).conj(),
                        n_fft)[:, :ir_frames.shape[-1]]
    return d_a, d_h


class _LtvFirConvolveFn(torch.autograd.Function):
    """The kernel forward, ltv_fir_convolve_bwd_plain as the backward."""

    @staticmethod
    def forward(ctx, a_frames, ir_frames, n_fft):
        ctx.n_fft = n_fft
        ctx.save_for_backward(a_frames, ir_frames)
        return _ltv_fir_convolve_launch(a_frames, ir_frames, n_fft)

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        d_a, d_h = ltv_fir_convolve_bwd_plain(
            g, a, h, ctx.n_fft, needs=ctx.needs_input_grad[:2])
        return d_a, d_h, None


def ltv_fir_convolve(a_frames, ir_frames, n_fft: int):
    """The framed spectral convolution of `frequency_filter` in one kernel
    (a block per row, radix-2 FFTs in shared memory): a_frames (R, frame),
    ir_frames (R, ir) fp32, n_fft a power of two >= frame + ir - 1 ->
    (R, n_fft). Differentiable in both inputs."""
    if a_frames.device.type == "cpu":
        return ltv_fir_convolve_plain(a_frames, ir_frames, n_fft)
    return _LtvFirConvolveFn.apply(a_frames, ir_frames, n_fft)


KERNELS = (performer_attention, combsub_spectral, harmonic_source,
           fused_resblocks_inject, fused_resblocks, dft_magnitude,
           combsub_spectral_bwd, oscillator_bank, ltv_fir_convolve)
reset_launch_counts()
