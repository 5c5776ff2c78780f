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
    fused_resblock_chain     <- fused_resblock_chain_pallas
    fused_stage              <- fused_stage_pallas
    dft_magnitude            <- dft_magnitude_pallas
    oscillator_bank          <- oscillator_bank_pallas
    ltv_fir_convolve         <- ltv_fir_convolve_pallas

Every wrapper but performer_attention and combsub_spectral_bwd is
differentiable: on CUDA tensors it runs inside a torch.autograd.Function
(combsub_spectral, oscillator_bank and harmonic_source only where a
gradient is wanted) whose backward is the combsub_spectral_bwd kernel for
combsub_spectral, and plain PyTorch for the others (the JAX package's
VJPs of #6 and #9 are plain XLA, those of the resblock and stage kernels
re-run their XLA references; oscillator_bank_pallas and
harmonic_source_pallas have none, and JAX differentiates the harmonic
source on its XLA route). The per-row `valid` forms of the trio are
inference-only, as in JAX.

Each wrapper takes its plain version only for CPU tensors. For any other
(CUDA) tensor it checks device, dtype, shape and contiguity (the attention:
the strides of the views it reads), allocates the
outputs, and launches its kernel (csrc/<name>.cu, built by ops/build.py) on
the current stream, or raises; it never falls back. `wrapper.launches` counts the
launches. Layouts at these functions are the JAX package's: (B, T, C)
activations, (B, H, T, d) attention.

Four kernels, the ones an exported synthesizer runs, are reached through
PyTorch custom ops, so that a program made by torch.export holds them as
nodes and a saved program replays them:

    ddsp_svc::performer_attention   #1
    ddsp_svc::combsub_spectral      #2 (forward)
    ddsp_svc::oscillator_bank       #8
    ddsp_svc::ltv_fir_convolve      #9

Each op's CUDA implementation checks, launches and counts; its CPU
implementation is the plain version; its fake implementation only
allocates the output. Everything that reads data (a pointer's alignment, a
host length) or fills a cache (the spectral window) runs in the CUDA
implementation, never in traced code. Their wrappers call the op on either
device where no gradient is wanted; where one is, a CPU tensor takes
autograd through the plain version and a CUDA tensor the autograd
Function, whose forward calls the op. The other seven wrappers launch
through ctypes directly, as an exported program reaches none of them.
"""
from __future__ import annotations

import ctypes
import functools
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
_L = ctypes.c_longlong
_F = ctypes.c_float

_SIGNATURES = {
    "performer_attention_launch": [_P] * 6 + [_I] * 4 + [_L] * 3 + [_F, _F, _P],
    "performer_attention_info": [_I, ctypes.POINTER(_I)],
    "combsub_spectral_launch": [_P] * 7 + [_I, _I, _P],
    "combsub_spectral_bwd_launch": [_P] * 12 + [_I, _I, _P],
    "combsub_spectral_bwd_info": [_I, ctypes.POINTER(_I)],
    "dft_magnitude_launch": [_P] * 4 + [_I] * 4 + [_P],
    "harmonic_source_launch": [_P] * 5 + [_I, _I, _I, _F, _P],
    "harmonic_source_info": [ctypes.POINTER(_I)],
    "resblocks_launch": [_P] * 12 + [_I] * 9 + [_P],
    "resblocks_info": [_I, ctypes.POINTER(_I)],
    "oscillator_bank_launch": [_P] * 3 + [_I] * 4 + [_P],
    "oscillator_bank_info": [_I, ctypes.POINTER(_I)],
    "ltv_fir_convolve_launch": [_P] * 3 + [_I] * 4 + [_P],
    "resblock_chain_launch": [_P] * 4 + [_I] * 7 + [_P],
    "resblock_chain_info": [_I, _I, ctypes.POINTER(_I)],
    "fused_stage_launch": [_P] * 14 + [_I] * 12 + [_P],
    "fused_stage_scratch_floats": [_I] * 3,
    "fused_stage_info": [_I, ctypes.POINTER(_I)],
}
_RESTYPES = {"fused_stage_scratch_floats": ctypes.c_longlong}


@functools.cache
def _c_function(lib_name: str, symbol: str):
    fn = getattr(library(lib_name), symbol)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[symbol]
        fn.restype = _RESTYPES.get(symbol, ctypes.c_int)
    return fn


def _launch(lib_name: str, symbol: str, *args) -> None:
    err = _c_function(lib_name, symbol)(*args)
    if err != 0:
        raise RuntimeError(f"{symbol} failed: CUDA error {err}")


def _stream(t: torch.Tensor) -> int:
    """The current stream of t's device, read without building the Stream
    object that torch.cuda.current_stream makes on every call."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(t: torch.Tensor, name: str, shape, device,
           dtype=torch.float32) -> None:
    if (t.dtype is dtype and t.device == device and t.shape == shape
            and t.is_contiguous()):
        return
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


def _wants_grad(tensors) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in tensors)


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


def _by_value(valid) -> bool:
    """valid_frames the attention kernel takes by value: an int, or a
    one-value tensor or array on the host (read there)."""
    return isinstance(valid, (int, np.integer)) or np.ndim(valid) == 0 and (
        not torch.is_tensor(valid) or valid.device.type == "cpu")


def attention_lengths(valid, b: int, t: int, device):
    """valid_frames as the attention kernel takes them: (None, n) when every
    row has one length n, passed by value (None: T; `_by_value`), else
    ((B,) int32 lengths on `device`, 0). A tensor on the card stays there:
    reading it would wait for the card."""
    if valid is None:
        return None, t
    if _by_value(valid):
        return None, int(valid)
    return _lengths(valid, b, t, device), 0


def _attention_strides(x, name: str, shape, device):
    """The (batch, head, time) strides of a q, k or v view that the kernel
    reads in place: fp32 on `device`, unit stride over the head dim, the
    other strides multiples of 4 floats from a 16-byte aligned start (a
    dim of size 1 counts as stride 0)."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} has dtype {x.dtype}, expected torch.float32")
    if x.shape != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    sb, sh, st, sd = x.stride()
    b, h, t, _ = shape
    strides = (sb if b > 1 else 0, sh if h > 1 else 0, st if t > 1 else 0)
    if sd != 1 or (strides[0] | strides[1] | strides[2]) & 3 \
            or x.data_ptr() & 15:
        raise ValueError(f"{name} with strides {x.stride()} is not a view "
                         "the attention kernel reads (unit last stride, "
                         "others multiples of 4, 16-byte aligned)")
    return strides


def _attention_checks(q, k, v, projection):
    """The attention kernel's checks of its inputs: (m, strides)."""
    b, h, t, d = q.shape
    m = projection.shape[0]
    if (m, d) != (266, 64):
        raise ValueError(f"performer_attention takes dim_head 64 and 266 "
                         f"features, got {d} and {m}")
    strides = _attention_strides(q, "q", (b, h, t, d), q.device)
    for name, x in (("k", k), ("v", v)):
        if _attention_strides(x, name, (b, h, t, d), q.device) != strides:
            raise ValueError(f"{name} has strides {x.stride()}, q "
                             f"{q.stride()}: q, k and v must share them")
    _check(projection, "projection", (m, d), q.device)
    return m, strides


@torch.library.custom_op("ddsp_svc::performer_attention", mutates_args=(),
                         device_types="cuda")
def performer_attention_op(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, projection: torch.Tensor,
                           lengths: Optional[torch.Tensor],
                           valid_all: int) -> torch.Tensor:
    """#1 as a custom op: valid_frames as (lengths, valid_all), the pair of
    attention_lengths, lengths a tensor of any int dtype (0-d or (B,)) that
    the CUDA implementation turns into (B,) int32 on the card."""
    b, h, t, d = q.shape
    m, strides = _attention_checks(q, k, v, projection)
    if lengths is not None:
        lengths, valid_all = attention_lengths(lengths, b, t, q.device)
    out = torch.empty((b, h, t, d), dtype=torch.float32, device=q.device)
    _launch("performer_attention", "performer_attention_launch",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), projection.data_ptr(),
            _ptr(lengths), out.data_ptr(), valid_all, b, h, t, *strides,
            d ** -0.25, m ** -0.5, _stream(q))
    performer_attention.launches += 1
    return out


@performer_attention_op.register_kernel("cpu")
def _(q, k, v, projection, lengths, valid_all):
    return performer_attention_plain(
        q, k, v, projection,
        valid_all if lengths is None else lengths).contiguous()


@performer_attention_op.register_fake
def _(q, k, v, projection, lengths, valid_all):
    return q.new_empty(q.shape)


def performer_attention(q, k, v, projection, valid_frames=None):
    """Fused non-causal FAVOR+ attention in one launch (a thread-block
    cluster per batch row and head): q, k, v (B, H, T, 64) fp32, contiguous
    or views with one set of strides (the heads split off a (B, T, H * 64)
    projection), projection (266, 64) -> (B, H, T, 64) contiguous.
    valid_frames (int, 0-d or (B,)) masks the key features of padded
    frames; output rows past it are meaningless, as in the plain
    version. Through the custom op, except for a CPU tensor where a
    gradient is wanted (the kernel has no backward: on the card a backward
    through the op raises)."""
    if q.device.type == "cpu" and _wants_grad((q, k, v, projection)):
        return performer_attention_plain(q, k, v, projection, valid_frames)
    if valid_frames is None:
        lengths, valid_all = None, q.shape[2]
    elif _by_value(valid_frames):
        lengths, valid_all = None, int(valid_frames)
    else:
        lengths, valid_all = torch.as_tensor(valid_frames), 0
    return performer_attention_op(q, k, v, projection, lengths, valid_all)


def attention_kernel_info(t: int) -> dict:
    """The attention kernel on the current card: the cluster size a launch
    at T frames takes, registers per thread, local-memory (spilled) bytes
    per thread and dynamic shared memory per CTA."""
    out = (_I * 4)()
    err = _c_function("performer_attention", "performer_attention_info")(t, out)
    if err != 0:
        raise RuntimeError(f"performer_attention_info failed: CUDA error {err}")
    return dict(cluster=out[0], registers=out[1], spill_bytes=out[2],
                smem_bytes=out[3])


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


_WINDOWS: dict = {}


def combsub_window(n_fft: int, device):
    """sqrt_hann_window(n_fft) on `device`, made once per (n_fft, device):
    the spectral kernels read it there."""
    key = (n_fft, str(device))
    if key not in _WINDOWS:
        _WINDOWS[key] = sqrt_hann_window(n_fft, device=device)
    return _WINDOWS[key]


@torch.library.custom_op("ddsp_svc::combsub_spectral", mutates_args=(),
                         device_types="cuda")
def combsub_spectral_op(tooth_frames: torch.Tensor, noise_frames: torch.Tensor,
                        hm: torch.Tensor, hp: torch.Tensor, nm: torch.Tensor,
                        n_fft: int) -> torch.Tensor:
    """#2 as a custom op."""
    rows = tooth_frames.shape[0]
    dev = tooth_frames.device
    _check_combsub(n_fft, rows, dev, (
        ("tooth_frames", tooth_frames), ("noise_frames", noise_frames),
        ("hm", hm), ("hp", hp), ("nm", nm)))
    window = combsub_window(n_fft, dev)
    out = torch.empty_like(tooth_frames)
    _launch("combsub_spectral", "combsub_spectral_launch",
            tooth_frames.data_ptr(), noise_frames.data_ptr(), hm.data_ptr(),
            hp.data_ptr(), nm.data_ptr(), window.data_ptr(), out.data_ptr(),
            rows, n_fft, _stream(out))
    combsub_spectral.launches += 1
    return out


combsub_spectral_op.register_kernel("cpu")(combsub_spectral_plain)


@combsub_spectral_op.register_fake
def _(tooth_frames, noise_frames, hm, hp, nm, n_fft):
    return tooth_frames.new_empty(tooth_frames.shape)


class _CombsubSpectralFn(torch.autograd.Function):
    """The forward op, with the adjoint kernel as its backward."""

    @staticmethod
    def forward(ctx, tooth_frames, noise_frames, hm, hp, nm, n_fft):
        ctx.n_fft = n_fft
        ctx.save_for_backward(tooth_frames, noise_frames, hm, hp, nm)
        return combsub_spectral_op(tooth_frames, noise_frames, hm, hp, nm,
                                   n_fft)

    @staticmethod
    def backward(ctx, g):
        grads = combsub_spectral_bwd(g.contiguous(), *ctx.saved_tensors,
                                     ctx.n_fft)
        return (*grads, None)


def combsub_spectral(tooth_frames, noise_frames, hm, hp, nm, n_fft: int):
    """The CombSubFast STFT-domain filter chain, per frame row three
    half-length FFTs in shared memory: windowed excitation frames (R, n_fft)
    and raw controls (R, n_fft//2+1) -> windowed output frames (R, n_fft).
    n_fft a power of two, 64..4096. Differentiable in all five inputs; where
    no gradient is wanted the op runs without the autograd Function."""
    tensors = (tooth_frames, noise_frames, hm, hp, nm)
    if not _wants_grad(tensors):
        return combsub_spectral_op(*tensors, n_fft)
    if tooth_frames.device.type == "cpu":
        return combsub_spectral_plain(*tensors, n_fft)
    return _CombsubSpectralFn.apply(*tensors, n_fft)


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
    """The adjoint of combsub_spectral in one kernel (per frame row five
    half-length FFTs in shared memory): the upstream gradient g (R, n_fft)
    and the forward's inputs -> (d_tooth, d_noise, d_hm, d_hp, d_nm)."""
    if g.device.type == "cpu":
        return combsub_spectral_bwd_plain(g, tooth_frames, noise_frames, hm,
                                          hp, nm, n_fft)
    rows = g.shape[0]
    dev = g.device
    _check_combsub(n_fft, rows, dev, (
        ("g", g), ("tooth_frames", tooth_frames),
        ("noise_frames", noise_frames), ("hm", hm), ("hp", hp), ("nm", nm)))
    window = combsub_window(n_fft, dev)
    d_tooth, d_noise = torch.empty_like(g), torch.empty_like(g)
    d_hm, d_hp, d_nm = (torch.empty_like(hm) for _ in range(3))
    _launch("combsub_spectral_bwd", "combsub_spectral_bwd_launch",
            g.data_ptr(), tooth_frames.data_ptr(), noise_frames.data_ptr(),
            hm.data_ptr(), hp.data_ptr(), nm.data_ptr(), window.data_ptr(),
            d_tooth.data_ptr(), d_noise.data_ptr(), d_hm.data_ptr(),
            d_hp.data_ptr(), d_nm.data_ptr(), rows, n_fft, _stream(g))
    combsub_spectral_bwd.launches += 1
    return d_tooth, d_noise, d_hm, d_hp, d_nm


def combsub_bwd_kernel_info(n_fft: int) -> dict:
    """As harmonic_source_kernel_info, for the adjoint kernel at n_fft."""
    return _kernel_info("combsub_spectral_bwd", "combsub_spectral_bwd_info",
                        n_fft)


# ------------------------------- DFT magnitude ------------------------------

DFT_MAX_N = 8192


def dft_magnitude_plain(frames, n_fft: int):
    """sqrt(re^2 + im^2 + 1e-12) of rfft(frames, n_fft): (R, n_fft) ->
    (R, n_fft//2+1), for any n_fft."""
    spec = torch.fft.rfft(frames, n_fft)
    return torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-12)


def dft_plan(n: int):
    """(l, m) of the kernel's transform for rfft of size n: l the complex
    length (n/2 for even n, the even and odd samples as one complex signal;
    n for odd n), m its FFT length: l when l is a power of two, else the
    least power of two >= 2l - 1 (Bluestein)."""
    l = n // 2 if n % 2 == 0 else n
    if l & (l - 1) == 0:
        return l, l
    return l, 1 << (2 * l - 2).bit_length()


def dft_tables64(n: int):
    """The Bluestein tables of size n in complex128, or None when l is a
    power of two: the chirp c[t] = exp(-j pi t^2 / l), t < l, with t^2 mod
    2l taken in integers, and FFT_m(b) / m of the conj-chirp b (b[t] =
    conj c[|t|] for |t| < l, cyclic in m, zero elsewhere)."""
    l, m = dft_plan(n)
    if m == l:
        return None
    t = np.arange(l, dtype=np.int64)
    chirp = np.exp(-1j * np.pi * ((t * t) % (2 * l)) / l)
    b = np.zeros(m, np.complex128)
    b[:l] = chirp.conj()
    b[m - l + 1:] = chirp[1:][::-1].conj()
    return chirp, np.fft.fft(b) / m


_DFT_TABLES: dict = {}


def dft_tables(n: int, device):
    """dft_tables64 cast to complex64, as (l, 2) and (m, 2) fp32 tensors on
    `device`, built once per (n, device); None for a power-of-two l."""
    key = (n, str(device))
    if key not in _DFT_TABLES:
        tables = dft_tables64(n)
        _DFT_TABLES[key] = None if tables is None else tuple(
            torch.view_as_real(torch.from_numpy(x.astype(np.complex64)))
            .to(device) for x in tables)
    return _DFT_TABLES[key]


def _dft_magnitude_launch(frames, n_fft: int):
    rows = frames.shape[0]
    if not 2 <= n_fft <= DFT_MAX_N:
        raise ValueError(f"dft_magnitude takes n_fft in [2, {DFT_MAX_N}], "
                         f"got {n_fft}")
    _check(frames, "frames", (rows, n_fft), frames.device)
    l, m = dft_plan(n_fft)
    chirp, bhat = dft_tables(n_fft, frames.device) or (None, None)
    out = torch.empty((rows, n_fft // 2 + 1), dtype=torch.float32,
                      device=frames.device)
    _launch("dft_magnitude", "dft_magnitude_launch", frames.data_ptr(),
            out.data_ptr(), _ptr(chirp), _ptr(bhat), rows, n_fft, l, m,
            _stream(out))
    dft_magnitude.launches += 1
    return out


class _DftMagnitudeFn(torch.autograd.Function):
    """The magnitude kernel forward; the backward is plain PyTorch, as the
    JAX package's custom VJP is plain XLA: with X = rfft(frames) and
    inv = g / sqrt(|X|^2 + 1e-12), d frames = Re sum_k inv X[k]
    e^{+2 pi j k t/n} (= (inv re) C^T - (inv im) S^T in the JAX package's
    DFT-matrix form). It runs in float64: the loss's log term weights each
    bin by ~1/|X|^2, so the gradient of a row is led by its quietest bins,
    whose fp32 spectrum is off by ~1e-7 of the row's loudest, and the
    batched fp32 cuFFT also rounds quiet rows at a louder neighbour's
    scale. On rows scaled by 10^[-4, 0] (tools/dft_grad_rows.py) fp32 reads
    up to ~1e-4 of a row's max even on the CPU or with each row scaled to
    unit max, batched fp32 cuFFT up to 0.13, float64 ~7e-8."""

    @staticmethod
    def forward(ctx, frames, n_fft):
        ctx.n_fft = n_fft
        ctx.save_for_backward(frames)
        return _dft_magnitude_launch(frames, n_fft)

    @staticmethod
    def backward(ctx, g):
        frames, = ctx.saved_tensors
        n = ctx.n_fft
        spec = torch.fft.rfft(frames.double(), n)
        mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-12)
        spec = spec * (g.double() / mag)
        return (torch.fft.ifft(spec, n).real * n).to(frames.dtype), None


def dft_magnitude(frames, n_fft: int):
    """|rfft(frames, n_fft)| with the 1e-12 floor inside the root, for any
    n_fft up to 8192: frames (R, n_fft) fp32 -> (R, n_fft//2+1). Per row an
    FFT in shared memory (Bluestein where dft_plan's l is not a power of
    two); differentiable."""
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


def _harmonic_source_launch(start, rad, w, b, upp: int, sine_amp: float):
    bsz, f, n_h = start.shape
    dev = start.device
    _check(start, "start", (bsz, f, n_h), dev)
    _check(rad, "rad", (bsz, f, n_h), dev)
    _check(w, "w", (n_h,), dev)
    _check(b, "b", (1,), dev)
    out = start.new_empty((bsz, f * upp))
    _launch("harmonic_source", "harmonic_source_launch",
            start.data_ptr(), rad.data_ptr(), w.data_ptr(), b.data_ptr(),
            out.data_ptr(), bsz * f, n_h, upp, sine_amp, _stream(out))
    harmonic_source.launches += 1
    return out


def harmonic_source(start, rad, w, b, upp: int, sine_amp: float = 0.1):
    """The NSF harmonic source merge: only the merged audio is written, the
    (B, F, upp, H) sine bank never exists. Same arguments as the plain
    version; b is a (1,) tensor so that no host read is needed. Where a
    gradient is wanted the kernel runs inside _PlainBackwardFn: the
    backward re-runs the plain bank."""
    if start.device.type == "cpu":
        return harmonic_source_plain(start, rad, w, b, upp, sine_amp)
    tensors = (start, rad, w, b)
    if _wants_grad(tensors):
        return _PlainBackwardFn.apply(
            lambda *xs: _harmonic_source_launch(*xs, upp, sine_amp),
            lambda *xs: harmonic_source_plain(*xs, upp, sine_amp), *tensors)
    return _harmonic_source_launch(*tensors, upp, sine_amp)


def harmonic_source_kernel_info() -> dict:
    """The compiled harmonic-source kernel on the current card: registers
    per thread, local-memory (spilled) bytes per thread and dynamic shared
    memory per block."""
    return _kernel_info("harmonic_source", "harmonic_source_info")


# ------------------ backward by re-running the plain version ----------------


def _replay_grads(plain, tensors, needs, g):
    """The gradients of sum(g * plain(*tensors)) with respect to the tensors
    whose `needs` is set (None for the others), by autograd through the
    plain version run again: the JAX package's custom VJPs of the resblock
    kernels re-run their XLA references the same way."""
    with torch.enable_grad():
        xs = [x if x is None else x.detach().requires_grad_(bool(n))
              for x, n in zip(tensors, needs)]
        want = [x for x in xs if x is not None and x.requires_grad]
        grads = iter(torch.autograd.grad(plain(*xs), want, g) if want else ())
    return tuple(next(grads) if x is not None and x.requires_grad else None
                 for x in xs)


class _PlainBackwardFn(torch.autograd.Function):
    """launch(*tensors) as the forward; the backward is _replay_grads of
    plain(*tensors), each gradient only when asked for."""

    @staticmethod
    def forward(ctx, launch, plain, *tensors):
        ctx.plain = plain
        ctx.save_for_backward(*tensors)
        return launch(*tensors)

    @staticmethod
    def backward(ctx, g):
        return (None, None) + _replay_grads(
            ctx.plain, ctx.saved_tensors, ctx.needs_input_grad[2:], g)


def _inference_only(name: str, tensors) -> None:
    """The per-row valid forms have no backward (as in the JAX package,
    whose custom VJPs never pass `valid`)."""
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in tensors):
        raise ValueError(f"{name} with valid= is inference-only: call it "
                         "under torch.no_grad()")


# ------------------------- resblock trio (+ injection) ----------------------

TRIO_KERNEL_SIZES = (3, 7, 11)
TRIO_CHANNELS = (8, 16, 32, 64)
STAGE_RATES = (1, 2, 4, 8)


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


def _check_dilations(dilations) -> tuple:
    dils = tuple(int(d) for d in dilations)
    # the receptive margin of the widest chain must fit the kernels' 64-sample
    # tile halo, and each tap offset the row padding (resblock_mma.cuh's kPad,
    # 28 columns)
    if len(dils) != 3 or 5 * sum(dils) + 15 > 64 or 5 * max(dils) > 28:
        raise ValueError(f"unsupported dilations {dils}")
    return dils


_FRAGMENT_INDEX: dict = {}


def _fragment_index(c: int, shapes, device):
    """For mma_fragments: the flat index into cat(w.reshape(-1) for w in
    the weights, [0]) of each slot of the fragment order, and whether the
    slot holds lo; built once per (C, ((convs, k) of each weight), device)."""
    key = (c, tuple(shapes), str(device))
    if key not in _FRAGMENT_INDEX:
        m = max(c, 16)
        lane = torch.arange(32)[:, None]
        v = torch.arange(4)
        # (m16 tile, lane, element) -> C_out row; (k8 group, ...) -> C_in col
        rows = (torch.arange(m // 16)[:, None, None] * 16 + lane // 4
                + 8 * (v % 2))
        cols = (torch.arange(c // 8)[:, None, None] * 8 + lane % 4
                + 4 * (v // 2))
        zero_slot = c * c * sum(n * k for n, k in shapes)
        idx, base = [], 0
        for n, k in shapes:
            conv = torch.arange(n)[:, None, None, None, None, None]
            tap = torch.arange(k)[None, :, None, None, None, None]
            co, ci = rows[None, None, None], cols[None, None, :, None]
            flat = base + ((conv * c + co) * c + ci) * k + tap
            flat = torch.where(co < c, flat, zero_slot)  # (n, k, G, Mt, 32, 4)
            idx.append(flat[..., None, :, :].expand(
                *flat.shape[:-2], 2, 32, 4).reshape(-1))
            base += n * c * c * k
        idx = torch.cat(idx)
        is_lo = (torch.arange(idx.numel()) // 128) % 2 == 1
        _FRAGMENT_INDEX[key] = (idx.to(device), is_lo.to(device))
    return _FRAGMENT_INDEX[key]


def mma_fragments(weights):
    """fp32 conv weights, weights[i] (..., C_out, C_in, k_i) with C_out =
    C_in (a chain's (3, 2, C, C, k)), in the order the tensor-core conv core
    (resblock_mma.cuh) reads them: each conv of weights[i] (k_i, C_in / 8,
    M / 16, 2, 32, 4), M = max(C_out, 16). Per k-step (tap, 8 input
    channels) and m16 tile, the hi and then the lo of lane l's A fragment
    of mma.m16n8k8: rows g, g + 8, g, g + 8 and columns q, q, q + 4, q + 4
    of the (16, 8) tile, g = l // 4, q = l % 4. Rows past C_out (C = 8) are
    zero. w = hi + lo exactly: hi is w rounded to tf32 (to nearest, ties
    away from zero, as cvt.rna.tf32.f32), lo the rest. Returns one flat
    view per weight, from six launches on the card."""
    c, m = weights[0].shape[-3], max(weights[0].shape[-3], 16)
    shapes = [(w.numel() // (c * c * w.shape[-1]), w.shape[-1])
              for w in weights]
    idx, is_lo = _fragment_index(c, shapes, weights[0].device)
    flat = torch.cat([*(w.reshape(-1) for w in weights),
                      weights[0].new_zeros(1)])[idx]
    hi = ((flat.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(is_lo, flat - hi, hi).split(
        [2 * n * c * m * k for n, k in shapes])


def stage_up_convs(up_weight, u: int):
    """The transposed conv's weights, up_weight (2C, C, 2u) (ConvTranspose1d
    layout, stride u), as the convs fused_stage.cu's fill runs, (u, 2, C,
    C, 2): for each phase r < u and each half of the input channels, a conv
    of two taps, r and r + u, which read x_pre[m0] and x_pre[m0 - 1] for an
    output of phase r. mma_fragments lays them out (a view)."""
    c = up_weight.shape[1]
    # (half, C_in, C_out, tap, r) -> (r, half, C_out, C_in, tap)
    return up_weight.reshape(2, c, c, 2, u).permute(4, 0, 2, 1, 3)


def _check_trio(weights, biases, c: int, dev) -> None:
    ks = tuple(int(w.shape[-1]) for w in weights)
    if ks != TRIO_KERNEL_SIZES:
        raise ValueError(f"the trio kernels take kernel sizes "
                         f"{TRIO_KERNEL_SIZES}, got {ks}")
    for w, bias, k in zip(weights, biases, ks):
        _check(w, "weight", (3, 2, c, c, k), dev)
        _check(bias, "bias", (3, 2, c), dev)


def _injection(har, nc_weight, nc_bias, bsz: int, c: int, dev):
    """har (B, T_final, 1) and the injection conv's weight as the kernels
    read them: ((B, T_final), (C, ksrc), (C,), T_final, ksrc)."""
    t_final, ksrc = har.shape[1], nc_weight.shape[-1]
    har2 = har.reshape(bsz, t_final)
    _check(har2, "har", (bsz, t_final), dev)
    _check(nc_weight, "nc_weight", (c, 1, ksrc), dev)
    _check(nc_bias, "nc_bias", (c,), dev)
    return har2, nc_weight.reshape(c, ksrc), nc_bias, t_final, ksrc


def _trio_launch(x_up, har, nc_weight, nc_bias, weights, biases, s_src: int,
                 dilations, valid):
    bsz, t, c = x_up.shape
    dev = x_up.device
    if c not in TRIO_CHANNELS:
        raise ValueError(f"fused_resblocks_inject takes C in {TRIO_CHANNELS}, "
                         f"got C={c}")
    dils = _check_dilations(dilations)
    x_cf = x_up.transpose(1, 2).contiguous()
    _check(x_cf, "x_up", (bsz, c, t), dev)
    _check_trio(weights, biases, c, dev)
    har2 = wnc = bnc = None
    t_final = ksrc = 0
    if har is not None:
        har2, wnc, bnc, t_final, ksrc = _injection(har, nc_weight, nc_bias,
                                                   bsz, c, dev)
    vl = None if valid is None else _lengths(valid, bsz, t, dev)
    w_k = mma_fragments(weights)
    out = torch.empty_like(x_cf)
    _launch("resblocks", "resblocks_launch",
            x_cf.data_ptr(), _ptr(har2), _ptr(wnc), _ptr(bnc),
            *(w.data_ptr() for w in w_k), *(b.data_ptr() for b in biases),
            _ptr(vl), out.data_ptr(), bsz, c, t, t_final, s_src, ksrc,
            *dils, _stream(out))
    # the no-injection form is the fused_resblocks_pallas kernel: counted apart
    (fused_resblocks if har is None else fused_resblocks_inject).launches += 1
    return out.transpose(1, 2)


def fused_resblocks_inject(x_up, har, nc_weight, nc_bias, weights, biases,
                           s_src: int, dilations=(1, 3, 5), valid=None):
    """The narrow-stage trio in one kernel: injection conv, three ResBlock1
    chains (k = 3/7/11) and their mean, on time tiles held in shared
    memory. Same arguments and result as resblocks_inject_plain; har=None
    runs the trio alone (the fused_resblocks_pallas form). Differentiable
    (the backward re-runs the plain version) except with valid=."""
    if x_up.device.type == "cpu":
        return resblocks_inject_plain(x_up, har, nc_weight, nc_bias, weights,
                                      biases, s_src, dilations, valid)
    n = len(weights)
    tensors = (x_up, har, nc_weight, nc_bias, *weights, *biases)
    if valid is not None:
        _inference_only("fused_resblocks_inject", tensors)
        return _trio_launch(x_up, har, nc_weight, nc_bias, weights, biases,
                            s_src, dilations, valid)
    return _PlainBackwardFn.apply(
        lambda x, h, nw, nb, *wb: _trio_launch(x, h, nw, nb, wb[:n], wb[n:],
                                               s_src, dilations, None),
        lambda x, h, nw, nb, *wb: resblocks_inject_plain(
            x, h, nw, nb, wb[:n], wb[n:], s_src, dilations),
        *tensors)


def fused_resblocks(x, weights, biases, dilations=(1, 3, 5), valid=None):
    """The trio alone (fused_resblocks_pallas): fused_resblocks_inject with
    har=None, whose launches are counted here."""
    return fused_resblocks_inject(x, None, None, None, weights, biases, 1,
                                  dilations, valid)


def _kernel_info(lib_name: str, symbol: str, *args) -> dict:
    out = (_I * 3)()
    err = _c_function(lib_name, symbol)(*args, out)
    if err != 0:
        raise RuntimeError(f"{symbol} failed: CUDA error {err}")
    return dict(registers=out[0], spill_bytes=out[1], smem_bytes=out[2])


def trio_kernel_info(c: int) -> dict:
    """The compiled trio kernel at width C on the current card: registers
    per thread, local-memory (spilled) bytes per thread and dynamic shared
    memory per block."""
    return _kernel_info("resblocks", "resblocks_info", c)


# ---------------------------- one resblock chain ----------------------------


def resblock_chain_plain(x, weight, bias, kernel_size: int,
                         dilations=(1, 3, 5)):
    """One ResBlock1 chain on the JAX package's (B, T, C) layout: weight
    (n_dil, 2, C, C, k), bias (n_dil, 2, C) -> (B, T, C)."""
    return resblock1_cf(x.transpose(1, 2), weight, bias, kernel_size,
                        dilations).transpose(1, 2)


def _chain_launch(x, weight, bias, kernel_size: int, dilations):
    bsz, t, c = x.shape
    k = int(kernel_size)
    dev = x.device
    if k not in TRIO_KERNEL_SIZES or c not in TRIO_CHANNELS:
        raise ValueError(f"fused_resblock_chain takes k in {TRIO_KERNEL_SIZES}"
                         f" and C in {TRIO_CHANNELS}, got k={k} and C={c}")
    dils = _check_dilations(dilations)
    x_cf = x.transpose(1, 2).contiguous()
    _check(x_cf, "x", (bsz, c, t), dev)
    _check(weight, "weight", (3, 2, c, c, k), dev)
    _check(bias, "bias", (3, 2, c), dev)
    w_k = mma_fragments([weight])[0]
    out = torch.empty_like(x_cf)
    _launch("resblock_chain", "resblock_chain_launch", x_cf.data_ptr(),
            w_k.data_ptr(), bias.data_ptr(), out.data_ptr(), bsz, c, t, k,
            *dils, _stream(out))
    fused_resblock_chain.launches += 1
    return out.transpose(1, 2)


def chain_kernel_info(c: int, k: int) -> dict:
    """As trio_kernel_info, for the one-chain kernel of kernel size k."""
    return _kernel_info("resblock_chain", "resblock_chain_info", c, k)


def fused_resblock_chain(x, weight, bias, kernel_size: int,
                         dilations=(1, 3, 5)):
    """One ResBlock1 chain (no trio mean) in one kernel, the trio kernel's
    tensor-core tiles with one chain: x (B, T, C) fp32, C in 8..64, k in
    3/7/11; same arguments and result as resblock_chain_plain.
    Differentiable (the backward re-runs the plain version)."""
    if x.device.type == "cpu":
        return resblock_chain_plain(x, weight, bias, kernel_size, dilations)
    return _PlainBackwardFn.apply(
        lambda *ts: _chain_launch(*ts, kernel_size, dilations),
        lambda *ts: resblock_chain_plain(*ts, kernel_size, dilations),
        x, weight, bias)


# ------------------------------- fused stage --------------------------------


def stage_plain(x_pre, har, up_weight, up_bias, nc_weight, nc_bias, weights,
                biases, u: int, s_src: int, dilations=(1, 3, 5)):
    """A narrow Generator stage: leaky(0.1) -> ConvTranspose(stride u,
    kernel k, padding (k - u) // 2) -> + the injection conv of har -> the
    trio mean. x_pre (B, T_in, C_in); har (B, T_final, 1); up_weight
    (C_in, C, k) and nc_weight (C, 1, ksrc) in the port's layouts; weights
    and biases as resblocks_inject_plain. Returns (B, T_out, C)."""
    k = up_weight.shape[-1]
    x = F.conv_transpose1d(F.leaky_relu(x_pre.transpose(1, 2), 0.1),
                           up_weight, up_bias, stride=u, padding=(k - u) // 2)
    return resblocks_inject_plain(x.transpose(1, 2), har, nc_weight, nc_bias,
                                  weights, biases, s_src, dilations)


def _stage_launch(x_pre, har, up_weight, up_bias, nc_weight, nc_bias,
                  weights, biases, u: int, s_src: int, dilations):
    bsz, t_in, c_in = x_pre.shape
    c, k = up_weight.shape[1], up_weight.shape[-1]
    dev = x_pre.device
    if c not in TRIO_CHANNELS or u not in STAGE_RATES or k != 2 * u \
            or c_in != 2 * c:
        raise ValueError(f"fused_stage takes C in {TRIO_CHANNELS}, C_in = 2C, "
                         f"u in {STAGE_RATES} and k = 2u, got C={c}, "
                         f"C_in={c_in}, u={u}, k={k}")
    dils = _check_dilations(dilations)
    p = (k - u) // 2
    t_out = (t_in - 1) * u - 2 * p + k
    x_cf = x_pre.transpose(1, 2).contiguous()
    _check(x_cf, "x_pre", (bsz, c_in, t_in), dev)
    _check(up_weight, "up_weight", (c_in, c, k), dev)
    _check(up_bias, "up_bias", (c,), dev)
    _check_trio(weights, biases, c, dev)
    w_up, *w_k = mma_fragments([stage_up_convs(up_weight, u), *weights])
    har2, wnc, bnc, t_final, ksrc = _injection(har, nc_weight, nc_bias, bsz,
                                               c, dev)
    out = torch.empty((bsz, c, t_out), dtype=torch.float32, device=dev)
    # each tile's x0, kept for its second and third chains
    x0 = torch.empty((_c_function("fused_stage", "fused_stage_scratch_floats")(
        bsz, c, t_out),), dtype=torch.float32, device=dev)
    _launch("fused_stage", "fused_stage_launch", x_cf.data_ptr(),
            har2.data_ptr(), w_up.data_ptr(), up_bias.data_ptr(),
            wnc.data_ptr(), bnc.data_ptr(), *(w.data_ptr() for w in w_k),
            *(b.data_ptr() for b in biases), out.data_ptr(), x0.data_ptr(),
            bsz, c, t_in,
            t_out, u, p, t_final, s_src, ksrc, *dils, _stream(out))
    fused_stage.launches += 1
    return out.transpose(1, 2)


def stage_kernel_info(c: int) -> dict:
    """As trio_kernel_info, for the fused-stage kernel."""
    return _kernel_info("fused_stage", "fused_stage_info", c)


def fused_stage(x_pre, har, up_weight, up_bias, nc_weight, nc_bias, weights,
                biases, u: int, s_src: int, dilations=(1, 3, 5)):
    """A whole narrow Generator stage in one kernel: the trio kernel whose
    tile starts from leaky(x_pre) through the transposed conv, read at the
    input's own rate, plus the injection conv. C in 8..64, C_in = 2C, u in
    1/2/4/8 with k = 2u. Same arguments and result as stage_plain.
    Differentiable (the backward re-runs the plain version)."""
    if x_pre.device.type == "cpu":
        return stage_plain(x_pre, har, up_weight, up_bias, nc_weight, nc_bias,
                           weights, biases, u, s_src, dilations)
    n = len(weights)
    return _PlainBackwardFn.apply(
        lambda x, h, uw, ub, nw, nb, *wb: _stage_launch(
            x, h, uw, ub, nw, nb, wb[:n], wb[n:], u, s_src, dilations),
        lambda x, h, uw, ub, nw, nb, *wb: stage_plain(
            x, h, uw, ub, nw, nb, wb[:n], wb[n:], u, s_src, dilations),
        x_pre, har, up_weight, up_bias, nc_weight, nc_bias, *weights,
        *biases)


# ------------------------------ oscillator bank -----------------------------

def _oscillator_bank_checks(phase, amplitudes_frames, block_size: int):
    """The oscillator bank kernel's checks of its inputs: (B, F, n_h)."""
    bsz, t = phase.shape
    _, f, n_h = amplitudes_frames.shape
    if t != f * block_size:
        raise ValueError(f"oscillator_bank takes T = F * block_size, got T={t}"
                         f", F={f}, block_size={block_size}")
    _check(phase, "phase", (bsz, t), phase.device)
    _check(amplitudes_frames, "amplitudes_frames", (bsz, f, n_h), phase.device)
    return bsz, f, n_h


@torch.library.custom_op("ddsp_svc::oscillator_bank", mutates_args=(),
                         device_types="cuda")
def oscillator_bank_op(phase: torch.Tensor, amplitudes_frames: torch.Tensor,
                       block_size: int, harmonic_chunk: int) -> torch.Tensor:
    """#8 as a custom op; harmonic_chunk is the plain version's (the CPU
    implementation's), which the kernel does not need."""
    bsz, f, n_h = _oscillator_bank_checks(phase, amplitudes_frames,
                                          block_size)
    out = torch.empty_like(phase)
    _launch("oscillator_bank", "oscillator_bank_launch", phase.data_ptr(),
            amplitudes_frames.data_ptr(), out.data_ptr(), bsz * f, f, n_h,
            block_size, _stream(out))
    oscillator_bank.launches += 1
    return out


oscillator_bank_op.register_kernel("cpu")(oscillator_bank_plain)


@oscillator_bank_op.register_fake
def _(phase, amplitudes_frames, block_size, harmonic_chunk):
    return phase.new_empty(phase.shape)


def oscillator_bank_kernel_info(n_h: int = 128) -> dict:
    """As harmonic_source_kernel_info, for the oscillator bank at n_h
    harmonics."""
    return _kernel_info("oscillator_bank", "oscillator_bank_info", n_h)


def oscillator_bank_bwd_plain(g, phase, amplitudes_frames, block_size: int,
                              harmonic_chunk: int = 32, needs=(False, True)):
    """The adjoint of the oscillator bank (the JAX package's
    oscillator_bank_pallas has no VJP): autograd through the plain version,
    re-run here. needs: which of (d phase, d amplitudes_frames) to compute;
    the other is None."""
    return _replay_grads(
        lambda p, a: oscillator_bank_plain(p, a, block_size, harmonic_chunk),
        (phase, amplitudes_frames), needs, g)


def oscillator_bank(phase, amplitudes_frames, block_size: int,
                    harmonic_chunk: int = 32):
    """Additive synthesis in one kernel: phase (B, T) [rad] and
    amplitudes_frames (B, F, n_harm), T = F * block_size, fp32 ->
    sum_k lerp(amp_k) sin(wrap((k+1) phase)), (B, T). Four samples a thread,
    the sines by a recurrence along the harmonics; the (B, T, n_harm) bank
    never exists in the forward. harmonic_chunk bounds the plain forward's
    memory; the backward, autograd of the plain version, keeps the sines of
    every chunk. Differentiable; where no gradient is wanted the op runs
    without the autograd Function."""
    tensors = (phase, amplitudes_frames)
    if not _wants_grad(tensors):
        return oscillator_bank_op(*tensors, block_size, harmonic_chunk)
    if phase.device.type == "cpu":
        return oscillator_bank_plain(*tensors, block_size, harmonic_chunk)
    # the phase comes from f0 and needs no gradient; each is computed only
    # when asked for
    return _PlainBackwardFn.apply(
        lambda p, a: oscillator_bank_op(p, a, block_size, harmonic_chunk),
        lambda p, a: oscillator_bank_plain(p, a, block_size, harmonic_chunk),
        *tensors)


# ------------------------------ LTV-FIR convolve ----------------------------

LTV_MAX_N = 4096


def ltv_fir_convolve_plain(a_frames, ir_frames, n_fft: int):
    """Per row irfft(rfft(a, n) * rfft(h, n), n): with n >= frame + ir - 1
    the linear convolution of each frame with its impulse response. a (R,
    frame), h (R, ir) -> (R, n_fft)."""
    from .spectral import irfft_any

    spec = torch.fft.rfft(a_frames, n_fft) * torch.fft.rfft(ir_frames, n_fft)
    return irfft_any(spec, n_fft)


@torch.library.custom_op("ddsp_svc::ltv_fir_convolve", mutates_args=(),
                         device_types="cuda")
def ltv_fir_convolve_op(a_frames: torch.Tensor, ir_frames: torch.Tensor,
                        n_fft: int) -> torch.Tensor:
    """#9 as a custom op."""
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


ltv_fir_convolve_op.register_kernel("cpu")(ltv_fir_convolve_plain)


@ltv_fir_convolve_op.register_fake
def _(a_frames, ir_frames, n_fft):
    return a_frames.new_empty((a_frames.shape[0], n_fft))


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
    """The forward op, ltv_fir_convolve_bwd_plain as the backward."""

    @staticmethod
    def forward(ctx, a_frames, ir_frames, n_fft):
        ctx.n_fft = n_fft
        ctx.save_for_backward(a_frames, ir_frames)
        return ltv_fir_convolve_op(a_frames, ir_frames, n_fft)

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        d_a, d_h = ltv_fir_convolve_bwd_plain(
            g, a, h, ctx.n_fft, needs=ctx.needs_input_grad[:2])
        return d_a, d_h, None


def ltv_fir_convolve(a_frames, ir_frames, n_fft: int):
    """The framed spectral convolution of `frequency_filter` in one kernel
    (per row three n/2-point FFTs in shared memory): a_frames (R, frame),
    ir_frames (R, ir) fp32, n_fft a power of two >= frame + ir - 1 ->
    (R, n_fft). Differentiable in both inputs; where no gradient is wanted
    the op runs without the autograd Function."""
    if not _wants_grad((a_frames, ir_frames)):
        return ltv_fir_convolve_op(a_frames, ir_frames, n_fft)
    if a_frames.device.type == "cpu":
        return ltv_fir_convolve_plain(a_frames, ir_frames, n_fft)
    return _LtvFirConvolveFn.apply(a_frames, ir_frames, n_fft)


KERNELS = (performer_attention, combsub_spectral, harmonic_source,
           fused_resblocks_inject, fused_resblocks, dft_magnitude,
           combsub_spectral_bwd, oscillator_bank, ltv_fir_convolve,
           fused_resblock_chain, fused_stage)
reset_launch_counts()
